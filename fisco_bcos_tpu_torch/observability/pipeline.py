"""Pipeline observatory — stage occupancy accounting and backpressure
watermarks for the admission→seal→consensus→execute→commit pipeline.

The ROADMAP's flood-TPS gap (0.07x baseline while per-op crypto beats it)
lives in the pipeline AROUND the kernels: some stage is saturated, others
idle behind it. The critical-path analyzer answers that for ONE
transaction; the throughput campaign needs the aggregate, continuous view
— which stage is busy, which is blocked and *on what* — the pipeline
occupancy accounting the FPGA-ECDSA engine (arxiv 2112.02229) and the
committee-consensus per-phase cost study (2302.00418) get their wins from.

Two instruments (the third, the sampling profiler, lives
in :mod:`.profiler`):

- **Stage occupancy state machine.** Each pipeline worker drives a
  per-stage busy/idle/blocked record through :data:`PIPELINE`:
  ``with PIPELINE.busy("admission"): ...`` marks thread-time busy;
  ``with PIPELINE.blocked("device_plane"): ...`` *inside* a busy region
  flips the ambient stage to blocked with attribution (the edge
  ``admission blocked_on=device_plane``), subtracting the wait from busy
  time. Loop-driven stages (the sealer tick) use the sticky marks
  (:meth:`PipelineRecorder.mark_blocked` / :meth:`~PipelineRecorder.mark_idle`)
  between ticks. Totals export as
  ``fisco_stage_busy_ms_total{stage}`` / ``fisco_stage_blocked_ms_total{stage,on}``
  counters, per-interval histograms on :data:`STAGE_SPAN_BUCKETS_MS`, and a
  ``fisco_stage_utilization_ratio{stage}`` pull-gauge over the last
  :data:`UTILIZATION_WINDOW_S`; aggregate state transitions land in a
  bounded per-stage timeline ring.
- **Backpressure watermarks.** Queue-depth probes registered at node boot
  (pool depth, sealer backlog, device-plane lanes, in-flight 2PC, notify
  queue, proof-plane pending builds) are sampled by one background thread
  (``FISCO_PIPELINE_SAMPLE_MS``, default 25 ms) into bounded timelines,
  served in the ``GET /pipeline`` JSON and merged into the Chrome-trace
  export as counter ("C") events — stage spans and queue levels render on
  one Perfetto timeline.

``FISCO_PIPELINE_OBS=0`` turns the whole layer into shared-noop context
managers and unregistered probes — the bench overhead A/B switch.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import deque
from typing import Callable

# per-interval stage spans: busy bursts are batch/block level (ms..s),
# blocked waits range from sub-ms plane waits to multi-second 2PC stalls
STAGE_SPAN_BUCKETS_MS = (
    1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 1000.0, 5000.0,
)
# the gauge's sliding window: long enough to cover a whole bench round
# burst, short enough that "saturated NOW" means now
UTILIZATION_WINDOW_S = 60.0
TIMELINE_CAP = 2048
WATERMARK_CAP = 2048

_BUSY, _BLOCKED, _IDLE = "busy", "blocked", "idle"


def pipeline_obs_enabled() -> bool:
    return os.environ.get("FISCO_PIPELINE_OBS", "1") != "0"


class _NoopCtx:
    """Shared do-nothing context for the disabled recorder — `busy()` and
    `blocked()` cost one attribute read and return this singleton."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopCtx()


class _ProbeGone(Exception):
    """A weakly-held probe's owner was garbage collected."""


class _Probe:
    """Probe holder: bound methods are held through a ``WeakMethod`` so a
    registered probe never pins its node's txpool/scheduler/proof-plane
    alive — a torn-down node's probes vanish with it (raising
    :class:`_ProbeGone` at the next sweep, which removes them and frees
    the name for the replacement node). Plain callables (lambdas, module
    functions) are held strongly as before."""

    __slots__ = ("_ref", "_fn")

    def __init__(self, fn: Callable[[], object]):
        if getattr(fn, "__self__", None) is not None:
            self._ref: weakref.WeakMethod | None = weakref.WeakMethod(fn)
            self._fn = None
        else:
            self._ref = None
            self._fn = fn

    @property
    def dead(self) -> bool:
        return self._ref is not None and self._ref() is None

    def __call__(self):
        if self._ref is not None:
            m = self._ref()
            if m is None:
                raise _ProbeGone()
            return m()
        return self._fn()


class StageStats:
    """One stage's accumulators + aggregate state machine. Every field is
    mutated under the owning recorder's lock; snapshots copy under it."""

    def __init__(
        self,
        name: str,
        now: float,
        timeline_cap: int = TIMELINE_CAP,
        flight=None,
    ):
        self.name = name
        self.created = now
        # black box feed: aggregate transitions double as flight
        # events; None for harness/test recorders so only the process
        # recorder writes the process ring
        self._flight = flight
        self.busy_ms = 0.0
        self.blocked_ms: dict[str, float] = {}  # on -> thread-ms
        self.intervals = 0  # completed busy intervals
        self.blocked_intervals = 0
        # aggregate transitions (t, state, detail): appended only when the
        # stage's AGGREGATE state changes — multi-threaded stages stay
        # compact, and the utilization replay below stays correct
        self.timeline: deque[tuple[float, str, str]] = deque(maxlen=timeline_cap)
        # open per-thread busy entries: tid -> [t0, blocked_sub_ms]
        self._open: dict[int, list[float]] = {}
        self.n_busy = 0
        self.n_blocked = 0
        self._last_on = ""
        # loop-driven override (sealer tick): (state, on, t0), active only
        # while no scoped interval is open
        self._sticky: tuple[str, str, float] | None = None
        self.state = _IDLE
        self.state_on = ""

    # -- aggregate state (recorder lock held) --------------------------------

    def _recompute_locked(self, now: float) -> None:
        if self.n_busy > 0:
            state, on = _BUSY, ""
        elif self.n_blocked > 0:
            state, on = _BLOCKED, self._last_on
        elif self._sticky is not None:
            state, on = self._sticky[0], self._sticky[1]
        else:
            state, on = _IDLE, ""
        if (state, on) != (self.state, self.state_on):
            self.state, self.state_on = state, on
            self.timeline.append((now, state, on))
            if self._flight is not None:
                self._flight.record("stage", state, stage=self.name, on=on)

    def _close_sticky_locked(self, now: float) -> None:
        if self._sticky is None:
            return
        state, on, t0 = self._sticky
        self._sticky = None
        if state == _BLOCKED:
            dur_ms = max(now - t0, 0.0) * 1e3
            self.blocked_ms[on] = self.blocked_ms.get(on, 0.0) + dur_ms
            self.blocked_intervals += 1

    # -- replay (recorder lock held) -----------------------------------------

    def busy_fraction_locked(self, now: float, window_s: float) -> float:
        """Fraction of the last ``window_s`` the AGGREGATE state was busy,
        replayed from the transition ring (state before the first recorded
        transition is idle — stages are created idle)."""
        start = max(now - window_s, self.created)
        if self.timeline and self.timeline[0][0] > self.created:
            # ring may have evicted early history; never claim coverage
            # before the oldest surviving transition unless it IS complete
            if len(self.timeline) == self.timeline.maxlen:
                start = max(start, self.timeline[0][0])
        span = now - start
        if span <= 0:
            return 1.0 if self.state == _BUSY else 0.0
        state, t_state = _IDLE, self.created
        acc = 0.0
        for t, s, _on in self.timeline:
            if t <= start:
                state, t_state = s, t
                continue
            if state == _BUSY:
                acc += t - max(t_state, start)
            state, t_state = s, t
        if state == _BUSY:
            acc += now - max(t_state, start)
        return min(max(acc / span, 0.0), 1.0)


class PipelineRecorder:
    """The stage-occupancy + watermark recorder. One process-wide instance
    (:data:`PIPELINE`) serves every pipeline worker; standalone instances
    (injected clock, metrics emission off) exist in tests and the
    interleave harness.

    Thread contract: scoped ``busy()``/``blocked()`` intervals belong to
    the calling thread (several threads may drive one stage — busy time
    accumulates as thread-milliseconds); sticky marks belong to a stage's
    single loop driver. All state mutates under one lock; the probe
    callables run OUTSIDE it (they take their subsystems' own locks)."""

    def __init__(
        self,
        clock: Callable[[], float] = time.perf_counter,
        enabled: bool | None = None,
        timeline_cap: int = TIMELINE_CAP,
        watermark_cap: int = WATERMARK_CAP,
        emit_metrics: bool = True,
    ):
        self.clock = clock
        self.enabled = pipeline_obs_enabled() if enabled is None else enabled
        self.emit_metrics = emit_metrics
        self.timeline_cap = int(timeline_cap)
        self.watermark_cap = int(watermark_cap)
        self._lock = threading.Lock()
        self._stages: dict[str, StageStats] = {}
        self._tls = threading.local()
        self._probes: dict[str, Callable[[], object]] = {}
        self._probe_failures: dict[str, int] = {}
        self._marks: dict[str, deque] = {}  # name -> deque[(t, value)]
        self._sampler: threading.Thread | None = None
        self._sampler_stop = threading.Event()
        # flight feed only from the process recorder (emit_metrics is the
        # existing "I am the real one" discriminator); lazy import keeps
        # roundlog->flight->(this module unused) cycles impossible
        self._flight = None
        if emit_metrics:
            try:
                from .flight import FLIGHT

                if FLIGHT.enabled:
                    self._flight = FLIGHT
            except ImportError:  # pragma: no cover - partial-import window
                pass
        self.t0 = self.clock()

    # -- internals -----------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _stage_locked(self, name: str, now: float) -> StageStats:
        st = self._stages.get(name)
        if st is None:
            st = self._stages[name] = StageStats(
                name, now, self.timeline_cap, flight=self._flight
            )
            if self.emit_metrics:
                self._register_gauge(name)
        return st

    def _register_gauge(self, name: str) -> None:
        try:
            from ..utils.metrics import REGISTRY

            REGISTRY.gauge_fn(
                f'fisco_stage_utilization_ratio{{stage="{name}"}}',
                lambda: self.utilization(name),
                help="fraction of the last window the stage was busy "
                "(aggregate over its worker threads)",
            )
        except Exception as e:  # metrics layer unavailable — recorder works
            from ..utils.log import note_swallowed

            note_swallowed("pipeline.gauge_register", e)

    def _emit_interval(self, kind: str, stage: str, on: str, dur_ms: float) -> None:
        """Registry emission for one closed interval — called with the
        recorder lock RELEASED (the registry has its own lock)."""
        if not self.emit_metrics:
            return
        try:
            from ..utils.metrics import REGISTRY
        except Exception:  # pragma: no cover - partial-import window
            return
        if not REGISTRY.enabled:
            return
        if kind == _BUSY:
            REGISTRY.counter_add(
                f'fisco_stage_busy_ms_total{{stage="{stage}"}}',
                dur_ms,
                help="thread-milliseconds each pipeline stage spent busy "
                "(blocked waits excluded)",
            )
            REGISTRY.observe(
                "fisco_stage_busy_span_ms",
                dur_ms,
                buckets=STAGE_SPAN_BUCKETS_MS,
                help="one stage busy interval (batch/block of work)",
                stage=stage,
            )
        else:
            REGISTRY.counter_add(
                f'fisco_stage_blocked_ms_total{{stage="{stage}",on="{on}"}}',
                dur_ms,
                help="thread-milliseconds each stage spent blocked, by what "
                "it was blocked on (the backpressure edges)",
            )
            REGISTRY.observe(
                "fisco_stage_blocked_span_ms",
                dur_ms,
                buckets=STAGE_SPAN_BUCKETS_MS,
                help="one stage blocked interval",
                stage=stage,
            )

    # -- scoped intervals ----------------------------------------------------

    def busy(self, stage: str):
        """Mark the calling thread busy in ``stage`` for the with-block.
        Reentrant per thread (a nested busy on the same stage is a no-op,
        so the executor's batch seam under the scheduler's block seam
        counts once). Entering busy closes any sticky mark on the stage."""
        if not self.enabled:
            return _NOOP
        return _BusyCtx(self, stage)

    def blocked(self, on: str, stage: str | None = None):
        """Attribute a wait to the ambient stage (the innermost ``busy``
        on this thread) — the ``stage blocked_on=<on>`` edge. With no
        ambient stage and no explicit ``stage=``, a no-op: an
        unattributable wait is noise, not signal. Reentrant per thread
        and stage: a nested wait inside an already-blocked region (e.g. a
        plane wait reached from inside a 2PC leg) keeps the OUTER
        attribution — its time is already counted there, and a second
        busy/blocked flip would corrupt the thread counts."""
        if not self.enabled:
            return _NOOP
        if stage is None:
            stack = getattr(self._tls, "stack", None)
            if not stack:
                return _NOOP
            stage = stack[-1]
        blocked_set = getattr(self._tls, "blocked", None)
        if blocked_set and stage in blocked_set:
            return _NOOP
        return _BlockedCtx(self, stage, on)

    # -- sticky marks (single-threaded loop stages) --------------------------

    def mark_blocked(self, stage: str, on: str) -> None:
        """Loop-driven stages (the sealer tick) park here between attempts:
        the stage shows blocked-on-``on`` until the next mark or busy()."""
        if not self.enabled:
            return
        now = self.clock()
        with self._lock:
            st = self._stage_locked(stage, now)
            if st._sticky is not None and st._sticky[:2] == (_BLOCKED, on):
                return  # already parked on the same edge — keep t0
            st._close_sticky_locked(now)
            st._sticky = (_BLOCKED, on, now)
            st._recompute_locked(now)

    def mark_idle(self, stage: str) -> None:
        if not self.enabled:
            return
        now = self.clock()
        with self._lock:
            st = self._stage_locked(stage, now)
            if st._sticky is None and st.state == _IDLE:
                return
            st._close_sticky_locked(now)
            st._recompute_locked(now)

    # -- introspection -------------------------------------------------------

    def utilization(
        self, stage: str, window_s: float = UTILIZATION_WINDOW_S
    ) -> float:
        with self._lock:
            st = self._stages.get(stage)
            if st is None:
                return 0.0
            return st.busy_fraction_locked(self.clock(), window_s)

    def snapshot(self, window_s: float = UTILIZATION_WINDOW_S) -> dict:
        """Per-stage document: totals (open intervals included), current
        aggregate state, blocked-on edges, utilization over ``window_s``."""
        out: dict[str, dict] = {}
        with self._lock:
            now = self.clock()
            for name, st in self._stages.items():
                busy_ms = st.busy_ms
                blocked = dict(st.blocked_ms)
                for t0, sub in st._open.values():
                    busy_ms += max((now - t0) * 1e3 - sub, 0.0)
                if st._sticky is not None and st._sticky[0] == _BLOCKED:
                    on = st._sticky[1]
                    blocked[on] = blocked.get(on, 0.0) + max(
                        now - st._sticky[2], 0.0
                    ) * 1e3
                elapsed_ms = max((now - st.created) * 1e3, 1e-9)
                out[name] = {
                    "state": st.state,
                    "blocked_on": st.state_on or None,
                    "busy_ms": round(busy_ms, 3),
                    "blocked_ms": {k: round(v, 3) for k, v in blocked.items()},
                    "intervals": st.intervals,
                    "blocked_intervals": st.blocked_intervals,
                    "active_threads": st.n_busy,
                    "blocked_threads": st.n_blocked,
                    "utilization": round(
                        st.busy_fraction_locked(now, window_s), 4
                    ),
                    "utilization_lifetime": round(
                        min(busy_ms / elapsed_ms, 1.0), 4
                    ),
                }
        return out

    def timelines(self, tail: int = 256) -> dict:
        """Per-stage transition-ring tails: [[t, state, on], ...]."""
        with self._lock:
            return {
                name: [list(e) for e in list(st.timeline)[-tail:]]
                for name, st in self._stages.items()
            }

    def reset(self) -> None:
        """Drop all stage + watermark state (tests / bench children)."""
        with self._lock:
            self._stages.clear()
            self._marks.clear()
            self._probe_failures.clear()
            self.t0 = self.clock()

    # -- backpressure watermarks ---------------------------------------------

    def add_probe(self, name: str, fn: Callable[[], object]) -> bool:
        """Register a queue-depth probe (callable -> number, or dict of
        sub-series -> number, e.g. the device plane's per-lane depths).
        First LIVE registration wins (a multi-node test process keeps the
        entry node's probes); a probe whose owner was garbage collected is
        replaced — the restart path re-observes the new node. Bound
        methods are held weakly (:class:`_Probe`), so registration never
        pins a node's subsystems in memory. Returns whether installed."""
        if not self.enabled:
            return False
        with self._lock:
            existing = self._probes.get(name)
            if existing is not None and not existing.dead:
                return False
            self._probes[name] = _Probe(fn)
        return True

    def remove_probe(self, name: str) -> None:
        with self._lock:
            self._probes.pop(name, None)
            self._probe_failures.pop(name, None)

    def sample_once(self) -> None:
        """One watermark sweep: call every probe (outside the recorder
        lock — probes take their subsystems' locks), ring the readings.
        A probe failing 8 times in a row is dropped (logged once)."""
        if not self.enabled:
            return
        with self._lock:
            probes = list(self._probes.items())
        now = self.clock()
        readings: list[tuple[str, float]] = []
        ok: list[str] = []
        gone: list[str] = []
        failed: list[tuple[str, Exception]] = []
        for name, fn in probes:
            try:
                value = fn()
                if isinstance(value, dict):
                    for k, v in value.items():
                        readings.append((f"{name}.{k}", float(v)))
                else:
                    readings.append((name, float(value)))
                ok.append(name)
            except _ProbeGone:
                # the probe's node was torn down: remove immediately and
                # free the name for the replacement node's registration
                gone.append(name)
            except Exception as e:
                failed.append((name, e))
        dead: list[tuple[str, Exception]] = []
        with self._lock:
            for name in ok:
                self._probe_failures.pop(name, None)
            for name in gone:
                self._probes.pop(name, None)
                self._probe_failures.pop(name, None)
            for name, e in failed:
                n = self._probe_failures.get(name, 0) + 1
                self._probe_failures[name] = n
                if n >= 8:
                    self._probes.pop(name, None)
                    dead.append((name, e))
            for name, v in readings:
                ring = self._marks.get(name)
                if ring is None:
                    ring = self._marks[name] = deque(maxlen=self.watermark_cap)
                ring.append((now, v))
        for name, e in dead:
            from ..utils.log import note_swallowed

            note_swallowed(f"pipeline.probe.{name}", e)

    def ensure_sampler(self, interval_s: float | None = None) -> None:
        """Start the background watermark sampler (idempotent)."""
        if not self.enabled:
            return
        if interval_s is None:
            try:
                interval_s = (
                    float(os.environ.get("FISCO_PIPELINE_SAMPLE_MS", "25")) / 1e3
                )
            except ValueError:
                interval_s = 0.025
        with self._lock:
            if self._sampler is not None and self._sampler.is_alive():
                return
            self._sampler_stop = threading.Event()
            stop = self._sampler_stop

            def run() -> None:
                while not stop.wait(interval_s):
                    self.sample_once()

            self._sampler = threading.Thread(
                target=run, name="pipeline-watermarks", daemon=True
            )
            self._sampler.start()

    def stop_sampler(self) -> None:
        with self._lock:
            stop, self._sampler = self._sampler_stop, None
        stop.set()

    def watermarks(self, tail: int = 256) -> dict:
        """{series: {last, max, n, timeline: [[t, v] x tail]}}."""
        with self._lock:
            out = {}
            for name, ring in self._marks.items():
                pts = list(ring)
                out[name] = {
                    "last": pts[-1][1] if pts else 0.0,
                    "max": max((v for _t, v in pts), default=0.0),
                    "n": len(pts),
                    "timeline": [[round(t, 6), v] for t, v in pts[-tail:]],
                }
            return out

    def counter_events(self) -> list[dict]:
        """The watermark rings as Chrome-trace counter ("C") events — the
        tracer merges these into ``GET /trace`` so queue levels render on
        the same Perfetto timeline as the stage spans."""
        pid = os.getpid()
        events = []
        with self._lock:
            rings = {name: list(ring) for name, ring in self._marks.items()}
        for name, pts in rings.items():
            for t, v in pts:
                events.append(
                    {
                        "ph": "C",
                        "name": f"queue.{name}",
                        "cat": "fisco",
                        "pid": pid,
                        "tid": 0,
                        "ts": round(t * 1e6, 3),
                        "args": {"depth": v},
                    }
                )
        return events


class _BusyCtx:
    __slots__ = ("_rec", "_stage", "_reentrant", "_t0")

    def __init__(self, rec: PipelineRecorder, stage: str):
        self._rec = rec
        self._stage = stage

    def __enter__(self):
        rec = self._rec
        stack = rec._stack()
        if self._stage in stack:
            self._reentrant = True
            return self
        self._reentrant = False
        now = rec.clock()
        tid = threading.get_ident()
        with rec._lock:
            st = rec._stage_locked(self._stage, now)
            st._close_sticky_locked(now)
            st._open[tid] = [now, 0.0]
            st.n_busy += 1
            st._recompute_locked(now)
        self._t0 = now
        stack.append(self._stage)
        return self

    def __exit__(self, *exc):
        if self._reentrant:
            return False
        rec = self._rec
        stack = rec._stack()
        if stack and stack[-1] == self._stage:
            stack.pop()
        now = rec.clock()
        tid = threading.get_ident()
        dur_ms = 0.0
        with rec._lock:
            st = rec._stages.get(self._stage)
            if st is not None:
                entry = st._open.pop(tid, None)
                if entry is not None:
                    t0, sub = entry
                    dur_ms = max((now - t0) * 1e3 - sub, 0.0)
                    st.busy_ms += dur_ms
                    st.intervals += 1
                st.n_busy = max(st.n_busy - 1, 0)
                st._recompute_locked(now)
        rec._emit_interval(_BUSY, self._stage, "", dur_ms)
        return False


class _BlockedCtx:
    __slots__ = ("_rec", "_stage", "_on", "_t0", "_was_busy")

    def __init__(self, rec: PipelineRecorder, stage: str, on: str):
        self._rec = rec
        self._stage = stage
        self._on = on

    def __enter__(self):
        rec = self._rec
        now = rec.clock()
        tid = threading.get_ident()
        blocked_set = getattr(rec._tls, "blocked", None)
        if blocked_set is None:
            blocked_set = rec._tls.blocked = set()
        blocked_set.add(self._stage)
        with rec._lock:
            st = rec._stage_locked(self._stage, now)
            # a thread leaving its busy region for a wait moves busy ->
            # blocked; a bare blocked (explicit stage=, no open busy on
            # this thread) only adds a blocked thread
            self._was_busy = tid in st._open
            if self._was_busy:
                st.n_busy = max(st.n_busy - 1, 0)
            st.n_blocked += 1
            st._last_on = self._on
            st._recompute_locked(now)
        self._t0 = now
        return self

    def __exit__(self, *exc):
        rec = self._rec
        now = rec.clock()
        tid = threading.get_ident()
        blocked_set = getattr(rec._tls, "blocked", None)
        if blocked_set is not None:
            blocked_set.discard(self._stage)
        dur_ms = max(now - self._t0, 0.0) * 1e3
        with rec._lock:
            st = rec._stages.get(self._stage)
            if st is not None:
                st.blocked_ms[self._on] = (
                    st.blocked_ms.get(self._on, 0.0) + dur_ms
                )
                st.blocked_intervals += 1
                if self._was_busy and tid in st._open:
                    # the wait does not count as busy work
                    st._open[tid][1] += dur_ms
                    st.n_busy += 1
                st.n_blocked = max(st.n_blocked - 1, 0)
                st._recompute_locked(now)
        rec._emit_interval(_BLOCKED, self._stage, self._on, dur_ms)
        return False


# process-wide recorder (pipeline workers import and use directly, like
# utils.metrics.REGISTRY / observability.TRACER)
PIPELINE = PipelineRecorder()


def pipeline_doc(
    window_s: float = UTILIZATION_WINDOW_S, tail: int = 256
) -> dict:
    """The ``GET /pipeline`` document: stage occupancy + blocked-on edges +
    watermark timelines, one JSON. ``epoch`` anchors the perf_counter
    timestamps to wall clock (same contract as the trace export)."""
    from .tracer import TRACER

    doc = {
        "enabled": PIPELINE.enabled,
        "ts": time.time(),
        "epoch": TRACER.epoch,
        "window_s": window_s,
        "stages": PIPELINE.snapshot(window_s) if PIPELINE.enabled else {},
        "timelines": PIPELINE.timelines(tail) if PIPELINE.enabled else {},
        "watermarks": PIPELINE.watermarks(tail) if PIPELINE.enabled else {},
    }
    return doc


def _install_chrome_source() -> None:
    """Merge the process recorder's watermark counters into the Chrome
    trace export (tracer.CHROME_EVENT_SOURCES). Import-time, idempotent."""
    from . import tracer

    if PIPELINE.counter_events not in tracer.CHROME_EVENT_SOURCES:
        tracer.CHROME_EVENT_SOURCES.append(PIPELINE.counter_events)


_install_chrome_source()
