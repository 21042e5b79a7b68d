"""Device observatory: per-op signals, the build ledger, in-plane time
attribution, live CUDA bytes and the recompile-storm state (the port of the
JAX package's ``observability/device.py``, with its names, signatures and
metric families).

The host entry points (``ops/keccak``, ``ops/sm3``, ``ops/sha256``,
``ops/poseidon``, ``ops/secp256k1``, ``ops/sm2``, ``ops/ed25519``,
``ops/merkle``, ``crypto/admission``, ``crypto/suite``, ``crypto/bls``)
wrap each host call in :class:`device_span`, under the op name and shape
key the JAX wrapper uses for the same batch:

- ``fisco_device_batch_size{op=...}``      power-of-two batch histogram
- ``fisco_device_op_latency_ms{op=...}``   wall latency per host call
- ``fisco_device_items_total{op=...}``     items processed (rate = items/sec)
- ``fisco_device_op_seconds_total{op=...}`` wall seconds
- ``fisco_device_compile_total{op=...}`` / ``fisco_device_cached_call_total``
  first-call-per-bucketed-shape vs repeat-shape calls.

On top, behind ``FISCO_DEVICE_OBS`` (default on; ``=0`` turns every one
into a shared noop):

- **The build ledger** (:data:`LEDGER`). The port has no JIT: its analogue
  of a compile is a kernel library's first use in a process
  (``ops/_kernels.py`` ``_library``), which either runs nvcc or finds the
  library in the build directory, the persistent cache, then loads it with
  ctypes. ``_kernels`` tells its build listeners, which
  :func:`install_build_hooks` registers, the JAX monitoring sequence: the
  verdict ``cache_miss`` (nvcc ran) or ``cache_hit``, then ``retrieval``
  (the load and the binding of the entry points), then
  ``backend_compile`` (nvcc's wall, 0.0 on a hit), which closes the
  episode. Attribution rides the thread-local frame :class:`device_span`
  pushed: a library is built and loaded on the thread that launches, so a
  span around a routed call lives in the body the DevicePlane's worker
  runs. A build outside any span lands under ``(unattributed)``.
- **Phase attribution**: every span splits its wall into compile (the
  measured nvcc seconds), transfer (the host→card copies a wrapper marks
  with ``span.phase("transfer")``) and execute, the host-clock remainder,
  as ``fisco_device_phase_ms{op,phase}`` and as retroactive child spans in
  the trace ring. The span adds no CUDA synchronisation and no CUDA event:
  where a call ends in a download, execute holds the kernels' time. The
  DevicePlane adds the queue segment per dispatch (phase="queue", labeled
  with the plane's op).
- **Live CUDA bytes**: :func:`device_memory_bytes` reads the caching
  allocator's live bytes a device.
- **Recompile-storm state**: cold builds per op inside
  ``FISCO_DEVICE_STORM_WINDOW_S`` (60 s) past the bucket-ladder bound
  (× ``FISCO_DEVICE_STORM_FACTOR``, 2) mark the op as storming in
  :meth:`CompileLedger.storm_state` and :func:`device_doc`. The JAX
  package also moves a ``/health`` row; the port has no health registry
  (it belongs to the node's host modules), so the state is only reported.

:func:`device_doc` is the JAX ``GET /device`` document, key for key.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from ..ops.hash_common import bucket_batch, bucket_ladder
from ..utils import metrics as _metrics
from .histogram import BATCH_BUCKETS, LATENCY_BUCKETS_MS
from .tracer import TRACER

# in-plane phase segments: queue waits are sub-ms..100ms, transfers ms-class,
# execute up to block-scale seconds
DEVICE_PHASE_BUCKETS_MS = (
    0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 1000.0, 5000.0,
)
# compile walls: ms-class library loads up to minute-class nvcc builds (the
# JAX buckets, which reach hour-class XLA compiles)
DEVICE_COMPILE_BUCKETS_MS = (
    1.0, 10.0, 50.0, 250.0, 1000.0, 5000.0, 30000.0, 120000.0, 600000.0,
    3600000.0,
)

_seen_lock = threading.Lock()
_seen_shapes: dict[str, set] = {}


def device_obs_enabled() -> bool:
    """The observatory master switch, read per call (an overhead A/B flips
    it mid-process); independent of FISCO_TELEMETRY, which governs the
    registry and the tracer."""
    return os.environ.get("FISCO_DEVICE_OBS", "1") != "0"


def _count_shape(op: str, key) -> None:
    with _seen_lock:
        shapes = _seen_shapes.setdefault(op, set())
        fresh = key not in shapes
        if fresh:
            shapes.add(key)
    name = "fisco_device_compile_total" if fresh else "fisco_device_cached_call_total"
    _metrics.REGISTRY.counter_add(
        f'{name}{{op="{op}"}}',
        1.0,
        help="device program calls split by first-shape (compile) vs repeat",
    )


def compile_counts() -> dict[str, int]:
    """Distinct (bucketed) shapes seen per op — the in-process view of
    ``fisco_device_compile_total``."""
    with _seen_lock:
        return {op: len(shapes) for op, shapes in _seen_shapes.items()}


# ---------------------------------------------------------------------------
# The build ledger
# ---------------------------------------------------------------------------

_UNATTRIBUTED = "(unattributed)"

# event key suffixes -> ledger kinds (the JAX monitoring names; the port's
# build listeners send the short kinds, which map to themselves)
_EVENT_KINDS = {
    "cache_misses": "cache_miss",
    "cache_hits": "cache_hit",
}
_DURATION_KINDS = {
    "backend_compile_duration": "backend_compile",
    "jaxpr_to_mlir_module_duration": "lowering",
    "cache_retrieval_time_sec": "retrieval",
}


class CompileLedger:
    """Measured build accounting per (op, bucketed shape).

    One build *episode* per thread: the cache verdict event
    (``cache_miss``/``cache_hit``) arrives first, the duration events
    close it — ``backend_compile`` is the terminator (it arrives on both
    paths; an episode with no verdict is a cold build by definition).
    Attribution comes from the thread-local frame the enclosing
    :class:`device_span` pushed.

    Standalone instances (injected clock, for the storm-window tests)
    exist in tests; the process singleton is :data:`LEDGER`.
    """

    def __init__(
        self,
        clock=time.perf_counter,
        storm_window_s: float | None = None,
        storm_factor: float | None = None,
        timeline_cap: int = 2048,
    ):
        from ..utils import env_float

        self.clock = clock
        self.storm_window_s = (
            env_float("FISCO_DEVICE_STORM_WINDOW_S", 60.0)
            if storm_window_s is None
            else float(storm_window_s)
        )
        self.storm_factor = (
            env_float("FISCO_DEVICE_STORM_FACTOR", 2.0)
            if storm_factor is None
            else float(storm_factor)
        )
        self._lock = threading.Lock()
        self._tls = threading.local()
        # (op, shape repr) -> entry dict (mutated under _lock)
        self._entries: dict[tuple[str, str], dict] = {}
        self._phase_ms: dict[str, dict[str, float]] = {}
        self._max_batch: dict[str, int] = {}
        # op -> deque of cold-build timestamps (the storm window)
        self._cold_times: dict[str, deque] = {}
        self._storm_ops: set[str] = set()
        self._dispatches: deque = deque(maxlen=int(timeline_cap))
        # dispatch adjacency: (prev op, op) -> count, fed at device_span
        # exit and DevicePlane dispatch — which op pairs run back-to-back,
        # i.e. which host round-trips a merged launch would delete
        self._adjacency: dict[tuple[str, str], int] = {}
        self._last_adj_op: str | None = None
        # bookkeeping wall spent in observatory accounting (device_span
        # exit paths add to it) — the measured-overhead figure
        self._overhead_s = 0.0

    # -- attribution frames (device_span drives these) -----------------------

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def push(self, op: str, shape_key, batch: int) -> dict:
        frame = {
            "op": op,
            "shape": shape_key,
            "batch": int(batch),
            "compile_ms": 0.0,
            "pending": None,  # cache verdict awaiting its backend_compile
            "pending_lowering_ms": 0.0,
            "pending_retrieval_ms": 0.0,
        }
        self._stack().append(frame)
        with self._lock:
            if batch > self._max_batch.get(op, 0):
                self._max_batch[op] = int(batch)
        return frame

    def pop(self) -> dict | None:
        stack = self._stack()
        return stack.pop() if stack else None

    def _frame(self) -> dict:
        stack = self._stack()
        if stack:
            return stack[-1]
        # builds outside any span still ledger (warm-up paths, tests); the
        # fallback frame persists per thread so a verdict event and its
        # closing backend_compile land in the same episode
        fallback = getattr(self._tls, "fallback", None)
        if fallback is None:
            fallback = self._tls.fallback = {
                "op": _UNATTRIBUTED, "shape": "?", "batch": 0,
                "compile_ms": 0.0, "pending": None,
                "pending_lowering_ms": 0.0, "pending_retrieval_ms": 0.0,
            }
        return fallback

    # -- hook entry points (the build listeners and injected test hooks) -----

    def note_event(self, name: str) -> None:
        """A counter-style event ('cache_miss'/'cache_hit', or a full
        monitoring key)."""
        kind = _EVENT_KINDS.get(name.rsplit("/", 1)[-1], name)
        if kind not in ("cache_miss", "cache_hit"):
            return
        self._frame()["pending"] = kind

    def note_duration(self, name: str, secs: float) -> None:
        """A duration-style event; ``backend_compile`` closes the episode
        and writes the ledger entry."""
        kind = _DURATION_KINDS.get(name.rsplit("/", 1)[-1], name)
        frame = self._frame()
        if kind == "lowering":
            frame["pending_lowering_ms"] += secs * 1e3
            return
        if kind == "retrieval":
            frame["pending_retrieval_ms"] += secs * 1e3
            return
        if kind != "backend_compile":
            return
        source = frame.pop("pending", None) or "cache_miss"
        lowering_ms = frame["pending_lowering_ms"]
        retrieval_ms = frame["pending_retrieval_ms"]
        frame["pending_lowering_ms"] = 0.0
        frame["pending_retrieval_ms"] = 0.0
        frame["pending"] = None
        compile_ms = secs * 1e3
        frame["compile_ms"] += compile_ms + lowering_ms
        self._note_compile(
            frame["op"], frame["shape"], source, compile_ms, lowering_ms,
            retrieval_ms,
        )

    def _note_compile(
        self, op, shape, source, compile_ms, lowering_ms, retrieval_ms
    ) -> None:
        now = self.clock()
        cold = source == "cache_miss"
        key = (op, repr(shape))
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = self._entries[key] = {
                    "op": op,
                    "shape": repr(shape),
                    "cold_compiles": 0,
                    "cache_hits": 0,
                    "compile_ms": 0.0,
                    "lowering_ms": 0.0,
                    "retrieval_ms": 0.0,
                    "last_source": "",
                    "t_last": 0.0,
                }
            e["cold_compiles" if cold else "cache_hits"] += 1
            e["compile_ms"] += compile_ms
            e["lowering_ms"] += lowering_ms
            e["retrieval_ms"] += retrieval_ms
            e["last_source"] = "cold" if cold else "persistent_cache"
            e["t_last"] = now
            if cold and op != _UNATTRIBUTED:
                # unattributed builds are exempt from storm accounting:
                # their max-batch is unknown, so the ladder bound
                # degenerates to ~2
                ring = self._cold_times.setdefault(op, deque(maxlen=256))
                ring.append(now)
            self._refresh_storm_locked(now)
        reg = _metrics.REGISTRY
        if reg.enabled:
            name = (
                "fisco_device_compile_cold_total"
                if cold
                else "fisco_device_compile_cache_hit_total"
            )
            reg.counter_add(
                f'{name}{{op="{op}"}}',
                1.0,
                help="measured kernel-library builds split by nvcc build vs "
                "build-cache load (ops/_kernels build listeners)",
            )
            reg.observe(
                "fisco_device_compile_ms",
                compile_ms,
                buckets=DEVICE_COMPILE_BUCKETS_MS,
                help="measured nvcc wall per library build (build-cache "
                "loads appear under source=cache)",
                op=op,
                source="cold" if cold else "cache",
            )

    # -- storm detection ------------------------------------------------------

    def _bound(self, op: str) -> int:
        ladder = len(bucket_ladder(max(self._max_batch.get(op, 1), 1)))
        return max(int(ladder * self.storm_factor), 1)

    def _refresh_storm_locked(self, now: float) -> None:
        horizon = now - self.storm_window_s
        storming: set[str] = set()
        for op, ring in self._cold_times.items():
            while ring and ring[0] < horizon:
                ring.popleft()
            if len(ring) > self._bound(op):
                storming.add(op)
        # the state only: the JAX package also moves its /health row here,
        # and the port has no health registry to move
        self._storm_ops = storming

    def refresh_storm(self) -> None:
        """Re-evaluate the storm window against the clock (the doc
        renderer calls it so recovery doesn't wait for the next build)."""
        with self._lock:
            self._refresh_storm_locked(self.clock())

    def storm_state(self) -> dict:
        with self._lock:
            self._refresh_storm_locked(self.clock())
            return {
                "active": bool(self._storm_ops),
                "ops": sorted(self._storm_ops),
                "window_s": self.storm_window_s,
                "bounds": {
                    op: self._bound(op) for op in self._cold_times
                },
            }

    # -- phase + dispatch accounting -----------------------------------------

    def note_phases(self, op: str, phases: dict, t0: float | None = None,
                    dur: float | None = None) -> None:
        with self._lock:
            agg = self._phase_ms.setdefault(op, {})
            for phase, ms in phases.items():
                if ms > 0.0:
                    agg[phase] = agg.get(phase, 0.0) + ms
            if dur is not None:
                self._dispatches.append(
                    (op, t0, dur, {k: round(v, 3) for k, v in phases.items()})
                )

    def note_adjacency(self, op: str) -> None:
        """One dispatch of ``op`` ended: count the (previous op -> op)
        edge. Process-global order, deliberately across threads — the
        plane serializes dispatches anyway."""
        with self._lock:
            prev = self._last_adj_op
            if prev is not None:
                key = (prev, op)
                self._adjacency[key] = self._adjacency.get(key, 0) + 1
            self._last_adj_op = op

    def adjacency(self) -> dict[str, int]:
        """Measured dispatch-adjacency counts as ``"a->b"`` edges."""
        with self._lock:
            return {
                f"{a}->{b}": n
                for (a, b), n in sorted(self._adjacency.items())
            }

    def add_overhead(self, secs: float) -> None:
        with self._lock:
            self._overhead_s += secs

    def overhead_seconds(self) -> float:
        with self._lock:
            return self._overhead_s

    # -- introspection --------------------------------------------------------

    def snapshot(self) -> list[dict]:
        """The ledger rows, most recently built first."""
        with self._lock:
            rows = [dict(e) for e in self._entries.values()]
        rows.sort(key=lambda e: -e["t_last"])
        for e in rows:
            for k in ("compile_ms", "lowering_ms", "retrieval_ms", "t_last"):
                e[k] = round(e[k], 3)
        return rows

    def program_counts(self) -> dict[str, int]:
        """Distinct (op, shape) entries with at least one measured build or
        cache load, per op — the ledger-truth counterpart of
        :func:`compile_counts`."""
        out: dict[str, int] = {}
        with self._lock:
            for op, _shape in self._entries:
                out[op] = out.get(op, 0) + 1
        return out

    def cold_compile_count(self) -> int:
        with self._lock:
            return sum(e["cold_compiles"] for e in self._entries.values())

    def phase_totals(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {
                op: {k: round(v, 3) for k, v in phases.items()}
                for op, phases in self._phase_ms.items()
            }

    def dispatches(self, tail: int = 64) -> list[list]:
        with self._lock:
            recent = list(self._dispatches)[-tail:]
        return [[op, t0, dur, ph] for op, t0, dur, ph in recent]

    def reset(self) -> None:
        """Drop build/phase state (tests, a run that starts a clean count)."""
        with self._lock:
            self._entries.clear()
            self._phase_ms.clear()
            self._cold_times.clear()
            self._dispatches.clear()
            self._adjacency.clear()
            self._last_adj_op = None
            self._overhead_s = 0.0


# process-wide ledger (the entry points and the build listeners feed it
# directly, like utils.metrics.REGISTRY / TRACER)
LEDGER = CompileLedger()

_HOOKS_INSTALLED = False
_HOOKS_LOCK = threading.Lock()


def _on_build(name: str, secs: float | None = None) -> None:
    """The build listener: an event when ``secs`` is None, else a
    duration."""
    if not device_obs_enabled():
        return
    if secs is None:
        LEDGER.note_event(name)
    else:
        LEDGER.note_duration(name, secs)


def install_build_hooks() -> bool:
    """Register the ledger's listener with ``ops/_kernels.py``'s library
    builds (idempotent; the listener early-returns when the observatory is
    off). The port's ``install_jax_hooks``."""
    global _HOOKS_INSTALLED
    with _HOOKS_LOCK:
        if not _HOOKS_INSTALLED:
            from ..ops import _kernels

            _kernels.BUILD_LISTENERS.append(_on_build)
            _HOOKS_INSTALLED = True
        return True


# ---------------------------------------------------------------------------
# Live device bytes
# ---------------------------------------------------------------------------


def device_memory_bytes() -> dict[str, float]:
    """Live bytes the caching allocator holds, per initialised CUDA device
    (``cuda:<i>``). Empty on the CPU, in a process that has not used the
    card (no CUDA context is created here) and on any error."""
    try:
        import torch

        if not torch.cuda.is_initialized():
            return {}
        return {
            f"cuda:{i}": float(torch.cuda.memory_allocated(i))
            for i in range(torch.cuda.device_count())
        }
    except Exception:
        return {}


def install_observatory() -> bool:
    """Boot-time wiring: the build listener. Idempotent; refuses entirely
    under ``FISCO_DEVICE_OBS=0``. (The JAX package also registers a
    ``device_mem`` watermark probe with its pipeline sampler; the port's
    does not yet.)"""
    if not device_obs_enabled():
        return False
    return install_build_hooks()


# ---------------------------------------------------------------------------
# The device document
# ---------------------------------------------------------------------------


def device_doc(tail: int = 64) -> dict:
    """Everything the device observatory knows, one JSON: the build ledger
    (nvcc build vs build-cache load), per-op phase totals, the first-shape
    counters, storm state, live CUDA bytes, and the plane's scheduler
    stats — the JAX ``GET /device`` document's keys. The watermark rings
    need the ``device_mem`` probe, which the port does not register yet:
    ``memory.watermarks`` is ``{}``, as the JAX document gives without it."""
    enabled = device_obs_enabled()
    doc: dict = {
        "enabled": enabled,
        "ts": time.time(),
        "epoch": TRACER.epoch,
        "ledger": LEDGER.snapshot() if enabled else [],
        "phase_ms": LEDGER.phase_totals() if enabled else {},
        "compile_counts": compile_counts(),
        "storm": LEDGER.storm_state() if enabled else {"active": False},
        "overhead_s": round(LEDGER.overhead_seconds(), 6),
        "dispatches": LEDGER.dispatches(tail) if enabled else [],
        "adjacency": LEDGER.adjacency() if enabled else {},
    }
    rows = doc["ledger"]
    doc["totals"] = {
        "cold_compiles": sum(e["cold_compiles"] for e in rows),
        "cache_hits": sum(e["cache_hits"] for e in rows),
        "compile_ms": round(sum(e["compile_ms"] for e in rows), 3),
    }
    if enabled:
        doc["memory"] = {"live_bytes": device_memory_bytes(), "watermarks": {}}
    else:
        doc["memory"] = {}
    try:
        from ..device.plane import get_plane, plane_enabled

        if plane_enabled():
            plane = get_plane()
            doc["plane"] = dict(plane.stats(), lanes=plane.lane_depths())
        else:
            doc["plane"] = {"enabled": False}
    except Exception:
        doc["plane"] = {}
    return doc


# ---------------------------------------------------------------------------
# device_span
# ---------------------------------------------------------------------------


class _NoopPhase:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_PHASE = _NoopPhase()


class _Phase:
    __slots__ = ("_span", "_name", "_t0")

    def __init__(self, span: "device_span", name: str):
        self._span = span
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._span._phases.append(
            (self._name, self._t0, time.perf_counter() - self._t0)
        )
        return False


class device_span:
    """Time one host-level device-batch call and emit the full signal set.

    ``shape_key`` is the bucketed shape of the batch (the batch bucket,
    plus any other shape-determining dims), as the JAX wrapper computes it;
    it defaults to ``bucket_batch(batch)``.

    ``queue_ms`` lets a caller that measured an upstream queue wait itself
    pre-load the queue segment (the DevicePlane does NOT use it — it
    records its queue segment directly at dispatch under its own op label);
    ``with span.phase("transfer"): ...`` marks host→card copies. Compile
    time comes from the ledger's measured build episodes during the span;
    execute is the remainder. An exception leaves the span unswallowed.
    """

    __slots__ = (
        "op", "batch", "key", "queue_ms", "_t0", "_span", "_phases",
        "_frame", "_obs_s",
    )

    def __init__(self, op: str, batch: int, shape_key=None,
                 queue_ms: float | None = None):
        self.op = op
        self.batch = int(batch)
        self.key = (
            shape_key if shape_key is not None
            else bucket_batch(max(int(batch), 1))
        )
        self.queue_ms = queue_ms
        self._phases: list[tuple[str, float, float]] = []
        self._frame: dict | None = None
        self._obs_s = 0.0  # this span's own observatory bookkeeping wall

    def phase(self, name: str):
        """Mark a sub-segment (e.g. ``transfer``) of this span's wall."""
        if self._frame is None:
            return _NOOP_PHASE
        return _Phase(self, name)

    def __enter__(self):
        reg = _metrics.REGISTRY
        if reg.enabled:
            reg.observe(
                "fisco_device_batch_size",
                self.batch,
                buckets=BATCH_BUCKETS,
                help="device-crypto batch sizes per op (power-of-two buckets)",
                op=self.op,
            )
            _count_shape(self.op, self.key)
        if device_obs_enabled():
            t_obs = time.perf_counter()
            self._frame = LEDGER.push(self.op, self.key, self.batch)
            self._obs_s += time.perf_counter() - t_obs
        else:
            self._frame = None
        self._span = TRACER.span(f"device.{self.op}", batch=self.batch)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self._t0
        self._span.__exit__(exc_type, exc, tb)
        if self._frame is not None:
            t_obs = time.perf_counter()
            LEDGER.pop()
            self._obs_s += time.perf_counter() - t_obs
        reg = _metrics.REGISTRY
        if reg.enabled and exc_type is None:
            reg.observe(
                "fisco_device_op_latency_ms",
                dt * 1e3,
                buckets=LATENCY_BUCKETS_MS,
                help="device-crypto host-call wall latency per op",
                op=self.op,
            )
            reg.counter_add(
                f'fisco_device_items_total{{op="{self.op}"}}',
                float(self.batch),
                help="items processed by device-crypto ops",
            )
            reg.counter_add(
                f'fisco_device_op_seconds_total{{op="{self.op}"}}',
                dt,
                help="wall seconds spent in device-crypto host calls",
            )
        if self._frame is not None:
            if exc_type is None:
                t_obs = time.perf_counter()
                self._emit_phases(dt)
                LEDGER.note_adjacency(self.op)
                self._obs_s += time.perf_counter() - t_obs
            LEDGER.add_overhead(self._obs_s)
        return False

    def _emit_phases(self, dt: float) -> None:
        total_ms = dt * 1e3
        compile_ms = self._frame["compile_ms"]
        # marked sub-segments aggregate under their OWN names (transfer is
        # the common one, but a wrapper may mark others) — the histogram
        # must agree with the trace child spans
        marked: dict[str, float] = {}
        for name, _t, d in self._phases:
            marked[name] = marked.get(name, 0.0) + d * 1e3
        execute_ms = max(
            total_ms - compile_ms - sum(marked.values()), 0.0
        )
        phases = dict(
            marked, compile=compile_ms, execute=execute_ms
        )
        if self.queue_ms is not None:
            phases["queue"] = float(self.queue_ms)
        reg = _metrics.REGISTRY
        if reg.enabled:
            for phase, ms in phases.items():
                if ms > 0.0 or phase == "execute":
                    reg.observe(
                        "fisco_device_phase_ms",
                        ms,
                        buckets=DEVICE_PHASE_BUCKETS_MS,
                        help="device-plane time attribution per op: "
                        "queue / compile / transfer / execute segments",
                        op=self.op,
                        phase=phase,
                    )
        LEDGER.note_phases(self.op, phases, t0=self._t0, dur=dt)
        # retroactive trace children: the dispatch timeline readable in the
        # Chrome trace (transfer segments keep their real timestamps; the
        # compile/execute splits anchor at the span start)
        ctx = getattr(self._span, "ctx", None)
        if ctx is not None and ctx.sampled:
            for name, t0, d in self._phases:
                TRACER.record(
                    f"device.{self.op}.{name}", t0=t0, dur=d, parent_ctx=ctx
                )
            if compile_ms > 0.0:
                TRACER.record(
                    f"device.{self.op}.compile",
                    t0=self._t0,
                    dur=compile_ms / 1e3,
                    parent_ctx=ctx,
                )
            TRACER.record(
                f"device.{self.op}.execute",
                t0=self._t0 + (compile_ms + sum(marked.values())) / 1e3,
                dur=execute_ms / 1e3,
                parent_ctx=ctx,
            )
