"""DevicePlane: the shared batch scheduler of every device crypto call (the
port of the JAX package's ``device/plane.py``, with its names).

Every batch seam of the port's suites and both admission entry points
submit to one process-wide plane (:func:`get_plane`) instead of launching
their own kernels: txpool admission, proposal verification, QC checks, tx
sync and proof-tree builds that wait together merge into one launch of each
kernel. A small call costs nearly a whole kernel on the card (a 4-lane
``batch_verify`` about what a block of 10,240 does), so k small calls
merged cost about one.

- **Per-op queues, future results.** A seam submits (op, payload, items,
  executor) and blocks on the returned ``concurrent.futures.Future``, so
  its API is unchanged. An op name carries the resolved device
  (``verify.secp256k1.cuda:0``, ``hash.keccak256.cpu``): the plane binds
  the first executor submitted under a name for good, so a CPU suite and a
  CUDA suite never share one.
- **Coalescing.** One worker thread dispatches an op's queue once its
  oldest request has waited the window (``FISCO_DEVICE_WINDOW_MS``) or its
  items reach the high-water mark (``FISCO_DEVICE_HIGH_WATER``, 4096).
  Requests that arrive while the worker is busy merge whatever the window.
- **Priority lanes.** consensus > admission > sync > proof among ready op
  queues (:func:`device_lane`); a queue whose oldest request has waited
  ``FISCO_DEVICE_STARVATION_MS`` (50) goes first, oldest first.
- **Group-fair selection.** Where a ready queue holds requests of more than
  one tenant group (:func:`device_group`), a dispatch is assembled by
  deficit-weighted round-robin across the groups within each lane
  (``FISCO_DEVICE_GROUP_QUANTUM`` items a round, times the group's
  ``FISCO_DEVICE_GROUP_WEIGHTS`` weight), capped at the high-water mark.
  A single-group queue merges whole.
- **Passthrough.** ``FISCO_DEVICE_PLANE=0``, read at every call, sends every
  seam down its direct path: no queue, no worker.

Executors run on the worker with a thread-local marker set, and
:func:`plane_route` is false there: an executor that calls a routed seam
(Ed25519's ``batch_recover`` calls ``batch_verify``) takes the direct path
instead of waiting on the worker it runs on. An executor calls the same
merged-batch body as the direct path, so the two give the same bytes. The
plane adds no fallback: an executor's exception reaches every future of its
dispatch.

Telemetry, as the JAX plane's: each submit counts
``fisco_device_plane_requests_total{op,lane}`` and keeps the caller's trace
context; each dispatch is a ``device.plane.dispatch`` span, parented to the
first sampled caller and linked to all of them, with the executor's
``device.<op>`` spans nested under it on the worker, and each sampled
caller gets a ``device.plane.wait`` record naming the dispatch's span. The
device observatory's ledger takes the dispatch's ``queue`` phase under the
plane op, its adjacency edge and its bookkeeping wall; the registry the
wait, phase, dispatch, coalesced, batch-items and occupancy metrics. The
process-wide plane registers the ``fisco_device_plane_queue_depth`` gauge.
The JAX plane's deferred counter counts the group-fair selection, which no
caller of the port reaches, and its pipeline-stage busy and blocked
accounting waits for the pipeline observatory, which the port does not
have.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable

import torch

from ..observability import BATCH_BUCKETS
from ..observability import tracer as _tracer
from ..observability.device import DEVICE_PHASE_BUCKETS_MS, LEDGER, device_obs_enabled
from ..ops.hash_common import bucket_batch
from ..utils import env_float
from ..utils import metrics as _metrics

# dispatch priority a lane, lower first: consensus is on the block time's
# critical path, admission feeds the next proposal, sync is gossip and proof
# the read path
LANES = {"consensus": 0, "admission": 1, "sync": 2, "proof": 3}
DEFAULT_LANE = "admission"

# The default window on a CUDA card, ms: 0. Measured by chip_smoke.py's plane
# phase on an NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md §5-§6):
# a timed wait of the worker sleeps at least ~1.1 ms on that host (asked for
# 0.25 ms, it took 1.16), so any window below that costs a lone QC check
# (0.9-1.1 ms direct) about 1.1 ms more, and concurrent callers merged as
# well at 0 as at 0.5 or 2 ms: they queue while the worker wakes or runs a
# dispatch.
CUDA_WINDOW_MS = 0.0

_tls = threading.local()

# wait-time buckets: a window is ~0-2 ms, starvation trips at ~50 ms, and
# anything past a few hundred ms means the plane is the bottleneck
WAIT_BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 1000.0)
OCCUPANCY_BUCKETS = (0.25, 0.5, 0.75, 0.9, 1.0)


def plane_enabled() -> bool:
    """The master switch, read at every call so passthrough can be turned on
    mid-process."""
    return os.environ.get("FISCO_DEVICE_PLANE", "1") != "0"


def in_plane_executor() -> bool:
    return bool(getattr(_tls, "in_exec", False))


def plane_route() -> bool:
    """True when a batch call should queue into the plane: the plane is on
    and this thread is not a plane executor (which would wait on itself)."""
    return plane_enabled() and not in_plane_executor()


def current_lane() -> str:
    return getattr(_tls, "lane", DEFAULT_LANE)


def current_group() -> str:
    """The tenant group this thread's device batches belong to; "" for
    none."""
    return getattr(_tls, "group", "")


@contextmanager
def device_group(name: str):
    """Tag this thread's device batch calls with their tenant group, the
    unit the plane's deficit round-robin arbitrates between."""
    prev = getattr(_tls, "group", "")
    _tls.group = name
    try:
        yield
    finally:
        _tls.group = prev


@contextmanager
def device_lane(name: str):
    """Tag this thread's device batch calls with a priority lane; untagged
    calls ride ``DEFAULT_LANE``."""
    prev = getattr(_tls, "lane", DEFAULT_LANE)
    _tls.lane = name
    try:
        yield
    finally:
        _tls.lane = prev


@dataclass
class PlaneRequest:
    """One queued batch: op name, op-specific payload, item count, lane,
    enqueue time, its future, the submitting caller's trace context (the
    dispatch span links back to it) and its tenant group."""

    op: str
    payload: object
    n: int
    lane: str
    t_enq: float
    future: Future
    ctx: object = None
    group: str = ""


class DevicePlane:
    """The coalescing scheduler. One process-wide instance (:func:`get_plane`)
    serves every seam; other instances exist in tests.

    An executor receives its op's request list and returns one result per
    request, in order; it runs on the worker with the executor marker set.
    """

    def __init__(
        self,
        window_ms: float | None = None,
        high_water: int | None = None,
        starvation_ms: float | None = None,
        autostart: bool = True,
    ):
        if window_ms is not None:
            self.window_ms = float(window_ms)
        elif os.environ.get("FISCO_DEVICE_WINDOW_MS"):
            self.window_ms = env_float("FISCO_DEVICE_WINDOW_MS", CUDA_WINDOW_MS)
        else:
            self.window_ms = self._default_window_ms()
        self.high_water = (
            int(env_float("FISCO_DEVICE_HIGH_WATER", 4096.0)) if high_water is None else int(high_water)
        )
        self.starvation_ms = (
            env_float("FISCO_DEVICE_STARVATION_MS", 50.0) if starvation_ms is None else float(starvation_ms)
        )
        # group-fair selection: items each group earns a DRR round, scaled by
        # its weight (FISCO_DEVICE_GROUP_WEIGHTS="g0=2,g1=1"); deficits persist
        # while a group has backlog and reset when it drains
        self.group_quantum = max(1, int(env_float("FISCO_DEVICE_GROUP_QUANTUM", 256.0)))
        self.group_weights: dict[str, float] = {}
        for part in os.environ.get("FISCO_DEVICE_GROUP_WEIGHTS", "").split(","):
            name, _, w = part.strip().partition("=")
            if name and w:
                try:
                    self.group_weights[name] = max(float(w), 1e-6)
                except ValueError:
                    pass
        self._deficit: dict[str, float] = {}
        self._drr_rotor = 0  # rotates the serving order across dispatches
        self._autostart = autostart
        self._cv = threading.Condition(threading.RLock())
        self._pending: dict[str, list[PlaneRequest]] = {}
        self._exec_fns: dict[str, Callable] = {}
        self._thread: threading.Thread | None = None
        self._busy = False
        # counters, mutated under _cv; stats() takes a snapshot
        self.requests = 0
        self.dispatches = 0
        self.merged_requests = 0  # requests that shared a dispatch with others
        self.items = 0
        self._wait_ms: deque[float] = deque(maxlen=4096)

    @staticmethod
    def _default_window_ms() -> float:
        """CUDA_WINDOW_MS with a CUDA card, 0 without one (the JAX default on
        a CPU backend): a plain batch on the CPU takes seconds, and an idle
        window would only delay every lone call."""
        return CUDA_WINDOW_MS if torch.cuda.is_available() else 0.0

    # -- submission ----------------------------------------------------------

    def submit(self, op: str, payload, n: int, exec_fn: Callable) -> Future:
        """Queue one batch under `op`; returns a Future of the executor's
        result for it. The caller's lane and group are taken here."""
        tracer = _tracer.TRACER
        req = PlaneRequest(
            op, payload, int(n), current_lane(), time.perf_counter(), Future(),
            ctx=tracer.current_context() if tracer.enabled else None, group=current_group(),
        )
        with self._cv:
            self._exec_fns.setdefault(op, exec_fn)
            self._pending.setdefault(op, []).append(req)
            self.requests += 1
            self.items += req.n
            if self._autostart:
                self._ensure_thread_locked()
            self._cv.notify_all()
        _metrics.REGISTRY.counter_add(
            f'fisco_device_plane_requests_total{{op="{op}",lane="{req.lane}"}}',
            1.0,
            help="batches submitted to the device plane by op and lane",
        )
        return req.future

    # -- scheduler -----------------------------------------------------------

    def _ensure_thread_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, name="device-plane", daemon=True)
            self._thread.start()

    def _group_ready(self, reqs: list[PlaneRequest], now: float) -> bool:
        age_ms = (now - reqs[0].t_enq) * 1e3
        return age_ms >= self.window_ms or sum(r.n for r in reqs) >= self.high_water

    def _pick_ready_locked(self, now: float):
        """Pop the ready op queue with the best claim, or None.

        Ready: the window has passed since the queue's oldest request, or
        its items reach high water. Among ready queues, starved ones (oldest
        request past starvation_ms) first, oldest first; then the best lane
        present; ties to the oldest. Returns ``(op, taken, deferred)``:
        :meth:`_select_fair` trims a multi-group queue, and what it defers
        goes back to the front of the op's queue, enqueue times intact."""
        best_op = None
        best_key = None
        for op, reqs in self._pending.items():
            if not reqs or not self._group_ready(reqs, now):
                continue
            age_ms = (now - reqs[0].t_enq) * 1e3
            if age_ms >= self.starvation_ms:
                key = (0, -age_ms, reqs[0].t_enq)
            else:
                key = (1, min(LANES.get(r.lane, 1) for r in reqs), reqs[0].t_enq)
            if best_key is None or key < best_key:
                best_key, best_op = key, op
        if best_op is None:
            return None
        taken, deferred = self._select_fair(self._pending.pop(best_op))
        if deferred:
            self._pending[best_op] = deferred
        return best_op, taken, deferred

    def _weight(self, group: str) -> float:
        return self.group_weights.get(group, 1.0)

    def _select_fair(self, reqs: list[PlaneRequest]):
        """Deficit-weighted round-robin across tenant groups within each
        lane: one dispatch of at most ``high_water`` items (a single larger
        request still goes whole: requests are indivisible), the rest left
        queued. A single-group queue merges whole. Returns ``(taken,
        deferred)``, FIFO within each (lane, group); ``taken`` is never
        empty."""
        all_groups = {r.group for r in reqs}
        if len(all_groups) <= 1:
            return reqs, []
        cap = self.high_water
        # a quantum scaled so one round across the groups about fills the
        # cap: a quantum >= cap would let the first group served spend the
        # whole dispatch
        base_q = max(1, min(self.group_quantum, cap // len(all_groups)))
        by_lane: dict[int, dict[str, deque]] = {}
        for r in reqs:
            by_lane.setdefault(LANES.get(r.lane, 1), {}).setdefault(r.group, deque()).append(r)
        taken: list[PlaneRequest] = []
        taken_ids: set[int] = set()
        total = 0
        rotor = self._drr_rotor
        self._drr_rotor += 1
        for rank in sorted(by_lane):
            queues = by_lane[rank]
            order = list(queues)
            start = rotor % len(order)  # no group is first every time
            order = order[start:] + order[:start]
            while total < cap and any(queues.values()):
                # one round: every backlogged group earns a quantum, then
                # spends its deficit on its oldest requests
                for g in order:
                    q = queues[g]
                    if not q:
                        continue
                    self._deficit[g] = self._deficit.get(g, 0.0) + base_q * self._weight(g)
                    while q and total < cap and self._deficit[g] >= q[0].n:
                        r = q.popleft()
                        self._deficit[g] -= r.n
                        taken.append(r)
                        taken_ids.add(id(r))
                        total += r.n
                    if total >= cap:
                        break
            if total >= cap:
                break
        deferred = [r for r in reqs if id(r) not in taken_ids]
        # a group that drained its backlog forfeits its credit
        still_backlogged = {r.group for r in deferred}
        for g in all_groups - still_backlogged:
            self._deficit.pop(g, None)
        return taken, deferred

    def _next_timeout_s(self, now: float) -> float | None:
        """Seconds until the earliest queue becomes window-ready; None when
        nothing is queued (sleep until notified)."""
        deadlines = [reqs[0].t_enq + self.window_ms / 1e3 for reqs in self._pending.values() if reqs]
        if not deadlines:
            return None
        return max(min(deadlines) - now, 0.0)

    def _run(self) -> None:
        while True:
            with self._cv:
                picked = None
                while picked is None:
                    picked = self._pick_ready_locked(time.perf_counter())
                    if picked is None:
                        self._cv.wait(self._next_timeout_s(time.perf_counter()))
                op, reqs, _deferred = picked
                self._busy = True
            try:
                self._dispatch(op, reqs)
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def _dispatch(self, op: str, reqs: list[PlaneRequest]) -> None:
        # once popped, the requests' futures live only here: every failure
        # must resolve them, or a caller blocked in result() waits forever
        try:
            # the merged-batch span: parented to the first sampled caller,
            # linked to every sampled caller it merged; entered on this
            # thread, it hands its context to the executor, whose
            # device.<op> spans nest under it
            ctxs = [r.ctx for r in reqs if r.ctx is not None and r.ctx.sampled]
            span = _tracer.TRACER.span(
                "device.plane.dispatch",
                parent=ctxs[0] if ctxs else None,
                links=ctxs,
                op=op,
                requests=len(reqs),
                items=sum(r.n for r in reqs),
            )
            with span:
                self._record_dispatch(op, reqs, getattr(span, "ctx", None))
                _tls.in_exec = True
                try:
                    results = self._exec_fns[op](reqs)
                finally:
                    _tls.in_exec = False
            if len(results) != len(reqs):
                raise RuntimeError(f"plane executor for {op} returned {len(results)} results for {len(reqs)} requests")
            for r, res in zip(reqs, results):
                r.future.set_result(res)
        except BaseException as e:  # noqa: BLE001 - no future may be left unresolved
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)

    def _record_dispatch(self, op: str, reqs: list[PlaneRequest], batch_ctx=None) -> None:
        now = time.perf_counter()
        total = sum(r.n for r in reqs)
        with self._cv:
            self.dispatches += 1
            if len(reqs) > 1:
                self.merged_requests += len(reqs)
            for r in reqs:
                self._wait_ms.append((now - r.t_enq) * 1e3)
        if batch_ctx is not None:
            # each sampled caller's trace gets its queue wait, naming the
            # dispatch's span (the fan-in edge, readable from either end)
            for r in reqs:
                if r.ctx is not None and r.ctx.sampled:
                    _tracer.TRACER.record(
                        "device.plane.wait",
                        t0=r.t_enq,
                        dur=now - r.t_enq,
                        parent_ctx=r.ctx,
                        op=op,
                        lane=r.lane,
                        batch_span=f"{batch_ctx.span_id:016x}",
                    )
        # the ledger rides FISCO_DEVICE_OBS alone (it keeps working with the
        # registry off): the queue segment under the plane's op, the
        # dispatch edge, the bookkeeping wall
        obs = device_obs_enabled()
        if obs:
            t_obs = time.perf_counter()
            LEDGER.note_phases(op, {"queue": sum((now - r.t_enq) * 1e3 for r in reqs)})
            LEDGER.note_adjacency(op)
            LEDGER.add_overhead(time.perf_counter() - t_obs)
        reg = _metrics.REGISTRY
        if not reg.enabled:
            return
        for r in reqs:
            wait_ms = (now - r.t_enq) * 1e3
            reg.observe(
                "fisco_device_plane_wait_ms",
                wait_ms,
                buckets=WAIT_BUCKETS_MS,
                help="queue wait from submit to dispatch, per lane",
                lane=r.lane,
            )
            if obs:
                reg.observe(
                    "fisco_device_phase_ms",
                    wait_ms,
                    buckets=DEVICE_PHASE_BUCKETS_MS,
                    help="device-plane time attribution per op: "
                    "queue / compile / transfer / execute segments",
                    op=op,
                    phase="queue",
                )
        reg.counter_add(
            f'fisco_device_plane_dispatch_total{{op="{op}"}}',
            1.0,
            help="merged device dispatches by op (requests/dispatches = "
            "coalesce ratio)",
        )
        if len(reqs) > 1:
            reg.counter_add(
                f'fisco_device_plane_coalesced_total{{op="{op}"}}',
                float(len(reqs)),
                help="requests that shared a merged dispatch with others",
            )
        reg.observe(
            "fisco_device_plane_batch_items",
            total,
            buckets=BATCH_BUCKETS,
            help="merged batch sizes dispatched by the plane",
            op=op,
        )
        bucket = bucket_batch(max(total, 1))
        reg.observe(
            "fisco_device_plane_bucket_occupancy",
            total / bucket if bucket else 0.0,
            buckets=OCCUPANCY_BUCKETS,
            help="real rows / bucket-padded rows per dispatch (batch dim"
            " only; pad waste = 1 - occupancy)",
            op=op,
        )

    # -- introspection -------------------------------------------------------

    def _depth(self) -> int:
        with self._cv:
            return sum(sum(r.n for r in reqs) for reqs in self._pending.values())

    def lane_depths(self) -> dict[str, int]:
        """Queued items by priority lane."""
        with self._cv:
            out: dict[str, int] = {}
            for reqs in self._pending.values():
                for r in reqs:
                    out[r.lane] = out.get(r.lane, 0) + r.n
        for lane in LANES:
            out.setdefault(lane, 0)
        return out

    def coalesce_ratio(self) -> float:
        """Requests per dispatch (>= 1.0; 1.0: nothing merged)."""
        with self._cv:
            return self.requests / self.dispatches if self.dispatches else 1.0

    def wait_p99_ms(self) -> float:
        with self._cv:
            waits = sorted(self._wait_ms)
        if not waits:
            return 0.0
        return waits[min(len(waits) - 1, int(0.99 * len(waits)))]

    def stats(self) -> dict:
        with self._cv:
            return {
                "requests": self.requests,
                "dispatches": self.dispatches,
                "merged_requests": self.merged_requests,
                "items": self.items,
                "queue_depth": self._depth(),
            }

    def drain(self, timeout: float = 60.0) -> bool:
        """Block until nothing is queued and no dispatch is in flight; False
        on timeout."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while any(self._pending.values()) or self._busy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(min(remaining, 0.05))
        return True

    def _register_gauges(self) -> None:
        """Register the queue-depth gauge. For the process-wide plane only
        (get_plane): the registry holds the closure and the last
        registration wins, so a throwaway instance would take the metric
        over and stay alive."""
        _metrics.REGISTRY.gauge_fn(
            "fisco_device_plane_queue_depth",
            lambda: float(self._depth()),
            help="items currently queued in the device plane",
        )


def plane_wait(fut: Future):
    """The result of a plane future (the seams' one blocking point)."""
    return fut.result()


def plane_wait_deferred(fut: Future):
    """:func:`plane_wait` for a hash future, whose result is a resolver:
    both the queue wait and the download."""
    return fut.result()()


_PLANE: DevicePlane | None = None
_PLANE_LOCK = threading.Lock()


def get_plane() -> DevicePlane:
    """The process-wide plane every seam shares (coalescing across callers
    is its point)."""
    global _PLANE
    if _PLANE is None:
        with _PLANE_LOCK:
            if _PLANE is None:
                _PLANE = DevicePlane()
                _PLANE._register_gauges()
    return _PLANE
