"""Span tracing with real trace semantics: 128-bit traces, explicit span
ids, cross-process propagation, span links (the port's copy of the JAX
package's ``observability/tracer.py``).

Reference: the reference's per-stage BlockTrace logs (DMCExecute.0..6 in
bcos-scheduler BlockExecutive.cpp:849-1010) answer "where did this block's
wall time go?" by grepping; here the same stages are first-class spans in a
bounded in-memory ring, exported as Chrome trace-event JSON (the format
Perfetto / chrome://tracing load directly) from ``GET /trace`` next to
``/metrics``.

Trace model:

- Every span belongs to a **trace** (128-bit ``trace_id``) and has its own
  64-bit ``span_id`` plus an explicit ``parent_id`` — name-based parentage
  is kept only as a display label (the same stage running concurrently is
  no longer ambiguous).
- The current :class:`TraceContext` propagates **in-process** through a
  ``contextvars.ContextVar``, so nesting works across module boundaries and
  survives explicit hand-offs into worker threads (``Tracer.attach``).
- **Across processes** the context rides a W3C-traceparent-style field
  (``00-<trace_id:32x>-<span_id:16x>-<flags:2x>``), which a service-RPC
  frame carries between processes.
- A span may carry **links** — (trace_id, span_id) references to spans in
  *other* traces. The device-plane coalescer uses them: one merged-batch
  span links every caller span it absorbed, so N transactions visibly
  converge into one kernel launch and fan back out.
- **Head-based sampling**: ``FISCO_TRACE_SAMPLE`` (0.0–1.0, default 1.0)
  decides per root span; the decision propagates with the context (children
  and remote callees honor it). Skipped spans and ring evictions are
  counted (``fisco_trace_spans_dropped_total{reason}``) so a truncated
  trace is distinguishable from a fast one.

Completed spans from other timelines (e.g. PBFT phase gaps measured between
message arrivals) are added retroactively via :meth:`Tracer.record`, with
an explicit ``parent_ctx`` placing them in the right trace.
"""

from __future__ import annotations

import contextvars
import json
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field

# the current trace context: None outside any span. Survives everything
# that runs on the same thread/context; worker threads start empty and are
# re-attached explicitly (Tracer.attach) at each hand-off seam.
_CURRENT: contextvars.ContextVar["TraceContext | None"] = contextvars.ContextVar(
    "fisco_trace_ctx", default=None
)


@dataclass(frozen=True)
class TraceContext:
    """The propagatable identity of one span: which trace, which span.

    ``name``/``depth`` are local display conveniences (never on the wire);
    ``sampled`` carries the head-based sampling decision downstream."""

    trace_id: int  # 128-bit
    span_id: int  # 64-bit
    sampled: bool = True
    name: str = ""
    depth: int = 0

    def traceparent(self) -> str:
        """W3C trace-context ``traceparent`` form (version 00)."""
        flags = 1 if self.sampled else 0
        return f"00-{self.trace_id:032x}-{self.span_id:016x}-{flags:02x}"

    @classmethod
    def from_traceparent(cls, header: str) -> "TraceContext | None":
        """Parse a traceparent field; None on anything malformed (a bad
        header must never break the RPC that carried it)."""
        try:
            _ver, tid, sid, flags = header.strip().split("-")
            if len(tid) != 32 or len(sid) != 16:
                return None
            return cls(
                int(tid, 16), int(sid, 16), bool(int(flags, 16) & 1), "remote", 0
            )
        except (ValueError, AttributeError):
            return None


def current_context() -> TraceContext | None:
    """The ambient trace context of this thread/context, if any."""
    return _CURRENT.get()


def trace_hex(ctx: TraceContext | None) -> str | None:
    """The 32-hex trace id of a context (None-safe): the exemplar label of a
    histogram observation. Unsampled contexts give None too: their spans
    were all dropped."""
    return f"{ctx.trace_id:032x}" if ctx is not None and ctx.sampled else None


@dataclass
class SpanRecord:
    name: str
    ts: float  # perf_counter at span start (seconds)
    dur: float  # seconds
    tid: int
    depth: int = 0
    parent: str | None = None  # display label only; parent_id is the truth
    attrs: dict = field(default_factory=dict)
    trace_id: int = 0
    span_id: int = 0
    parent_id: int | None = None
    links: tuple = ()  # ((trace_id, span_id), ...)


class _NoopSpan:
    """Shared do-nothing span for a disabled/unsampled tracer.

    Contract: ``attrs`` hands out a fresh throwaway dict per access, so two
    item assignments (``sp.attrs["k"] = v; sp.attrs["j"] = w``) land in two
    different dicts and BOTH are discarded — callers must use
    :meth:`set` (``sp.set(k=v, j=w)``), which real spans implement by
    updating their one attrs dict and this class implements as a no-op."""

    __slots__ = ()

    ctx = None

    @property
    def attrs(self) -> dict:
        return {}

    def set(self, **kv) -> "_NoopSpan":
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = (
        "_tracer", "name", "attrs", "_t0", "depth", "parent",
        "ctx", "_parent_ctx", "links", "_token",
    )

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        attrs: dict,
        parent_ctx: TraceContext | None,
        links: tuple = (),
    ):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._parent_ctx = parent_ctx
        self.links = tuple(links)

    def set(self, **kv) -> "_Span":
        """Attach attributes (the only supported mutation API — item
        assignment on ``attrs`` silently vanishes on a disabled tracer)."""
        self.attrs.update(kv)
        return self

    def __enter__(self):
        tr = self._tracer
        pctx = self._parent_ctx
        if pctx is None:
            pctx = _CURRENT.get()
        if pctx is None:
            self.ctx = tr._new_root(self.name)
        else:
            self.ctx = TraceContext(
                pctx.trace_id,
                tr._new_span_id(),
                pctx.sampled,
                self.name,
                pctx.depth + 1,
            )
        self._parent_ctx = pctx
        self.parent = pctx.name or None if pctx is not None else None
        self.depth = self.ctx.depth
        self._token = _CURRENT.set(self.ctx)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        _CURRENT.reset(self._token)
        self._tracer.record(
            self.name,
            t0=self._t0,
            dur=dur,
            depth=self.depth,
            parent=self.parent,
            ctx=self.ctx,
            parent_ctx=self._parent_ctx,
            links=self.links,
            **self.attrs,
        )
        return False


class Tracer:
    """Bounded ring of completed spans; thread-safe, cheap when disabled."""

    def __init__(
        self,
        capacity: int = 8192,
        enabled: bool = True,
        sample_rate: float | None = None,
    ):
        self.capacity = int(capacity)
        self.enabled = enabled
        if sample_rate is None:
            try:
                sample_rate = float(os.environ.get("FISCO_TRACE_SAMPLE", "1") or "1")
            except ValueError:
                sample_rate = 1.0
        self.sample_rate = sample_rate
        self._buf: deque[SpanRecord] = deque()
        self._lock = threading.Lock()
        self._tls = threading.local()
        # drop accounting: plain ints (GIL-cheap on the hot path), mirrored
        # into the metrics registry lazily (flush_drop_metrics)
        self._dropped = {"sampled": 0, "ring_evict": 0}
        self._dropped_pushed = {"sampled": 0, "ring_evict": 0}
        # wall-clock anchor: rec.ts (perf_counter) + epoch ≈ time.time() at
        # span start — what cross-process stitching orders by
        self.epoch = time.time() - time.perf_counter()

    # -- ids / sampling -------------------------------------------------------

    def _rng(self) -> random.Random:
        rng = getattr(self._tls, "rng", None)
        if rng is None:
            rng = self._tls.rng = random.Random(
                int.from_bytes(os.urandom(16), "big")
                ^ threading.get_ident()
            )
        return rng

    def _new_span_id(self) -> int:
        return self._rng().getrandbits(64) or 1

    def _sample(self) -> bool:
        rate = self.sample_rate
        if rate >= 1.0:
            return True
        if rate <= 0.0:
            return False
        return self._rng().random() < rate

    def _new_root(self, name: str = "") -> TraceContext:
        rng = self._rng()
        return TraceContext(
            rng.getrandbits(128) or 1, rng.getrandbits(64) or 1,
            self._sample(), name, 0,
        )

    def new_root_context(self, name: str = "") -> TraceContext | None:
        """An explicit root context (e.g. one per in-flight block) that
        retroactive records and attach() can hang spans onto."""
        if not self.enabled:
            return None
        return self._new_root(name)

    def current_context(self) -> TraceContext | None:
        return _CURRENT.get()

    def current_traceparent(self) -> str:
        """The injectable wire form of the ambient context ('' when absent
        or the tracer is disabled) — what service-RPC clients send."""
        if not self.enabled:
            return ""
        ctx = _CURRENT.get()
        return ctx.traceparent() if ctx is not None else ""

    def attach(self, ctx: TraceContext | None):
        """Context manager installing ``ctx`` as the ambient context — the
        hand-off seam for worker threads and extracted remote contexts.
        ``attach(None)`` is a no-op (callers never need to branch)."""
        return _Attach(ctx)

    def _drop(self, reason: str) -> None:
        # benign-race int bump: a lost increment under contention is noise,
        # a lock here would tax every sampled-out span
        # analysis: allow(guarded-state, deliberate lock-free fast path)
        self._dropped[reason] = self._dropped.get(reason, 0) + 1

    def drop_counts(self) -> dict:
        return dict(self._dropped)

    def flush_drop_metrics(self) -> None:
        """Push drop-count deltas into the process registry as
        ``fisco_trace_spans_dropped_total{reason=...}`` counters. Called on
        every export so a scrape after /trace sees current numbers; cheap
        enough to call ad hoc."""
        try:
            from ..utils.metrics import REGISTRY
        except Exception:  # pragma: no cover - partial-import window
            return
        # the flush path is cold (scrape/export time): take the ring lock so
        # two concurrent scrapes can't both claim the same delta
        deltas = []
        with self._lock:
            for reason, n in self._dropped.items():
                delta = n - self._dropped_pushed.get(reason, 0)
                if delta > 0:
                    self._dropped_pushed[reason] = n
                    deltas.append((reason, delta))
        for reason, delta in deltas:
            REGISTRY.counter_add(
                f'fisco_trace_spans_dropped_total{{reason="{reason}"}}',
                float(delta),
                help="spans not recorded, by reason (sampled = head "
                "sampling, ring_evict = ring overwrote them)",
            )

    # -- span creation --------------------------------------------------------

    def span(
        self,
        name: str,
        parent: TraceContext | None = None,
        links: tuple = (),
        **attrs,
    ):
        """Context manager timing a region; yields the span so callers can
        add attrs (``sp.set(txs=n)``) before it closes. ``parent`` overrides
        the ambient context (cross-thread/remote parents); ``links`` are
        (trace_id, span_id) pairs or TraceContexts from OTHER traces."""
        if not self.enabled:
            return _NOOP
        pctx = parent if parent is not None else _CURRENT.get()
        if pctx is not None and not pctx.sampled:
            # unsampled trace: skip the span but keep the ambient decision
            self._drop("sampled")
            return _NOOP
        if pctx is None and self.sample_rate <= 0.0:
            # fast path: nothing upstream and sampling is off — no root
            self._drop("sampled")
            return _NOOP
        if links:
            links = tuple(
                (l.trace_id, l.span_id) if isinstance(l, TraceContext) else tuple(l)
                for l in links
            )
        return _Span(self, name, attrs, parent, links)

    def record(
        self,
        name: str,
        t0: float,
        dur: float,
        depth: int = 0,
        parent: str | None = None,
        ctx: TraceContext | None = None,
        parent_ctx: TraceContext | None = None,
        links: tuple = (),
        **attrs,
    ) -> TraceContext | None:
        """Append a COMPLETED span with explicit timing — the retroactive
        path for phase gaps measured between events (PBFT quorum waits,
        pool-wait). ``parent_ctx`` places it in a trace; without one the
        ambient context applies, else it becomes a sampled-on-its-own root.
        Returns the recorded span's context (None when dropped)."""
        if not self.enabled:
            return None
        if ctx is None:
            base = parent_ctx if parent_ctx is not None else _CURRENT.get()
            if base is not None:
                if not base.sampled:
                    self._drop("sampled")
                    return None
                ctx = TraceContext(
                    base.trace_id, self._new_span_id(), True, name, base.depth + 1
                )
                parent_ctx = base
            else:
                ctx = self._new_root(name)
                if not ctx.sampled:
                    self._drop("sampled")
                    return None
        elif not ctx.sampled:
            self._drop("sampled")
            return None
        if parent is None and parent_ctx is not None:
            parent = parent_ctx.name or None
        if not depth:
            depth = ctx.depth
        if links:
            links = tuple(
                (l.trace_id, l.span_id) if isinstance(l, TraceContext) else tuple(l)
                for l in links
            )
        rec = SpanRecord(
            name,
            t0,
            max(dur, 0.0),
            threading.get_ident(),
            depth,
            parent,
            attrs,
            trace_id=ctx.trace_id,
            span_id=ctx.span_id,
            parent_id=parent_ctx.span_id if parent_ctx is not None else None,
            links=links,
        )
        if self.capacity <= 0:
            # FISCO_TRACE_CAPACITY=0: keep nothing, count everything
            self._drop("ring_evict")
            return ctx
        with self._lock:
            if len(self._buf) >= self.capacity:
                self._buf.popleft()
                self._dropped["ring_evict"] += 1
            self._buf.append(rec)
        return ctx

    def spans(self) -> list[SpanRecord]:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    # -- export ---------------------------------------------------------------

    def export_chrome(self) -> dict:
        """Chrome trace-event JSON object (Perfetto/chrome://tracing load it
        directly): complete ("X") events, timestamps in microseconds. Real
        ids ride in args (``trace_id``/``span_id``/``parent_id`` hex);
        ``parent`` stays as the display label only."""
        self.flush_drop_metrics()
        pid = os.getpid()
        events = []
        for rec in self.spans():
            args = {k: v for k, v in rec.attrs.items()}
            if rec.parent is not None:
                args["parent"] = rec.parent
            args["trace_id"] = f"{rec.trace_id:032x}"
            args["span_id"] = f"{rec.span_id:016x}"
            if rec.parent_id is not None:
                args["parent_id"] = f"{rec.parent_id:016x}"
            if rec.links:
                args["links"] = [
                    f"{t:032x}:{s:016x}" for t, s in rec.links
                ]
            events.append(
                {
                    "ph": "X",
                    "name": rec.name,
                    "cat": "fisco",
                    "pid": pid,
                    "tid": rec.tid,
                    "ts": round(rec.ts * 1e6, 3),
                    "dur": round(rec.dur * 1e6, 3),
                    "args": args,
                }
            )
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            # perf_counter -> wall clock anchor for cross-process stitching
            "epoch": self.epoch,
        }

    def export_json(self) -> str:
        return json.dumps(self.export_chrome(), default=str)


class _Attach:
    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: TraceContext | None):
        self._ctx = ctx

    def __enter__(self):
        self._token = _CURRENT.set(self._ctx) if self._ctx is not None else None
        return self._ctx

    def __exit__(self, *exc):
        if self._token is not None:
            _CURRENT.reset(self._token)
        return False


# process-wide default tracer (modules import and use directly, like
# utils.metrics.REGISTRY); FISCO_TELEMETRY=0 starts it disabled
TRACER = Tracer(
    capacity=int(os.environ.get("FISCO_TRACE_CAPACITY", "8192")),
    enabled=os.environ.get("FISCO_TELEMETRY", "1") != "0",
)
