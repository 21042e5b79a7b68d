"""Observability of the port: labeled histograms, span tracing, device-op
instrumentation (the port of the JAX package's ``observability`` pieces
that its device plane feeds).

- :mod:`.histogram` — the Prometheus histogram model (``_bucket``/``_sum``/
  ``_count`` exposition) with the reference's 0/50/100/150 ms mtail latency
  buckets and power-of-two batch buckets. ``utils.metrics.MetricsRegistry``
  composes it; modules observe through the process ``REGISTRY``.
- :mod:`.tracer` — thread-safe span tracing (``TRACER.span(...)`` context
  managers, nesting, bounded ring, 128-bit trace ids, traceparent
  propagation, span links, head sampling) exported as Chrome trace-event
  JSON (``TRACER.export_chrome()``).
- :mod:`.device` — the device observatory: per-op batch/latency/items
  metrics, the build ledger (a library built by nvcc vs loaded from the
  build cache, fed by ``ops/_kernels.py``'s build listeners), queue /
  compile / transfer / execute phase attribution, live CUDA bytes and the
  recompile-storm state, one document from ``device_doc()``. Imported
  directly as ``from ..observability.device import device_span`` by the
  host entry points (kept out of this namespace so importing the package
  never drags in the metrics registry mid-import); ``FISCO_DEVICE_OBS=0``
  noops the observatory layer independently.

``set_enabled(False)`` (or env ``FISCO_TELEMETRY=0`` before import) turns
the registry and the tracer into no-ops — the switch an overhead A/B uses.
"""

from __future__ import annotations

from .histogram import (  # noqa: F401
    BATCH_BUCKETS,
    LATENCY_BUCKETS_MS,
    Histogram,
)
from .tracer import (  # noqa: F401
    TRACER,
    SpanRecord,
    TraceContext,
    Tracer,
    current_context,
)


def set_enabled(flag: bool) -> None:
    """Enable/disable the whole telemetry layer (registry + tracer)."""
    from ..utils.metrics import REGISTRY

    REGISTRY.enabled = bool(flag)
    TRACER.enabled = bool(flag)


def telemetry_enabled() -> bool:
    from ..utils.metrics import REGISTRY

    return REGISTRY.enabled or TRACER.enabled
