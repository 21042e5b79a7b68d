"""Metrics registry with Prometheus text exposition (the port's copy of the
JAX package's ``utils/metrics.py``, without ``bind_node_metrics``: the
node's gauges belong to the node, which is not in the port).

Reference: the reference exports node metrics by tailing METRIC log lines
with mtail into Prometheus (tools/BcosAirBuilder/build_chain.sh:891-946
generates the mtail config, including the 0/50/100/150 ms latency histograms
for block execution and commit at :920-935).  Here the same signals are
first-class: modules register counters/gauges/histograms, and
:meth:`MetricsRegistry.render` gives the Prometheus text a node's
``GET /metrics`` serves — no sidecar required.

Exposition follows format 0.0.4: ONE ``# HELP``/``# TYPE`` header per metric
family regardless of how many labeled samples it has, escaped help text, and
histogram families rendered as ``_bucket``/``_sum``/``_count``.
"""

from __future__ import annotations

import os
import threading
from typing import Callable

from ..observability.histogram import (
    LATENCY_BUCKETS_MS,
    Histogram,
    escape_help,
)


class MetricsRegistry:
    def __init__(self, enabled: bool = True):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, Callable[[], float] | float] = {}
        self._histograms: dict[str, Histogram] = {}
        self._help: dict[str, str] = {}
        # master switch (observability.set_enabled): when off, every write
        # is a cheap early return — the bench overhead A/B baseline
        self.enabled = enabled

    def counter_add(self, name: str, value: float = 1.0, help: str = "") -> None:
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value
            if help:
                self._help.setdefault(name.split("{")[0], help)

    def gauge_set(self, name: str, value: float, help: str = "") -> None:
        if not self.enabled:
            return
        with self._lock:
            self._gauges[name] = value
            if help:
                self._help.setdefault(name.split("{")[0], help)

    def gauge_fn(self, name: str, fn: Callable[[], float], help: str = "") -> None:
        """Register a pull-time gauge (evaluated at scrape)."""
        if not self.enabled:
            return
        with self._lock:
            self._gauges[name] = fn
            if help:
                self._help.setdefault(name.split("{")[0], help)

    # -- histograms ----------------------------------------------------------

    def histogram(
        self, name: str, buckets=LATENCY_BUCKETS_MS, help: str = ""
    ) -> Histogram:
        """Get-or-create the histogram family `name` (buckets/help only
        apply on first registration)."""
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, buckets, help)
            return h

    def observe(
        self,
        name: str,
        value: float,
        buckets=LATENCY_BUCKETS_MS,
        help: str = "",
        exemplar: str | None = None,
        **labels,
    ) -> None:
        """One-call histogram observation (labels as kwargs). ``exemplar``
        (a trace-id hex) ties this sample's bucket to a concrete trace in
        the OpenMetrics exemplar rendering."""
        if not self.enabled:
            return
        self.histogram(name, buckets, help).observe(
            value, labels or None, exemplar=exemplar
        )

    def counters_matching(self, base: str) -> dict[str, float]:
        """Snapshot of every counter series whose name starts with ``base``
        (full labeled name -> value) — programmatic artifact access (the
        scenario runner embeds isolation counters in its JSON)."""
        with self._lock:
            return {
                name: v
                for name, v in self._counters.items()
                if name.startswith(base)
            }

    # -- exposition ----------------------------------------------------------

    def render(self, openmetrics: bool = False) -> str:
        """Prometheus text exposition format 0.0.4 — each family's
        ``# HELP``/``# TYPE`` emitted exactly once, help text escaped.

        ``openmetrics=True`` renders the OpenMetrics variant: histogram
        exemplars included and a ``# EOF`` terminator — only served when
        the scraper negotiated ``application/openmetrics-text`` (the 0.0.4
        parser rejects exemplar suffixes)."""
        if self is globals().get("REGISTRY"):
            # pull the tracer's span-drop tallies in at scrape time so a
            # /metrics-only consumer still sees ring-evict/sampling drops
            try:
                from ..observability.tracer import TRACER

                TRACER.flush_drop_metrics()
            except Exception as e:
                from .log import note_swallowed

                note_swallowed("metrics.flush_drops", e)
        lines: list[str] = []
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = list(self._histograms.values())
            helps = dict(self._help)

        def emit_family(samples: dict[str, float], mtype: str) -> None:
            by_base: dict[str, list[str]] = {}
            for name in samples:
                by_base.setdefault(name.split("{")[0], []).append(name)
            for base in sorted(by_base):
                # OpenMetrics names the counter FAMILY without the _total
                # suffix (samples keep it); a strict parser rejects a TYPE
                # line whose name ends in _total
                family = base
                if (
                    openmetrics
                    and mtype == "counter"
                    and family.endswith("_total")
                ):
                    family = family[: -len("_total")]
                if base in helps:
                    lines.append(f"# HELP {family} {escape_help(helps[base])}")
                lines.append(f"# TYPE {family} {mtype}")
                for name in sorted(by_base[base]):
                    lines.append(f"{name} {samples[name]:g}")

        emit_family(counters, "counter")
        gauge_vals: dict[str, float] = {}
        for name, val in gauges.items():
            if callable(val):
                try:
                    val = float(val())
                except Exception as e:
                    # a broken pull-gauge drops its sample, not the scrape
                    from .log import note_swallowed

                    note_swallowed("metrics.gauge_eval", e)
                    continue
            gauge_vals[name] = val
        emit_family(gauge_vals, "gauge")
        for h in sorted(histograms, key=lambda h: h.name):
            h.render_into(lines, with_exemplars=openmetrics)
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"


# process-wide default registry (modules import and use directly);
# FISCO_TELEMETRY=0 starts it disabled (observability.set_enabled flips it)
REGISTRY = MetricsRegistry(enabled=os.environ.get("FISCO_TELEMETRY", "1") != "0")
