"""Labeled Prometheus histograms — the latency/batch-size metric model (the
port's copy of the JAX package's ``observability/histogram.py``).

Reference: the reference's ops deployment defines mtail latency histograms
over the node's METRIC log lines with buckets 0/50/100/150 ms for block
execution and block commit (tools/BcosAirBuilder/build_chain.sh:920-935);
:data:`LATENCY_BUCKETS_MS` reproduces exactly that bucket contract so a
dashboard built against the reference's exposition reads this repo's
`/metrics` unchanged. :data:`BATCH_BUCKETS` adds the power-of-two batch-size
axis the device-crypto plane needs (batch shapes are bucketed to powers of
two before launch — ops/hash_common._bucket — so the histogram edges
mirror the launched batch shapes).

Exposition follows Prometheus text format 0.0.4: per label set, cumulative
``<name>_bucket{le="..."}`` samples (upper-bound inclusive), a ``+Inf``
bucket equal to ``_count``, plus ``<name>_sum`` and ``<name>_count``.

Exemplars: ``observe(value, exemplar=trace_id_hex)`` remembers
the LAST exemplar per bucket and renders it in OpenMetrics exemplar syntax
(``... # {trace_id="<hex>"} <value> <unix_ts>``) so a p99 bucket points at
a concrete trace to pull from ``/trace/tx/<hash>``. Exemplars are only
legal in the ``application/openmetrics-text`` format — the classic 0.0.4
text parser rejects a mid-line ``#`` — so rendering them is opt-in
(``render_into(lines, with_exemplars=True)``): the HTTP endpoint emits
them only when the scraper negotiates OpenMetrics via the Accept header.
"""

from __future__ import annotations

import math
import threading
import time
from bisect import bisect_left

# the reference's mtail bucket contract for block execution/commit latency
LATENCY_BUCKETS_MS = (0.0, 50.0, 100.0, 150.0)
# power-of-two batch sizes: mirrors the bucketed device batch shapes
BATCH_BUCKETS = tuple(float(1 << i) for i in range(15))  # 1 .. 16384


def format_float(v: float) -> str:
    """Prometheus sample/`le` formatting: shortest form, ``+Inf`` for inf."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    return f"{v:g}"


def escape_help(text: str) -> str:
    """HELP line escaping per exposition format 0.0.4."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def escape_label_value(v: object) -> str:
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def render_labels(pairs: tuple[tuple[str, str], ...]) -> str:
    """``{k="v",...}`` or empty string for the unlabeled series."""
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in pairs)
    return "{" + inner + "}"


class _Child:
    """One label set's state: per-bin counts (bin i = first bucket >= value,
    last bin = overflow/+Inf-only), running sum and count."""

    __slots__ = ("bins", "sum", "count", "exemplars")

    def __init__(self, nbuckets: int):
        self.bins = [0] * (nbuckets + 1)
        self.sum = 0.0
        self.count = 0
        # bin index -> (exemplar label value, observed value, unix ts);
        # last-write-wins, rendered in OpenMetrics exemplar syntax
        self.exemplars: dict[int, tuple[str, float, float]] = {}


class Histogram:
    """Thread-safe histogram family with optional labels.

    ``observe(value, labels)`` buckets by upper-bound-inclusive semantics
    (a sample equal to a bucket edge lands in that bucket, matching
    Prometheus ``le``). Children are created lazily per label set.
    """

    def __init__(self, name: str, buckets=LATENCY_BUCKETS_MS, help: str = ""):
        if not buckets:
            raise ValueError("histogram needs at least one bucket")
        self.name = name
        self.help = help
        self.buckets = tuple(sorted({float(b) for b in buckets}))
        if self.buckets and self.buckets[-1] == math.inf:
            self.buckets = self.buckets[:-1]  # +Inf is implicit
        self._lock = threading.Lock()
        self._children: dict[tuple[tuple[str, str], ...], _Child] = {}

    def observe(
        self, value: float, labels: dict | None = None, exemplar: str | None = None
    ) -> None:
        value = float(value)
        key = (
            tuple(sorted((str(k), str(v)) for k, v in labels.items()))
            if labels
            else ()
        )
        idx = bisect_left(self.buckets, value)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _Child(len(self.buckets))
            child.bins[idx] += 1
            child.sum += value
            child.count += 1
            if exemplar:
                child.exemplars[idx] = (str(exemplar), value, time.time())

    def snapshot(self) -> dict:
        """{label_pairs: (cumulative bucket counts ..., sum, count)} — the
        cumulative counts align with self.buckets (no +Inf entry)."""
        out = {}
        with self._lock:
            for key, child in self._children.items():
                cum, total = [], 0
                for b in child.bins[:-1]:
                    total += b
                    cum.append(total)
                out[key] = (tuple(cum), child.sum, child.count)
        return out

    def render_into(self, lines: list[str], with_exemplars: bool = False) -> None:
        if self.help:
            lines.append(f"# HELP {self.name} {escape_help(self.help)}")
        lines.append(f"# TYPE {self.name} histogram")
        for key in sorted(self.snapshot_keys()):
            cum, total, count, exemplars = self._render_child(key)
            if not with_exemplars:
                exemplars = {}
            for i, (bound, c) in enumerate(zip(self.buckets, cum)):
                lbl = render_labels(key + (("le", format_float(bound)),))
                lines.append(
                    f"{self.name}_bucket{lbl} {c}{_exemplar_suffix(exemplars.get(i))}"
                )
            lbl = render_labels(key + (("le", "+Inf"),))
            lines.append(
                f"{self.name}_bucket{lbl} {count}"
                f"{_exemplar_suffix(exemplars.get(len(self.buckets)))}"
            )
            lines.append(f"{self.name}_sum{render_labels(key)} {total:g}")
            lines.append(f"{self.name}_count{render_labels(key)} {count}")

    # split helpers so render_into never holds the lock across formatting
    def snapshot_keys(self):
        with self._lock:
            return list(self._children)

    def _render_child(self, key):
        with self._lock:
            child = self._children.get(key)
            if child is None:
                return [], 0.0, 0, {}
            bins, total_sum, count = list(child.bins), child.sum, child.count
            exemplars = dict(child.exemplars)
        cum, total = [], 0
        for b in bins[:-1]:
            total += b
            cum.append(total)
        return cum, total_sum, count, exemplars


def _exemplar_suffix(ex: tuple[str, float, float] | None) -> str:
    """OpenMetrics exemplar rendering: `` # {trace_id="<v>"} value ts``."""
    if ex is None:
        return ""
    label, value, ts = ex
    return f' # {{trace_id="{escape_label_value(label)}"}} {value:g} {ts:.3f}'
