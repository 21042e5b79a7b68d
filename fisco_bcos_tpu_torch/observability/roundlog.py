"""Consensus round forensics — the per-node round ledger and the cross-node
aligner.

Every observability layer so far is per-process; the committee questions —
"which replica is the straggler in round 4817", "how long did the prepare
quorum actually take *across* the fleet" — need per (height, view) timing
recorded at every replica and aligned afterwards. That is exactly the data
ByzCoin-style committee scaling (1602.06997) and the per-phase committee
vote cost model (2302.00418) are built on, and what the PBFT engine used to
throw away after observing its per-process latency histograms.

Two pieces:

- :class:`RoundLedger` — a bounded per-node ledger the PBFT engine drives:
  monotonic timestamps for pre-prepare receipt, own prepare/commit vote
  send, each signer's vote arrival (by committee index), execute start/end,
  the three quorums and the durable commit, plus view-change records with
  cause attribution. Notes are one dict write under a private lock — cheap
  enough for the engine's message path — and quorum notes emit the round
  metrics (``fisco_round_phase_ms{phase}``, ``fisco_vote_arrival_spread_ms``)
  on named bucket constants.
- The **aligner** (:func:`align_rounds` / :func:`round_doc` /
  :func:`rounds_doc`) — merges ledger snapshots from many nodes, corrects
  each node's monotonic clock by an exchanged-probe offset
  (:mod:`.fleet` measures them), computes per-phase spans, inter-node
  skew per round, and names the straggler signer (largest median vote
  lateness behind the first arrival, the 2302.00418 first-to-last spread).

``FISCO_FLEET_OBS=0`` turns the ledger into :data:`NOOP_LEDGER` — every
note is one attribute call on a shared do-nothing object (the bench
overhead A/B switch, same pattern as ``FISCO_PIPELINE_OBS``).
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque

from ..utils.metrics import REGISTRY

# round phases: sub-ms vote hops on the in-proc mesh up to multi-second
# execute/commit spans on real chains under load
ROUND_PHASE_BUCKETS_MS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 1000.0, 5000.0,
)
# inter-node skew and intra-quorum vote spread: healthy committees sit in
# the sub-ms..tens-of-ms band; a straggler pushes into the tail buckets
ROUND_SKEW_BUCKETS_MS = (
    0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 500.0,
)
VOTE_SPREAD_BUCKETS_MS = ROUND_SKEW_BUCKETS_MS

ROUND_CAP = 256  # rounds retained per ledger
VIEW_CHANGE_CAP = 128

# the quorum event each phase span ends at, and the event it starts from —
# the aligner and the note-time metric emission share this one table
PHASE_EDGES: tuple[tuple[str, str, str], ...] = (
    ("prepare", "pre_prepare", "prepared"),
    ("commit", "prepared", "committed"),
    ("execute", "execute_start", "execute_end"),
    ("checkpoint", "committed", "stable"),
    ("durable", "stable", "durable"),
)

# quorum event -> vote kind whose arrival spread it closes
_QUORUM_VOTES = {"prepared": "prepare", "committed": "commit", "stable": "checkpoint"}


def fleet_obs_enabled() -> bool:
    return os.environ.get("FISCO_FLEET_OBS", "1") != "0"


class RoundRecord:
    """One (height, view) round at one node. Mutated only under the owning
    ledger's lock; ``to_doc`` copies under it."""

    __slots__ = ("height", "view", "events", "votes")

    def __init__(self, height: int, view: int):
        self.height = height
        self.view = view
        # event -> monotonic t, first occurrence wins (re-delivered frames
        # must not move a quorum edge)
        self.events: dict[str, float] = {}
        # vote kind -> committee index (str: survives JSON) -> arrival t
        self.votes: dict[str, dict[str, float]] = {}

    def to_doc(self) -> dict:
        return {
            "height": self.height,
            "view": self.view,
            "events": dict(self.events),
            "votes": {k: dict(v) for k, v in self.votes.items()},
        }


class RoundLedger:
    """Bounded per-node round ledger. ``clock`` is injectable (the state
    machine tests and the interleave harness drive deterministic time);
    ``emit_metrics=False`` keeps harness runs out of the process registry."""

    def __init__(
        self,
        node_tag: str = "",
        cap: int = ROUND_CAP,
        clock=time.perf_counter,
        emit_metrics: bool = True,
    ):
        self.node_tag = node_tag
        self.cap = int(cap)
        self.clock = clock
        self.emit_metrics = emit_metrics
        self.enabled = True
        self._lock = threading.Lock()
        self._rounds: "OrderedDict[tuple[int, int], RoundRecord]" = OrderedDict()
        self._view_changes: deque[dict] = deque(maxlen=VIEW_CHANGE_CAP)
        # phase edges double as flight-recorder events (the black box's
        # "engine" category); harness ledgers (emit_metrics=False) stay out
        # of the process ring. Imported here, not at module top — flight
        # imports this module for the enable switch.
        self._flight = None
        if emit_metrics:
            from .flight import FLIGHT

            self._flight = FLIGHT

    # -- engine-facing writes ------------------------------------------------

    def _round_locked(self, height: int, view: int) -> RoundRecord:
        key = (height, view)
        rec = self._rounds.get(key)
        if rec is None:
            rec = self._rounds[key] = RoundRecord(height, view)
            while len(self._rounds) > self.cap:
                self._rounds.popitem(last=False)
        return rec

    def _note_rec_locked(self, rec: RoundRecord, event: str, t: float) -> None:
        if event in rec.events:
            return
        rec.events[event] = t
        if self._flight is not None:
            self._flight.record(
                "engine", event, scope=self.node_tag, height=rec.height
            )
        if not self.emit_metrics:
            return
        for phase, start, end in PHASE_EDGES:
            if event == end and start in rec.events:
                REGISTRY.observe(
                    "fisco_round_phase_ms",
                    (t - rec.events[start]) * 1e3,
                    buckets=ROUND_PHASE_BUCKETS_MS,
                    phase=phase,
                    help="consensus round per-phase span (round forensics)",
                )
        kind = _QUORUM_VOTES.get(event)
        if kind:
            arrivals = rec.votes.get(kind)
            if arrivals and len(arrivals) > 1:
                ts = arrivals.values()
                REGISTRY.observe(
                    "fisco_vote_arrival_spread_ms",
                    (max(ts) - min(ts)) * 1e3,
                    buckets=VOTE_SPREAD_BUCKETS_MS,
                    kind=kind,
                    help="first-to-last vote arrival spread per quorum",
                )

    def note(self, height: int, view: int, event: str, t: float | None = None) -> None:
        """Record a phase edge (first occurrence wins). Quorum edges emit
        the per-phase span and, where a vote kind closes, its first-to-last
        arrival spread."""
        if t is None:
            t = self.clock()
        with self._lock:
            self._note_rec_locked(self._round_locked(height, view), event, t)

    def note_height(self, height: int, event: str, t: float | None = None) -> None:
        """Record a phase edge against the NEWEST round at ``height`` —
        the async-commit completion path knows the block number but not
        which view's round carried it."""
        if t is None:
            t = self.clock()
        with self._lock:
            for key in reversed(self._rounds):
                if key[0] == height:
                    self._note_rec_locked(self._rounds[key], event, t)
                    return

    def vote(
        self, height: int, view: int, kind: str, signer: int,
        t: float | None = None,
    ) -> None:
        """Record signer ``signer``'s ``kind`` vote arrival (first wins —
        rebroadcasts must not rewrite history)."""
        if t is None:
            t = self.clock()
        with self._lock:
            rec = self._round_locked(height, view)
            rec.votes.setdefault(kind, {}).setdefault(str(int(signer)), t)

    def view_change(
        self, height: int, from_view: int, to_view: int, cause: str,
        t: float | None = None,
    ) -> None:
        """Record a view transition with cause attribution (``timeout``,
        ``catchup``, ``entered``, ``recover``)."""
        if t is None:
            t = self.clock()
        with self._lock:
            self._view_changes.append(
                {
                    "t": t,
                    "height": height,
                    "from_view": from_view,
                    "to_view": to_view,
                    "cause": cause,
                }
            )

    # -- snapshot ------------------------------------------------------------

    def probe(self) -> float:
        """This node's monotonic clock NOW — the fleet clock-probe payload."""
        return self.clock()

    def snapshot(
        self, last: int | None = None, height: int | None = None
    ) -> dict:
        """JSON-able ledger dump: rounds (optionally only ``height`` or the
        newest ``last``), view-change records, and the clock reading the
        aligner pairs with the transport's probe offsets."""
        with self._lock:
            rounds = [r.to_doc() for r in self._rounds.values()]
            vcs = list(self._view_changes)
        if height is not None:
            rounds = [r for r in rounds if r["height"] == height]
        elif last is not None and last >= 0:
            rounds = rounds[-last:]
        return {
            "node": self.node_tag,
            "clock": self.clock(),
            "rounds": rounds,
            "view_changes": vcs,
        }


class _NoopLedger:
    """Shared do-nothing ledger for ``FISCO_FLEET_OBS=0`` — every engine
    note costs one attribute lookup and an immediate return."""

    __slots__ = ()
    enabled = False
    node_tag = ""
    clock = staticmethod(time.perf_counter)

    def note(self, *a, **k) -> None:
        pass

    def note_height(self, *a, **k) -> None:
        pass

    def vote(self, *a, **k) -> None:
        pass

    def view_change(self, *a, **k) -> None:
        pass

    def probe(self) -> float:
        return 0.0

    def snapshot(self, last=None, height=None) -> dict:
        return {"node": "", "clock": 0.0, "rounds": [], "view_changes": []}


NOOP_LEDGER = _NoopLedger()


# -- cross-node alignment -----------------------------------------------------


def phase_spans(round_doc_: dict) -> dict[str, float]:
    """Per-phase spans (ms) of one round dict (``RoundRecord.to_doc``)."""
    events = round_doc_.get("events", {})
    spans: dict[str, float] = {}
    for phase, start, end in PHASE_EDGES:
        if start in events and end in events:
            spans[phase] = (events[end] - events[start]) * 1e3
    return spans


def percentile(values, q: float) -> float:
    """Nearest-rank percentile of ``values`` (q in [0, 100])."""
    vs = sorted(values)
    if not vs:
        return 0.0
    idx = max(0, min(len(vs) - 1, int(round(q / 100.0 * (len(vs) - 1)))))
    return vs[idx]


def _corrected(t: float, offset: float) -> float:
    """Map a peer timestamp into the reference clock frame: ``offset`` is
    (peer clock - reference clock), so subtracting lands in reference time."""
    return t - offset


def align_rounds(
    ledgers: dict[str, dict],
    offsets: dict[str, float] | None = None,
    record_skew: bool = False,
) -> list[dict]:
    """Merge per-node ledger snapshots into per-round fleet documents.

    ``ledgers`` maps a node label to its ``RoundLedger.snapshot()``;
    ``offsets`` maps the same labels to (peer clock - reference clock)
    seconds from the clock-probe exchange (missing/reference label = 0.0).
    Every per-node timestamp is offset-corrected before comparison.

    Each returned round doc carries per-node phase spans, the fleet-wide
    span envelope, the inter-node skew (spread of the corrected quorum
    edge), and the named straggler signer — the committee index whose
    votes trail the first arrival by the largest median margin across
    the observing nodes. ``record_skew=True`` additionally observes each
    round's skew into ``fisco_round_skew_ms`` (the aggregation call paths
    — /fleet, the flood bench — own that; a passive GET must not double
    count)."""
    offsets = offsets or {}
    by_round: dict[tuple[int, int], dict[str, dict]] = {}
    for label, snap in ledgers.items():
        for rd in snap.get("rounds", ()):
            key = (rd["height"], rd["view"])
            by_round.setdefault(key, {})[label] = rd
    out: list[dict] = []
    for (height, view) in sorted(by_round):
        per_node = by_round[(height, view)]
        doc: dict = {"height": height, "view": view, "nodes": {}}
        # per-node spans + fleet envelope
        envelope: dict[str, list[float]] = {}
        for label, rd in per_node.items():
            spans = phase_spans(rd)
            doc["nodes"][label] = {"view": rd["view"], "phases": spans}
            for phase, ms in spans.items():
                envelope.setdefault(phase, []).append(ms)
        doc["phases"] = {
            phase: {"min_ms": min(v), "max_ms": max(v)}
            for phase, v in envelope.items()
        }
        # inter-node skew: spread of the corrected quorum edge across nodes
        # (prefer the stable commit — the edge every replica reaches)
        for edge in ("stable", "committed", "prepared"):
            ts = [
                _corrected(rd["events"][edge], offsets.get(label, 0.0))
                for label, rd in per_node.items()
                if edge in rd.get("events", {})
            ]
            if len(ts) > 1:
                doc["skew_ms"] = (max(ts) - min(ts)) * 1e3
                doc["skew_edge"] = edge
                break
        if record_skew and "skew_ms" in doc:
            REGISTRY.observe(
                "fisco_round_skew_ms",
                doc["skew_ms"],
                buckets=ROUND_SKEW_BUCKETS_MS,
                help="inter-node spread of the round's quorum edge "
                "(offset-corrected)",
            )
        # straggler: lateness of each signer's vote behind the first
        # arrival, aggregated over every observing node and vote kind —
        # offsets cancel (lateness is measured within ONE node's clock).
        # MEDIAN across observations, not mean: a slow OBSERVER processes
        # every arriving vote late and would inflate every OTHER signer's
        # lateness in its own ledger — the median keeps one pathological
        # observer from dominating attribution.
        lateness: dict[str, list[float]] = {}
        for rd in per_node.values():
            for kind in ("prepare", "commit", "checkpoint"):
                arrivals = rd.get("votes", {}).get(kind)
                if not arrivals or len(arrivals) < 2:
                    continue
                first = min(arrivals.values())
                for signer, t in arrivals.items():
                    lateness.setdefault(signer, []).append((t - first) * 1e3)
        if lateness:
            meds = {
                s: sorted(v)[len(v) // 2] for s, v in lateness.items()
            }
            straggler = max(meds, key=lambda s: meds[s])
            doc["vote_lateness_ms"] = {s: round(m, 3) for s, m in meds.items()}
            doc["straggler"] = int(straggler)
            doc["straggler_lateness_ms"] = meds[straggler]
        out.append(doc)
    return out


def round_doc(
    ledgers: dict[str, dict],
    offsets: dict[str, float] | None = None,
    height: int | None = None,
) -> dict:
    """The ``GET /round/<height>`` document: every aligned view of that
    height (re-proposals under view changes show up as separate rounds)."""
    aligned = [
        d for d in align_rounds(ledgers, offsets)
        if height is None or d["height"] == height
    ]
    return {
        "found": bool(aligned),
        "height": height,
        "rounds": aligned,
        "nodes": sorted(ledgers),
    }


def rounds_doc(
    ledgers: dict[str, dict],
    offsets: dict[str, float] | None = None,
    last: int = 32,
    record_skew: bool = False,
) -> dict:
    """The ``GET /rounds?last=N`` document: newest ``last`` aligned rounds
    plus fleet-wide skew percentiles and merged view-change records."""
    aligned = align_rounds(ledgers, offsets, record_skew=record_skew)
    if last >= 0:
        aligned = aligned[-last:]
    skews = [d["skew_ms"] for d in aligned if "skew_ms" in d]
    vcs = []
    for label, snap in ledgers.items():
        for vc in snap.get("view_changes", ()):
            vcs.append({"node": label, **vc})
    return {
        "rounds": aligned,
        "nodes": sorted(ledgers),
        "skew_ms": {
            "n": len(skews),
            "p50": percentile(skews, 50),
            "p95": percentile(skews, 95),
            "max": max(skews) if skews else 0.0,
        },
        "view_changes": vcs,
    }
