"""Consensus evidence + the cross-node chain-safety auditor.

Two halves of the byzantine robustness layer:

**Evidence** — when the engine detects a byzantine consensus message
(equivocation, stale-view frame replay, conflicting votes, a fabricated
view-change prepared-cert, a bad/forged QC vote) it files an
:class:`EvidenceRecord` here. Every record counts into
``fisco_consensus_evidence_total{kind=...}`` and — when the offender is
attributable AND the offense is provably byzantine — files one strike
against the offender's source in the EXISTING admission-quota strike
board (group ``"consensus"``, the same board QC isolation and tx spam
strikes feed), so repeat offenders get the same ``SOURCE_DEMOTED``
treatment tx spammers already get. Stale-view replay records WITHOUT
striking: an honest replica that missed a view change re-sends its own
old-view votes, and the receiver cannot tell lag from malice. Demotion is a
*cost* penalty, never a liveness one: a demoted validator loses the
unverified QC fast path (its packets pay eager authentication) and its
submissions are refused, but its **valid votes always still count toward
quorum** (tests/test_byzantine.py pins it — excluding f validators on
evidence would let an attacker vote honest replicas out of the committee).

**Auditor** — :func:`audit_chain` is the final gate every byzantine and
crash scenario runs (and the flood smoke adopts): across the honest nodes
of a committee it asserts the four chain-safety invariants

- *agreement*: one committed header hash per height, across all nodes;
- *integrity*: no height gaps, parent-hash links intact, no transaction
  committed at two heights (double-commit);
- *certificates*: every committed header carries a quorum-valid QC /
  signature list for its committee (BlockValidator);
- *durable views are monotone*: a node's persisted PBFT view never
  regresses across a reboot (pass the previous report's ``views`` as
  ``prior_views``).

Violations are strings naming the node/height/check; a non-empty list is
a safety bug, full stop — liveness degradation is the scenarios' business,
safety violations are the auditor's.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ..utils.log import get_logger
from ..utils.metrics import REGISTRY

_log = get_logger("consensus-audit")

# the quota-board tenant consensus offenses strike into — shared with the
# QC collector's isolation strikes (qc.STRIKE_GROUP)
EVIDENCE_GROUP = "consensus"

EVIDENCE_KINDS = (
    "equivocation",  # two pre-prepares at one (number, view)
    "stale_view_replay",  # pre-view-change frames re-injected
    "vote_conflict",  # one authenticated signer, two different votes
    "fabricated_prepared_cert",  # VC prepared claim with no valid quorum
    "bad_qc_vote",  # authenticated vote whose qc signature fails
    "forged_qc_vote",  # vote that does not authenticate as its claimed sender
)


@dataclass
class EvidenceRecord:
    kind: str
    number: int = 0
    view: int = 0
    from_index: int = -1  # committee index of the offender (-1 = unknown)
    source: str = ""  # strike-board source tag ("" = unattributable)
    detail: str = ""
    at: float = field(default_factory=time.time)

    def as_dict(self) -> dict:
        return {
            "kind": self.kind,
            "number": self.number,
            "view": self.view,
            "from_index": self.from_index,
            "source": self.source,
            "detail": self.detail,
        }


class EvidenceBoard:
    """Process-wide bounded evidence log (like the HEALTH registry: one
    per process, reset between scenario runs/tests)."""

    MAX_RECORDS = 2048

    def __init__(self):
        self._lock = threading.Lock()
        self._records: deque[EvidenceRecord] = deque(maxlen=self.MAX_RECORDS)
        self._counts: dict[str, int] = {}

    def record(self, rec: EvidenceRecord) -> None:
        with self._lock:
            self._records.append(rec)
            self._counts[rec.kind] = self._counts.get(rec.kind, 0) + 1

    def count(self, kind: str | None = None) -> int:
        with self._lock:
            if kind is None:
                return sum(self._counts.values())
            return self._counts.get(kind, 0)

    def counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [r.as_dict() for r in self._records]

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._counts.clear()


EVIDENCE = EvidenceBoard()


def record_evidence(
    kind: str,
    *,
    number: int = 0,
    view: int = 0,
    from_index: int = -1,
    source: str = "",
    detail: str = "",
    strike: bool = True,
) -> None:
    """File one piece of byzantine evidence: bounded record + labeled
    counter + (when attributable) one strike on the existing quota board.
    ``strike=False`` is for callers that already struck through their own
    path (the QC collector) — evidence must never double-charge."""
    if kind not in EVIDENCE_KINDS:
        raise ValueError(f"unknown evidence kind {kind!r}")
    EVIDENCE.record(
        EvidenceRecord(
            kind,
            number=number,
            view=view,
            from_index=from_index,
            source=source,
            detail=detail,
        )
    )
    REGISTRY.counter_add(
        f'fisco_consensus_evidence_total{{kind="{kind}"}}',
        help="byzantine consensus-message detections by kind "
        "(equivocation, replay, vote conflicts, fabricated certs, bad QC "
        "votes)",
    )
    _log.warning(
        "consensus evidence: %s at %d/%d from index %d (%s)%s",
        kind,
        number,
        view,
        from_index,
        source or "unattributed",
        f" — {detail}" if detail else "",
    )
    if strike and source:
        from ..txpool.quota import get_quotas

        get_quotas().note_invalid(EVIDENCE_GROUP, source, 1)


def validator_source(node_id: bytes) -> str:
    """The strike-board source tag for a committee member, keyed by its
    stable node id (committee reloads reorder indices; ids don't move)."""
    return f"validator:{bytes(node_id).hex()[:16]}"


# ---------------------------------------------------------------------------
# The chain-safety auditor
# ---------------------------------------------------------------------------


def _violation(violations: list[str], check: str, msg: str) -> None:
    violations.append(f"[{check}] {msg}")
    REGISTRY.counter_add(
        f'fisco_consensus_audit_violations_total{{check="{check}"}}',
        help="chain-safety auditor violations by invariant",
    )


def audit_chain(
    nodes,
    honest=None,
    prior_views: dict[str, int] | None = None,
    check_certs: bool = True,
) -> dict:
    """Audit the honest nodes' committed chains for safety violations.

    ``nodes`` — Node-shaped objects (``.ledger``, ``.suite``, optional
    ``.engine`` for the durable-view check). ``honest`` — indices into
    ``nodes`` to audit (default: all; a byzantine node's *committed chain*
    is still expected safe — its engine is honest code — but scenarios
    that wedge a replica on purpose can exclude it). ``prior_views`` — a
    previous report's ``views`` map, for the cross-reboot monotonicity
    check. Returns the report dict; ``report["ok"]`` is the gate.
    """
    from .block_validator import BlockValidator

    audited = (
        list(nodes) if honest is None else [nodes[i] for i in honest]
    )
    violations: list[str] = []
    heights: list[int] = []
    views: dict[str, int] = {}
    headers_checked = 0

    per_node_hashes: list[dict[int, bytes]] = []
    for node in audited:
        ledger = node.ledger
        suite = node.suite
        tag = f"node:{bytes(node.node_id).hex()[:8]}"
        height = ledger.block_number()
        heights.append(height)
        hashes: dict[int, bytes] = {}
        validator = BlockValidator(suite) if check_certs else None
        # certificate checks are per-HEIGHT: a member added mid-chain
        # (enable_number = join-block + 1, ConsensusPrecompiled semantics)
        # must not enlarge the quorum old headers are judged against.
        # Removals are NOT reconstructable — the s_consensus row is gone —
        # so a chain that removed members can report false certificate
        # violations; pass check_certs=False there (known limitation).
        committee = ledger.consensus_nodes()
        prev_hash = ledger.block_hash_by_number(0) or b""
        seen_txs: dict[bytes, int] = {}
        for k in range(1, height + 1):
            header = ledger.header_by_number(k)
            if header is None:
                _violation(
                    violations, "integrity", f"{tag}: height gap at {k}"
                )
                prev_hash = b""
                continue
            h = header.hash(suite)
            hashes[k] = h
            headers_checked += 1
            # ledger's number->hash index must agree with the stored header
            idx_hash = ledger.block_hash_by_number(k)
            if idx_hash != h:
                _violation(
                    violations,
                    "integrity",
                    f"{tag}: number->hash index disagrees with header at {k}",
                )
            if prev_hash and (
                not header.parent_info
                or header.parent_info[0].hash != prev_hash
            ):
                _violation(
                    violations,
                    "integrity",
                    f"{tag}: parent link broken at {k}",
                )
            prev_hash = h
            for txh in ledger.tx_hashes_by_number(k):
                first = seen_txs.setdefault(txh, k)
                if first != k:
                    _violation(
                        violations,
                        "integrity",
                        f"{tag}: tx {txh.hex()[:12]} committed at both "
                        f"{first} and {k} (double-commit)",
                    )
            if validator is not None and not validator.check_block(
                header, [n for n in committee if n.enable_number <= k]
            ):
                _violation(
                    violations,
                    "certificate",
                    f"{tag}: header {k} QC/signature check failed",
                )
        per_node_hashes.append(hashes)
        engine = getattr(node, "engine", None)
        cstore = getattr(engine, "cstore", None) if engine is not None else None
        if cstore is not None:
            view = cstore.load_view()
            key = bytes(node.node_id).hex()[:16]
            views[key] = view
            if prior_views is not None and view < prior_views.get(key, 0):
                _violation(
                    violations,
                    "view_monotonicity",
                    f"{tag}: durable view regressed {prior_views[key]} -> "
                    f"{view}",
                )

    common = min(heights) if heights else 0
    for k in range(1, common + 1):
        distinct = {hs.get(k) for hs in per_node_hashes}
        # a node with a GAP at k already filed an integrity violation —
        # its missing (None) entry is not a disagreement between the
        # nodes that do have the header
        distinct.discard(None)
        if len(distinct) > 1:
            _violation(
                violations,
                "agreement",
                f"height {k}: {len(distinct)} distinct committed hashes "
                "across honest nodes",
            )

    REGISTRY.counter_add(
        "fisco_consensus_audit_runs_total",
        help="chain-safety auditor passes executed",
    )
    report = {
        "ok": not violations,
        "violations": violations,
        "heights": heights,
        "common_height": common,
        "headers_checked": headers_checked,
        "views": views,
    }
    if violations:
        _log.error("chain-safety audit FAILED: %s", violations)
    return report


def assert_chain_safe(nodes, **kw) -> dict:
    """The scenario/tool gate: audit and raise on any violation."""
    report = audit_chain(nodes, **kw)
    if not report["ok"]:
        raise AssertionError(
            "chain-safety audit failed:\n  " + "\n  ".join(report["violations"])
        )
    return report
