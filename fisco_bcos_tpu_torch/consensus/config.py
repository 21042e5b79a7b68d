"""PBFT configuration: committee, weights, quorum, leader rotation.

Reference: bcos-pbft/pbft/config/PBFTConfig.* — quorum is weight-based
(minRequiredQuorum = total*2/3 rounded up via 2f+1 analog), leader rotates
every `leader_period` blocks and advances with the view
(leaderIndex = (number / leader_period + view) % n).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto.suite import CryptoSuite, KeyPair
from ..ledger.ledger import ConsensusNode


def min_quorum(total_weight: int) -> int:
    """Weighted 2f+1: the smallest q with 3q > 2*total (the reference's
    minRequiredQuorum). THE quorum rule — the engine's vote threshold and
    the validator's committed-QC check must agree on it, so it lives in
    exactly one place."""
    return (2 * total_weight) // 3 + 1


@dataclass
class PBFTConfig:
    suite: CryptoSuite
    keypair: KeyPair
    nodes: list[ConsensusNode] = field(default_factory=list)  # sealers, sorted
    leader_period: int = 1
    # ledger head at construction: the boot committee must apply the SAME
    # enable_number filter that reload(active_at=committed+1) applies on
    # every commit, or a restarted node computes different leader/quorum
    # math than running replicas when an s_consensus row carries
    # enable_number > head+1. None = no filter (static test committees).
    head: int | None = None

    def __post_init__(self) -> None:
        self.reload(
            self.nodes, active_at=None if self.head is None else self.head + 1
        )

    @property
    def node_id(self) -> bytes:
        return self.keypair.pub

    @property
    def committee_size(self) -> int:
        return len(self.nodes)

    @property
    def total_weight(self) -> int:
        return sum(n.weight for n in self.nodes)

    @property
    def quorum(self) -> int:
        """Weighted 2f+1 (see :func:`min_quorum`)."""
        return min_quorum(self.total_weight)

    def index_of(self, node_id: bytes) -> int | None:
        for i, n in enumerate(self.nodes):
            if n.node_id == node_id:
                return i
        return None

    @property
    def my_index(self) -> int | None:
        return self.index_of(self.node_id)

    def node_at(self, index: int) -> ConsensusNode | None:
        if 0 <= index < len(self.nodes):
            return self.nodes[index]
        return None

    def weight_of(self, index: int) -> int:
        n = self.node_at(index)
        return n.weight if n else 0

    def leader_index(self, number: int, view: int) -> int:
        if not self.nodes:
            return 0
        return (number // self.leader_period + view) % len(self.nodes)

    def is_leader(self, number: int, view: int) -> bool:
        return self.my_index == self.leader_index(number, view)

    # ------------------------------------------------------------------ QC

    @property
    def qc_keypair(self):
        """This node's quorum-certificate keypair, derived from the
        consensus secret under the active scheme (cached per scheme —
        FISCO_QC_SCHEME can flip between tests)."""
        from .qc import derive_qc_keypair, qc_scheme_name

        scheme = qc_scheme_name()
        cache = getattr(self, "_qc_kp_cache", None)
        if cache is None or cache[0] != scheme:
            cache = (scheme, derive_qc_keypair(self.keypair.secret))
            self._qc_kp_cache = cache
        return cache[1]

    def qc_pubs(self) -> list[bytes]:
        """Committee QC pubkeys in sealer order ('' where unregistered)."""
        return [n.qc_pub for n in self.nodes]

    def qc_ready(self) -> bool:
        """QC fast path is active: switched on AND every committee member
        has a registered qc_pub of the active scheme's length. A single
        legacy member keeps the whole committee on the per-signature path
        — mixed-mode quorums would need two verification flows for one
        proposal."""
        from .qc import get_scheme, qc_enabled

        if not qc_enabled() or not self.nodes:
            return False
        try:
            want = get_scheme().pub_len
        except ValueError:
            return False
        return all(len(n.qc_pub) == want for n in self.nodes)

    def reload(self, nodes: list[ConsensusNode], active_at: int | None = None) -> None:
        """Committee change from an s_consensus update (dynamic membership).

        `active_at`: the block number the committee serves (committed + 1).
        A member joined via ConsensusPrecompiled carries enable_number =
        write-block + 1 (ConsensusPrecompiled.cpp semantics) and must not
        vote before it — every replica filters on the same boundary, so the
        committee (and header sealer lists) stay deterministic."""
        self.nodes = sorted(
            (
                n
                for n in nodes
                if n.node_type == "consensus_sealer"
                and (active_at is None or n.enable_number <= active_at)
            ),
            key=lambda n: n.node_id,
        )
