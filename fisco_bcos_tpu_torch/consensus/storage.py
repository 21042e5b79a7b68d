"""Durable consensus state — crash-safe PBFT restarts.

Reference: bcos-pbft/pbft/storage/LedgerStorage.cpp (stable checkpoints and
committed proposals persisted to a dedicated consensus DB) plus the
PBFTEngine's recover flow.  What must survive a crash for safety:

- the current **view** (a restarted node must not regress to an old view and
  accept a stale leader's proposal);
- the node's **prepare votes** per block number (voting for a *different*
  proposal at the same (number, view) after restart is equivocation);
- the highest **prepared proposal** (a prepare quorum may mean some replica
  committed it — the restarted node must be able to re-offer it in view
  change, reference ViewChange prepared-proof semantics).

Liveness state (the pool) is persisted by the txpool itself (see
TxPool.persistent seam; reference Initializer.cpp:188-195 re-imports on
boot).  All rows live in one ``s_consensus_state`` KV table of the node's
transactional storage — writes are small and synchronous (write-ahead of the
corresponding broadcast, like the reference's commitStableCheckPoint
ordering).
"""

from __future__ import annotations

from ..codec.flat import FlatReader, FlatWriter
from ..storage.entry import Entry, EntryStatus
from ..storage.interfaces import StorageInterface

TABLE = "s_consensus_state"


class ConsensusStorage:
    def __init__(self, storage: StorageInterface):
        self.storage = storage

    # -- raw KV ---------------------------------------------------------------

    def _put(self, key: str, value: bytes) -> None:
        self.storage.set_row(TABLE, key.encode(), Entry({"value": value}))

    def _get(self, key: str) -> bytes | None:
        e = self.storage.get_row(TABLE, key.encode())
        return None if e is None else e.get()

    # -- view -----------------------------------------------------------------

    def save_view(self, view: int) -> None:
        self._put("view", view.to_bytes(8, "little"))

    def load_view(self) -> int:
        raw = self._get("view")
        return int.from_bytes(raw, "little") if raw else 0

    # -- prepare votes (equivocation guard across restarts) -------------------

    def save_vote(self, number: int, view: int, proposal_hash: bytes) -> None:
        w = FlatWriter()
        w.u64(view)
        w.fixed(proposal_hash, 32)
        self._put(f"voted:{number}", w.out())

    def load_vote(self, number: int) -> tuple[int, bytes] | None:
        raw = self._get(f"voted:{number}")
        if not raw:
            return None
        r = FlatReader(raw)
        view = r.u64()
        h = r.fixed(32)
        r.done()
        return view, h

    # -- prepared proposal (view-change re-offer after restart) ---------------

    def save_prepared(
        self, number: int, view: int, block_data: bytes, proof: list[bytes]
    ) -> None:
        """Persist the prepared proposal WITH its prepare-quorum certificate
        (the signed PREPARE messages) — a restarted node re-offers it in view
        change, and an unproven claim is worthless there."""
        w = FlatWriter()
        w.u64(view)
        w.bytes_(block_data)
        w.seq(proof, lambda w2, b: w2.bytes_(b))
        self._put("prepared", w.out())
        self._put("prepared_number", number.to_bytes(8, "little"))

    def load_prepared(self) -> tuple[int, int, bytes, list[bytes]] | None:
        """Returns (number, view, block_data, proof) or None."""
        raw_n = self._get("prepared_number")
        raw = self._get("prepared")
        if not raw_n or not raw:
            return None
        r = FlatReader(raw)
        view = r.u64()
        data = r.bytes_()
        proof = r.seq(lambda r2: r2.bytes_())
        r.done()
        return int.from_bytes(raw_n, "little"), view, data, proof

    def prune_below(self, number: int) -> None:
        """Drop vote records for committed heights (bounded table)."""
        for key in self.storage.get_primary_keys(TABLE):
            ks = key.decode(errors="replace")
            if not ks.startswith("voted:"):
                continue
            try:
                n = int(ks[6:])
            except ValueError:
                continue
            if n <= number:
                self.storage.set_row(TABLE, key, Entry(status=EntryStatus.DELETED))
        p = self._get("prepared_number")
        if p and int.from_bytes(p, "little") <= number:
            self.storage.set_row(
                TABLE, b"prepared_number", Entry(status=EntryStatus.DELETED)
            )
            self.storage.set_row(TABLE, b"prepared", Entry(status=EntryStatus.DELETED))
