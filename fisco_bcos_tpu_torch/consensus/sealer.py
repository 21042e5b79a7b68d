"""Sealer — packages pending txs into block proposals.

Reference: bcos-sealer/Sealer.cpp:94-114 (worker loop: fetch → generate →
submit to consensus) + SealingManager.cpp:140/230. Proposals carry tx-hash
*metadata* only (SealingManager::generateProposal ships TransactionMetaData;
replicas fill from their pool and fetch stragglers via tx-sync) — pre-prepare
size is independent of tx payload size. The tx-count limit comes from the
ledger's governed config.

The port's copy of the JAX package's ``consensus/sealer.py``; its txs root
runs where the suite runs. Left out of the port: the critical-path index
(each sealed transaction's pool-wait gap and the block-trace registration,
read only by the RPC's per-transaction trace).
"""

from __future__ import annotations

import time

from ..ledger import Ledger
from ..observability import TRACER
from ..observability.pipeline import PIPELINE
from ..protocol.block import Block
from ..protocol.block_header import BlockHeader, ParentInfo
from ..resilience.crashpoints import crashpoint
from ..scheduler.scheduler import pipeline_on
from ..txpool import TxPool
from ..utils.log import get_logger
from ..utils.metrics import REGISTRY
from .config import PBFTConfig
from .engine import PBFTEngine

_log = get_logger("sealer")


class Sealer:
    def __init__(
        self,
        config: PBFTConfig,
        txpool: TxPool,
        ledger: Ledger,
        engine: PBFTEngine,
    ):
        self.config = config
        self.txpool = txpool
        self.ledger = ledger
        self.engine = engine
        self.min_seal_txs = 1
        # node tag for crash-point scoping (Node sets the pubkey prefix)
        self.crash_scope = ""
        # pipeline mode: (number, txs, hashes, txs-root resolver) sealed
        # AHEAD while a proposal is in flight — sealing of N+2 overlaps
        # consensus on N+1. Sealer state is single-threaded (one runtime
        # tick loop owns it).
        self._prebuilt: tuple | None = None

    def _chain_head(self, cfg) -> tuple[int, int, bytes]:
        """(next number, parent number, parent hash). In pipeline mode the
        engine's optimistic head wins: a commit whose 2PC is still on the
        commit worker already fixes the next parent, and waiting for the
        durable ledger to say so would re-serialize the pipeline."""
        number = cfg.block_number + 1
        parent_number, parent_hash = cfg.block_number, cfg.block_hash
        if pipeline_on():
            head_n, head_h = self.engine.consensus_head()
            if head_n > cfg.block_number and head_h:
                number = head_n + 1
                parent_number, parent_hash = head_n, head_h
        return number, parent_number, parent_hash

    def _drop_prebuilt(self) -> None:
        if self._prebuilt is not None:
            _n, _txs, hashes, _root_f = self._prebuilt
            self._prebuilt = None
            self.txpool.unseal(hashes)

    def _prebuild(self, number: int, limit: int) -> None:
        """Seal the NEXT height's batch while the current proposal is in
        flight: fetch + group the txs and dispatch the tx-root merkle now,
        so when the head advances the proposal is assembly-only (parent
        info + timestamp). Leadership is re-checked at use time; a stale
        prebuild unseals its txs."""
        if self._prebuilt is not None:
            if self._prebuilt[0] == number:
                return
            self._drop_prebuilt()
        if not self.config.is_leader(number, self.engine.view):
            return
        if self.txpool.unsealed_count() < self.min_seal_txs:
            return
        with PIPELINE.busy("sealer"):
            txs, hashes = self.txpool.seal_txs(limit)
            # crash window: the batch just left the sealable set, no
            # proposal references it yet — a reboot's reload_persisted
            # must return every one of these txs to the pool
            crashpoint("sealer.mid_prebuild", self.crash_scope)
            if len(txs) < self.min_seal_txs:
                self.txpool.unseal(hashes)
                return
            root_f = Block(tx_metadata=hashes).calculate_txs_root_async(
                self.config.suite
            )
            self._prebuilt = (number, txs, hashes, root_f)
        REGISTRY.counter_add(
            "fisco_sealer_prebuilt_total",
            help="proposals sealed ahead while a prior proposal was in flight",
        )

    def _take_prebuilt(self, number: int):
        """Claim a prebuilt batch for `number`; a mismatched height means
        the pipeline moved differently (view change, lost leadership) —
        its txs go back to the pool."""
        if self._prebuilt is None:
            return None
        if self._prebuilt[0] != number:
            self._drop_prebuilt()
            return None
        pb = self._prebuilt
        self._prebuilt = None
        return pb

    def generate_proposal(self) -> Block | None:
        """Fetch ≤tx_count_limit unsealed txs and build the next block."""
        cfg = self.ledger.ledger_config()
        number, parent_number, parent_hash = self._chain_head(cfg)
        if not self.config.is_leader(number, self.engine.view):
            self._drop_prebuilt()
            PIPELINE.mark_idle("sealer")
            return None
        if self.engine.has_in_flight(number):
            # a proposal is already being voted on: sealing (hashing +
            # device merkle) every tick just to be rejected by the engine's
            # self-equivocation guard is pure waste. For the pipeline
            # observatory this IS the sealer's blocked state — attributed
            # to the commit 2PC when one is in flight (the height can't
            # advance until it lands), else to the consensus quorum. In
            # pipeline mode the tick is not wasted: the NEXT height's
            # batch seals ahead instead.
            PIPELINE.mark_blocked(
                "sealer",
                "2pc_commit"
                if self.engine.scheduler.in_flight_commits()
                else "consensus_quorum",
            )
            if pipeline_on():
                self._prebuild(number + 1, cfg.tx_count_limit)
            return None
        t0 = time.perf_counter()
        with PIPELINE.busy("sealer"):
            prebuilt = self._take_prebuilt(number)
            if prebuilt is not None:
                _n, txs, hashes, root_f = prebuilt
                REGISTRY.counter_add(
                    "fisco_sealer_prebuilt_hits_total",
                    help="proposals assembled from a batch sealed ahead",
                )
            else:
                txs, hashes = self.txpool.seal_txs(cfg.tx_count_limit)
                root_f = None
            if len(txs) < self.min_seal_txs:
                self.txpool.unseal(hashes)
                PIPELINE.mark_idle("sealer")
                return None
            suite = self.config.suite
            header = BlockHeader(
                version=1,
                number=number,
                parent_info=[ParentInfo(parent_number, parent_hash)],
                timestamp=int(time.time() * 1000),
                sealer=self.config.my_index
                if self.config.my_index is not None
                else 0,
                sealer_list=[n.node_id for n in self.config.nodes],
                consensus_weights=[n.weight for n in self.config.nodes],
            )
            block = Block(header=header, tx_metadata=hashes)
            header.txs_root = (
                root_f() if root_f is not None
                else block.calculate_txs_root(suite)
            )
            header.clear_hash_cache()
        dur = time.perf_counter() - t0
        REGISTRY.observe(
            "fisco_sealer_seal_latency_ms",
            dur * 1e3,
            help="proposal generation wall latency (fetch + tx-root merkle)",
        )
        REGISTRY.counter_add(
            "fisco_sealer_proposals_total", help="block proposals generated"
        )
        if TRACER.enabled:
            # open the BLOCK's trace with the seal span
            TRACER.record("seal", t0, dur, block=number, txs=len(txs))
        return block

    def seal_and_submit(self) -> bool:
        """One sealer iteration (executeWorker): propose if leader and txs
        are pending. Returns True if a proposal was submitted."""
        block = self.generate_proposal()
        if block is None:
            return False
        ok = self.engine.submit_proposal(block)
        if not ok:
            # give the txs back — not our turn / wrong number
            self.txpool.unseal(list(block.tx_metadata))
        else:
            _log.info(
                "proposed block %d with %d txs",
                block.header.number,
                len(block.tx_metadata),
            )
        return ok
