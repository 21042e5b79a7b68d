"""TxPool — admission, pool storage, sealing, proposal verification (the
port's copy of the JAX package's ``txpool/txpool.py``: the same gates in the
same order, the same results; each signature batch is one ``batch_admit`` on
the suite's device, routed through the port's DevicePlane under the pool's
group and lane).

Reference: bcos-txpool/TxPool.cpp + txpool/storage/MemoryStorage.cpp. The pool
holds verified txs keyed by hash; the sealer fetches unsealed batches
(batchFetchTxs, MemoryStorage.cpp:619-726); consensus verifies proposals by
hash-presence and batch-verifies any txs it had to fetch
(batchVerifyProposal, MemoryStorage.cpp:982-1021; importDownloadedTxs'
tbb-parallel verify at TransactionSync.cpp:521-553 → here one device batch).

Left out of the port: the critical-path index (``note_tx(s)`` /
``note_committed``, read only by the RPC's per-transaction trace).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from ..crypto.suite import CryptoSuite
from ..device.plane import device_group, device_lane
from ..ledger import Ledger
from ..observability import BATCH_BUCKETS, TRACER
from ..observability.pipeline import PIPELINE
from ..observability.tracer import trace_hex
from ..protocol.transaction import Transaction, hash_transactions_batch
from ..storage.entry import Entry, EntryStatus
from ..utils.error import ErrorCode
from ..utils.log import get_logger, note_swallowed
from ..utils.metrics import REGISTRY
from .quota import get_quotas
from .validator import (
    LedgerNonceChecker,
    TxPoolNonceChecker,
    TxValidator,
    batch_admit,
)

_log = get_logger("txpool")

# admission rejection reasons for the labeled drop counter (one label value
# per family of ErrorCode — keeps the metric cardinality fixed)
_REJECT_REASON = {
    ErrorCode.ALREADY_IN_TX_POOL: "dup",
    ErrorCode.TX_ALREADY_IN_CHAIN: "replay",
    ErrorCode.TX_POOL_FULL: "full",
    ErrorCode.INVALID_SIGNATURE: "sig",
    ErrorCode.BLOCK_LIMIT_CHECK_FAIL: "expired",
    ErrorCode.OVER_GROUP_QUOTA: "quota",
    ErrorCode.SOURCE_DEMOTED: "demoted",
}


@dataclass
class TxSubmitResult:
    tx_hash: bytes
    status: ErrorCode
    sender: bytes = b""


class TxPool:
    PERSIST_TABLE = "s_txpool_data"

    def __init__(
        self,
        suite: CryptoSuite,
        ledger: Ledger,
        chain_id: str = "chain0",
        group_id: str = "group0",
        pool_limit: int = 15000 * 9,
        block_limit: int = 600,
        persistent_store=None,
        quotas=None,
    ):
        self.suite = suite
        self.ledger = ledger
        self.group_id = group_id
        self.pool_limit = pool_limit
        # multi-tenant admission policer (per-group token bucket + strike
        # demotion); default = the process-wide singleton so every group's
        # pool shares ONE model of the node's capacity
        self.quotas = quotas if quotas is not None else get_quotas()
        # durable pool (reference: Initializer.cpp:188-195 re-imports pool
        # txs on boot); None -> memory-only pool
        self.pstore = persistent_store
        self._txs: dict[bytes, Transaction] = {}
        self._sealed: set[bytes] = set()
        # sealable FIFO index (insertion-ordered): exactly the pool entries
        # not yet sealed, so the sealing scan touches only candidates
        # instead of cursor-skipping sealed entries across the whole pool
        # — the flood's seal tick was O(pool), now O(scan window)
        self._unsealed: dict[bytes, Transaction] = {}
        self.seal_scan_cap = 4096
        self._lock = threading.RLock()
        self.pool_nonces = TxPoolNonceChecker()
        self.ledger_nonces = LedgerNonceChecker(block_limit)
        self.validator = TxValidator(
            suite, chain_id, group_id, self.pool_nonces, self.ledger_nonces
        )
        # prime the replay window from the chain head
        head = ledger.block_number()
        for n in range(max(1, head - block_limit + 1), head + 1):
            self.ledger_nonces.commit_block(n, ledger.nonces_by_number(n))

    # -- admission -----------------------------------------------------------

    def submit(self, tx: Transaction, source: str = "local") -> TxSubmitResult:
        """Single-tx admission (RPC path; TxPool.cpp:68 submitTransaction).

        ``source`` names the submitter for strike accounting (RPC session /
        gossip peer)."""
        with TRACER.span("txpool.submit") as sp:
            if self.quotas.demoted(self.group_id, source):
                self.quotas.count_demoted_drop(self.group_id, 1)
                return TxSubmitResult(b"", ErrorCode.SOURCE_DEMOTED)
            with self._lock:
                if len(self._txs) >= self.pool_limit:
                    return TxSubmitResult(b"", ErrorCode.TX_POOL_FULL)
            h = tx.hash(self.suite)
            with self._lock:
                if h in self._txs:
                    return TxSubmitResult(h, ErrorCode.ALREADY_IN_TX_POOL)
            # the quota gate sits BEFORE the signature verify: shed traffic
            # must cost no crypto
            if self.quotas.try_admit(self.group_id, 1) < 1:
                return TxSubmitResult(h, ErrorCode.OVER_GROUP_QUOTA)
            code = self.validator.verify(tx)
            if code != ErrorCode.SUCCESS:
                if code == ErrorCode.INVALID_SIGNATURE:
                    self.quotas.note_invalid(self.group_id, source, 1)
                sp.set(status=code.name)
                return TxSubmitResult(h, code)
            self._insert(tx, h)
            return TxSubmitResult(h, ErrorCode.SUCCESS, tx.sender)

    def submit_batch(
        self,
        txs: list[Transaction],
        lane: str = "admission",
        source: str = "local",
        policed: bool = True,
    ) -> list[TxSubmitResult]:
        """Batch admission: ONE fused device batch (keccak → recover →
        address) for the whole batch — the device replacement for the
        reference's per-tx verify loop. `lane` tags the device-plane
        priority of the signature batch (tx-sync imports pass "sync" so
        gossip floods queue behind consensus/RPC verification).

        Gate order matches the reference (dup/static → pool-full → sig),
        with the multi-tenant gates around it: a demoted ``source`` is
        refused before any work, and the group's admission quota funds only
        part of an over-rate batch — so a full pool, an all-replay batch,
        or a quota-shed flood costs no device program at all. A pooled duplicate is caught by its nonce
        (``_insert`` registers every pooled nonce, and equal hash implies
        equal nonce), so no pre-verification hash pass is needed — the
        fused program's digests fill the hash caches of verified lanes,
        and only rejected lanes pay a host hash for their result row."""
        with TRACER.span(
            "txpool.submit_batch", batch=len(txs), lane=lane
        ) as sp, PIPELINE.busy("admission"):
            return self._submit_batch_spanned(txs, lane, source, policed, sp)

    def _submit_batch_spanned(
        self,
        txs: list[Transaction],
        lane: str,
        source: str,
        policed: bool,
        sp,
    ) -> list[TxSubmitResult]:
        t0 = time.perf_counter()
        if policed and txs and self.quotas.demoted(self.group_id, source):
            # a demoted spammer's whole batch is refused before static
            # checks, hashing, or any device work — maximum shed, zero cost
            self.quotas.count_demoted_drop(self.group_id, len(txs))
            results = [
                TxSubmitResult(b"", ErrorCode.SOURCE_DEMOTED) for _ in txs
            ]
            self._record_admission(txs, results, t0, sp)
            return results
        results: list[TxSubmitResult | None] = [None] * len(txs)
        to_verify: list[int] = []
        with self._lock:
            room = self.pool_limit - len(self._txs)
        batch_nonces: set[str] = set()
        for i, tx in enumerate(txs):
            code = self.validator.check_static(tx)
            if code == ErrorCode.SUCCESS and tx.nonce in batch_nonces:
                code = ErrorCode.ALREADY_IN_TX_POOL  # intra-batch nonce replay
            if code != ErrorCode.SUCCESS:
                results[i] = TxSubmitResult(tx.hash(self.suite), code)
                continue
            if len(to_verify) >= room:
                results[i] = TxSubmitResult(
                    tx.hash(self.suite), ErrorCode.TX_POOL_FULL
                )
                continue
            batch_nonces.add(tx.nonce)
            to_verify.append(i)
        # group quota: the bucket funds a PREFIX of the admissible subset
        # (partial grant); the overflow is shed before the device verify so
        # an over-rate group costs no device program for the shed part.
        # `policed=False` bypasses tenant policing for node-internal
        # re-admission (boot reload of the persisted pool). The sync lane
        # is bucket-exempt: gossip imports were already rate-policed at the
        # RPC edge that admitted them, and re-charging every replica's
        # bucket would multiply one tx's cost by the replication factor —
        # strike demotion (above) still covers spamming peers.
        granted = (
            self.quotas.try_admit(self.group_id, len(to_verify))
            if policed and lane != "sync"
            else len(to_verify)
        )
        if granted < len(to_verify):
            for i in to_verify[granted:]:
                results[i] = TxSubmitResult(
                    txs[i].hash(self.suite), ErrorCode.OVER_GROUP_QUOTA
                )
            to_verify = to_verify[:granted]
        if to_verify:
            # ONE fused device program (keccak → recover → address); fills
            # hash + sender caches for every verified lane. The group tag
            # makes the plane's deficit-round-robin see this batch as this
            # tenant's traffic.
            with device_group(self.group_id), device_lane(lane):
                ok = batch_admit([txs[i] for i in to_verify], self.suite)
            invalid = 0
            persisted: list[tuple[bytes, Transaction]] = []
            for j, i in enumerate(to_verify):
                h = txs[i].hash(self.suite)  # cached by the fused pass
                if ok[j]:
                    self._insert(txs[i], h, persist=False)
                    persisted.append((h, txs[i]))
                    results[i] = TxSubmitResult(h, ErrorCode.SUCCESS, txs[i].sender)
                else:
                    invalid += 1
                    results[i] = TxSubmitResult(h, ErrorCode.INVALID_SIGNATURE)
            if invalid:
                # strike the source: repeated invalid-signature batches get
                # the submitter demoted (spam or a broken client — either
                # way the node stops paying to verify it)
                self.quotas.note_invalid(self.group_id, source, invalid)
            if self.pstore is not None and persisted:
                # one transaction for the whole batch — per-row sqlite
                # commits would fsync thousands of times per block
                self.pstore.set_rows(
                    self.PERSIST_TABLE,
                    [(h, Entry({"value": t.encode()})) for h, t in persisted],
                )
        self._record_admission(txs, results, t0, sp)
        return results  # type: ignore[return-value]

    def _record_admission(self, txs, results, t0: float, sp) -> None:
        """Batch-level admission telemetry (one observation per batch, never
        per tx — the hot loop above stays untouched)."""
        if not REGISTRY.enabled and not TRACER.enabled:
            return
        dur = time.perf_counter() - t0
        admitted = 0
        rejects: dict[str, int] = {}
        for r in results:
            if r is not None and r.status == ErrorCode.SUCCESS:
                admitted += 1
            elif r is not None:
                reason = _REJECT_REASON.get(r.status, "static")
                rejects[reason] = rejects.get(reason, 0) + 1
        REGISTRY.observe(
            "fisco_txpool_admission_latency_ms",
            dur * 1e3,
            help="submit_batch wall latency (static gates + device verify)",
            exemplar=trace_hex(sp.ctx),
        )
        REGISTRY.observe(
            "fisco_txpool_batch_size",
            len(txs),
            buckets=BATCH_BUCKETS,
            help="admission batch sizes",
        )
        REGISTRY.counter_add(
            "fisco_txpool_admitted_total",
            float(admitted),
            help="transactions admitted to the pool",
        )
        for reason, n in rejects.items():
            # group-labeled so a multi-tenant node can attribute shed load:
            # "we are dropping group-X spam" is a different story from
            # "we are dropping everyone's txs"
            REGISTRY.counter_add(
                f'fisco_txpool_rejected_total{{group="{self.group_id}"'
                f',reason="{reason}"}}',
                float(n),
                help="transactions rejected at admission by group and reason",
            )
        sp.set(admitted=admitted)

    def _insert(self, tx: Transaction, h: bytes, persist: bool = True) -> None:
        with self._lock:
            self._txs[h] = tx
            if h not in self._sealed:
                self._unsealed[h] = tx
        # analysis: allow(guarded-state, TxPoolNonceChecker is internally
        # locked — the pool lock guards _txs, not the nonce set)
        self.pool_nonces.insert(tx.nonce)
        if persist and self.pstore is not None:
            self.pstore.set_row(self.PERSIST_TABLE, h, Entry({"value": tx.encode()}))

    def reload_persisted(self) -> int:
        """Re-import durably-stored pool txs after a restart (signatures
        re-verified in one device batch; committed nonces rejected by the
        primed ledger window). Returns the number re-admitted."""
        if self.pstore is None:
            return 0
        txs = []
        for key in self.pstore.get_primary_keys(self.PERSIST_TABLE):
            e = self.pstore.get_row(self.PERSIST_TABLE, key)
            if e is None or not e.get():
                continue
            try:
                txs.append(Transaction.decode(e.get()))
            except Exception as exc:
                # a corrupt persisted row must not block re-import of the rest
                note_swallowed("txpool.persist_decode", exc)
                continue
        if not txs:
            return 0
        # node-internal re-admission: tenant quotas must not shed a pool
        # the node itself persisted (signatures still re-verify on device)
        results = self.submit_batch(txs, policed=False)
        ok = sum(1 for r in results if r.status == ErrorCode.SUCCESS)
        _log.info("re-imported %d/%d persisted pool txs", ok, len(txs))
        return ok

    # -- queries -------------------------------------------------------------

    def pending_count(self) -> int:
        with self._lock:
            return len(self._txs)

    def unsealed_count(self) -> int:
        with self._lock:
            return len(self._unsealed)

    def get(self, h: bytes) -> Transaction | None:
        with self._lock:
            return self._txs.get(h)

    def fetch_txs(self, hashes: list[bytes]) -> list[Transaction | None]:
        """Fill a proposal's metadata with pooled txs (asyncFillBlock)."""
        with self._lock:
            return [self._txs.get(h) for h in hashes]

    # -- sealing -------------------------------------------------------------

    def seal_txs(self, limit: int) -> tuple[list[Transaction], list[bytes]]:
        """Pick ≤limit unsealed txs and mark them sealed
        (asyncSealTxs → batchFetchTxs, MemoryStorage.cpp:619). Returns
        ``(txs, hashes)`` — the admission-time cached digests ride along
        so the sealer never re-hashes a tx it is packaging.

        Round-robin across senders (arrival order within a sender): the
        reference bounds per-traversal fetches so one flooding sender cannot
        starve everyone else out of a block. The scan runs over the
        insertion-ordered UNSEALED index only — oldest-first is the fair
        order, and there are no sealed entries to cursor-skip, so the
        whole call is O(scan window) however large the pool grows. The
        grouping window stays capped at a multiple of `limit`."""
        from collections import deque
        from itertools import islice

        scan_cap = max(limit * 8, self.seal_scan_cap)
        out: list[Transaction] = []
        out_hashes: list[bytes] = []
        with self._lock:
            if not self._unsealed:
                return out, out_hashes
            by_sender: dict[bytes, deque] = {}
            for h, tx in islice(self._unsealed.items(), scan_cap):
                by_sender.setdefault(tx.sender, deque()).append((h, tx))
            queues = deque(by_sender.values())
            while queues and len(out) < limit:
                q = queues.popleft()
                h, tx = q.popleft()
                self._sealed.add(h)
                del self._unsealed[h]
                out.append(tx)
                out_hashes.append(h)
                if q:
                    queues.append(q)
        return out, out_hashes

    def unseal(self, hashes: list[bytes]) -> None:
        """Return sealed txs to the pool (failed/abandoned proposal).
        Re-queued at the tail of the sealable index — order degrades, the
        txs stay sealable."""
        with self._lock:
            for h in hashes:
                if h in self._sealed:
                    self._sealed.discard(h)
                    tx = self._txs.get(h)
                    if tx is not None:
                        self._unsealed[h] = tx

    def mark_sealed(self, hashes: list[bytes]) -> None:
        """Mark an ACCEPTED proposal's txs sealed (the reference's
        asyncMarkTxs). With the pipelined commit a rotated leader seals
        the next block before the previous 2PC lands — in-flight proposal
        txs must already be out of every replica's sealable set or the
        next leader would double-propose them."""
        with self._lock:
            for h in hashes:
                if h in self._txs and h not in self._sealed:
                    self._sealed.add(h)
                    self._unsealed.pop(h, None)

    # -- proposal verification (consensus path) ------------------------------

    def verify_block(
        self, tx_hashes: list[bytes], fetch_missing=None
    ) -> tuple[bool, list[bytes]]:
        """Hash-presence check for a proposal (asyncVerifyBlock →
        batchVerifyProposal). Unknown txs are fetched via `fetch_missing`
        (sync-from-peers hook) and batch-verified on device before import.
        Returns (all known/valid, missing hashes)."""
        with TRACER.span("txpool.verify_block", txs=len(tx_hashes)) as sp:
            ok, missing = self._verify_block_inner(tx_hashes, fetch_missing)
            REGISTRY.counter_add(
                "fisco_txpool_proposal_verify_total",
                help="proposal hash-presence verifications",
            )
            if missing:
                sp.set(missing=len(missing))
                REGISTRY.counter_add(
                    "fisco_txpool_proposal_missing_total",
                    float(len(missing)),
                    help="proposal txs absent from the pool (straggler fetches)",
                )
            return ok, missing

    def _verify_block_inner(
        self, tx_hashes: list[bytes], fetch_missing=None
    ) -> tuple[bool, list[bytes]]:
        with self._lock:
            missing = [h for h in tx_hashes if h not in self._txs]
        if not missing:
            return True, []
        if fetch_missing is None:
            return False, missing
        fetched = fetch_missing(missing)
        got = [t for t in fetched if t is not None]
        if len(got) != len(missing):
            return False, missing
        # proposal-straggler verification sits on the consensus critical
        # path — it must preempt admission/sync batches in the plane queue
        with device_group(self.group_id), device_lane("consensus"):
            ok = batch_admit(got, self.suite)
        if not ok.all():
            return False, missing
        # the fetched txs must BE the missing ones — a peer returning valid
        # but unrelated txs must not make the proposal verify
        got_hashes = hash_transactions_batch(got, self.suite)
        if set(got_hashes) != set(missing):
            return False, missing
        for t, h in zip(got, got_hashes):
            code = self.validator.check_static(t)
            if code not in (ErrorCode.SUCCESS, ErrorCode.ALREADY_IN_TX_POOL):
                return False, missing
            self._insert(t, h)
        return True, []

    # -- block lifecycle -----------------------------------------------------

    def on_block_committed(self, number: int, tx_hashes: list[bytes]) -> None:
        """Drop committed txs, advance the nonce window
        (asyncNotifyBlockResult)."""
        nonces = []
        with self._lock:
            for h in tx_hashes:
                tx = self._txs.pop(h, None)
                self._sealed.discard(h)
                self._unsealed.pop(h, None)
                if tx is not None:
                    nonces.append(tx.nonce)
                    self.pool_nonces.remove(tx.nonce)
        if self.pstore is not None and tx_hashes:
            self.pstore.set_rows(
                self.PERSIST_TABLE,
                [(h, Entry(status=EntryStatus.DELETED)) for h in tx_hashes],
            )
        self.ledger_nonces.commit_block(number, nonces)
        _log.info("block %d committed: dropped %d txs", number, len(tx_hashes))
