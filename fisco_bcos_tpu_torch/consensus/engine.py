"""PBFT consensus engine.

Reference: bcos-pbft/pbft/engine/PBFTEngine.cpp — message dispatch
(handleMsg:603-673), leader proposal entry (asyncSubmitProposal:325 →
onRecvProposal:336), replica flow (handlePrePrepareMsg:784-918 → verify via
txpool → broadcastPrepareMsg:920 → handlePrepareMsg:962 → handleCommitMsg:980
→ checkAndCommit), executed-state checkpointing (handleCheckPointMsg:1384,
stable checkpoint → ledger commit), and view change
(handleViewChangeMsg:1193 / handleNewViewMsg:1273).

Differences kept deliberate and documented:
- Proposals carry tx-hash metadata (SealingManager ships TransactionMetaData);
  replicas fill from the pool and synchronously fetch stragglers from the
  leader via tx-sync (asyncVerifyBlock's fetch-then-recheck), with fetched
  signatures batch-verified in one device program. Full-tx proposals remain
  accepted (view-change re-proposals carry the filled block so a new node
  can vote without a pool).
- Execution happens at commit-quorum inside the handler (the reference
  pipelines via StateMachine::asyncApply worker threads); checkpoint
  signatures then form the QC stored in the header's signature_list, exactly
  like the reference's commitStableCheckPoint.
- Timeouts are explicit (`on_timeout()`): the node runtime owns timers, the
  engine owns state — keeps N-engines-in-one-process tests deterministic
  (the PBFTFixture pattern, SURVEY.md §4.3).

The port's copy of the JAX package's ``consensus/engine.py``: the same
phases, frames and state. Its device work runs where its suite runs (the
full-tx proposal's ``batch_admit`` and the txs root on the port plane's
``consensus`` lane, the QC checks through ``qc.py``). Left out of the port:
the critical-path index's block-trace registration (read only by the RPC's
per-transaction trace). The engine takes any scheduler with the
interface it calls (``execute_block``, ``commit_block``,
``commit_block_async``, ``staged_state``); the ``Scheduler`` class is not
carried yet.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ..front.front import FrontService, ModuleID
from ..ledger import Ledger
from ..observability import TRACER
from ..observability.pipeline import PIPELINE
from ..observability.roundlog import NOOP_LEDGER
from ..resilience.crashpoints import (
    InjectedCrash,
    crashpoint,
    ensure_env_crash_plan,
)
from ..utils.metrics import REGISTRY
from ..protocol.block import Block
from ..protocol.block_header import SignatureTuple
from ..scheduler.scheduler import SchedulerError, pipeline_on
from ..txpool import TxPool
from ..txpool.validator import batch_admit
from ..utils.error import ErrorCode
from ..utils.log import get_logger, note_swallowed
from ..utils.worker import Worker
from .audit import EVIDENCE_GROUP, record_evidence, validator_source
from .config import PBFTConfig
from .messages import (
    NewViewPayload,
    PacketType,
    PBFTMessage,
    ViewChangePayload,
)
from .qc import QuorumCert, QuorumCollector, qc_scheme_name, vote_preimage

_log = get_logger("pbft")

ensure_env_crash_plan()  # arm FISCO_CRASH_PLAN seams once per process

# packets that join quorum certificates: in QC mode they accumulate
# UNVERIFIED (no per-message signature check on arrival) and are admitted
# wholesale by one aggregate verification at quorum time
VOTE_PACKETS = frozenset(
    (PacketType.PREPARE, PacketType.COMMIT, PacketType.CHECKPOINT)
)


@dataclass
class ProposalCache:
    """Votes for one (number): the reference's PBFTCache."""

    pre_prepare: PBFTMessage | None = None
    block: Block | None = None
    # immutable accept-time encoding of the FILLED block — the bytes that
    # certificates persist and view changes re-offer; never re-encoded from
    # the live object (pre-execution mutates header/receipts concurrently)
    block_data: bytes = b""
    prepares: dict[int, PBFTMessage] = field(default_factory=dict)
    commits: dict[int, PBFTMessage] = field(default_factory=dict)
    checkpoints: dict[int, PBFTMessage] = field(default_factory=dict)
    executed_header = None
    prepared: bool = False  # prepare quorum reached
    committed: bool = False  # commit quorum reached (executed)
    stable: bool = False  # checkpoint quorum reached (ledger-committed)
    # the prepare-quorum certificate (QC mode): what view changes carry
    # instead of the O(n) encoded-PREPARE proof list
    prepare_qc: "QuorumCert | None" = None
    # phase timestamps (perf_counter) feeding the per-phase latency
    # histograms and the retroactive pbft.* trace spans
    t_accept: float = 0.0
    t_prepared: float = 0.0
    t_committed: float = 0.0
    # this process's trace for the in-flight block: every pbft.* phase
    # record and the execute/commit span trees hang off it, so one
    # trace_id covers the block's whole pipeline (critical_path stitches
    # per-process block traces by number)
    trace_ctx: object = None


class PBFTEngine:
    def __init__(
        self,
        config: PBFTConfig,
        scheduler: "Scheduler",  # noqa: F821 - any object with its interface
        txpool: TxPool,
        ledger: Ledger,
        front: FrontService,
        consensus_storage: "ConsensusStorage | None" = None,
    ):
        self.config = config
        self.scheduler = scheduler
        self.txpool = txpool
        self.ledger = ledger
        self.front = front
        self.suite = config.suite
        self.view = 0
        self.to_view = 0  # view we are trying to change to
        self.committed_number = ledger.block_number()
        # the optimistic chain head (pipeline mode): committed_number may
        # run ahead of the durable ledger while a 2PC is on the commit
        # worker, and the sealer chains the next proposal on THIS hash
        self._head_hash = (
            ledger.block_hash_by_number(self.committed_number) or b""
        )
        # durable consensus state (pbft/storage/LedgerStorage.cpp analog):
        # restores view + vote guards + the prepared proposal after a crash
        self.cstore = consensus_storage
        self._recovered_prepared: tuple[int, int, bytes, list[bytes]] | None = None
        if self.cstore is not None:
            self.view = self.to_view = self.cstore.load_view()
            rp = self.cstore.load_prepared()
            if rp is not None and rp[0] == self.committed_number + 1:
                self._recovered_prepared = rp
        self._caches: dict[int, ProposalCache] = {}
        self._view_changes: dict[int, dict[int, PBFTMessage]] = {}
        self._recover_responses: dict[int, PBFTMessage] = {}
        # safety lock from new-view proofs: view -> (number, only acceptable
        # proposal hash); a new leader must re-propose the highest prepared
        # proposal, and replicas enforce it here
        self._view_locks: dict[int, tuple[int, bytes]] = {}
        self._lock = threading.RLock()
        self.timeout_state = False
        # injected-crash containment: once a crash point fires on this
        # node, its engine is dead — every subsequent message is ignored
        # exactly as a killed process would ignore it (the harness reboots
        # a fresh Node over the durable storage)
        self._crashed = False
        # node tag for crash-point scoping (Node sets the pubkey prefix so
        # a multi-node process can kill exactly one replica)
        self.crash_scope = ""
        # round forensics: Node swaps in a real RoundLedger when
        # the fleet observatory is on; the shared noop keeps every note a
        # single attribute call otherwise
        self.roundlog = NOOP_LEDGER
        # node_id -> strike-board source tag memo (hot-path demotion probe)
        self._source_tags: dict[bytes, str] = {}
        # set by node wiring: (hashes, from_node_id) -> list[Transaction|None]
        # (TransactionSync.fetch_missing — the proposal straggler fetch)
        self.fetch_missing_fn = None
        # live deployments dispatch PBFT messages on one consensus worker
        # thread (the reference's single PBFTEngine worker, PBFTEngine.cpp:40)
        # so a blocking tx fetch can't stall the gateway reader that must
        # deliver the fetch response; deterministic tests dispatch inline.
        self._worker: Worker | None = None
        # aggregate-QC vote accumulator (consensus/qc.py): built lazily on
        # first activation — constructing a scheme at boot would make a
        # mistyped FISCO_QC_SCHEME crash a node whose operator disabled
        # the subsystem outright with FISCO_QC=0
        self.qc: QuorumCollector | None = None
        # off-lock quorum admission (the pre-prepare double-gate pattern
        # applied to votes): quorate phases enqueue a verify job here; the
        # OUTERMOST dispatch frame on each thread drains the queue AFTER
        # releasing the engine lock, runs the aggregate check lock-free,
        # then re-acquires and re-checks the gate before admitting. A slow
        # pairing (or a slow wire delaying vote batches) therefore never
        # parks handle_message.
        self._verify_mu = threading.Lock()
        self._verify_jobs: deque[tuple[str, int]] = deque()
        self._verify_keys: set[tuple[str, int]] = set()
        self._dispatch_tls = threading.local()
        # committee-wide evidence propagation (consensus/gossip.py): Node
        # wires an EvidenceGossip here; detection sites offer their
        # offending frames so EVERY honest node can re-verify and strike
        self.gossip = None
        front.register_module(ModuleID.PBFT, self._on_front_message)

    def _qc_active(self) -> bool:
        """QC fast path for this committee, re-checked per call (env flips
        in tests; committee reloads at every commit). A scheme switch
        rebuilds the collector — stale-scheme votes just fail isolation."""
        if not self.config.qc_ready():
            return False
        if self.qc is None or self.qc.scheme.name != qc_scheme_name():
            # double-checked: the receive path probes outside the engine
            # lock; racing initializers must share ONE collector (its
            # counters and seal memo are the per-quorum bookkeeping)
            with self._lock:
                if self.qc is None or self.qc.scheme.name != qc_scheme_name():
                    self.qc = QuorumCollector(self.suite)
                    self.qc.strike_tagger = self._qc_strike_tag
        return True

    def _qc_strike_tag(self, qc_pub: bytes) -> str:
        """qc_pub -> the member's node-id strike tag, so QC isolation
        strikes and byzantine-message evidence strikes (audit.py) combine
        under one board source toward the demotion threshold. Linear scan:
        strikes/demotion probes are rare (bad votes, non-empty penalty
        box), and reading the live config tracks committee reloads."""
        if qc_pub:
            for node in self.config.nodes:
                if node.qc_pub == qc_pub:
                    return validator_source(node.node_id)
        return ""

    # -------------------------------------------------- off-lock QC admission

    def _enter_dispatch(self) -> None:
        tls = self._dispatch_tls
        tls.depth = getattr(tls, "depth", 0) + 1

    def _exit_dispatch(self) -> None:
        tls = self._dispatch_tls
        tls.depth -= 1
        if tls.depth == 0:
            self._drive_verify_jobs()

    def _enqueue_verify(self, kind: str, number: int) -> None:
        """Queue one aggregate-verification job (deduped per phase+height).
        Jobs carry only (kind, number): every other input is re-derived
        from live state when the job runs, so a stale job is harmless."""
        key = (kind, number)
        with self._verify_mu:
            if key not in self._verify_keys:
                self._verify_keys.add(key)
                self._verify_jobs.append(key)

    def _drive_verify_jobs(self) -> None:
        """Drain pending verify jobs. Called at every dispatch exit once
        the engine lock is released; nested dispatch frames (the in-proc
        gateway delivers broadcasts synchronously under the sender's
        lock) defer to the outermost frame on their thread, so the slow
        aggregate check genuinely runs off-lock."""
        if self._crashed or not self._verify_jobs:
            return
        tls = self._dispatch_tls
        if getattr(tls, "driving", False):
            return  # re-entered from a completion's broadcast: outer loop drains
        tls.driving = True
        try:
            while True:
                with self._verify_mu:
                    if not self._verify_jobs:
                        return
                    kind, number = self._verify_jobs.popleft()
                    self._verify_keys.discard((kind, number))
                try:
                    self._run_verify_job(kind, number)
                except InjectedCrash:
                    # completion paths carry crash points; absorb here —
                    # the transport boundary already returned, and a
                    # crash must never unwind a peer's delivery
                    self._crashed = True
                    _log.error(
                        "injected crash in %s verify job at %d — node "
                        "halted (reboot to recover)", kind, number,
                    )
                    return
        finally:
            tls.driving = False

    _VERIFY_PACKETS = {
        "prepare": PacketType.PREPARE,
        "commit": PacketType.COMMIT,
        "checkpoint": PacketType.CHECKPOINT,
    }

    def _verify_snapshot(
        self, kind: str, number: int
    ) -> "tuple[PacketType, int, bytes, dict[int, PBFTMessage]] | None":
        """Gate + input snapshot for one verify job, under the engine
        lock. None when the gate closed (phase already admitted, cache
        pruned, view moved, quorum no longer agrees) — the job dies."""
        cache = self._caches.get(number)
        if cache is None:
            return None
        if kind == "prepare":
            if cache.prepared or cache.pre_prepare is None:
                return None
            agreeing = self._agreeing(
                cache.prepares, cache.pre_prepare.proposal_hash
            )
            view, msg32 = self.view, cache.pre_prepare.proposal_hash
        elif kind == "commit":
            if cache.committed or not cache.prepared or cache.pre_prepare is None:
                return None
            agreeing = self._agreeing(
                cache.commits, cache.pre_prepare.proposal_hash
            )
            view, msg32 = self.view, cache.pre_prepare.proposal_hash
        else:  # checkpoint
            if cache.stable or cache.executed_header is None:
                return None
            msg32 = cache.executed_header.hash(self.suite)
            agreeing = {
                i: m
                for i, m in cache.checkpoints.items()
                if m.proposal_hash == msg32
                and self.config.node_at(i) is not None
            }
            view = 0  # checkpoint preimage is the header hash — viewless
        if self._weight(agreeing) < self.config.quorum:
            return None
        return self._VERIFY_PACKETS[kind], view, msg32, dict(agreeing)

    def _run_verify_job(self, kind: str, number: int) -> None:
        """One off-lock admission: snapshot under the lock, verify the
        aggregate WITHOUT the lock, then re-acquire and re-run the gate
        before mutating any consensus state (the pre-prepare handler's
        double-gate re-check pattern)."""
        with self._lock:
            snap = self._verify_snapshot(kind, number)
        if snap is None:
            return
        packet_type, view, msg32, agreeing = snap
        # the expensive pairing/aggregate check — engine lock NOT held
        ok, cert, bad = self._verify_quorum_offlock(
            packet_type, number, view, msg32, agreeing
        )
        with self._lock:
            cache = self._caches.get(number)
            if cache is None:
                return
            votes = {
                "prepare": cache.prepares,
                "commit": cache.commits,
                "checkpoint": cache.checkpoints,
            }[kind]
            for i in bad:
                m = votes.get(i)
                if m is not None and m is agreeing.get(i):
                    # prune exactly the frame we judged — a fresh
                    # (re-sent) vote that arrived mid-verify survives
                    votes.pop(i, None)
                    self._offer_bad_vote_evidence(m)
            recheck = self._verify_snapshot(kind, number)
            if recheck is None:
                return
            if recheck[1] != view or recheck[2] != msg32:
                # the world moved under the verification (view change /
                # re-execution): what we verified is no longer what the
                # gate would admit — verify again against live state
                self._enqueue_verify(kind, number)
                return
            if not ok:
                # not quorate after pruning: future vote arrivals re-run
                # the phase check and re-enqueue
                return
            if kind == "prepare":
                self._complete_prepared(number, cache, agreeing, cert)
            elif kind == "commit":
                self._complete_committed(number, cache)
            else:
                self._complete_stable_locked(number, cache, cert)

    def _offer_bad_vote_evidence(self, m: PBFTMessage) -> None:
        """Gossip a pruned bad QC vote when the frame is self-attributing
        (outer signature verified: the named signer really sent the
        invalid aggregate signature)."""
        if not getattr(m, "_authenticated", False):
            return
        self._gossip_offer(
            "bad_qc_vote",
            number=m.number,
            view=m.view,
            offender=m.generated_from,
            frames=[m],
            detail=f"invalid qc_sig on {m.packet_type.name}",
        )

    def _gossip_offer(self, kind: str, **kw) -> None:
        """Publish a local byzantine detection to the committee (no-op when
        gossip is not wired). Gossip is best-effort side channel: a publish
        failure must never disturb the consensus path that detected it."""
        if self.gossip is None:
            return
        try:
            self.gossip.offer(kind, **kw)
        except Exception as e:
            note_swallowed("pbft.gossip_offer", e)

    # ----------------------------------------------------------------- worker

    def start_worker(self) -> None:
        if self._worker is not None:
            return
        self._worker = Worker("pbft-worker")
        self._worker.start()

    def stop_worker(self) -> None:
        if self._worker is not None:
            self._worker.stop()
        self._worker = None

    # ------------------------------------------------------------------ utils

    MAX_AHEAD = 256  # waterline: ignore votes far past the chain head

    def _in_waterline(self, number: int) -> bool:
        """Reject numbers outside (committed, committed + MAX_AHEAD] so one
        faulty sealer can't grow the vote caches without bound (the
        reference's waterlines check)."""
        return self.committed_number < number <= self.committed_number + self.MAX_AHEAD

    def _cache_locked(self, number: int) -> ProposalCache:
        return self._caches.setdefault(number, ProposalCache())

    def _block_ctx(self, number: int, cache: ProposalCache):
        """Lazily open this process's block trace (root context) — created
        at first touch of the proposal, reused by every phase."""
        if cache.trace_ctx is None and TRACER.enabled:
            cache.trace_ctx = TRACER.new_root_context(name="pbft.block")
        return cache.trace_ctx

    def has_in_flight(self, number: int) -> bool:
        """A proposal at `number` has been accepted and is being voted on."""
        with self._lock:
            cache = self._caches.get(number)
            return cache is not None and cache.pre_prepare is not None

    def consensus_head(self) -> tuple[int, bytes]:
        """Optimistic chain head: the highest stable-committed block's
        (number, header hash) INCLUDING commits whose 2PC is still in
        flight on the commit worker — what the pipelined sealer chains
        the next proposal onto (the durable ledger answers only after
        the 2PC lands)."""
        with self._lock:
            return self.committed_number, self._head_hash

    def _async_commit_active(self) -> bool:
        """The pipelined (worker-driven) commit runs only on live
        deployments: deterministic tests dispatch messages inline and
        keep the lock-step commit, exactly like the message-worker
        split."""
        return self._worker is not None and pipeline_on()

    def _on_commit_result(self, number: int, exc) -> None:
        """Commit-worker completion callback. Success needs nothing —
        consensus already advanced optimistically. A terminal failure
        rolls the optimistic head back to the durable ledger so block
        sync / view change can recover from a truthful height (the same
        position as a node that crashed before its commit)."""
        if exc is None:
            self.roundlog.note_height(number, "durable")
            return
        with self._lock:
            durable = self.ledger.block_number()
            rolled = self.committed_number > durable
            if rolled:
                self.committed_number = durable
                self._head_hash = (
                    self.ledger.block_hash_by_number(durable) or b""
                )
                REGISTRY.counter_add(
                    "fisco_pbft_commit_rollback_total",
                    help="optimistic heads rolled back after an async 2PC "
                    "failure",
                )
        if rolled:
            _log.error(
                "async commit of block %d failed (%s): head rolled back "
                "to %d", number, exc, durable,
            )
        else:
            # a prior failure's callback already rolled the head back (or
            # nothing ever advanced) — report the failure, not a rollback
            _log.error(
                "async commit of block %d failed (%s): head already at "
                "durable %d", number, exc, durable,
            )

    def _broadcast(self, msg: PBFTMessage) -> None:
        self.front.broadcast(ModuleID.PBFT, msg.encode())

    def _sign(self, msg: PBFTMessage) -> PBFTMessage:
        msg.generated_from = self.config.my_index if self.config.my_index is not None else -1
        msg.sign(self.suite, self.config.keypair)
        if msg.packet_type in VOTE_PACKETS and self._qc_active():
            # the aggregatable vote signature: over the shared preimage
            # (for checkpoints, the executed header hash itself — that is
            # what the committed header's certificate must verify against)
            msg.qc_sig = self.qc.scheme.sign_vote(
                self.config.qc_keypair, self._vote_msg32(msg)
            )
        return msg

    def _vote_msg32(self, msg: PBFTMessage) -> bytes:
        if msg.packet_type == PacketType.CHECKPOINT:
            return msg.proposal_hash
        return vote_preimage(
            self.suite, msg.packet_type, msg.view, msg.number, msg.proposal_hash
        )

    def _weight(self, votes: dict[int, PBFTMessage]) -> int:
        return sum(self.config.weight_of(i) for i in votes)

    # ------------------------------------------------------------ leader path

    def submit_proposal(self, block: Block) -> bool:
        """Leader entry (asyncSubmitProposal:325): wrap the sealed block in a
        signed PrePrepare, broadcast, and process it locally."""
        if self._crashed:
            return False
        self._enter_dispatch()
        try:
            return self._submit_proposal(block)
        except InjectedCrash:
            # a crash point fired on THIS node's own proposal path: halt
            # the engine and let the drive boundary (sealer tick / test
            # harness) observe the kill
            self._crashed = True
            raise
        finally:
            self._exit_dispatch()

    def _submit_proposal(self, block: Block) -> bool:
        # the leader's own pre-prepare (and, single-node, the whole phase
        # chain down to commit) runs here, not through handle_message —
        # same consensus-stage accounting either way
        with PIPELINE.busy("consensus"), self._lock:
            number = block.header.number
            if self.timeout_state:
                return False
            if not self.config.is_leader(number, self.view):
                return False
            if number != self.committed_number + 1:
                return False
            existing = self._caches.get(number)
            if existing is not None and existing.pre_prepare is not None:
                # we already proposed at this height/view: a second, different
                # proposal would be self-equivocation (re-delivery is the
                # rebroadcast path's job, not the sealer's)
                return False
            msg = PBFTMessage(
                packet_type=PacketType.PRE_PREPARE,
                view=self.view,
                number=number,
                proposal_hash=block.header.hash(self.suite),
                proposal_data=block.encode(),
            )
            self._sign(msg)
            self._broadcast(msg)
            self._handle_pre_prepare(msg, from_self=True)
            return True

    def rebroadcast_in_flight(self) -> None:
        """Re-broadcast our pre-prepare and votes for the uncommitted head
        proposal (runtime-timer driven). Transient peer loss (reconnects,
        stalls) drops frames; PBFT is idempotent to re-delivery — the
        equivocation guard accepts the same hash, votes overwrite
        themselves — so periodic re-send restores liveness without waiting
        out the full view-change timeout (the reference's resend via
        checkPoint/timeout broadcasts)."""
        with self._lock:
            cache = self._caches.get(self.committed_number + 1)
            if cache is None or cache.stable:
                return
            msgs: list[PBFTMessage] = []
            if (
                cache.pre_prepare is not None
                and cache.pre_prepare.generated_from == self.config.my_index
            ):
                msgs.append(cache.pre_prepare)
            my = self.config.my_index
            if my is not None:
                for votes in (cache.prepares, cache.commits, cache.checkpoints):
                    if my in votes:
                        msgs.append(votes[my])
        if msgs:
            REGISTRY.counter_add(
                "fisco_pbft_rebroadcast_total",
                float(len(msgs)),
                help="in-flight proposal/vote re-broadcasts (liveness resend)",
            )
        for m in msgs:
            self._broadcast(m)

    # -------------------------------------------------------------- dispatch

    def _on_front_message(self, src: bytes, payload: bytes) -> None:
        try:
            msg = PBFTMessage.decode(payload)
        except Exception:
            _log.warning("undecodable pbft message from %s", src.hex()[:8])
            return
        w = self._worker
        if w is not None:
            w.post(lambda: self.handle_message(msg, src))
        else:
            self.handle_message(msg, src)

    def _evidence_demoted(self, node) -> bool:
        """Has the strike board demoted this validator for byzantine
        *messages* (equivocation/replay/conflicts — audit.py evidence)?
        Hot path (every QC vote): one LOCK-FREE emptiness peek when
        nobody is demoted — the locked per-source probe and the source
        tag only materialize while someone is in the penalty box."""
        from ..txpool.quota import get_quotas

        quotas = get_quotas()
        if not quotas.any_demoted(EVIDENCE_GROUP):
            return False
        key = bytes(node.node_id)
        src = self._source_tags.get(key)
        if src is None:
            src = self._source_tags[key] = validator_source(key)
        return quotas.demoted(EVIDENCE_GROUP, src)

    def handle_message(
        self, msg: PBFTMessage, src: bytes | None = None
    ) -> None:
        """Transport entry. Tracks dispatch depth so queued aggregate-QC
        verification jobs drain only at the OUTERMOST frame on this
        thread — i.e. after the engine lock is released and nested
        in-proc deliveries have unwound (off-lock double-gate)."""
        self._enter_dispatch()
        try:
            self._handle_message(msg, src)
        finally:
            self._exit_dispatch()

    def _handle_message(
        self, msg: PBFTMessage, src: bytes | None = None
    ) -> None:
        if self._crashed:
            return  # a crash point fired: this node is dead until reboot
        node = self.config.node_at(msg.generated_from)
        if node is None:
            return
        # QC fast path: vote packets accumulate UNVERIFIED — the quorum
        # admits them wholesale with one aggregate verification. Packets
        # from demoted (previously-bad) signers — QC isolation strikes or
        # byzantine-message evidence — lose the fast path and pay eager
        # per-message authentication; everything that is not a vote
        # (pre-prepare, view machinery, recovery) is always verified here.
        # Demotion only ever costs the fast path: a demoted validator's
        # authenticated votes still join quorums (liveness must survive
        # the penalty box — see audit.py).
        defer_to_qc = (
            msg.packet_type in VOTE_PACKETS
            and bool(msg.qc_sig)
            and self._qc_active()
            and not self.qc.is_demoted(node.qc_pub)
            and not self._evidence_demoted(node)
        )
        if not defer_to_qc and not msg.verify(self.suite, node.node_id):
            _log.warning(
                "bad signature on %s from index %d",
                msg.packet_type.name,
                msg.generated_from,
            )
            return
        # unverified fast-path votes may never EVICT a cached vote (the
        # handlers enforce it through this marker): with sender
        # authentication deferred, last-write-wins would let a forged vote
        # replace a victim's genuine one and get it struck from the quorum
        msg._authenticated = not defer_to_qc
        with self._lock:
            handler = {
                PacketType.PRE_PREPARE: self._handle_pre_prepare,
                PacketType.PREPARE: self._handle_prepare,
                PacketType.COMMIT: self._handle_commit,
                PacketType.CHECKPOINT: self._handle_checkpoint,
                PacketType.VIEW_CHANGE: self._handle_view_change,
                PacketType.NEW_VIEW: self._handle_new_view,
                PacketType.RECOVER_REQUEST: self._handle_recover_request,
                PacketType.RECOVER_RESPONSE: self._handle_recover_response,
            }[msg.packet_type]
            # stale-view replay: a proposal/vote from a view this node has
            # already moved past, for a height still in flight. Charged to
            # the TRANSPORT peer that delivered it, not the frame's signer
            # — replaying a victim's genuine old frames must never let the
            # replayer get the victim struck (checkpoints are viewless and
            # exempt; committed-height stragglers are ordinary lag).
            stale_replay = (
                msg.packet_type
                in (PacketType.PRE_PREPARE, PacketType.PREPARE, PacketType.COMMIT)
                and msg.view < self.view
                and msg.number > self.committed_number
            )
        if stale_replay:
            peer_idx = self.config.index_of(src) if src else None
            if src and peer_idx is not None:
                source = validator_source(src)  # a member replayed: one tag
            elif src:
                source = f"peer:{src.hex()[:16]}"
            else:
                # no transport peer known (direct/test drive): the record
                # stays UNATTRIBUTED — charging the frame's signer (in the
                # source OR the offender index) would let a replayer
                # defame the victim whose genuine frames it re-injected
                source = ""
            # strike=False: an honest replica that MISSED the view change
            # re-sends its own cached old-view votes through the exact
            # same signature (the runtime's in-flight rebroadcast), and
            # the receiver cannot tell lag from malice. Replay evidence is
            # therefore a visible detection signal only — striking it
            # would demote honest laggards after every bumpy view change.
            record_evidence(
                "stale_view_replay",
                number=msg.number,
                view=msg.view,
                # the offender is the DELIVERING peer when it is a member,
                # otherwise unknown (-1) — never the frame's signer
                from_index=peer_idx if peer_idx is not None else -1,
                source=source,
                detail=(
                    f"{msg.packet_type.name} from view {msg.view} "
                    f"re-injected at view {self.view}"
                ),
                strike=False,
            )
        # the consensus stage is this worker processing one message; the
        # execute/commit legs inside flip it to blocked-on attribution so
        # PBFT bookkeeping time and downstream-stage time stay separable.
        # An injected crash is absorbed HERE — the transport boundary — so
        # one node's death never unwinds the in-proc gateway's delivery to
        # its peers; the engine is dead from this instant.
        try:
            with PIPELINE.busy("consensus"):
                handler(msg)
        except InjectedCrash:
            self._crashed = True
            _log.error(
                "injected crash while handling %s — node halted (reboot "
                "to recover)",
                msg.packet_type.name,
            )

    # ------------------------------------------------------------ pre-prepare

    def _pre_prepare_gate(self, msg: PBFTMessage) -> bool:
        """The admissibility checks for a pre-prepare (run under the lock,
        twice: before the lock-free verify and again before voting)."""
        if not self._in_waterline(msg.number):
            return False
        if msg.view != self.view or self.timeout_state:
            return False
        if msg.generated_from != self.config.leader_index(msg.number, msg.view):
            _log.warning("pre-prepare from non-leader %d", msg.generated_from)
            return False
        cache = self._cache_locked(msg.number)
        if cache.pre_prepare is not None:
            # accepting a SECOND proposal for the same (number, view) and
            # voting again is equivocation — PBFT safety forbids it. The
            # sender is the proven leader (checked above) and the packet
            # is signature-verified, so the evidence is attributable.
            if cache.pre_prepare.proposal_hash != msg.proposal_hash:
                _log.warning(
                    "leader equivocation at %d/%d ignored", msg.number, msg.view
                )
                node = self.config.node_at(msg.generated_from)
                record_evidence(
                    "equivocation",
                    number=msg.number,
                    view=msg.view,
                    from_index=msg.generated_from,
                    source=validator_source(node.node_id) if node else "",
                    detail="second pre-prepare with a different proposal "
                    "hash at one (number, view)",
                )
                self._gossip_offer(
                    "equivocation",
                    number=msg.number,
                    view=msg.view,
                    offender=msg.generated_from,
                    frames=[cache.pre_prepare, msg],
                    detail="two signed pre-prepares at one (number, view)",
                )
            return False
        lock = self._view_locks.get(msg.view)
        if lock is not None and lock[0] == msg.number and lock[1] != msg.proposal_hash:
            _log.warning(
                "pre-prepare %d/%d violates new-view prepared lock",
                msg.number,
                msg.view,
            )
            return False
        return True

    def _handle_pre_prepare(self, msg: PBFTMessage, from_self: bool = False) -> None:
        t_gate0 = time.perf_counter()
        with self._lock:
            if not self._pre_prepare_gate(msg):
                return
            leader = self.config.node_at(msg.generated_from)
            bctx = self._block_ctx(msg.number, self._cache_locked(msg.number))
        # decode + verify + tx fill run OUTSIDE the lock: the metadata fetch
        # can block on tx-sync for seconds, and votes/other handlers must
        # keep flowing meanwhile (the reference verifies on txpool threads).
        # The block trace is attached here so the verification span tree —
        # txpool.verify_block, straggler fetches, device-plane waits — lands
        # in this block's trace instead of as disconnected roots.
        try:
            block = Block.decode(msg.proposal_data)
        except Exception:
            _log.warning("undecodable proposal %d", msg.number)
            return
        if block.header.hash(self.suite) != msg.proposal_hash:
            return
        if block.header.number != msg.number:
            return
        with TRACER.attach(bctx):
            verified = self._verify_and_fill(
                block, leader.node_id if leader else None, from_self
            )
        if not verified:
            _log.warning("proposal %d failed verification", msg.number)
            return
        with self._lock:
            if not self._pre_prepare_gate(msg):  # state may have moved
                return
            if self.cstore is not None:
                # crash-safe equivocation guard: a vote for a different hash
                # at this (number, view) may already be on the wire from a
                # previous life of this process
                pv = self.cstore.load_vote(msg.number)
                if (
                    pv is not None
                    and pv[0] == msg.view
                    and pv[1] != msg.proposal_hash
                ):
                    _log.warning(
                        "refusing conflicting re-vote at %d/%d after restart",
                        msg.number,
                        msg.view,
                    )
                    return
                self.cstore.save_vote(msg.number, msg.view, msg.proposal_hash)
            cache = self._cache_locked(msg.number)
            cache.pre_prepare = msg
            cache.block = block
            cache.block_data = block.encode()  # accept-time snapshot
            cache.t_accept = time.perf_counter()
            self.roundlog.note(msg.number, msg.view, "pre_prepare", t=cache.t_accept)
            if self._async_commit_active():
                # pipelined commit: the next height seals before this
                # block's 2PC lands, so its txs must leave the sealable
                # set NOW (the reference's asyncMarkTxs on proposal
                # accept) — on every node, since leadership rotates
                self.txpool.mark_sealed(block.tx_hashes(self.suite))
            # pre-prepare gate latency: message arrival -> accepted (covers
            # decode, proposal verify, tx fill/straggler fetch)
            REGISTRY.observe(
                "fisco_pbft_preprepare_gate_latency_ms",
                (cache.t_accept - t_gate0) * 1e3,
                help="pre-prepare arrival to acceptance (decode+verify+fill)",
            )
            TRACER.record(
                "pbft.pre_prepare",
                t_gate0,
                cache.t_accept - t_gate0,
                parent_ctx=cache.trace_ctx,
                block=msg.number,
                view=msg.view,
            )
            prepare = PBFTMessage(
                packet_type=PacketType.PREPARE,
                view=self.view,
                number=msg.number,
                proposal_hash=msg.proposal_hash,
            )
            self._sign(prepare)
            self._broadcast(prepare)
            cache.prepares[prepare.generated_from] = prepare
            self.roundlog.note(msg.number, msg.view, "prepare_sent")
            self.roundlog.vote(
                msg.number, msg.view, "prepare", prepare.generated_from
            )
            # votes may have arrived ahead of the pre-prepare (depth-first
            # delivery / network reordering — the reference caches them too)
            self._check_prepared_quorum(msg.number, cache)
            self._check_commit_quorum(msg.number, cache)
            already_executed = cache.executed_header is not None
            pre_data = cache.block_data
            pre_txs = list(cache.block.transactions)
        if not already_executed:
            # block pipeline (StateMachine::asyncPreApply): execute while the
            # vote round-trips are in flight; the commit-quorum handler then
            # hits the scheduler's proposal-identity cache. Outside the
            # engine lock — execution takes block-time, votes must flow.
            # An EXECUTION VIEW runs, never cache.block: execution fills
            # header roots/receipts in place, and the certificate path
            # serializes cache state concurrently — but the transaction
            # objects are shared (immutable once signed), so the view
            # costs a header decode instead of an N-tx re-decode per
            # block. lazy_roots: the root programs dispatch but don't
            # sync — the device computes them while the prepare/commit
            # votes round-trip, and the commit-quorum cache hit resolves
            # them (pipeline mode).
            try:
                with TRACER.attach(bctx):
                    self.scheduler.execute_block(
                        Block.execution_view(pre_data, pre_txs),
                        lazy_roots=True,
                    )
            except SchedulerError as e:
                _log.debug("pre-execute %d skipped: %s", msg.number, e)

    def _verify_and_fill(
        self, block: Block, leader_id: bytes | None, from_self: bool
    ) -> bool:
        """Proposal verification + tx fill (asyncVerifyBlock + asyncFillBlock).

        Metadata proposals: every hash must be pooled (stragglers fetched
        from the leader via tx-sync and batch-verified on device before
        import — TxPool.verify_block), then the block is filled in metadata
        order. Full-tx proposals (view-change re-proposals): carried
        signatures batch-verified on device. Both paths end with the header
        txs_root recomputed against the device merkle — binding votes to tx
        *content*, not just the hash list.
        """
        from ..device.plane import device_lane

        if block.tx_metadata and not block.transactions:
            fetch = None
            if self.fetch_missing_fn is not None and leader_id is not None:
                fetch = lambda hs: self.fetch_missing_fn(hs, leader_id)  # noqa: E731
            ok, missing = self.txpool.verify_block(block.tx_metadata, fetch)
            if not ok:
                _log.warning("proposal missing %d txs", len(missing))
                return False
            txs = self.txpool.fetch_txs(block.tx_metadata)
            if any(t is None for t in txs):
                return False
            block.transactions = txs  # fill in metadata order
        elif block.transactions and not from_self:
            # full-tx proposal: device batch admission of carried signatures,
            # on the plane's consensus lane (ahead of admission/sync batches)
            with device_lane("consensus"):
                ok = batch_admit(block.transactions, self.suite)
            if not bool(ok.all()):
                return False
            for t in block.transactions:
                code = self.txpool.validator.check_static(t)
                if code not in (ErrorCode.SUCCESS, ErrorCode.ALREADY_IN_TX_POOL):
                    return False
        with device_lane("consensus"):
            root_ok = not block.transactions or (
                block.header.txs_root == block.calculate_txs_root(self.suite)
            )
        if not root_ok:
            _log.warning("proposal txs_root mismatch at %d", block.header.number)
            return False
        return True

    # ------------------------------------------------------- prepare / commit

    def _handle_prepare(self, msg: PBFTMessage) -> None:
        with self._lock:
            if not self._in_waterline(msg.number) or msg.view != self.view:
                return
            cache = self._cache_locked(msg.number)
            # buffered even pre-proposal
            self._cache_vote(
                cache.prepares,
                msg,
                (int(PacketType.PREPARE), msg.number, msg.view, msg.proposal_hash),
            )
            self.roundlog.vote(msg.number, msg.view, "prepare", msg.generated_from)
            self._check_prepared_quorum(msg.number, cache)

    def _handle_commit(self, msg: PBFTMessage) -> None:
        with self._lock:
            if not self._in_waterline(msg.number) or msg.view != self.view:
                return
            cache = self._cache_locked(msg.number)
            self._cache_vote(
                cache.commits,
                msg,
                (int(PacketType.COMMIT), msg.number, msg.view, msg.proposal_hash),
            )
            self.roundlog.vote(msg.number, msg.view, "commit", msg.generated_from)
            self._check_commit_quorum(msg.number, cache)

    def _agreeing(self, votes: dict[int, PBFTMessage], proposal_hash: bytes):
        return {i: m for i, m in votes.items() if m.proposal_hash == proposal_hash}

    def _cache_vote(
        self, votes: dict[int, PBFTMessage], msg: PBFTMessage, key: tuple
    ) -> None:
        """Store a vote and mirror its qc_sig into the collector. An
        UNVERIFIED fast-path vote may not replace a cached vote that
        differs — on conflict the newcomer is authenticated on the spot
        (one signature check, paid only under attack), so a genuine vote
        beats a forged one REGARDLESS of arrival order: forged-first
        cannot suppress the real vote, genuine-first cannot be evicted.
        An authenticated sender changing its vote is then equivocation
        for the _agreeing filter, exactly as before QCs existed."""
        existing = votes.get(msg.generated_from)
        if (
            existing is not None
            and not getattr(msg, "_authenticated", True)
            and (
                existing.proposal_hash != msg.proposal_hash
                or existing.qc_sig != msg.qc_sig
            )
        ):
            node = self.config.node_at(msg.generated_from)
            if node is None or not msg.verify(self.suite, node.node_id):
                return  # unauthenticated conflict: drop the newcomer
            msg._authenticated = True
        if (
            existing is not None
            and getattr(msg, "_authenticated", True)
            and not getattr(existing, "_authenticated", False)
            and (
                existing.proposal_hash != msg.proposal_hash
                or existing.qc_sig != msg.qc_sig
            )
        ):
            # An authenticated newcomer is about to evict a cached
            # UNVERIFIED fast-path frame that disagrees with it. Judge the
            # loser now instead of discarding it silently: over a real
            # wire the genuine vote usually heals the slot before any
            # quorum snapshot runs, and the aggregate path only judges
            # frames still cached at snapshot time — silent eviction would
            # let a forgery vanish unrecorded. The signature check is paid
            # only under attack; honest re-sends are byte-identical.
            node = self.config.node_at(existing.generated_from)
            if node is not None and existing.verify(self.suite, node.node_id):
                existing._authenticated = True  # genuine: conflict below
            else:
                REGISTRY.counter_add(
                    "fisco_qc_forged_votes_total",
                    1.0,
                    help="fast-path vote packets whose qc signature failed "
                    "AND whose packet signature does not authenticate the "
                    "claimed sender (dropped, victim not struck)",
                )
                record_evidence(
                    "forged_qc_vote",
                    number=msg.number,
                    view=msg.view,
                    from_index=msg.generated_from,
                    detail="evicted cached vote does not authenticate as "
                    "its claimed sender",
                    strike=False,
                )
        if (
            existing is not None
            and existing.proposal_hash != msg.proposal_hash
            and getattr(msg, "_authenticated", True)
            and getattr(existing, "_authenticated", True)
        ):
            # one signer, two different votes at the same (number, view),
            # and BOTH frames authenticated: honest replicas vote once and
            # only ever re-send the identical frame, so the conflict is
            # byzantine by construction. An unauthenticated cached vote is
            # NOT enough — it may be an attacker's forgery under this
            # signer's index, and charging the genuine newcomer would let
            # the forger get an honest validator struck (the forged cached
            # vote itself dies at QC aggregate time, dropped un-struck).
            node = self.config.node_at(msg.generated_from)
            record_evidence(
                "vote_conflict",
                number=msg.number,
                view=msg.view,
                from_index=msg.generated_from,
                source=validator_source(node.node_id) if node else "",
                detail=f"conflicting {msg.packet_type.name} votes",
            )
            self._gossip_offer(
                "vote_conflict",
                number=msg.number,
                view=msg.view,
                offender=msg.generated_from,
                frames=[existing, msg],
                detail=f"conflicting {msg.packet_type.name} votes",
            )
        votes[msg.generated_from] = msg
        if msg.qc_sig and self.qc is not None:
            self.qc.add_vote(
                key, msg.generated_from, msg.qc_sig,
                replace=getattr(msg, "_authenticated", True),
            )

    def _verify_quorum_offlock(
        self,
        packet_type: PacketType,
        number: int,
        view: int,
        msg32: bytes,
        agreeing: dict[int, PBFTMessage],
    ) -> "tuple[bool, QuorumCert | None, set[int]]":
        """QC-mode quorum admission over an agreeing-vote SNAPSHOT: one
        aggregate verification admits the quorum; bad votes found by
        isolation are struck by the collector and reported back for the
        caller to prune UNDER the engine lock. Runs without the engine
        lock (the collector carries its own synchronization) so a slow
        pairing never parks handle_message. Returns
        (quorum_admitted, cert, bad_signers)."""
        qc_votes = {i: m.qc_sig for i, m in agreeing.items() if m.qc_sig}
        key = (int(packet_type), number, view, msg32)

        def vote_authentic(i: int) -> bool:
            """Strike gate: was the bad vote's PACKET really sent by the
            validator it names? Checked lazily — the outer signature is
            only paid for votes that already failed QC verification."""
            m = agreeing.get(i)
            if m is None:
                return False
            if getattr(m, "_authenticated", False):
                return True
            node = self.config.node_at(i)
            if node is not None and m.verify(self.suite, node.node_id):
                m._authenticated = True
                return True
            return False

        valid, bad, cert = self.qc.admit(
            key,
            msg32 if packet_type == PacketType.CHECKPOINT
            else vote_preimage(self.suite, packet_type, view, number, msg32),
            qc_votes,
            self.config.qc_pubs(),
            self.config.weight_of,
            self.config.quorum,
            authenticated_fn=vote_authentic,
        )
        bad = set(bad)
        if cert is not None:
            return True, cert, bad
        # votes without a qc_sig were outer-verified on arrival: a pure
        # legacy quorum (mixed-mode peers) still decides, just without a
        # certificate to carry
        noqc = {i: m for i, m in agreeing.items() if not m.qc_sig and i not in bad}
        noqc_weight = self._weight(noqc)
        if noqc_weight >= self.config.quorum:
            return True, None, bad
        # mixed-mode rescue (rolling upgrades): neither the qc subset nor
        # the legacy subset is quorate alone, but together they are —
        # verify the qc votes INDIVIDUALLY and combine, or the chain would
        # stall at this height forever despite a quorum of verifiable
        # agreeing votes
        qc_rest = {
            i: m.qc_sig
            for i, m in agreeing.items()
            if m.qc_sig and i not in bad
        }
        if (
            noqc
            and qc_rest
            and noqc_weight + sum(self.config.weight_of(i) for i in qc_rest)
            >= self.config.quorum
        ):
            pre = (
                msg32
                if packet_type == PacketType.CHECKPOINT
                else vote_preimage(self.suite, packet_type, view, number, msg32)
            )
            good = self.qc.verify_votes(
                qc_rest, pre, self.config.qc_pubs(),
                authenticated_fn=vote_authentic,
            )
            bad |= set(qc_rest) - good
            if (
                noqc_weight + sum(self.config.weight_of(i) for i in good)
                >= self.config.quorum
            ):
                return True, None, bad
        return False, None, bad

    def _check_prepared_quorum(self, number: int, cache: ProposalCache) -> None:
        if cache.prepared or cache.pre_prepare is None:
            return
        agreeing = self._agreeing(cache.prepares, cache.pre_prepare.proposal_hash)
        if self._weight(agreeing) < self.config.quorum:
            return
        if self._qc_active():
            # the aggregate check is the slow part: queue it for the
            # off-lock driver at dispatch exit instead of pairing here
            # with the engine lock held
            self._enqueue_verify("prepare", number)
            return
        self._complete_prepared(number, cache, agreeing, None)

    def _complete_prepared(
        self,
        number: int,
        cache: ProposalCache,
        agreeing: dict[int, PBFTMessage],
        cert: "QuorumCert | None",
    ) -> None:
        """Prepare quorum ADMITTED (gate re-checked under the lock by the
        caller): record the QC, persist the prepared proof, broadcast our
        COMMIT."""
        if cert is not None:
            cache.prepare_qc = cert
        cache.prepared = True
        cache.t_prepared = time.perf_counter()
        self.roundlog.note(number, self.view, "prepared", t=cache.t_prepared)
        if cache.t_accept:
            REGISTRY.observe(
                "fisco_pbft_prepare_latency_ms",
                (cache.t_prepared - cache.t_accept) * 1e3,
                help="pre-prepare accept to prepare quorum",
            )
            TRACER.record(
                "pbft.prepare",
                cache.t_accept,
                cache.t_prepared - cache.t_accept,
                parent_ctx=cache.trace_ctx,
                block=number,
            )
        if self.cstore is not None and cache.block_data:
            # write-ahead of the COMMIT broadcast: after a crash this node
            # can still prove (and re-offer) the prepared proposal — from
            # the accept-time snapshot, not the (possibly executing) object
            self.cstore.save_prepared(
                number,
                cache.pre_prepare.view,
                cache.block_data,
                [m.encode() for m in agreeing.values()],
            )
        # crash window: the prepared proposal is durable, the COMMIT vote
        # has not broadcast — a reboot must re-offer it via view change
        # without ever voting a different hash at this (number, view)
        crashpoint("engine.pre_commit_broadcast", self.crash_scope)
        commit = PBFTMessage(
            packet_type=PacketType.COMMIT,
            view=self.view,
            number=number,
            proposal_hash=cache.pre_prepare.proposal_hash,
        )
        self._sign(commit)
        self._broadcast(commit)
        cache.commits[commit.generated_from] = commit
        self.roundlog.note(number, self.view, "commit_sent")
        self.roundlog.vote(number, self.view, "commit", commit.generated_from)
        self._check_commit_quorum(number, cache)

    def _check_commit_quorum(self, number: int, cache: ProposalCache) -> None:
        if cache.committed or not cache.prepared or cache.pre_prepare is None:
            return
        agreeing = self._agreeing(cache.commits, cache.pre_prepare.proposal_hash)
        if self._weight(agreeing) < self.config.quorum:
            return
        if self._qc_active():
            self._enqueue_verify("commit", number)
            return
        self._complete_committed(number, cache)

    def _complete_committed(self, number: int, cache: ProposalCache) -> None:
        """Commit quorum ADMITTED (gate re-checked under the lock by the
        caller): execute and distribute the checkpoint."""
        cache.committed = True
        cache.t_committed = time.perf_counter()
        self.roundlog.note(number, self.view, "committed", t=cache.t_committed)
        if cache.t_prepared:
            REGISTRY.observe(
                "fisco_pbft_commit_latency_ms",
                (cache.t_committed - cache.t_prepared) * 1e3,
                help="prepare quorum to commit quorum",
            )
            TRACER.record(
                "pbft.commit",
                cache.t_prepared,
                cache.t_committed - cache.t_prepared,
                parent_ctx=cache.trace_ctx,
                block=number,
            )
        self._execute_and_checkpoint(number, cache)

    def _execute_and_checkpoint(self, number: int, cache: ProposalCache) -> None:
        """Commit quorum reached: apply via the scheduler (StateMachine::
        asyncApply) and distribute a checkpoint over the *executed* header."""
        assert cache.block is not None
        self.roundlog.note(number, self.view, "execute_start")
        try:
            with TRACER.attach(cache.trace_ctx), TRACER.span(
                "pbft.execute_and_checkpoint", block=number
            ), PIPELINE.blocked(
                "execute"
            ):  # nests scheduler.execute_block, inside the block trace
                header = self.scheduler.execute_block(cache.block)
        except SchedulerError as e:
            _log.error("execute block %d failed: %s", number, e)
            return
        self.roundlog.note(number, self.view, "execute_end")
        if cache.t_committed:
            REGISTRY.observe(
                "fisco_pbft_execute_latency_ms",
                (time.perf_counter() - cache.t_committed) * 1e3,
                help="commit quorum to executed header (incl. preexec cache hits)",
            )
        cache.executed_header = header
        header_hash = header.hash(self.suite)
        ckpt = PBFTMessage(
            packet_type=PacketType.CHECKPOINT,
            view=self.view,
            number=number,
            proposal_hash=header_hash,
            # the QC signature: over the header hash itself (what
            # BlockValidator::checkSignatureList verifies), carried alongside
            # the packet signature (reference: PBFTProposal's own signature)
            payload=self.suite.signature_impl.sign(self.config.keypair, header_hash),
        )
        self._sign(ckpt)
        self._broadcast(ckpt)
        self.roundlog.note(number, self.view, "checkpoint_sent")
        self._handle_checkpoint(ckpt)

    # ------------------------------------------------------------- checkpoint

    def _handle_checkpoint(self, msg: PBFTMessage) -> None:
        with self._lock:
            if not self._in_waterline(msg.number):
                return
            cache = self._cache_locked(msg.number)
            self._cache_vote(
                cache.checkpoints,
                msg,
                (int(PacketType.CHECKPOINT), msg.number, 0, msg.proposal_hash),
            )
            self.roundlog.vote(
                msg.number, self.view, "checkpoint", msg.generated_from
            )
            self._check_checkpoint_quorum(msg.number, cache)

    def _check_checkpoint_quorum(self, number: int, cache: ProposalCache) -> None:
        if cache.stable or cache.executed_header is None:
            return
        if self._qc_active():
            # aggregate admission: ONE verification for the whole
            # checkpoint quorum; the resulting constant-size cert IS the
            # committed header's QC record. The cheap weight pregate runs
            # here (valid votes are a subset of matching ones, so a
            # sub-quorum matching set can never admit); the pairing
            # itself goes to the off-lock driver.
            executed_hash = cache.executed_header.hash(self.suite)
            matching = {
                i: m
                for i, m in cache.checkpoints.items()
                if m.proposal_hash == executed_hash
                and self.config.node_at(i) is not None
            }
            if self._weight(matching) < self.config.quorum:
                return
            self._enqueue_verify("checkpoint", number)
            return
        self._complete_stable_locked(number, cache, None)

    def _complete_stable_locked(
        self, number: int, cache: ProposalCache, cert: "QuorumCert | None"
    ) -> None:
        """Checkpoint quorum ADMITTED (gate re-checked under the lock by
        the caller): stamp the header's QC record, commit the block, and
        advance the head."""
        header = cache.executed_header
        executed_hash = header.hash(self.suite)
        if cert is not None:
            header.signature_list = []
            header.qc = cert.encode()
        else:
            # legacy path (FISCO_QC=0 / non-QC committee / mixed-mode
            # fallback): per-signer payload verification, O(n) list —
            # byte-identical to the pre-QC build
            matching = {
                i: m
                for i, m in cache.checkpoints.items()
                if m.proposal_hash == executed_hash
                and self.config.node_at(i) is not None
            }
            agreeing = {}
            for i, m in matching.items():
                # the payload must be a valid QC signature over the
                # header hash
                if not self.suite.signature_impl.verify(
                    self.config.node_at(i).node_id, executed_hash, m.payload
                ):
                    continue
                agreeing[i] = m
            if self._weight(agreeing) < self.config.quorum:
                return
            header.signature_list = [
                SignatureTuple(i, m.payload) for i, m in sorted(agreeing.items())
            ]
            header.qc = b""
        cache.stable = True
        header.clear_hash_cache()
        use_async = self._async_commit_active()
        try:
            with TRACER.attach(cache.trace_ctx), TRACER.span(
                "pbft.checkpoint_commit", block=number
            ), PIPELINE.blocked(
                "commit"
            ):  # nests scheduler.commit_block, inside the block trace
                if use_async:
                    # pipeline mode: the 2PC runs on the commit
                    # worker; this engine advances optimistically and
                    # keeps processing messages — a failed 2PC rolls
                    # the head back via _on_commit_result
                    self.scheduler.commit_block_async(
                        header, on_done=self._on_commit_result
                    )
                else:
                    self.scheduler.commit_block(header)
        except SchedulerError as e:
            _log.error("commit block %d failed: %s", number, e)
            cache.stable = False
            return
        now = time.perf_counter()
        if cache.t_committed:
            from ..observability.tracer import trace_hex

            REGISTRY.observe(
                "fisco_pbft_checkpoint_latency_ms",
                (now - cache.t_committed) * 1e3,
                help="executed to checkpoint quorum + ledger commit",
                exemplar=trace_hex(cache.trace_ctx),
            )
            TRACER.record(
                "pbft.checkpoint",
                cache.t_committed,
                now - cache.t_committed,
                parent_ctx=cache.trace_ctx,
                block=number,
            )
        self.roundlog.note(number, self.view, "stable", t=now)
        if not use_async:
            # lock-step commit: the 2PC landed inside the try above —
            # the round is durable the instant it is stable (the async
            # path notes durability from the commit-worker callback)
            self.roundlog.note_height(number, "durable")
        self.committed_number = number
        self._head_hash = executed_hash
        # crash window: the optimistic head just advanced; in pipeline
        # mode the 2PC may still be queued on the commit worker — a
        # reboot rebuilds the head from the durable ledger and block
        # sync re-drives anything the crash stranded
        crashpoint("engine.post_head_advance", self.crash_scope)
        self.timeout_state = False
        stale = [n for n in self._caches if n <= number]
        for n in stale:
            self._caches.pop(n)
        if self.qc is not None:
            self.qc.reset_below(number)
        if self.cstore is not None:
            self.cstore.prune_below(number)
        if (
            self._recovered_prepared is not None
            and self._recovered_prepared[0] <= number
        ):
            self._recovered_prepared = None
        # committee may have changed at this block; members activate at
        # their enable_number (block N+1 for a change written at N).
        # With the async commit the ledger row may not be durable yet —
        # read through the committing block's post-state overlay (falls
        # back to the ledger once the 2PC has booked)
        staged = (
            self.scheduler.staged_state(number) if use_async else None
        )
        self.config.reload(
            self.ledger.consensus_nodes(storage=staged),
            active_at=number + 1,
        )
        _log.info(
            "block %d stable-committed, view=%d, committee=%d",
            number,
            self.view,
            self.config.committee_size,
        )

    # ------------------------------------------------------------ view change

    def on_timeout(self, cause: str = "timeout") -> None:
        """Consensus timeout: try to move to view+1 (PBFTTimer expiry).
        ``cause`` attributes the round-forensics record — the catch-up path
        re-enters here with ``catchup``."""
        self._enter_dispatch()
        try:
            self._on_timeout(cause)
        finally:
            self._exit_dispatch()

    def _on_timeout(self, cause: str) -> None:
        with self._lock:
            self.timeout_state = True
            self.to_view = max(self.to_view, self.view) + 1
            REGISTRY.counter_add(
                "fisco_pbft_view_change_total",
                help="view changes initiated (consensus timeouts + catch-ups)",
            )
            self.roundlog.view_change(
                self.committed_number + 1, self.view, self.to_view, cause
            )
            self._send_view_change()

    def _send_view_change(self) -> None:
        prepared_proposal = b""
        prepared_view = -1
        prepare_proof: list[bytes] = []
        prepared_qc = b""
        number = self.committed_number + 1
        cache = self._caches.get(number)
        if (
            cache is not None
            and cache.prepared
            and cache.block_data
            and cache.pre_prepare is not None
        ):
            prepared_proposal = cache.block_data
            prepared_view = cache.pre_prepare.view
            if cache.prepare_qc is not None:
                # constant-size proof: the prepare-quorum certificate
                # replaces the O(n) encoded-PREPARE list
                prepared_qc = cache.prepare_qc.encode()
            else:
                prepare_proof = [
                    m.encode()
                    for m in cache.prepares.values()
                    if m.proposal_hash == cache.pre_prepare.proposal_hash
                ]
        elif (
            self._recovered_prepared is not None
            and self._recovered_prepared[0] == number
        ):
            # prepared before a crash (durable prepared record + its quorum
            # certificate): re-offer it so the new leader can re-propose
            _n, prepared_view, prepared_proposal, prepare_proof = (
                self._recovered_prepared
            )
        payload = ViewChangePayload(
            committed_number=self.committed_number,
            prepared_view=prepared_view,
            prepared_proposal=prepared_proposal,
            prepare_proof=prepare_proof,
            prepared_qc=prepared_qc,
        )
        msg = PBFTMessage(
            packet_type=PacketType.VIEW_CHANGE,
            view=self.to_view,
            number=self.committed_number,
            payload=payload.encode(),
        )
        self._sign(msg)
        self._broadcast(msg)
        self._handle_view_change(msg)

    MAX_VIEW_AHEAD = 256  # waterline for view-change caches (like MAX_AHEAD)

    def _handle_view_change(self, msg: PBFTMessage) -> None:
        with self._lock:
            if msg.view <= self.view or msg.view > self.view + self.MAX_VIEW_AHEAD:
                return
            votes = self._view_changes.setdefault(msg.view, {})
            votes[msg.generated_from] = msg
            # catch up: if quorum forming for a higher view, join it
            if (
                not self.timeout_state
                and self._weight(votes) >= self.config.quorum
                and msg.view > self.to_view
            ):
                self.to_view = msg.view - 1
                self.on_timeout(cause="catchup")
                return
            if self._weight(votes) < self.config.quorum:
                return
            new_leader = self.config.leader_index(self.committed_number + 1, msg.view)
            if self.config.my_index != new_leader:
                return
            nv = PBFTMessage(
                packet_type=PacketType.NEW_VIEW,
                view=msg.view,
                number=self.committed_number,
                payload=NewViewPayload(
                    view_changes=[m.encode() for m in votes.values()]
                ).encode(),
            )
            self._sign(nv)
            self._broadcast(nv)
            self._lock_view_to_prepared(msg.view, list(votes.values()))
            self._enter_view_locked(msg.view)
            self._repropose_from(votes)

    def _handle_new_view(self, msg: PBFTMessage) -> None:
        with self._lock:
            if msg.view <= self.view:
                return
            if msg.generated_from != self.config.leader_index(
                self.committed_number + 1, msg.view
            ):
                return
            try:
                payload = NewViewPayload.decode(msg.payload)
                vcs = [PBFTMessage.decode(b) for b in payload.view_changes]
            except Exception:
                return
            weight = 0
            seen: set[int] = set()
            valid_vcs: list[PBFTMessage] = []
            for vc in vcs:
                node = self.config.node_at(vc.generated_from)
                if node is None or vc.generated_from in seen:
                    continue
                if vc.packet_type != PacketType.VIEW_CHANGE or vc.view != msg.view:
                    continue
                if not vc.verify(self.suite, node.node_id):
                    continue
                seen.add(vc.generated_from)
                weight += node.weight
                valid_vcs.append(vc)
            if weight < self.config.quorum:
                _log.warning("new-view %d with insufficient proof", msg.view)
                return
            self._lock_view_to_prepared(msg.view, valid_vcs)
            self._enter_view_locked(msg.view)

    def _verified_prepared(
        self, payload: ViewChangePayload
    ) -> tuple[int, Block, bytes] | None:
        """Validate a VC's prepared claim against its prepare-quorum
        certificate. Returns (prepared_view, block, proposal_hash) only when
        a weighted quorum of correctly-signed PREPAREs for exactly this
        proposal backs the claim — an unproven assertion is worthless."""
        if not payload.prepared_proposal:
            return None
        try:
            block = Block.decode(payload.prepared_proposal)
        except Exception:
            return None
        proposal_hash = block.header.hash(self.suite)
        if payload.prepared_qc and self._qc_active():
            # QC-mode proof: one aggregate verification over the carried
            # prepare certificate (committee-size-independent view-change
            # bandwidth); a bad cert falls through to the message proofs
            from .qc import verify_header_cert

            try:
                cert = QuorumCert.decode(payload.prepared_qc)
            except ValueError as e:
                note_swallowed("pbft.prepared_qc_decode", e)
            else:
                pre = vote_preimage(
                    self.suite,
                    PacketType.PREPARE,
                    payload.prepared_view,
                    block.header.number,
                    proposal_hash,
                )
                if (
                    cert.committee == self.config.committee_size
                    and sum(
                        self.config.weight_of(i) for i in cert.signers()
                    )
                    >= self.config.quorum
                    and verify_header_cert(cert, self.config.qc_pubs(), pre)
                ):
                    return payload.prepared_view, block, proposal_hash
        weight = 0
        seen: set[int] = set()
        for raw in payload.prepare_proof:
            try:
                pm = PBFTMessage.decode(raw)
            except Exception as e:
                # a malformed proof entry is byzantine-relevant: count it
                note_swallowed("pbft.prepare_proof_decode", e)
                continue
            if (
                pm.packet_type != PacketType.PREPARE
                or pm.view != payload.prepared_view
                or pm.number != block.header.number
                or pm.proposal_hash != proposal_hash
                or pm.generated_from in seen
            ):
                continue
            node = self.config.node_at(pm.generated_from)
            if node is None or not pm.verify(self.suite, node.node_id):
                continue
            seen.add(pm.generated_from)
            weight += node.weight
        if weight < self.config.quorum:
            return None
        return payload.prepared_view, block, proposal_hash

    def _lock_view_to_prepared(self, view: int, vcs: list[PBFTMessage]) -> None:
        """Bind the new view to the highest *proven* prepared proposal in the
        VC set: the new leader MUST re-propose it (a prepare quorum may mean
        some node already committed it — proposing anything else forks).
        Quorum intersection guarantees any valid 2f+1 VC set contains the
        prepared proposal of any block that committed anywhere."""
        best: tuple[int, Block, bytes] | None = None
        for m in vcs:
            try:
                p = ViewChangePayload.decode(m.payload)
            except Exception as e:
                note_swallowed("pbft.viewchange_decode", e)
                continue
            proven = self._verified_prepared(p)
            if proven is None and p.prepared_proposal:
                # a prepared CLAIM whose proof does not verify: honest
                # replicas only ever offer proposals with their real
                # prepare quorum attached, so a fabricated cert is an
                # attempt to steer the new view onto an unprepared block
                node = self.config.node_at(m.generated_from)
                record_evidence(
                    "fabricated_prepared_cert",
                    number=self.committed_number + 1,
                    view=m.view,
                    from_index=m.generated_from,
                    source=validator_source(node.node_id) if node else "",
                    detail="view-change prepared claim without a valid "
                    "prepare quorum",
                )
                self._gossip_offer(
                    "fabricated_prepared_cert",
                    number=self.committed_number + 1,
                    view=m.view,
                    offender=m.generated_from,
                    frames=[m],
                    detail="prepared claim whose proof fails quorum "
                    "re-verification",
                )
            if proven is not None and (best is None or proven[0] > best[0]):
                best = proven
        if best is None:
            self._view_locks.pop(view, None)
            return
        _view, block, proposal_hash = best
        self._view_locks[view] = (block.header.number, proposal_hash)

    def _enter_view_locked(self, view: int) -> None:
        self.roundlog.view_change(
            self.committed_number + 1, self.view, view, "entered"
        )
        self.view = view
        self.to_view = view
        self.timeout_state = False
        if self.cstore is not None:
            self.cstore.save_view(view)
        # votes from older views are void; proposals re-run under the new
        # view. Dropped (non-stable) proposals return their txs to the
        # sealable set — UNLESS the new view is locked to re-proposing
        # exactly that height's prepared proposal, whose txs must stay
        # sealed for the re-proposal
        lock = self._view_locks.get(view)
        for n, c in self._caches.items():
            if n > self.committed_number and c.stable:
                continue
            if c.block is None or (lock is not None and lock[0] == n):
                continue
            self.txpool.unseal(c.block.tx_hashes(self.suite))
        self._caches = {
            n: c for n, c in self._caches.items() if n > self.committed_number and c.stable
        }
        self._view_changes = {v: m for v, m in self._view_changes.items() if v > view}
        self._view_locks = {v: l for v, l in self._view_locks.items() if v >= view}
        if self.qc is not None:
            self.qc.reset_view(view)
        _log.info("entered view %d (leader=%s)", view,
                  self.config.leader_index(self.committed_number + 1, view))

    def _repropose_from(self, votes: dict[int, PBFTMessage]) -> None:
        """New leader re-proposes the highest *proven* prepared proposal."""
        best: tuple[int, Block, bytes] | None = None
        for m in votes.values():
            try:
                p = ViewChangePayload.decode(m.payload)
            except Exception as e:
                note_swallowed("pbft.viewchange_decode", e)
                continue
            proven = self._verified_prepared(p)
            if proven is not None and (best is None or proven[0] > best[0]):
                best = proven
        if best is None:
            return
        block = best[1]
        if block.header.number != self.committed_number + 1:
            return
        self.submit_proposal(block)

    # ------------------------------------------------------------------ sync

    def on_synced_block(self, number: int) -> None:
        """Block sync committed a block out-of-band: fast-forward consensus
        state (the reference's config->setCommittedProposal on sync)."""
        with self._lock:
            if number <= self.committed_number:
                return
            self.committed_number = number
            self._head_hash = self.ledger.block_hash_by_number(number) or b""
            self.timeout_state = False
            stale = [n for n in self._caches if n <= number]
            for n in stale:
                self._caches.pop(n)
            if self.qc is not None:
                self.qc.reset_below(number)
            self.config.reload(
                self.ledger.consensus_nodes(), active_at=number + 1
            )

    # ---------------------------------------------------------------- recover

    def _handle_recover_request(self, msg: PBFTMessage) -> None:
        with self._lock:
            node = self.config.node_at(msg.generated_from)
            if node is None:
                return
            resp = PBFTMessage(
                packet_type=PacketType.RECOVER_RESPONSE,
                view=self.view,
                number=self.committed_number,
            )
            self._sign(resp)
            self.front.send_message(ModuleID.PBFT, node.node_id, resp.encode())

    def _handle_recover_response(self, msg: PBFTMessage) -> None:
        with self._lock:
            self._recover_responses[msg.generated_from] = msg
            agreeing = {
                i: m for i, m in self._recover_responses.items() if m.view >= msg.view
            }
            if self._weight(agreeing) >= self.config.quorum and msg.view > self.view:
                self._recover_responses.clear()
                self._enter_view_locked(msg.view)

    def request_recover(self) -> None:
        with self._lock:
            msg = PBFTMessage(packet_type=PacketType.RECOVER_REQUEST, view=self.view,
                              number=self.committed_number)
            self._sign(msg)
            self._broadcast(msg)
