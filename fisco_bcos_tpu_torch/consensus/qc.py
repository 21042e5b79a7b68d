"""Quorum certificates — aggregate-signature vote admission for PBFT.

Replaces the per-vote signature checks and the O(n) committed
``signature_list`` (engine.py handle_message / BlockValidator
checkSignatureList analog) with one certificate per quorum:

- **Vote flow**: prepare/commit/checkpoint votes carry a second,
  QC-scheme signature (``PBFTMessage.qc_sig``) over a preimage every
  honest signer shares (phase ‖ view ‖ number ‖ proposal hash — for
  checkpoints, the executed header hash itself). Votes accumulate in the
  :class:`QuorumCollector` UNVERIFIED; when the weight threshold is met,
  ONE aggregate verification (BLS pairing through the DevicePlane, or one
  merged Ed25519 batch-verify) admits the whole quorum.
- **Isolation**: when an aggregate fails, the collector falls back to
  per-signer verification to name the bad vote, strikes the signer
  through the EXISTING admission-quota strike machinery
  (``txpool.quota``, group ``"consensus"``), and re-seals over the valid
  subset. A struck validator is demoted to the eager path — its future
  votes are verified individually before joining any aggregate — but is
  never excluded from consensus: vote packets are not sender-
  authenticated in fast-path QC mode, so a forged vote under a victim's
  index must only be able to cost the victim its fast path, never its
  vote (docs/consensus_qc.md).
- **Schemes**: ``FISCO_QC_SCHEME=ed25519`` (default — concatenated-sig
  certificate, one merged device batch-verify per quorum, O(n) bytes) or
  ``bls`` (BLS12-381 aggregate: constant 96-byte signature + bitmap, the
  committee-scale rung). ``FISCO_QC=0`` — or any committee member
  missing a registered ``qc_pub`` — keeps the exact per-signature path,
  bit-identical to the pre-QC build (tests/test_qc.py pins it).

Key registration: each node derives its QC keypair from its consensus
secret (:func:`derive_qc_keypair`); the committee's QC pubkeys live in
``ConsensusNode.qc_pub`` (the s_consensus table), which is the
proof-of-possession boundary that makes same-message BLS aggregation
rogue-key safe — a pubkey nobody holds the secret for never enters the
committee.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

from ..codec.flat import FlatReader, FlatWriter
from ..utils.log import get_logger
from ..utils.metrics import REGISTRY

_log = get_logger("qc")

# fisco_qc_verify_ms bucket contract: sub-ms host ed25519 batches up to
# multi-hundred-ms first-compile / tunneled pairing checks
QC_VERIFY_BUCKETS_MS = (0.5, 1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 1000.0)
# certificate sizes: ed25519 concatenated certs grow with the committee,
# BLS certs stay near 100 B — the split these buckets make visible
QC_BYTES_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)

STRIKE_GROUP = "consensus"  # quota-policer tenant the strike board lives in


def qc_enabled() -> bool:
    """Master switch, read per call (tests flip it mid-process). Default
    on — but the engine only activates QC when the WHOLE committee has
    registered qc_pubs (PBFTConfig.qc_ready), so legacy committees keep
    the exact per-signature path either way."""
    return os.environ.get("FISCO_QC", "1") != "0"


def qc_scheme_name() -> str:
    name = os.environ.get("FISCO_QC_SCHEME", "ed25519").strip().lower()
    return {"bls12_381": "bls", "bls12-381": "bls"}.get(name, name)


def vote_preimage(suite, packet_type: int, view: int, number: int, proposal_hash: bytes) -> bytes:
    """The 32-byte message every agreeing vote signs — identical across
    signers (the per-sender fields stay OUT of the preimage; that is what
    makes the votes aggregatable)."""
    w = FlatWriter()
    w.u8(int(packet_type))
    w.i64(view)
    w.i64(number)
    w.fixed(proposal_hash, 32)
    return suite.hash(w.out())


# ---------------------------------------------------------------------------
# Certificate record (the constant-size replacement for signature_list)
# ---------------------------------------------------------------------------

_SCHEME_IDS = {"ed25519": 1, "bls": 2}
_SCHEME_NAMES = {v: k for k, v in _SCHEME_IDS.items()}


@dataclass
class QuorumCert:
    """Aggregate signature + signer bitmap over a known committee order
    (the sorted sealer list both the header and PBFTConfig share)."""

    scheme: str = "ed25519"
    committee: int = 0  # committee size the bitmap is over
    bitmap: bytes = b""
    agg_sig: bytes = b""

    def signers(self) -> list[int]:
        out = []
        for i in range(self.committee):
            if i < len(self.bitmap) * 8 and (self.bitmap[i // 8] >> (i % 8)) & 1:
                out.append(i)
        return out

    @staticmethod
    def make_bitmap(idxs, committee: int) -> bytes:
        buf = bytearray((committee + 7) // 8)
        for i in idxs:
            if not 0 <= i < committee:
                raise ValueError(f"signer index {i} outside committee")
            buf[i // 8] |= 1 << (i % 8)
        return bytes(buf)

    def encode(self) -> bytes:
        w = FlatWriter()
        w.u8(_SCHEME_IDS[self.scheme])
        w.u32(self.committee)
        w.bytes_(self.bitmap)
        w.bytes_(self.agg_sig)
        return w.out()

    @classmethod
    def decode(cls, buf: bytes) -> "QuorumCert":
        r = FlatReader(buf)
        sid = r.u8()
        if sid not in _SCHEME_NAMES:
            raise ValueError(f"unknown QC scheme id {sid}")
        cert = cls(_SCHEME_NAMES[sid], r.u32(), r.bytes_(), r.bytes_())
        r.done()
        if len(cert.bitmap) != (cert.committee + 7) // 8:
            raise ValueError("QC bitmap length does not match committee")
        return cert


# ---------------------------------------------------------------------------
# Schemes
# ---------------------------------------------------------------------------


class QCScheme:
    """One vote-signature + aggregation backend. Vote signatures are over
    the 32-byte preimage; certificates verify against the committee's
    registered qc_pubs (indexed in committee order)."""

    name: str = ""
    pub_len: int = 0

    def derive_keypair(self, secret: int):
        raise NotImplementedError

    def sign_vote(self, kp, msg32: bytes) -> bytes:
        raise NotImplementedError

    def verify_one(self, qc_pub: bytes, msg32: bytes, sig: bytes) -> bool:
        raise NotImplementedError

    def build_cert(self, sig_by_idx: dict[int, bytes], committee: int) -> QuorumCert:
        raise NotImplementedError

    def verify_cert(self, cert: QuorumCert, qc_pubs: list[bytes], msg32: bytes) -> bool:
        raise NotImplementedError


class Ed25519QCScheme(QCScheme):
    """The cheap first rung: concatenated 64-byte signatures (O(n) cert
    bytes) admitted by ONE merged device/native batch-verify per quorum."""

    name = "ed25519"
    pub_len = 32
    sig_len = 64

    def __init__(self):
        from ..crypto.suite import Ed25519Crypto

        self._impl = Ed25519Crypto()

    def derive_keypair(self, secret: int):
        return self._impl.generate_keypair(secret=secret)

    def sign_vote(self, kp, msg32: bytes) -> bytes:
        return self._impl.sign(kp, msg32)[:64]  # R‖S; pub comes from the committee

    def verify_one(self, qc_pub: bytes, msg32: bytes, sig: bytes) -> bool:
        if len(sig) != 64 or len(qc_pub) != self.pub_len:
            return False
        return self._impl.verify(qc_pub, msg32, sig + qc_pub)

    def build_cert(self, sig_by_idx, committee) -> QuorumCert:
        idxs = sorted(sig_by_idx)
        return QuorumCert(
            scheme=self.name,
            committee=committee,
            bitmap=QuorumCert.make_bitmap(idxs, committee),
            agg_sig=b"".join(sig_by_idx[i] for i in idxs),
        )

    def verify_cert(self, cert, qc_pubs, msg32) -> bool:
        idxs = cert.signers()
        if len(cert.agg_sig) != 64 * len(idxs) or not idxs:
            return False
        if any(i >= len(qc_pubs) or not qc_pubs[i] for i in idxs):
            return False
        sigs = [
            cert.agg_sig[64 * k : 64 * (k + 1)] + qc_pubs[i]
            for k, i in enumerate(idxs)
        ]
        ok = self._impl.batch_verify(
            [msg32] * len(idxs), [qc_pubs[i] for i in idxs], sigs
        )
        return bool(ok.all())


class BLSQCScheme(QCScheme):
    """BLS12-381 aggregate certificates: 96-byte signature + bitmap,
    verification cost independent of committee size (one pairing check,
    dispatched through the DevicePlane on the caller's lane)."""

    name = "bls"
    pub_len = 48
    sig_len = 96

    def __init__(self):
        from ..crypto.bls import BLSCrypto

        self._impl = BLSCrypto()

    def derive_keypair(self, secret: int):
        return self._impl.generate_keypair(secret=secret)

    def sign_vote(self, kp, msg32: bytes) -> bytes:
        return self._impl.sign(kp, msg32)

    def verify_one(self, qc_pub: bytes, msg32: bytes, sig: bytes) -> bool:
        return self._impl.verify(qc_pub, msg32, sig)

    def build_cert(self, sig_by_idx, committee) -> QuorumCert:
        idxs = sorted(sig_by_idx)
        return QuorumCert(
            scheme=self.name,
            committee=committee,
            bitmap=QuorumCert.make_bitmap(idxs, committee),
            agg_sig=self._impl.aggregate([sig_by_idx[i] for i in idxs]),
        )

    def verify_cert(self, cert, qc_pubs, msg32) -> bool:
        idxs = cert.signers()
        if not idxs or len(cert.agg_sig) != 96:
            return False
        if any(i >= len(qc_pubs) or not qc_pubs[i] for i in idxs):
            return False
        return self._impl.aggregate_verify(
            [qc_pubs[i] for i in idxs], msg32, cert.agg_sig
        )


_SCHEMES: dict[str, QCScheme] = {}
_SCHEMES_LOCK = threading.Lock()


def get_scheme(name: str | None = None) -> QCScheme:
    name = name or qc_scheme_name()
    if name not in _SCHEME_IDS:
        raise ValueError(f"unknown QC scheme {name!r} (know: {sorted(_SCHEME_IDS)})")
    if name not in _SCHEMES:
        with _SCHEMES_LOCK:
            if name not in _SCHEMES:
                _SCHEMES[name] = (
                    Ed25519QCScheme() if name == "ed25519" else BLSQCScheme()
                )
    return _SCHEMES[name]


def derive_qc_keypair(secret: int, scheme: str | None = None):
    """The node's QC keypair, deterministically derived from its consensus
    secret — chain builders compute every member's qc_pub the same way."""
    return get_scheme(scheme).derive_keypair(secret)


def qc_pub_for(secret: int, scheme: str | None = None) -> bytes:
    return derive_qc_keypair(secret, scheme).pub


# ---------------------------------------------------------------------------
# The vote accumulator
# ---------------------------------------------------------------------------


@dataclass
class _Pending:
    """Unverified qc_sigs for one (phase, number, view, hash) key."""

    sigs: dict[int, bytes] = field(default_factory=dict)
    sealed: "QuorumCert | None" = None


class QuorumCollector:
    """Accumulates unverified vote signatures and admits whole quorums by
    aggregate verification, isolating bad votes when an aggregate fails.

    Thread-safe on its own lock (view-change resets and the race harness
    drive it concurrently). Scheme verification runs OUTSIDE the
    collector's lock, and — since the engine moved quorum admission onto
    its off-lock verify queue (snapshot under the engine lock, aggregate
    check without it, double-gate re-check before completion; see
    ``PBFTEngine._run_verify_job``) — outside the engine lock too: a
    slow pairing never parks ``handle_message``."""

    MAX_KEYS = 4096  # waterline backstop (engine prunes by number anyway)

    def __init__(self, suite, scheme: QCScheme | None = None):
        self.suite = suite
        self.scheme = scheme or get_scheme()
        # optional qc_pub -> strike-board source tag (see _strike_source)
        self.strike_tagger = None
        self._lock = threading.Lock()
        self._pending: dict[tuple, _Pending] = {}
        # stats (mutated under _lock; read by stats()/harness)
        self.votes = 0
        self.aggregates = 0
        self.fallbacks = 0
        self.bad_votes = 0
        self.sealed = 0

    # -- votes ---------------------------------------------------------------

    def add_vote(
        self, key: tuple, idx: int, sig: bytes, replace: bool = True
    ) -> None:
        """Accumulate one unverified vote signature. ``replace=False``
        (unauthenticated fast-path arrivals) makes a DIFFERING signature
        unable to evict a cached one — in fast-path QC mode vote packets
        are not sender-authenticated, and last-write-wins would let a
        forger replace a victim's genuine vote and get it struck out of
        the quorum; the engine authenticates conflicting newcomers and
        passes ``replace=True`` for the ones that prove themselves."""
        if not sig:
            return
        with self._lock:
            if len(self._pending) >= self.MAX_KEYS and key not in self._pending:
                return
            sigs = self._pending.setdefault(key, _Pending()).sigs
            if idx in sigs and sigs[idx] != sig and not replace:
                return
            sigs[idx] = bytes(sig)
            self.votes += 1

    def drop_vote(self, key: tuple, idx: int) -> None:
        with self._lock:
            p = self._pending.get(key)
            if p is not None:
                p.sigs.pop(idx, None)

    def reset_below(self, number: int) -> None:
        """Commit/sync pruning: forget keys at or below the height."""
        with self._lock:
            for k in [k for k in self._pending if k[1] <= number]:
                del self._pending[k]

    # checkpoint keys sign the executed header hash (viewless preimage) —
    # they survive view changes; keys carry phase 0x05 = PacketType.CHECKPOINT
    CHECKPOINT_PHASE = 0x05

    def reset_view(self, view: int) -> None:
        """View change: prepare/commit votes from older views are void
        (checkpoint votes bind the executed header, not the view)."""
        with self._lock:
            for k in [
                k
                for k in self._pending
                if k[2] < view and k[0] != self.CHECKPOINT_PHASE
            ]:
                del self._pending[k]

    def stats(self) -> dict:
        with self._lock:
            return {
                "votes": self.votes,
                "aggregates": self.aggregates,
                "fallbacks": self.fallbacks,
                "bad_votes": self.bad_votes,
                "sealed": self.sealed,
                "pending_keys": len(self._pending),
            }

    # -- strikes (the existing admission-quota machinery) ---------------------
    # keyed by the signer's registered QC pubkey, NOT its committee index:
    # committee reloads reorder the sorted node list at every membership
    # change, and an index-keyed penalty would transfer to whichever node
    # inherits the index while the offender walks free. The engine installs
    # ``strike_tagger`` (qc_pub -> the member's node-id source tag,
    # audit.validator_source) so QC isolation strikes and byzantine-message
    # evidence strikes land under ONE board source and combine toward the
    # demotion threshold; the qc_pub-hex tag is only the standalone fallback.

    def _strike_source(self, qc_pub: bytes) -> str:
        tagger = self.strike_tagger
        if tagger is not None:
            tag = tagger(qc_pub)
            if tag:
                return tag
        return f"validator:{bytes(qc_pub).hex()[:16]}"

    def _demoted(self, qc_pub: bytes) -> bool:
        if not qc_pub:
            return False
        from ..txpool.quota import get_quotas

        quotas = get_quotas()
        # hot path (engine probes every QC vote): lock-free emptiness peek;
        # the locked probe and the tag only materialize while someone is
        # actually in the penalty box
        if not quotas.any_demoted(STRIKE_GROUP):
            return False
        return quotas.demoted(STRIKE_GROUP, self._strike_source(qc_pub))

    def _strike(self, qc_pub: bytes) -> None:
        if not qc_pub:
            return  # no registered identity to hold accountable
        from ..txpool.quota import get_quotas

        get_quotas().note_invalid(STRIKE_GROUP, self._strike_source(qc_pub), 1)
        REGISTRY.counter_add(
            "fisco_qc_bad_votes_total",
            1.0,
            help="votes that failed per-signer isolation after an aggregate "
            "verification failure (feeds the quota strike board)",
        )

    # -- quorum admission ------------------------------------------------------

    def admit(
        self,
        key: tuple,
        msg32: bytes,
        candidates: dict[int, bytes] | None,
        qc_pubs: list[bytes],
        weight_of,
        quorum: int,
        authenticated_fn=None,
    ) -> tuple[set, set, "QuorumCert | None"]:
        """Admit a quorum: aggregate-verify the candidate votes (by default
        everything accumulated for `key`), isolating bad votes on failure.

        Returns ``(valid_indices, bad_indices, cert)`` — cert is None when
        the valid weight is below quorum (either still waiting for votes,
        or isolation removed too much). Bad votes are dropped from the
        accumulator and struck — the caller prunes its own vote cache from
        ``bad_indices``; votes from already-demoted signers are eagerly
        verified BEFORE joining the aggregate (the fast path is all a
        forged vote can cost its victim).

        ``authenticated_fn(idx) -> bool`` (optional) tells the collector
        whether a bad vote's PACKET was sender-authenticated: only
        authenticated bad votes strike — a forged packet under a victim's
        index is dropped and counted, never charged to the victim."""
        with self._lock:
            p = self._pending.get(key)
            if candidates is None:
                candidates = dict(p.sigs) if p is not None else {}
            else:
                candidates = dict(candidates)
            if p is not None and p.sealed is not None:
                sealed = p.sealed
                if set(sealed.signers()) >= set(candidates):
                    return set(sealed.signers()), set(), sealed
        if not candidates:
            return set(), set(), None
        if sum(weight_of(i) for i in candidates) < quorum:
            return set(), set(), None

        from ..observability import TRACER
        from ..observability.pipeline import PIPELINE

        eager_bad: set[int] = set()
        trusted = dict(candidates)
        for idx in list(trusted):
            if idx >= len(qc_pubs) or not qc_pubs[idx]:
                del trusted[idx]
                eager_bad.add(idx)
                continue
            if self._demoted(qc_pubs[idx]):
                # eager rung: a demoted signer's vote is verified alone
                if not self.scheme.verify_one(
                    qc_pubs[idx], msg32, trusted[idx]
                ):
                    del trusted[idx]
                    eager_bad.add(idx)
        valid = dict(trusted)
        cert: QuorumCert | None = None
        if valid and sum(weight_of(i) for i in valid) >= quorum:
            with TRACER.span("qc.aggregate", scheme=self.scheme.name, n=len(valid)):
                cert = self.scheme.build_cert(valid, len(qc_pubs))
            t0 = time.perf_counter()
            with TRACER.span(
                "qc.verify", scheme=self.scheme.name, n=len(valid)
            ), PIPELINE.blocked("device_plane.qc"):
                ok = self.scheme.verify_cert(cert, qc_pubs, msg32)
            self._observe_verify(t0, cert)
            with self._lock:
                self.aggregates += 1
            if not ok:
                # isolation: name the bad vote(s), strike, re-seal
                with self._lock:
                    self.fallbacks += 1
                REGISTRY.counter_add(
                    "fisco_qc_aggregate_fallback_total",
                    1.0,
                    help="aggregate QC verifications that failed and fell "
                    "back to per-signer isolation",
                )
                bad = set()
                with PIPELINE.blocked("device_plane.qc"):
                    for idx, sig in valid.items():
                        if not self.scheme.verify_one(qc_pubs[idx], msg32, sig):
                            bad.add(idx)
                for idx in bad:
                    del valid[idx]
                eager_bad |= bad
                cert = None
                if valid and sum(weight_of(i) for i in valid) >= quorum:
                    with TRACER.span(
                        "qc.aggregate", scheme=self.scheme.name, n=len(valid)
                    ):
                        cert = self.scheme.build_cert(valid, len(qc_pubs))
        else:
            cert = None

        with self._lock:
            self.bad_votes += len(eager_bad)
            p = self._pending.get(key)
            if p is not None:
                for idx in eager_bad:
                    p.sigs.pop(idx, None)
            if cert is not None:
                self.sealed += 1
                if p is not None:
                    p.sealed = cert
        self._strike_or_drop(eager_bad, qc_pubs, authenticated_fn)
        return set(valid), eager_bad, cert

    def _strike_or_drop(self, bad, qc_pubs, authenticated_fn) -> None:
        from .audit import record_evidence

        for idx in bad:
            if authenticated_fn is None or authenticated_fn(idx):
                pub = qc_pubs[idx] if 0 <= idx < len(qc_pubs) else b""
                self._strike(pub)
                # strike=False: _strike above already filed the quota
                # strike — evidence records the detection without
                # double-charging the offender
                record_evidence(
                    "bad_qc_vote",
                    from_index=idx,
                    source=self._strike_source(pub) if pub else "",
                    detail="authenticated vote failed QC verification",
                    strike=False,
                )
                _log.warning(
                    "qc: vote from validator %d failed verification (struck)",
                    idx,
                )
            else:
                # the packet does not even authenticate as its claimed
                # sender: forgery, not misbehavior — drop without penalty
                REGISTRY.counter_add(
                    "fisco_qc_forged_votes_total",
                    1.0,
                    help="fast-path vote packets whose qc signature failed "
                    "AND whose packet signature does not authenticate the "
                    "claimed sender (dropped, victim not struck)",
                )
                # unattributable by design (no source, no strike): the
                # forger hid behind the victim's index — the record keeps
                # the detection visible without charging anyone
                record_evidence(
                    "forged_qc_vote",
                    from_index=idx,
                    detail="vote does not authenticate as its claimed "
                    "sender",
                    strike=False,
                )
                _log.warning(
                    "qc: dropping forged vote claiming validator %d", idx
                )

    def verify_votes(
        self,
        votes: dict[int, bytes],
        msg32: bytes,
        qc_pubs: list[bytes],
        authenticated_fn=None,
    ) -> set:
        """Individually verify a vote set (the mixed-mode rescue path:
        combining qc votes with legacy-verified ones when neither subset
        alone is quorate). Failures are struck like isolation failures,
        under the same authentication gate."""
        good: set[int] = set()
        bad: set[int] = set()
        for idx, sig in votes.items():
            if (
                0 <= idx < len(qc_pubs)
                and qc_pubs[idx]
                and self.scheme.verify_one(qc_pubs[idx], msg32, sig)
            ):
                good.add(idx)
            else:
                bad.add(idx)
        with self._lock:
            self.bad_votes += len(bad)
        self._strike_or_drop(bad, qc_pubs, authenticated_fn)
        return good

    def is_demoted(self, qc_pub: bytes) -> bool:
        """Exposed for the engine's receive path: a demoted validator's
        packets get eager outer authentication instead of the unverified
        fast path."""
        return self._demoted(qc_pub)

    def _observe_verify(self, t0: float, cert: QuorumCert) -> None:
        REGISTRY.observe(
            "fisco_qc_verify_ms",
            (time.perf_counter() - t0) * 1e3,
            buckets=QC_VERIFY_BUCKETS_MS,
            help="aggregate QC verification wall time per quorum",
            scheme=cert.scheme,
        )
        REGISTRY.observe(
            "fisco_qc_bytes",
            float(len(cert.encode())),
            buckets=QC_BYTES_BUCKETS,
            help="encoded quorum-certificate size",
            scheme=cert.scheme,
        )


def verify_header_cert(cert: QuorumCert, qc_pubs: list[bytes], msg32: bytes) -> bool:
    """Sync/lightnode-side certificate check (no accumulator): one
    aggregate verification, instrumented like the collector's."""
    from ..observability import TRACER
    from ..observability.pipeline import PIPELINE

    scheme = get_scheme(cert.scheme)
    t0 = time.perf_counter()
    with TRACER.span("qc.verify", scheme=cert.scheme, n=len(cert.signers())), \
            PIPELINE.blocked("device_plane.qc"):
        ok = scheme.verify_cert(cert, qc_pubs, msg32)
    REGISTRY.observe(
        "fisco_qc_verify_ms",
        (time.perf_counter() - t0) * 1e3,
        buckets=QC_VERIFY_BUCKETS_MS,
        help="aggregate QC verification wall time per quorum",
        scheme=cert.scheme,
    )
    return ok
