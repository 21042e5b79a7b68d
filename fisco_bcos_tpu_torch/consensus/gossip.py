"""Evidence gossip: byzantine detections propagate to the whole committee.

A single honest node detecting an offense (equivocation,
conflicting votes, a fabricated prepared-cert, a bad QC vote) demotes the
offender LOCALLY — but demotion is only a committee property if every
honest node converges on it (ByzCoin's collective-detection insight:
per-node views of an offender diverge exactly when the offender wants
them to). :class:`EvidenceGossip` re-broadcasts signed, self-attributing
evidence records over ``ModuleID.EVIDENCE_GOSSIP`` so detection made
anywhere strikes everywhere, within a bounded number of re-broadcast
rounds (the record's TTL).

Forgery safety is the design center: **a gossiped record never strikes on
the gossiper's say-so**. The record embeds the offending frames
themselves, and a receiver re-verifies them locally — the offender's own
signatures over contradictory content are the proof, making records
self-attributing. A fabricated record naming an honest victim fails frame
re-verification and strikes nobody (the fabricator gets its record
dropped; its reporter signature makes the spam attributable). Replay/
amplification is bounded by a seen-set (one strike and at most one
forward per record per node) and the TTL budget.

Gossiped kinds are exactly the PROVABLE ones: a frame set that convicts
the offender by signature alone. ``stale_view_replay`` (indistinguishable
from honest lag) and ``forged_qc_vote`` (the frame does NOT authenticate
as its claimed sender, so there is nobody to convict) never gossip.
"""

from __future__ import annotations

import json
import threading
from collections import deque

from ..front.front import ModuleID
from ..utils.log import get_logger, note_swallowed
from ..utils.metrics import REGISTRY
from .audit import record_evidence, validator_source
from .messages import PacketType, PBFTMessage, ViewChangePayload

_log = get_logger("evidence-gossip")

# offenses a frame set can prove to a third party
GOSSIPABLE = (
    "equivocation",
    "vote_conflict",
    "fabricated_prepared_cert",
    "bad_qc_vote",
)

VOTE_TYPES = (PacketType.PREPARE, PacketType.COMMIT, PacketType.CHECKPOINT)

DEFAULT_TTL = 3  # re-broadcast rounds: enough for any connected mesh n<=64
MAX_SEEN = 4096  # bounded dedup memory (records + offense keys)


def _counter(name: str) -> None:
    REGISTRY.counter_add(
        f'fisco_evidence_gossip_total{{event="{name}"}}',
        help="evidence-gossip records by outcome (received, confirmed, "
        "rejected, forwarded, duplicate, published)",
    )


class EvidenceGossip:
    """One node's gossip endpoint: publishes local detections, re-verifies
    and re-publishes remote ones. Registered on the node's front at
    construction."""

    def __init__(self, engine, front, keypair, ttl: int = DEFAULT_TTL):
        self.engine = engine
        self.front = front
        self.keypair = keypair
        self.ttl = int(ttl)
        self._lock = threading.Lock()
        self._seen: set[bytes] = set()  # record ids (hash of signed body)
        self._seen_order: deque[bytes] = deque()
        # offense key -> already struck here (one strike per offense per
        # node, however many distinct records describe it)
        self._offenses: set[tuple] = set()
        self._offense_order: deque[tuple] = deque()
        # confirmed offender node ids (hex) — the convergence witness the
        # fleet endpoint exports
        self.confirmed_offenders: set[str] = set()
        self.stats = {
            "published": 0, "received": 0, "confirmed": 0,
            "rejected": 0, "forwarded": 0, "duplicates": 0,
        }
        front.register_module(ModuleID.EVIDENCE_GOSSIP, self._on_message)

    # -- publishing local detections -------------------------------------

    def offer(
        self,
        kind: str,
        *,
        number: int,
        view: int,
        offender: int,
        frames: list[PBFTMessage],
        detail: str = "",
    ) -> None:
        """Publish a LOCAL detection (the engine already recorded and
        struck it): wrap the offending frames in a signed record and
        broadcast. ``offender`` is the committee index at detection time;
        the record carries the stable node id."""
        if kind not in GOSSIPABLE:
            return
        node = self.engine.config.node_at(offender)
        if node is None:
            return
        body = {
            "kind": kind,
            "number": int(number),
            "view": int(view),
            "offender": bytes(node.node_id).hex(),
            "reporter": bytes(self.keypair.pub).hex(),
            "frames": [m.encode().hex() for m in frames],
            "detail": detail,
        }
        blob = json.dumps(body, sort_keys=True).encode()
        suite = self.engine.suite
        sig = suite.signature_impl.sign(self.keypair, suite.hash(blob))
        rid = suite.hash(blob)
        okey = (kind, int(number), int(view), body["offender"])
        with self._lock:
            if okey in self._offenses:
                return  # already published (or received) this offense
            self._remember_seen(rid)
            self._remember_offense(okey)  # local strike already filed
            self.confirmed_offenders.add(body["offender"])
            self.stats["published"] += 1
        _counter("published")
        self._send(blob, sig, self.ttl)

    def _send(self, blob: bytes, sig: bytes, ttl: int) -> None:
        env = json.dumps(
            {"body": blob.hex(), "sig": sig.hex(), "ttl": int(ttl)}
        ).encode()
        self.front.broadcast(ModuleID.EVIDENCE_GOSSIP, env)

    # -- receiving -------------------------------------------------------

    def _on_message(self, src: bytes, payload: bytes) -> None:
        try:
            env = json.loads(payload)
            blob = bytes.fromhex(env["body"])
            sig = bytes.fromhex(env["sig"])
            ttl = int(env["ttl"])
            body = json.loads(blob)
            kind = body["kind"]
            number, view = int(body["number"]), int(body["view"])
            offender_id = bytes.fromhex(body["offender"])
            reporter_id = bytes.fromhex(body["reporter"])
            frames = [
                PBFTMessage.decode(bytes.fromhex(f)) for f in body["frames"]
            ]
        except Exception as e:
            note_swallowed("gossip.decode", e)
            self._reject("undecodable")
            return
        suite = self.engine.suite
        rid = suite.hash(blob)
        with self._lock:
            if rid in self._seen:
                self.stats["duplicates"] += 1
                _counter("duplicate")
                return
            self._remember_seen(rid)
            self.stats["received"] += 1
        _counter("received")
        config = self.engine.config
        if kind not in GOSSIPABLE:
            self._reject("kind")
            return
        # the reporter must be a committee member and must have signed the
        # record — NOT because we trust it (we don't; the frames must
        # re-verify), but so gossip spam is attributable and non-members
        # cannot inject load
        if config.index_of(reporter_id) is None or not suite.signature_impl.verify(
            reporter_id, suite.hash(blob), sig
        ):
            self._reject("reporter")
            return
        offender_idx = config.index_of(offender_id)
        if offender_idx is None:
            self._reject("offender-unknown")
            return
        if not self._confirm(kind, number, view, offender_idx, frames):
            self._reject("frames")
            return
        okey = (kind, number, view, body["offender"])
        with self._lock:
            fresh = okey not in self._offenses
            if fresh:
                self._remember_offense(okey)
            self.confirmed_offenders.add(body["offender"])
            self.stats["confirmed"] += 1
        _counter("confirmed")
        if fresh:
            record_evidence(
                kind,
                number=number,
                view=view,
                from_index=offender_idx,
                source=validator_source(offender_id),
                detail=f"gossiped by {reporter_id.hex()[:8]}: "
                + (body.get("detail") or ""),
            )
        # forward once, while the TTL budget lasts — the seen-set stops
        # echo amplification, the TTL bounds convergence rounds
        if ttl > 1:
            with self._lock:
                self.stats["forwarded"] += 1
            _counter("forwarded")
            self._send(blob, sig, ttl - 1)

    def _reject(self, why: str) -> None:
        with self._lock:
            self.stats["rejected"] += 1
        _counter("rejected")
        _log.warning("gossiped evidence rejected (%s)", why)

    # -- local re-verification (the forgery gate) ------------------------

    def _confirm(
        self,
        kind: str,
        number: int,
        view: int,
        offender_idx: int,
        frames: list[PBFTMessage],
    ) -> bool:
        """Do the embedded frames PROVE the offense against the offender,
        verified with OUR OWN keys and committee view? Every path here
        requires the offender's outer signature on the frames — the
        offense convicts itself or the record is worthless."""
        try:
            if kind == "equivocation":
                return self._confirm_equivocation(
                    number, view, offender_idx, frames
                )
            if kind == "vote_conflict":
                return self._confirm_vote_conflict(
                    number, view, offender_idx, frames
                )
            if kind == "fabricated_prepared_cert":
                return self._confirm_fabricated_cert(offender_idx, frames)
            if kind == "bad_qc_vote":
                return self._confirm_bad_qc_vote(offender_idx, frames)
        except Exception as e:
            note_swallowed("gossip.confirm", e)
        return False

    def _authentic(self, m: PBFTMessage, offender_idx: int) -> bool:
        node = self.engine.config.node_at(offender_idx)
        return (
            node is not None
            and m.generated_from == offender_idx
            and m.verify(self.engine.suite, node.node_id)
        )

    def _confirm_equivocation(self, number, view, offender_idx, frames):
        """Two signed PRE_PREPAREs at one (number, view) with different
        proposal hashes, from the slot's proven leader."""
        if len(frames) != 2:
            return False
        a, b = frames
        if not (
            a.packet_type == b.packet_type == PacketType.PRE_PREPARE
            and a.number == b.number == number
            and a.view == b.view == view
            and a.proposal_hash != b.proposal_hash
        ):
            return False
        if self.engine.config.leader_index(number, view) != offender_idx:
            return False
        return self._authentic(a, offender_idx) and self._authentic(b, offender_idx)

    def _confirm_vote_conflict(self, number, view, offender_idx, frames):
        """One signer, two signed votes of the same phase at one
        (number, view), different proposal hashes."""
        if len(frames) != 2:
            return False
        a, b = frames
        if not (
            a.packet_type == b.packet_type
            and a.packet_type in VOTE_TYPES
            and a.number == b.number == number
            and a.view == b.view == view
            and a.proposal_hash != b.proposal_hash
        ):
            return False
        return self._authentic(a, offender_idx) and self._authentic(b, offender_idx)

    def _confirm_fabricated_cert(self, offender_idx, frames):
        """A signed VIEW_CHANGE claiming a prepared proposal whose
        attached proof does NOT verify as a prepare quorum."""
        if len(frames) != 1:
            return False
        (m,) = frames
        if m.packet_type != PacketType.VIEW_CHANGE:
            return False
        if not self._authentic(m, offender_idx):
            return False
        try:
            payload = ViewChangePayload.decode(m.payload)
        except Exception:
            return False
        if not payload.prepared_proposal:
            return False
        return self.engine._verified_prepared(payload) is None

    def _confirm_bad_qc_vote(self, offender_idx, frames):
        """A signed vote whose qc signature fails the scheme against the
        offender's registered qc_pub (the QC collector's isolation
        offense, provable to any third party)."""
        if len(frames) != 1:
            return False
        (m,) = frames
        if m.packet_type not in VOTE_TYPES or not m.qc_sig:
            return False
        if not self._authentic(m, offender_idx):
            return False
        if not self.engine._qc_active() or self.engine.qc is None:
            return False
        node = self.engine.config.node_at(offender_idx)
        if node is None or not node.qc_pub:
            return False
        pre = self.engine._vote_msg32(m)
        return not self.engine.qc.scheme.verify_one(node.qc_pub, pre, m.qc_sig)

    # -- bounded memory ---------------------------------------------------

    def _remember_seen(self, rid: bytes) -> None:
        self._seen.add(rid)
        self._seen_order.append(rid)
        while len(self._seen_order) > MAX_SEEN:
            self._seen.discard(self._seen_order.popleft())

    def _remember_offense(self, okey: tuple) -> None:
        self._offenses.add(okey)
        self._offense_order.append(okey)
        while len(self._offense_order) > MAX_SEEN:
            self._offenses.discard(self._offense_order.popleft())

    # -- observability ----------------------------------------------------

    def snapshot(self) -> dict:
        """This node's convergence row (federated via the fleet endpoint):
        counters plus the offenders THIS node has locally confirmed."""
        with self._lock:
            return {
                **self.stats,
                "offenses": len(self._offenses),
                "offenders": sorted(self.confirmed_offenders),
            }
