"""PBFT wire messages — every message is signed by its sender.

Reference: bcos-pbft/pbft/protocol/PB/*.proto + PBFTCodec.cpp:47 (sign on
encode, verify on decode — consensus messages are authenticated, not just
the proposals they carry). Packet types mirror PBFTEngine::handleMsg:603-673.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

from ..codec.flat import FlatReader, FlatWriter
from ..crypto.suite import CryptoSuite, KeyPair


class PacketType(IntEnum):
    PRE_PREPARE = 0x00
    PREPARE = 0x01
    COMMIT = 0x02
    VIEW_CHANGE = 0x03
    NEW_VIEW = 0x04
    CHECKPOINT = 0x05
    RECOVER_REQUEST = 0x06
    RECOVER_RESPONSE = 0x07


@dataclass
class PBFTMessage:
    """One consensus packet. `proposal_data` carries an encoded Block for
    PrePrepare / NewView; `proposal_hash` is the header hash being voted;
    `payload` carries nested encoded messages (view-change proofs)."""

    packet_type: PacketType = PacketType.PREPARE
    view: int = 0
    generated_from: int = 0  # sender's sealer index
    number: int = 0
    proposal_hash: bytes = b"\x00" * 32
    proposal_data: bytes = b""
    payload: bytes = b""
    signature: bytes = b""
    # QC-scheme vote signature over the shared vote preimage
    # (consensus/qc.vote_preimage; for checkpoints, the header hash) —
    # OUTSIDE the packet-signed fields, self-authenticating, and encoded
    # only when present so FISCO_QC=0 wire bytes stay byte-identical to
    # the pre-QC build
    qc_sig: bytes = b""

    def _signed_fields(self) -> bytes:
        w = FlatWriter()
        w.u8(int(self.packet_type))
        w.i64(self.view)
        w.i64(self.generated_from)
        w.i64(self.number)
        w.fixed(self.proposal_hash, 32)
        w.bytes_(self.proposal_data)
        w.bytes_(self.payload)
        return w.out()

    def hash(self, suite: CryptoSuite) -> bytes:
        return suite.hash(self._signed_fields())

    def sign(self, suite: CryptoSuite, kp: KeyPair) -> "PBFTMessage":
        self.signature = suite.signature_impl.sign(kp, self.hash(suite))
        return self

    def verify(self, suite: CryptoSuite, pub: bytes) -> bool:
        if not self.signature:
            return False
        try:
            return suite.signature_impl.verify(pub, self.hash(suite), self.signature)
        except Exception:
            return False

    def encode(self) -> bytes:
        w = FlatWriter()
        w.bytes_(self._signed_fields())
        w.bytes_(self.signature)
        if self.qc_sig:
            w.bytes_(self.qc_sig)
        return w.out()

    @classmethod
    def decode(cls, buf: bytes) -> "PBFTMessage":
        r = FlatReader(buf)
        inner = FlatReader(r.bytes_())
        msg = cls(
            packet_type=PacketType(inner.u8()),
            view=inner.i64(),
            generated_from=inner.i64(),
            number=inner.i64(),
            proposal_hash=inner.fixed(32),
            proposal_data=inner.bytes_(),
            payload=inner.bytes_(),
        )
        inner.done()
        msg.signature = r.bytes_()
        if not r.at_end():
            msg.qc_sig = r.bytes_()
        r.done()
        return msg


@dataclass
class ViewChangePayload:
    """Proof carried by ViewChange: the latest committed number plus any
    prepared-but-uncommitted proposal WITH its prepare-quorum certificate
    (PBFTViewChangeMsg analog). The certificate is what makes the claim
    trustworthy — an unproven "prepared" assertion from one replica must
    never influence the new view's proposal choice."""

    committed_number: int = 0
    prepared_view: int = -1
    prepared_proposal: bytes = b""  # encoded Block, or empty
    prepare_proof: list[bytes] = field(default_factory=list)  # encoded PREPAREs
    # constant-size alternative proof (QC mode): the encoded prepare-quorum
    # QuorumCert — view-change bandwidth independent of committee size.
    # Optional trailing section; absent = byte-identical legacy encoding.
    prepared_qc: bytes = b""

    def encode(self) -> bytes:
        w = FlatWriter()
        w.i64(self.committed_number)
        w.i64(self.prepared_view)
        w.bytes_(self.prepared_proposal)
        w.seq(self.prepare_proof, lambda w2, b: w2.bytes_(b))
        if self.prepared_qc:
            w.bytes_(self.prepared_qc)
        return w.out()

    @classmethod
    def decode(cls, buf: bytes) -> "ViewChangePayload":
        r = FlatReader(buf)
        p = cls(r.i64(), r.i64(), r.bytes_(), r.seq(lambda r2: r2.bytes_()))
        if not r.at_end():
            p.prepared_qc = r.bytes_()
        r.done()
        return p


@dataclass
class NewViewPayload:
    """NewView proof: the 2f+1 view-change messages justifying the view."""

    view_changes: list[bytes] = field(default_factory=list)  # encoded PBFTMessages

    def encode(self) -> bytes:
        w = FlatWriter()
        w.seq(self.view_changes, lambda w2, b: w2.bytes_(b))
        return w.out()

    @classmethod
    def decode(cls, buf: bytes) -> "NewViewPayload":
        r = FlatReader(buf)
        p = cls(r.seq(lambda r2: r2.bytes_()))
        r.done()
        return p
