"""Block header (the port's copy of the JAX package's
``protocol/block_header.py``).

Mirrors bcos-framework/protocol/BlockHeader.h and the BlockHeader tars struct:
the header hash is computed over the encoded header *without* the signature
list (signatures sign the header hash — that's what PBFT's QC is), matching
the reference's hash/signature split. The QC check over `signature_list` is
the #2 batch-verify hot loop (bcos-pbft/core/BlockValidator.cpp:141-177) and
goes to the device in consensus code.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..codec.flat import FlatReader, FlatWriter
from ..crypto.suite import CryptoSuite


@dataclass
class ParentInfo:
    number: int
    hash: bytes  # 32


@dataclass
class SignatureTuple:
    index: int  # sealer index in sealer_list
    signature: bytes


@dataclass
class BlockHeader:
    version: int = 0
    parent_info: list[ParentInfo] = field(default_factory=list)
    txs_root: bytes = b"\x00" * 32
    receipts_root: bytes = b"\x00" * 32
    state_root: bytes = b"\x00" * 32
    number: int = 0
    gas_used: int = 0
    timestamp: int = 0
    sealer: int = 0  # proposer index
    sealer_list: list[bytes] = field(default_factory=list)  # node pubkeys (64B)
    extra_data: bytes = b""
    consensus_weights: list[int] = field(default_factory=list)
    signature_list: list[SignatureTuple] = field(default_factory=list)
    # encoded consensus/qc.QuorumCert (opaque at this layer — the protocol
    # package must not import consensus): the constant-size replacement for
    # signature_list when aggregate QCs are active. Like signature_list it
    # sits OUTSIDE the hash preimage (it IS the signature over the hash),
    # and it encodes only when present, so FISCO_QC=0 headers stay
    # byte-identical to the pre-QC build.
    qc: bytes = b""
    # succinct state-plane commitment (merkle over the KeyPage state) — part
    # of the hash preimage, but encoded only when present so
    # FISCO_STATE_PROOF=0 headers stay byte-identical to the pre-succinct
    # build (the same optional-trailing-section pattern as `qc`)
    state_commitment: bytes = b""
    _hash: bytes | None = field(default=None, repr=False)

    def encode_hash_fields(self) -> bytes:
        """Everything except signature_list — the hash/sign preimage."""
        w = FlatWriter()
        w.u32(self.version)
        w.seq(
            self.parent_info,
            lambda w2, p: (w2.i64(p.number), w2.fixed(p.hash, 32)),
        )
        w.fixed(self.txs_root, 32)
        w.fixed(self.receipts_root, 32)
        w.fixed(self.state_root, 32)
        w.i64(self.number)
        w.u64(self.gas_used)
        w.i64(self.timestamp)
        w.i64(self.sealer)
        w.seq(self.sealer_list, lambda w2, s: w2.bytes_(s))
        w.bytes_(self.extra_data)
        w.seq(self.consensus_weights, lambda w2, x: w2.u64(x))
        if self.state_commitment:
            w.bytes_(self.state_commitment)
        return w.out()

    def encode(self) -> bytes:
        w = FlatWriter()
        w.bytes_(self.encode_hash_fields())
        w.seq(
            self.signature_list,
            lambda w2, s: (w2.i64(s.index), w2.bytes_(s.signature)),
        )
        if self.qc:
            w.bytes_(self.qc)
        return w.out()

    @classmethod
    def decode(cls, buf: bytes) -> "BlockHeader":
        r = FlatReader(buf)
        h = cls._decode_hash_fields(r.bytes_())
        h.signature_list = r.seq(
            lambda r2: SignatureTuple(r2.i64(), r2.bytes_())
        )
        if not r.at_end():
            h.qc = r.bytes_()
        r.done()
        return h

    @classmethod
    def _decode_hash_fields(cls, data: bytes) -> "BlockHeader":
        r = FlatReader(data)
        h = cls(
            version=r.u32(),
            parent_info=r.seq(lambda r2: ParentInfo(r2.i64(), r2.fixed(32))),
            txs_root=r.fixed(32),
            receipts_root=r.fixed(32),
            state_root=r.fixed(32),
            number=r.i64(),
            gas_used=r.u64(),
            timestamp=r.i64(),
            sealer=r.i64(),
            sealer_list=r.seq(lambda r2: r2.bytes_()),
            extra_data=r.bytes_(),
            consensus_weights=r.seq(lambda r2: r2.u64()),
        )
        if not r.at_end():
            h.state_commitment = r.bytes_()
        r.done()
        return h

    def hash(self, suite: CryptoSuite) -> bytes:
        if self._hash is None:
            self._hash = suite.hash(self.encode_hash_fields())
        return self._hash

    def clear_hash_cache(self) -> None:
        self._hash = None
