"""Transaction protocol object (the port's copy of the JAX package's
``protocol/transaction.py``: the same bytes, hashes on the port's suite).

Field set mirrors the reference's TransactionData/Transaction tars structs
(bcos-tars-protocol/tars/Transaction.tars) and the framework interface
(bcos-framework/protocol/Transaction.h): the *signed payload* is the encoded
TransactionData (version, chainID, groupID, blockLimit, nonce, to, input,
abi); the tx hash is hash(payload); `verify()` recovers the sender from the
signature over that hash (Transaction.h:64-84). Batch admission for whole
blocks lives in txpool (one fused device program) — this object's single-item
verify is the low-latency RPC path.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import IntFlag

from ..codec.flat import FlatReader, FlatWriter
from ..crypto.suite import CryptoSuite, KeyPair


class TransactionAttribute(IntFlag):
    """bcos-framework/protocol/Transaction.h:45-51."""

    EVM_ABI_CODEC = 0x1
    LIQUID_SCALE_CODEC = 0x2
    DAG = 0x4
    LIQUID_CREATE = 0x8


@dataclass
class Transaction:
    version: int = 0
    chain_id: str = ""
    group_id: str = ""
    block_limit: int = 0
    nonce: str = ""
    to: bytes = b""  # 20-byte address, or b"" for create
    input: bytes = b""
    abi: str = ""
    # signature part
    signature: bytes = b""
    # mutable/annotation part (not hashed, not signed)
    attribute: int = 0
    import_time: int = 0
    extra_data: bytes = b""
    # caches
    _hash: bytes | None = field(default=None, repr=False)
    _data: bytes | None = field(default=None, repr=False)
    _wire: bytes | None = field(default=None, repr=False)
    sender: bytes = b""  # recovered 20-byte address ("forceSender" cache)

    # -- canonical bytes ----------------------------------------------------

    def encode_data(self) -> bytes:
        """The signed payload (TransactionData analog) — the hash preimage.

        Cached: the data fields are immutable once a tx is signed (only the
        signature/annotation section changes), and the block path encodes
        every tx three times (admission hash, sealing, ledger prewrite)."""
        if self._data is not None:
            return self._data
        w = FlatWriter()
        w.u32(self.version)
        w.str_(self.chain_id)
        w.str_(self.group_id)
        w.i64(self.block_limit)
        w.str_(self.nonce)
        w.bytes_(self.to)
        w.bytes_(self.input)
        w.str_(self.abi)
        self._data = w.out()
        return self._data

    def encode(self) -> bytes:
        """Full wire form: payload + signature + annotations. Cached: a tx
        is immutable once signed, and the block path serializes it again
        at pool persistence, gossip, and ledger prewrite — the zero-copy
        tx path decodes once at admission and every later stage reuses
        these exact bytes."""
        if self._wire is not None:
            return self._wire
        w = FlatWriter()
        w.bytes_(self.encode_data())
        w.bytes_(self.signature)
        w.u32(self.attribute)
        w.i64(self.import_time)
        w.bytes_(self.extra_data)
        self._wire = w.out()
        return self._wire

    @classmethod
    def decode(cls, buf: bytes) -> "Transaction":
        r = FlatReader(buf)
        data = r.bytes_()
        tx = cls._decode_data(data)
        # seed the payload cache with the EXACT bytes that were signed —
        # the first hash is free, and re-encoding canonicality never matters
        tx._data = data
        tx.signature = r.bytes_()
        tx.attribute = r.u32()
        tx.import_time = r.i64()
        tx.extra_data = r.bytes_()
        r.done()
        # the ingress bytes ARE the wire form: re-encoding a gossiped /
        # persisted tx is free from here on
        tx._wire = bytes(buf)
        return tx

    def invalidate_caches(self) -> None:
        """Drop the payload/hash/wire caches after mutating a data field
        (test fixtures forging variants; production txs are immutable once
        signed). One helper so no site can null one cache but not the
        others. Mutating only the signature/annotation section requires
        dropping just the wire cache — sign() does."""
        self._hash = None
        self._data = None
        self._wire = None

    @classmethod
    def _decode_data(cls, data: bytes) -> "Transaction":
        r = FlatReader(data)
        tx = cls(
            version=r.u32(),
            chain_id=r.str_(),
            group_id=r.str_(),
            block_limit=r.i64(),
            nonce=r.str_(),
            to=r.bytes_(),
            input=r.bytes_(),
            abi=r.str_(),
        )
        r.done()
        return tx

    # -- hashing / signing --------------------------------------------------

    def hash(self, suite: CryptoSuite) -> bytes:
        if self._hash is None:
            self._hash = suite.hash(self.encode_data())
        return self._hash

    def sign(self, kp: KeyPair, suite: CryptoSuite) -> "Transaction":
        self.signature = suite.signature_impl.sign(kp, self.hash(suite))
        self.sender = suite.calculate_address(kp.pub)
        self._wire = None  # the signature section changed under the cache
        return self

    def verify(self, suite: CryptoSuite) -> bool:
        """Single-item admission check (Transaction.h:64-84): recompute hash,
        recover the signer, cache the sender address. The batch path is
        txpool's fused device program."""
        try:
            pub = suite.signature_impl.recover(self.hash(suite), self.signature)
        except ValueError:
            return False
        self.sender = suite.calculate_address(pub)
        return True

    def force_sender(self, addr: bytes) -> None:
        self.sender = addr


def hash_transactions_batch(txs: list[Transaction], suite: CryptoSuite) -> list[bytes]:
    """Hash many txs in one device program and fill their caches — the batch
    form of Transaction.hash for sealing/verification paths (the reference
    hashes per-tx on tbb threads, TransactionImpl.cpp:43-66)."""
    missing = [t for t in txs if t._hash is None]
    if missing:
        digests = suite.hash_batch([t.encode_data() for t in missing])
        for t, d in zip(missing, digests):
            t._hash = bytes(d)
    return [t._hash for t in txs]  # type: ignore[misc]


class TransactionFactory:
    """Builds/decodes transactions bound to one crypto suite
    (reference: TransactionFactory.h / TransactionFactoryImpl)."""

    def __init__(self, suite: CryptoSuite):
        self.suite = suite

    def create(
        self,
        *,
        chain_id: str,
        group_id: str,
        block_limit: int,
        nonce: str,
        to: bytes = b"",
        input: bytes = b"",
        abi: str = "",
        attribute: int = 0,
        version: int = 1,
    ) -> Transaction:
        return Transaction(
            version=version,
            chain_id=chain_id,
            group_id=group_id,
            block_limit=block_limit,
            nonce=nonce,
            to=to,
            input=input,
            abi=abi,
            attribute=attribute,
            import_time=int(time.time() * 1000),
        )

    def create_signed(self, kp: KeyPair, **kwargs) -> Transaction:
        return self.create(**kwargs).sign(kp, self.suite)

    def decode(self, buf: bytes) -> Transaction:
        return Transaction.decode(buf)
