"""BLSCrypto: the BLS12-381 aggregate-signature scheme of the QC
certificates (``consensus/qc.py`` ``BLSQCScheme``, ``FISCO_QC_SCHEME=bls``),
the port of the JAX package's ``crypto/bls.py``.

Single-item sign / verify, aggregation, the independent-message
``batch_verify`` and the point decoders run on the host through the port's
oracle (``crypto/ref/bls12_381.py``), as they do in the JAX class on every
backend; committee keys and quorum signatures decompress once a process
(the cached decoders below). The aggregate check, one pairing check that
admits a whole quorum, runs on the class's device: ``aggregate_verify`` and
``aggregate_verify_batch`` go through the DevicePlane as the op
``bls_aggregate_verify.<device>``, whose executor merges every queued
request's checks into one ``ops.bls12_381.pairing_check_batch`` (one kernel
launch on the card, the plain version on the CPU) and slices the verdicts
back a request. With ``FISCO_DEVICE_PLANE=0`` the same merged body runs on
the caller's thread. There is no host cutover: a check reaches the device or
an exception. A batch in which no check decodes (a key or signature that
fails to decompress, an empty signer set) is rejected before any pairing.

Header sync's one aggregate check, ``multi_pairing_verify``, folds K
aggregate checks into one (K + 1)-pair product by the JAX class's
Fiat-Shamir random linear combination, byte for byte (the transcript, the
scalars, the pairs' order), and runs it as one
``ops.bls12_381.multi_pairing_check`` on the class's device, directly (the
JAX class does not route it through the plane either); the scalar
multiplications and hash-to-G2 stay on the host, as in the JAX class.

Both device calls run under the JAX class's device spans, after the host
work the JAX class also does before them: ``bls_aggregate_verify`` keyed
by the checks' batch bucket, ``bls_multi_pairing`` by the pairs' power-of-
two pad (``multi_pairing_pad``).

Key model: BLS keypairs are derived (secret scalar mod r) from the node's
consensus secret, and the committee's BLS keys are registered in the
consensus-node table, which is the proof-of-possession boundary that makes
same-message aggregation rogue-key safe (``consensus/qc.py``).
"""

from __future__ import annotations

import hashlib
import secrets
from functools import lru_cache

import numpy as np

from ..device import resolve_device
from ..observability.device import device_span
from ..ops import bls12_381 as bls_ops
from ..ops.hash_common import bucket_batch
from .ref import bls12_381 as ref
from .suite import CryptoSuite, Keccak256, KeyPair, SignatureCrypto, _routed


@lru_cache(maxsize=4096)
def _g1_point(pub48: bytes):
    """Cached, validated key decompression (None: malformed or outside the
    subgroup): a quorum's aggregate check pays the pairing, not 2f + 1
    subgroup checks."""
    try:
        return ref.decompress_g1(pub48)
    except ValueError:
        return None


@lru_cache(maxsize=4096)
def _g2_point(sig96: bytes):
    try:
        return ref.decompress_g2(sig96)
    except ValueError:
        return None


@lru_cache(maxsize=1024)
def _apk_point(pubs: tuple[bytes, ...]):
    """The aggregate key of a signer set (quorum bitmaps repeat across
    rounds, so the G1 additions amortise too); None if a key is bad."""
    acc = None
    for p in pubs:
        pt = _g1_point(p)
        if pt is None:
            return None
        acc = ref.ec_add(acc, pt, ref.FP_OPS)
    return acc


def rlc_pairs(checks, triples) -> list[tuple]:
    """The folded product's pairs from normalised checks [(pubs, msg,
    agg_sig)] and their decoded (apk, σ, H(m)): (-g1, Σ r_k·σ_k) first, then
    (r_k·apk_k, H(m_k)) a check. The scalars are the JAX class's: a SHA-256
    transcript over every (msg, σ), bound before any scalar is drawn, then
    r_k = max(1, the first 16 bytes of SHA-256(seed ‖ u64be(k)))."""
    tr = hashlib.sha256()
    for _, msg, agg in checks:
        tr.update(len(msg).to_bytes(4, "big"))
        tr.update(msg)
        tr.update(agg)
    seed = tr.digest()
    scalars = [max(1, int.from_bytes(hashlib.sha256(seed + k.to_bytes(8, "big")).digest()[:16], "big"))
               for k in range(len(checks))]
    sig_acc = None
    pairs = []
    for r, (apk, sig, hm) in zip(scalars, triples):
        sig_acc = ref.ec_add(sig_acc, ref.ec_mul(sig, r, ref.FP2_OPS), ref.FP2_OPS)
        pairs.append((ref.ec_mul(apk, r, ref.FP_OPS), hm))
    return [(ref.ec_neg(ref.G1, ref.FP_OPS), sig_acc)] + pairs


def multi_pairing_pairs(checks) -> list[tuple] | None:
    """Normalised checks -> the folded product's pairs, or None when a key
    or signature does not decode (an empty signer set included)."""
    triples = []
    for pubs, msg, agg in checks:
        apk = _apk_point(pubs) if pubs else None
        sig = _g2_point(agg)
        if apk is None or sig is None:
            return None
        triples.append((apk, sig, bls_ops.hash_to_g2(msg)))
    return rlc_pairs(checks, triples)


class BLSCrypto(SignatureCrypto):
    """Min-pubkey-size BLS: 48-byte G1 keys, 96-byte G2 signatures,
    same-message aggregation (the QC case)."""

    name = "bls12_381"
    sig_len = 96

    def generate_keypair(self, secret: int | None = None) -> KeyPair:
        if secret is None:
            secret = int.from_bytes(secrets.token_bytes(32), "big")
        sk, pub = ref.keygen(secret)
        return KeyPair(sk, pub)

    def sign(self, kp: KeyPair, msg_hash: bytes) -> bytes:
        return ref.sign(kp.secret, msg_hash)

    def verify(self, pub: bytes, msg_hash: bytes, sig: bytes) -> bool:
        pk = _g1_point(bytes(pub))
        s = _g2_point(bytes(sig))
        if pk is None or s is None:
            return False
        return ref.pairing_check(
            [(ref.ec_neg(ref.G1, ref.FP_OPS), s), (pk, ref.hash_to_g2(bytes(msg_hash)))]
        )

    def recover(self, msg_hash: bytes, sig: bytes) -> bytes:
        raise ValueError("BLS signatures carry no recoverable public key")

    def batch_verify(self, msg_hashes, pubs, sigs) -> np.ndarray:
        """Independent messages: a host loop over the cached points, as in
        the JAX class (distinct messages share no pairing)."""
        return np.array(
            [self.verify(bytes(p), bytes(h), bytes(s)) for h, p, s in zip(msg_hashes, pubs, sigs)],
            dtype=bool,
        )

    def batch_recover(self, msg_hashes, sigs):
        raise ValueError("BLS signatures carry no recoverable public key")

    # -- aggregation (the QC surface) ---------------------------------------

    def aggregate(self, sigs: list[bytes]) -> bytes:
        """The sum of the G2 signatures, one 96-byte certificate signature."""
        acc = None
        for s in sigs:
            pt = _g2_point(bytes(s))
            if pt is None:
                raise ValueError("malformed signature in aggregate")
            acc = ref.ec_add(acc, pt, ref.FP2_OPS)
        return ref.compress_g2(acc)

    def aggregate_verify(self, pubs: list[bytes], msg_hash: bytes, agg_sig: bytes) -> bool:
        """One pairing check for the whole signer set (same message)."""
        return bool(self.aggregate_verify_batch([(tuple(pubs), msg_hash, agg_sig)])[0])

    def aggregate_verify_batch(self, checks) -> np.ndarray:
        """checks: [(pubs, msg_hash, agg_sig)] -> bool[B]: the device and the
        batch resolved on the caller's thread, then ``_aggregate_verify_merged``
        through the DevicePlane (``bls_aggregate_verify.<device>``), where
        concurrent callers' checks merge into one pairing batch."""
        dev = resolve_device(self.device)
        checks = [(tuple(bytes(p) for p in pubs), bytes(m), bytes(s)) for pubs, m, s in checks]
        if not checks:
            return np.zeros(0, dtype=bool)
        return _routed(f"bls_aggregate_verify.{dev}", (checks,), len(checks),
                       lambda c: self._aggregate_verify_merged(c, dev))

    def _aggregate_verify_merged(self, checks, dev) -> np.ndarray:
        """The merged batch's body, both dispatch modes': decompression and
        hash-to-G2 on the host (cached), then one pairing check a lane on
        `dev`; no pairing when no lane decodes."""
        triples = []
        for pubs, msg, agg in checks:
            apk = _apk_point(pubs) if pubs else None
            sig = _g2_point(agg)
            hm = bls_ops.hash_to_g2(msg) if apk is not None and sig is not None else None
            triples.append((apk, sig, hm))
        n = len(triples)
        with device_span("bls_aggregate_verify", n, shape_key=bucket_batch(max(n, 1))):
            if all(hm is None for _, _, hm in triples):
                return np.zeros(n, dtype=bool)
            return bls_ops.pairing_check_batch(triples, device=dev)

    # -- header sync (the multi-pairing) -------------------------------------

    def multi_pairing_verify(self, checks) -> bool:
        """One accept or reject for a set of aggregate checks [(pubs,
        msg_hash, agg_sig)]: e(-g1, Σ r_k·σ_k)·∏ e(r_k·apk_k, H(m_k)) == 1
        for scalars r_k drawn from a transcript of every (msg, σ) (soundness
        error ~2^-128), which holds iff every check does. False at once when
        a key or signature does not decode; an empty set is True; neither
        runs a pairing. Callers that need the failing check fall back to
        :meth:`aggregate_verify_batch`."""
        dev = resolve_device(self.device)
        checks = [(tuple(bytes(p) for p in pubs), bytes(m), bytes(s)) for pubs, m, s in checks]
        if not checks:
            return True
        pairs = multi_pairing_pairs(checks)
        if pairs is None:
            return False
        n = len(pairs)
        with device_span("bls_multi_pairing", n, shape_key=bls_ops.multi_pairing_pad(n)):
            return bls_ops.multi_pairing_check(pairs, device=dev)


def bls_suite(device=None) -> CryptoSuite:
    """Keccak256 + BLS12-381, the aggregate-QC suite, bound to `device`
    (None: the CUDA card; raises without one)."""
    dev = resolve_device(device)
    return CryptoSuite(Keccak256(dev), BLSCrypto(dev))
