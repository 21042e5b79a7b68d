"""CryptoSuite: the seam through which a node reaches every hash and
signature kernel (the port of the JAX package's ``crypto/suite.py``;
reference: bcos-crypto CryptoSuite.h:33-69, Signature.h:31-58,
Hash.h:37-60, and the suite choice of ProtocolInitializer.cpp:51-99,
``sm_crypto ? SM3 + SM2 : keccak256 + secp256k1``).

Each suite is bound to one device when it is built (:func:`ecdsa_suite`,
:func:`sm_suite`): the CUDA card unless the caller names another, and with
no device named and no CUDA, building it raises. Every batch call of the
suite and of its implementations runs there, whatever the batch's size, so
on the card a batch reaches the kernels or an exception; ``device="cpu"``
runs their plain PyTorch versions. There is no host cutover and no breaker.

Every batch seam goes through the DevicePlane (``device/plane.py``), as the
JAX suite's do: a routed entry validates its batch and resolves its device
on the caller's thread, then submits it under an op name that carries the
device (``hash.keccak256.cuda:0``, ``verify.secp256k1.cpu``, ...), and the
plane's executor merges every request queued under that name into one call
of the direct body (``_batch_async_direct``, ``_address_direct``,
``_verify_merged``, ``_recover_merged``), slicing the result back a
request. ``FISCO_DEVICE_PLANE=0`` calls the same direct body on the
caller's thread, so the two modes give the same bytes. ``merkle_tree``
rides the plane a tree a request; ``merkle_root_async`` and Ed25519's
``batch_recover`` (which calls ``batch_verify``) stay direct, as in JAX.
Each direct body runs under the JAX suite's device span (the hash's name
for a hash or address batch, ``merkle_tree`` a tree; the signature calls
through the ops entry points' spans), on the thread that launches.

Single-item calls (``hash``, ``generate_keypair``, ``sign``, ``verify``,
``recover``, ``calculate_address``) run on the host through the port's
``crypto/ref``, the pure-Python leg the JAX suite falls back to without its
native core; both give the same bytes (RFC 6979 nonces; RFC 8032 for
Ed25519). ``Ed25519Crypto`` is the signature scheme of the QC certificates
(``consensus/qc.py``); its batch verify runs the Ed25519 challenge and
verify kernels on the suite's device. ``Poseidon`` is the succinct state
plane's commitment hasher (``FISCO_STATE_HASH=poseidon``); the plane builds
its suite with :func:`hash_impl_by_name`.
"""

from __future__ import annotations

import secrets
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..device.plane import get_plane, plane_route, plane_wait, plane_wait_deferred
from ..observability.device import device_span
from ..ops import ed25519 as ed_ops
from ..ops import keccak as keccak_ops
from ..ops import poseidon as poseidon_ops
from ..ops import merkle as merkle_ops
from ..ops import secp256k1 as secp_ops
from ..ops import sha256 as sha256_ops
from ..ops import sm2 as sm2_ops
from ..ops import sm3 as sm3_ops
from ..ops.address import sender_address_device, sm3_sender_address_device
from ..ops.bigint import limb_tensor
from ..ops.hash_common import bucket_batch, rows_as_packed
from ..ops.merkle import hasher_fns
from ..utils.bytesutil import right160
from .ref import ecdsa as ref_ecdsa
from .ref import ed25519 as ref_ed25519


# ---------------------------------------------------------------------------
# DevicePlane executors
# ---------------------------------------------------------------------------


def _slices(reqs) -> list[tuple[int, int]]:
    """Each request's [lo, hi) in the merged batch."""
    bounds = np.cumsum([0] + [r.n for r in reqs]).tolist()
    return list(zip(bounds[:-1], bounds[1:]))


def _take(out, lo: int, hi: int):
    return tuple(x[lo:hi] for x in out) if isinstance(out, tuple) else out[lo:hi]


def _merged_plane_exec(body):
    """The executor of a seam whose payload is a tuple of batch arguments
    (arrays or lists, one row an item): each argument joined across the
    queued requests, one call of `body` on the merged batch, its output (an
    array or a tuple of arrays) sliced back a request. The port of JAX
    ``_verify_plane_exec``, ``_verify_plane_exec_lists``,
    ``_recover_plane_exec`` and ``admission._admission_plane_exec``."""

    def run(reqs):
        if len(reqs) == 1:  # nothing to join or slice
            return [body(*reqs[0].payload)]
        merged = [
            np.concatenate(parts, axis=0) if isinstance(parts[0], np.ndarray) else [x for p in parts for x in p]
            for parts in zip(*(r.payload for r in reqs))
        ]
        out = body(*merged)
        return [_take(out, lo, hi) for lo, hi in _slices(reqs)]

    return run


def _routed(op: str, payload: tuple, n: int, body):
    """``body(*payload)``: through the DevicePlane under `op` when routing is
    on and the batch holds items, else on this thread."""
    if plane_route() and n:
        return plane_wait(get_plane().submit(op, payload, n, _merged_plane_exec(body)))
    return body(*payload)


def _hash_plane_exec(name: str, batch_async_direct):
    """The executor of a hash op (JAX ``_hash_plane_exec``): every queued
    request's messages in one launch, dispatched without a download under
    one `name` span (the dispatch only: the download is the caller's wait),
    and a resolver a request that downloads the merged digests once
    (whichever caller resolves first) and takes its slice."""

    def run(reqs):
        msgs = [m for r in reqs for m in r.payload]
        with device_span(name, len(msgs), shape_key=bucket_batch(max(len(msgs), 1))):
            resolve = batch_async_direct(msgs)
        memo: list = []
        lock = threading.Lock()

        def realize():
            with lock:
                if not memo:
                    memo.append(resolve())
                return memo[0]

        return [lambda lo=lo, hi=hi: realize()[lo:hi] for lo, hi in _slices(reqs)]

    return run


# ---------------------------------------------------------------------------
# Hash implementations
# ---------------------------------------------------------------------------


class HashImpl:
    """A hash function with a single-message host call and batch calls.

    ``device`` is where the batch calls run; None means the CUDA card,
    resolved at each call (raising without one). ``hash_batch(_async)`` may
    name another device for itself. The batch calls ride the DevicePlane
    (``hash.<name>.<device>``, ``address.<name>.<device>``) over the direct
    bodies ``_batch_async_direct`` and ``_address_direct``."""

    name: str = ""

    def __init__(self, device: torch.device | None = None):
        self.device = device

    def _device(self, device) -> torch.device:
        return resolve_device(self.device if device is None else device)

    def hash(self, data: bytes) -> bytes:
        return hasher_fns(self.name)[1](data)

    def hash_batch(self, msgs, device=None) -> np.ndarray:
        """list[bytes] -> [B, 32] uint8 digests, one kernel launch. Direct
        (plane off, or no messages), one span of the hash's name covers the
        launch and the download, as the JAX ``_batch_direct`` does."""
        msgs = list(msgs)
        dev = self._device(device)
        if plane_route() and msgs:
            return self.hash_batch_async(msgs, dev)()
        with device_span(self.name, len(msgs)):
            return self._batch_async_direct(msgs, dev)()

    def hash_batch_async(self, msgs, device=None):
        """Dispatch the batch, defer the download: () -> [B, 32] uint8.
        Through the plane, concurrent callers' messages share one launch."""
        msgs = list(msgs)
        dev = self._device(device)
        if plane_route() and msgs:
            fut = get_plane().submit(
                f"hash.{self.name}.{dev}", msgs, len(msgs),
                _hash_plane_exec(self.name, lambda m: self._batch_async_direct(m, dev)),
            )
            return lambda: plane_wait_deferred(fut)
        return self._batch_async_direct(msgs, dev)

    def _batch_async_direct(self, msgs: list, dev: torch.device):
        """One launch of the packed kernel on `dev`: () -> [B, 32] uint8."""
        raise NotImplementedError

    def address_batch(self, pubs) -> np.ndarray:
        """right160(H(key)) of each [B, 64] uint8 public key x ‖ y ->
        [B, 20] uint8. Every lane is hashed, the zero key too."""
        dev = resolve_device(self.device)
        pubs = np.asarray(pubs, dtype=np.uint8)
        if pubs.ndim != 2 or pubs.shape[1] != 64:
            raise ValueError(f"public keys must be [B, 64] uint8, got {pubs.shape}")
        if not len(pubs):
            return np.zeros((0, 20), dtype=np.uint8)
        return _routed(f"address.{self.name}.{dev}", (pubs,), len(pubs), lambda p: self._address_spanned(p, dev))

    def _address_spanned(self, pubs: np.ndarray, dev: torch.device) -> np.ndarray:
        """:meth:`_address_direct` under the span the JAX suite's address
        batch gives it: its hash's, over the keys as messages."""
        with device_span(self.name, len(pubs)):
            return self._address_direct(pubs, dev)

    def _address_direct(self, pubs: np.ndarray, dev: torch.device) -> np.ndarray:
        """One launch of the hash kernel's sender form, which builds each
        message from the keys' limbs."""
        n = len(pubs)
        qx, qy = limb_tensor(pubs[:, :32], n, dev), limb_tensor(pubs[:, 32:], n, dev)
        return self._sender(qx, qy)[0].cpu().numpy()

    def _sender(self, qx: torch.Tensor, qy: torch.Tensor):
        raise NotImplementedError


class Keccak256(HashImpl):
    name = "keccak256"

    def _batch_async_direct(self, msgs, dev):
        return keccak_ops.keccak256_batch_async(msgs, dev)

    def _sender(self, qx, qy):
        return sender_address_device(qx, qy)


class SM3(HashImpl):
    name = "sm3"

    def _batch_async_direct(self, msgs, dev):
        return sm3_ops.sm3_batch_async(msgs, dev)

    def _sender(self, qx, qy):
        every = torch.ones(qx.shape[0], dtype=torch.bool, device=qx.device)
        return sm3_sender_address_device(qx, qy, every)


def _packed_address(packed_hash, pubs: np.ndarray, dev: torch.device) -> np.ndarray:
    """One launch of a packed hash kernel over the keys as 64-byte rows,
    bytes 12..31 of each digest (JAX ``calculate_address_batch``): the
    address of a hash whose kernel has no sender form."""
    digests = packed_hash(*rows_as_packed(torch.tensor(pubs, device=dev)))
    return digests[:, 12:].cpu().numpy()


class Sha256(HashImpl):
    name = "sha256"

    def _batch_async_direct(self, msgs, dev):
        return sha256_ops.sha256_batch_async(msgs, dev)

    def _address_direct(self, pubs, dev):
        return _packed_address(sha256_ops.sha256_packed, pubs, dev)


class Poseidon(HashImpl):
    """The SNARK-friendly hash (JAX ``crypto/suite.py`` ``Poseidon``): the
    single-message hash on the host through the port's oracle, the batch
    calls through the Poseidon kernel."""

    name = "poseidon"

    def _batch_async_direct(self, msgs, dev):
        return poseidon_ops.poseidon_batch_async(msgs, dev)

    def _address_direct(self, pubs, dev):
        return _packed_address(poseidon_ops.poseidon_packed, pubs, dev)


_HASH_IMPLS: dict[str, type[HashImpl]] = {
    "keccak256": Keccak256, "sm3": SM3, "sha256": Sha256, "poseidon": Poseidon,
}


def hash_impl_by_name(name: str) -> HashImpl:
    """Hash impl registry lookup (the ``FISCO_STATE_HASH`` selection seam).
    An unknown name raises: one node silently hashing with another function
    than its peers would fork the state commitment."""
    hasher_fns(name)  # raises for a hasher the port does not carry
    return _HASH_IMPLS[name]()


# ---------------------------------------------------------------------------
# Key pairs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KeyPair:
    """Secret scalar + uncompressed public key (reference: KeyPairInterface)."""

    secret: int
    pub: bytes  # 64 bytes, x‖y big-endian

    @property
    def pub_x(self) -> int:
        return int.from_bytes(self.pub[:32], "big")

    @property
    def pub_y(self) -> int:
        return int.from_bytes(self.pub[32:], "big")


def _make_keypair(curve: ref_ecdsa.Curve, secret: int | None) -> KeyPair:
    if secret is None:
        secret = secrets.randbelow(curve.n - 1) + 1
    x, y = ref_ecdsa.privkey_to_pubkey(curve, secret)
    return KeyPair(secret, x.to_bytes(32, "big") + y.to_bytes(32, "big"))


def _rs(sig: bytes) -> tuple[int, int]:
    return int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:64], "big")


def _point(pub: bytes) -> tuple[int, int]:
    return int.from_bytes(pub[:32], "big"), int.from_bytes(pub[32:], "big")


# ---------------------------------------------------------------------------
# Signature implementations
# ---------------------------------------------------------------------------


class SignatureCrypto:
    """Signature interface (reference: Signature.h:31-58) + batch extension.

    sign/verify/recover operate on 32-byte message hashes on the host.
    `recover` returns the 64-byte uncompressed public key or raises; the
    batch calls run on ``device`` (None: the CUDA card, resolved at each
    call) and return validity masks instead of raising (invalid lanes lower
    a bit)."""

    name: str = ""
    sig_len: int = 0

    def __init__(self, device: torch.device | None = None):
        self.device = device

    def _batch(self, sigs, *arrays):
        """(device, sigs [B, sig_len] uint8, each array as uint8), copied:
        callers pass read-only views (``np.frombuffer``). A signature block
        of another width, or an array of another row count, raises: its rows
        would not line up with the hashes."""
        dev = resolve_device(self.device)
        sigs = np.array(sigs, dtype=np.uint8)
        arrays = [np.array(a, dtype=np.uint8) for a in arrays]
        if sigs.ndim != 2 or sigs.shape[1] != self.sig_len:
            raise ValueError(f"{self.name}: signatures must be [B, {self.sig_len}] uint8, got {sigs.shape}")
        if any(len(a) != len(sigs) for a in arrays):
            raise ValueError(f"{self.name}: {len(sigs)} signatures against rows {[len(a) for a in arrays]}")
        return dev, sigs, *arrays

    def generate_keypair(self, secret: int | None = None) -> KeyPair:
        raise NotImplementedError

    def sign(self, kp: KeyPair, msg_hash: bytes) -> bytes:
        raise NotImplementedError

    def verify(self, pub: bytes, msg_hash: bytes, sig: bytes) -> bool:
        raise NotImplementedError

    def recover(self, msg_hash: bytes, sig: bytes) -> bytes:
        raise NotImplementedError

    def batch_verify(self, msg_hashes, pubs, sigs) -> np.ndarray:
        """[B, 32] hashes, [B, 64] keys, [B, sig_len] signatures -> ok
        bool[B]: ``_verify_merged`` through the DevicePlane
        (``verify.<name>.<device>``)."""
        dev, sigs, hashes, pubs = self._batch(sigs, msg_hashes, pubs)
        if not len(sigs):
            return np.zeros(0, dtype=bool)
        return _routed(f"verify.{self.name}.{dev}", (hashes, pubs, sigs), len(sigs),
                       lambda h, p, s: self._verify_merged(h, p, s, dev))

    def batch_recover(self, msg_hashes, sigs) -> tuple[np.ndarray, np.ndarray]:
        """[B, 32] hashes, [B, sig_len] signatures -> (keys [B, 64] uint8,
        zero where not ok, ok bool[B]): ``_recover_merged`` through the
        DevicePlane (``recover.<name>.<device>``)."""
        dev, sigs, hashes = self._batch(sigs, msg_hashes)
        if not len(sigs):
            return np.zeros((0, 64), dtype=np.uint8), np.zeros(0, dtype=bool)
        return _routed(f"recover.{self.name}.{dev}", (hashes, sigs), len(sigs),
                       lambda h, s: self._recover_merged(h, s, dev))

    def _verify_merged(self, hashes, pubs, sigs, dev) -> np.ndarray:
        raise NotImplementedError

    def _recover_merged(self, hashes, sigs, dev) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError


class Secp256k1Crypto(SignatureCrypto):
    """65-byte r‖s‖v signatures (reference: Secp256k1Crypto.cpp:32-136).

    The host calls take v ∈ {0..3} ∪ {27..30}, 29 and 30 read as 2 and 3,
    as the JAX suite's host leg does; the batch calls follow the device
    program, v ∈ {0..3, 27, 28}, 29 and 30 not ok (ROADMAP C)."""

    name = "secp256k1"
    sig_len = 65

    def generate_keypair(self, secret: int | None = None) -> KeyPair:
        return _make_keypair(ref_ecdsa.SECP256K1, secret)

    def sign(self, kp: KeyPair, msg_hash: bytes) -> bytes:
        r, s, v = ref_ecdsa.ecdsa_sign(msg_hash, kp.secret)
        return r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([v])

    def verify(self, pub: bytes, msg_hash: bytes, sig: bytes) -> bool:
        return ref_ecdsa.ecdsa_verify(msg_hash, *_rs(sig), _point(pub))

    def recover(self, msg_hash: bytes, sig: bytes) -> bytes:
        pub = ref_ecdsa.ecdsa_recover(msg_hash, *_rs(sig), sig[64])
        if pub is None:
            raise ValueError("secp256k1 recover failed")
        x, y = pub
        return x.to_bytes(32, "big") + y.to_bytes(32, "big")

    def _verify_merged(self, hashes, pubs, sigs, dev) -> np.ndarray:
        """One launch of the verify kernel (v is not read)."""
        return secp_ops.verify_batch(hashes, sigs[:, :32], sigs[:, 32:64], pubs, device=dev)

    def _recover_merged(self, hashes, sigs, dev) -> tuple[np.ndarray, np.ndarray]:
        """One launch of the recover kernel."""
        return secp_ops.recover_batch(hashes, sigs, device=dev)


class SM2Crypto(SignatureCrypto):
    """128-byte r‖s‖pubkey signatures; "recover" parses the carried key and
    verifies it (reference: SM2Crypto.cpp:29-91)."""

    name = "sm2"
    sig_len = 128

    def generate_keypair(self, secret: int | None = None) -> KeyPair:
        return _make_keypair(ref_ecdsa.SM2_CURVE, secret)

    def sign(self, kp: KeyPair, msg_hash: bytes) -> bytes:
        r, s = ref_ecdsa.sm2_sign(msg_hash, kp.secret)
        return r.to_bytes(32, "big") + s.to_bytes(32, "big") + kp.pub

    def verify(self, pub: bytes, msg_hash: bytes, sig: bytes) -> bool:
        return ref_ecdsa.sm2_verify(msg_hash, *_rs(sig), _point(pub))

    def recover(self, msg_hash: bytes, sig: bytes) -> bytes:
        pub = sig[64:128]
        if not self.verify(pub, msg_hash, sig):
            raise ValueError("sm2 recover: carried pubkey fails verification")
        return pub

    def _verify_merged(self, hashes, pubs, sigs, dev) -> np.ndarray:
        """Against `pubs`, not the key a signature carries: one launch of the
        SM3 kernel's e form and one of the SM2 kernel."""
        return sm2_ops.verify_batch(hashes, sigs[:, :32], sigs[:, 32:64], pubs, device=dev)

    def _recover_merged(self, hashes, sigs, dev) -> tuple[np.ndarray, np.ndarray]:
        """The carried keys, verified: the e form and the SM2 kernel."""
        return sm2_ops.recover_batch(hashes, sigs, device=dev)


class Ed25519Crypto(SignatureCrypto):
    """96-byte R‖S‖pub32 signatures (reference: Ed25519Crypto.cpp, wedpr);
    "recover" parses the appended key and verifies it, as SM2's does. The
    secret is the 32-byte seed read as a little-endian integer.

    The batch calls take lists of bytes, of any lengths: a key shorter than
    32 bytes or a signature shorter than 64 (96 for ``batch_recover``)
    lowers its lane's bit and never raises. Such a lane reaches the kernel
    as the JAX suite's placeholder, and its mask drops the verdict."""

    name = "ed25519"
    sig_len = 96
    # a malformed lane's stand-in (R, key zero; s = 1), as in the JAX suite
    _PLACEHOLDER = b"\x00" * 32 + b"\x01" + b"\x00" * 63

    def generate_keypair(self, secret: int | None = None) -> KeyPair:
        if secret is None:
            secret = int.from_bytes(secrets.token_bytes(32), "little")
        seed = (secret % (1 << 256)).to_bytes(32, "little")
        return KeyPair(int.from_bytes(seed, "little"), ref_ed25519.seed_to_pubkey(seed))

    @staticmethod
    def _seed(kp: KeyPair) -> bytes:
        return (kp.secret % (1 << 256)).to_bytes(32, "little")

    def sign(self, kp: KeyPair, msg_hash: bytes) -> bytes:
        return ref_ed25519.sign(self._seed(kp), msg_hash) + kp.pub

    def verify(self, pub: bytes, msg_hash: bytes, sig: bytes) -> bool:
        return ref_ed25519.verify(pub[:32], msg_hash, sig[:64])

    def recover(self, msg_hash: bytes, sig: bytes) -> bytes:
        pub = sig[64:96]
        if not self.verify(pub, msg_hash, sig[:64] + pub):
            raise ValueError("ed25519 signature does not verify")
        return pub

    def batch_verify(self, msg_hashes, pubs, sigs) -> np.ndarray:
        """Messages, keys and signatures (lists of bytes-like items) -> ok
        bool[B]: ``ed25519.verify_batch``, the challenge kernel then the
        verify kernel."""
        dev = resolve_device(self.device)
        if not len(msg_hashes) == len(pubs) == len(sigs):
            raise ValueError(f"ed25519: {len(msg_hashes)} messages, {len(pubs)} keys, {len(sigs)} signatures")
        if not len(sigs):
            return np.zeros(0, dtype=bool)
        return _routed(f"verify.{self.name}.{dev}", (list(msg_hashes), list(pubs), list(sigs)), len(sigs),
                       lambda m, p, s: self._verify_merged(m, p, s, dev))

    def _verify_merged(self, msg_hashes, pubs, sigs, dev) -> np.ndarray:
        wellformed = np.array([len(p) >= 32 and len(s) >= 64 for p, s in zip(pubs, sigs)], dtype=bool)
        if not wellformed.all():
            pubs = [p if good else self._PLACEHOLDER[64:] for p, good in zip(pubs, wellformed)]
            sigs = [s if good else self._PLACEHOLDER[:64] for s, good in zip(sigs, wellformed)]
        return ed_ops.verify_batch(msg_hashes, pubs, sigs, device=dev) & wellformed

    def batch_recover(self, msg_hashes, sigs) -> tuple[np.ndarray, np.ndarray]:
        """Messages and 96-byte signatures -> (the carried keys [B, 32]
        uint8, zero where not ok, ok bool[B]); a signature shorter than 96
        bytes is not ok. Not routed itself: its ``batch_verify`` is (a
        direct call on the plane's worker)."""
        wellformed = np.array([len(s) >= 96 for s in sigs], dtype=bool)
        joined = b"".join(sigs)
        if len(joined) != 96 * len(sigs) or not wellformed.all():
            joined = b"".join(bytes(s[:96]) if good else self._PLACEHOLDER for s, good in zip(sigs, wellformed))
        rows = np.frombuffer(joined, dtype=np.uint8).reshape(len(sigs), 96)
        ok = self.batch_verify(msg_hashes, list(rows[:, 64:]), list(rows[:, :64])) & wellformed
        return np.where(ok[:, None], rows[:, 64:], 0).astype(np.uint8), ok


# ---------------------------------------------------------------------------
# The suite
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CryptoSuite:
    """Hash + signature bundle (reference: CryptoSuite.h:33-69); its batch
    calls run on its one device, which both implementations share."""

    hash_impl: HashImpl
    signature_impl: SignatureCrypto

    def __post_init__(self):
        if self.hash_impl.device != self.signature_impl.device:
            raise ValueError(
                f"a suite runs on one device: hash on {self.hash_impl.device}, "
                f"signatures on {self.signature_impl.device}"
            )

    @property
    def device(self) -> torch.device | None:
        return self.hash_impl.device

    def hash(self, data: bytes) -> bytes:
        return self.hash_impl.hash(data)

    def hash_batch(self, msgs) -> np.ndarray:
        return self.hash_impl.hash_batch(msgs)

    def hash_batch_async(self, msgs):
        return self.hash_impl.hash_batch_async(msgs)

    def calculate_address(self, pub: bytes) -> bytes:
        """right160(hash(pubkey)) — CryptoSuite.h:56-59."""
        return right160(self.hash_impl.hash(pub))

    def calculate_address_batch(self, pubs) -> np.ndarray:
        """[B, 64] uint8 keys -> [B, 20] uint8 addresses; the zero key (a
        not-ok lane of ``batch_recover``) gets right160(H(0^64))."""
        return self.hash_impl.address_batch(pubs)

    def merkle_root_async(self, leaves):
        """Dispatch every level of the wide merkle tree over ``[N, 32]``
        uint8 leaves, hashed with this suite's hasher; () -> root bytes."""
        return merkle_ops.merkle_root_async(leaves, hasher=self.hash_impl.name, device=self.device)

    def merkle_tree(self, leaves) -> merkle_ops.MerkleTree:
        """A proof-capable tree (every level kept) over ``[N, 32]`` uint8
        leaves, hashed with this suite's hasher. Rides the DevicePlane as
        ``merkle_tree.<hasher>.<device>``, a tree a request, on the caller's
        lane. Leaves already on the card are read after an event recorded
        here on the caller's stream."""
        dev = resolve_device(self.device)
        hasher = self.hash_impl.name
        if plane_route() and len(leaves) > 1:
            ready = None
            if isinstance(leaves, torch.Tensor) and leaves.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(leaves.device))
            return plane_wait(get_plane().submit(
                f"merkle_tree.{hasher}.{dev}", (leaves, ready), len(leaves), _merkle_tree_plane_exec(hasher, dev)
            ))
        return _merkle_tree_spanned(leaves, hasher, dev)


def _merkle_tree_spanned(leaves, hasher: str, dev: torch.device) -> merkle_ops.MerkleTree:
    """One tree under the JAX suite's ``merkle_tree`` span, keyed by its
    hasher and leaf bucket."""
    n = len(leaves)
    with device_span("merkle_tree", n, shape_key=(hasher, merkle_ops.bucket_leaves(max(n, 1)))):
        return merkle_ops.MerkleTree(leaves, hasher=hasher, device=dev)


def _merkle_tree_plane_exec(hasher: str, dev: torch.device):
    """The executor of proof-tree builds (JAX ``_merkle_tree_plane_exec``):
    each request is a tree of its own (there is nothing sound to merge
    across roots), built in turn on the worker behind the priority lanes."""

    def run(reqs):
        out = []
        for r in reqs:
            leaves, ready = r.payload
            if ready is not None:
                torch.cuda.current_stream(dev).wait_event(ready)
            out.append(_merkle_tree_spanned(leaves, hasher, dev))
        return out

    return run


def ecdsa_suite(device=None) -> CryptoSuite:
    """Keccak256 + secp256k1 (the reference's default, non-SM suite), bound
    to `device` (None: the CUDA card; raises without one)."""
    dev = resolve_device(device)
    return CryptoSuite(Keccak256(dev), Secp256k1Crypto(dev))


def sm_suite(device=None) -> CryptoSuite:
    """SM3 + SM2 (the reference's sm_crypto=true national suite), bound to
    `device` (None: the CUDA card; raises without one)."""
    dev = resolve_device(device)
    return CryptoSuite(SM3(dev), SM2Crypto(dev))
