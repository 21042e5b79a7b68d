"""The port's CryptoSuite against the JAX package's, method by method, on
the CPU (``device="cpu"``): key pairs, signatures, single-item verify and
recover, hashes, addresses, merkle roots, trees and proofs, and the batch
verify and recover of both suites on one mixed 32-lane block each, with a
lane of every bad kind; and the same for ``Ed25519Crypto``, the QC
certificates' scheme, with short and empty signatures in its batches.

The JAX suite runs only on its host legs here: on a CPU backend its
signature batches ride the native host loop (``use_native_batch``) and its
merkle trees the native hasher, and its expected digests and addresses come
from its single-item host calls. ``jax_host_only`` makes its device leg
fail the test, so no JAX program is traced. Each plain batch of the port
is computed once for the module."""

import numpy as np
import pytest
import torch

from fisco_bcos_tpu.crypto import suite as jsuite
from fisco_bcos_tpu.lightnode.lightnode import _write_items
from fisco_bcos_tpu.ops import ed25519 as jed
from fisco_bcos_tpu.ops import merkle as jmerkle
from fisco_bcos_tpu.utils.bytesutil import right160 as jright160
from fisco_bcos_tpu.codec.flat import FlatWriter
from fisco_bcos_tpu_torch.crypto import suite
from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref
from fisco_bcos_tpu_torch.crypto.ref import ed25519 as ref_ed
from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256
from fisco_bcos_tpu_torch.crypto.ref.sm3 import sm3
from fisco_bcos_tpu_torch.ops import _kernels

SUITES = ("ecdsa", "sm")
SECP, SM2 = ref.SECP256K1, ref.SM2_CURVE
LANES = 32  # one bucket of tests/conftest.py's FISCO_TEST_BUCKET


def _b(v: int) -> bytes:
    return v.to_bytes(32, "big")


def _pub(point) -> bytes:
    return _b(point[0]) + _b(point[1])


def _off_curve_y(c, x: int) -> int:
    y = 1
    while (y * y - (x**3 + c.a * x + c.b)) % c.p == 0:
        y += 1
    return y


def _small_r(c, s: int, h: bytes) -> int:
    """The least r whose x = r + n lies below p with a square root, so that
    recovery id 2 (and its alias 29) recovers a key."""
    r = 1
    while ref.ecdsa_recover(h, r, s, 2, c) is None:
        r += 1
    return r


def _secp_lanes():
    """(label, hash, pub, sig65) for 32 lanes: valid signatures and one lane
    of every bad kind for verify (on the key given) and for recover."""
    lanes = []
    for i in range(LANES):
        d = 0x5EC0 + 7919 * i
        h = {1: bytes(32), 2: b"\xff" * 32}.get(i, keccak256(b"suite lane %d" % i))
        r, s, v = ref.ecdsa_sign(h, d)
        pub = _pub(ref.privkey_to_pubkey(SECP, d))
        label = "valid"
        if i == 1 or i == 2:
            label = "valid, z = 0 or 2^256 - 1"
        elif i == 3:
            label, v = "v + 27", v + 27
        elif i == 4:
            label, r = "r = 0", 0
        elif i == 5:
            label, s = "s = 0", 0
        elif i == 6:
            label, s = "s = n", SECP.n
        elif i == 7:
            label, s = "s = 2^256 - 1", (1 << 256) - 1
        elif i == 8:
            label, s, v = "high s", SECP.n - s, v ^ 1
        elif i == 9:
            label, r = "r >= n", r + SECP.n if r + SECP.n < 1 << 256 else SECP.n
        elif i in (10, 11, 12, 13):
            label, v = f"v = {(4, 29, 30, 255)[i - 10]}", (4, 29, 30, 255)[i - 10]
        elif i == 14:
            label, r, v = "x = r + n >= p", SECP.p - SECP.n + 1, 2
        elif i == 15:
            label, r = "random r", int.from_bytes(keccak256(b"r %d" % i), "big") % SECP.n
        elif i == 16:
            label, r = "corrupted r", r ^ (1 << 77)
        elif i == 17:
            label, s = "corrupted s", s ^ (1 << 5)
        elif i == 18:
            label, h = "wrong hash", keccak256(b"not the signed message")
        elif i == 19:
            label, pub = "key off the curve", pub[:32] + _b(_off_curve_y(SECP, int.from_bytes(pub[:32], "big")))
        elif i == 20:
            label, pub = "key qx >= p", _b(SECP.p + 1) + pub[32:]
        elif i == 21:
            label, pub = "key (0, 0)", bytes(64)
        elif i == 22:
            label, pub = "another signer's key", _pub(ref.privkey_to_pubkey(SECP, d + 1))
        elif i in (23, 24):
            # one small r, s and hash with recovery id 2 and its alias 29: the
            # device rule recovers lane 24 and rejects lane 23 (ROADMAP C)
            label, v = ("small r, v = 29", 29) if i == 23 else ("small r, v = 2", 2)
            h, s = keccak256(b"small r"), 0x5EC0
            r = _small_r(SECP, s, h)
        lanes.append((label, h, pub, _b(r) + _b(s % (1 << 256)) + bytes([v])))
    return lanes


def _sm2_lanes():
    """(label, hash, pub, sig128) for 32 lanes: valid SM2 signatures and one
    lane of every bad kind; the key given to verify and the key the
    signature carries differ on two lanes."""
    lanes = []
    for i in range(LANES):
        d = 0x1234 + 7919 * i
        h = {16: bytes(32), 17: b"\xff" * 32}.get(i, sm3(b"suite sm lane %d" % i))
        r, s = ref.sm2_sign(h, d)
        pub = carried = _pub(ref.privkey_to_pubkey(SM2, d))
        other = _pub(ref.privkey_to_pubkey(SM2, d + 1))
        label = "valid"
        if i == 2:
            label, r = "r = 0", 0
        elif i == 3:
            label, s = "s = 0", 0
        elif i == 4:
            label, s = "s = n", SM2.n
        elif i == 5:
            label, s = "t = r + s = n", SM2.n - r
        elif i == 6:
            label, r = "r >= n", r + SM2.n if r + SM2.n < 1 << 256 else SM2.n
        elif i == 7:
            label, s = "s = 2^256 - 1", (1 << 256) - 1
        elif i == 8:
            label = "key off the curve"
            pub = carried = pub[:32] + _b(_off_curve_y(SM2, int.from_bytes(pub[:32], "big")))
        elif i == 9:
            label, pub = "key qx >= p", _b(SM2.p + 2) + pub[32:]
            carried = pub
        elif i == 10:
            label, pub, carried = "key (0, 0)", bytes(64), bytes(64)
        elif i == 11:
            label, h = "wrong hash", sm3(b"not the signed message")
        elif i == 12:
            label, s = "corrupted s", s ^ (1 << 100)
        elif i == 13:
            label, r = "corrupted r", r ^ 1
        elif i == 14:
            label, carried = "carried key wrong, given key right", other
        elif i == 15:
            label, pub = "carried key right, given key wrong", other
        elif i in (16, 17):
            label = "valid, hash 0 or 2^256 - 1"
        lanes.append((label, h, pub, _b(r) + _b(s) + carried))
    return lanes


def _rows(lanes, col: int, width: int) -> np.ndarray:
    return np.frombuffer(b"".join(lane[col] for lane in lanes), dtype=np.uint8).reshape(-1, width)


@pytest.fixture(scope="module")
def jax_host_only():
    """The JAX suite's device leg fails the test: its batches must ride the
    native host loop on the CPU, tracing no JAX program."""

    def device_leg(*_args, **_kwargs):
        pytest.fail("the JAX suite took its device leg")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsuite, "_device_or_host", device_leg)
        mp.setattr(jed, "verify_batch", device_leg)
        mp.setattr(jsuite.HashImpl, "hash_batch", device_leg)
        mp.setattr(jsuite.HashImpl, "hash_batch_async", device_leg)
        yield


@pytest.fixture(scope="module")
def suites(jax_host_only):
    return {
        "ecdsa": (suite.ecdsa_suite(device="cpu"), jsuite.ecdsa_suite(), _secp_lanes()),
        "sm": (suite.sm_suite(device="cpu"), jsuite.sm_suite(), _sm2_lanes()),
    }


@pytest.fixture(scope="module")
def batches(suites):
    """Each suite's batch verify and recover on its mixed block, the port's
    (plain PyTorch, computed once) and the JAX suite's (native host loop)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_kernels, "_library", lambda name: pytest.fail("kernel loader called on CPU"))
        for kind, (port, jax_suite, lanes) in suites.items():
            hashes, pubs = _rows(lanes, 1, 32), _rows(lanes, 2, 64)
            sigs = _rows(lanes, 3, port.signature_impl.sig_len)
            out[kind] = {
                who: (s.signature_impl.batch_verify(hashes, pubs, sigs),
                      *s.signature_impl.batch_recover(hashes, sigs))
                for who, s in (("port", port), ("jax", jax_suite))
            }
    return out


def test_suite_shape_and_device(suites):
    for kind in SUITES:
        port, jax_suite, _ = suites[kind]
        assert port.hash_impl.name == jax_suite.hash_impl.name
        assert port.signature_impl.name == jax_suite.signature_impl.name
        assert port.signature_impl.sig_len == jax_suite.signature_impl.sig_len
        assert port.device == port.signature_impl.device == torch.device("cpu")
    assert isinstance(suite.hash_impl_by_name("poseidon"), suite.Poseidon)
    assert suite.hash_impl_by_name("poseidon").device is None
    with pytest.raises(KeyError, match="unknown hasher"):
        suite.hash_impl_by_name("md5")
    assert isinstance(suite.hash_impl_by_name("sha256"), suite.Sha256)


@pytest.mark.parametrize("kind", SUITES)
def test_keypairs_and_signatures_match_jax(suites, kind):
    """Equal keys; signatures equal byte for byte (the JAX suite's native
    nonce is RFC 6979, as crypto/ref's is), and each suite verifies and
    recovers the other's."""
    port, jax_suite, _ = suites[kind]
    p, j = port.signature_impl, jax_suite.signature_impl
    curve = SECP if kind == "ecdsa" else SM2
    for secret in (1, 2, 0xC0FFEE, curve.n - 2):
        kp, jkp = p.generate_keypair(secret), j.generate_keypair(secret)
        assert kp.pub == jkp.pub and kp.secret == jkp.secret == secret
        assert (kp.pub_x, kp.pub_y) == (jkp.pub_x, jkp.pub_y)
        h = port.hash(b"message %d" % secret)
        sig = p.sign(kp, h)
        assert sig == j.sign(jkp, h) and len(sig) == p.sig_len
        assert p.verify(kp.pub, h, sig) and j.verify(kp.pub, h, sig)
        assert p.recover(h, sig) == j.recover(h, sig) == kp.pub
    fresh = p.generate_keypair()
    assert j.generate_keypair(fresh.secret).pub == fresh.pub


@pytest.mark.parametrize("kind", SUITES)
def test_single_verify_and_recover_match_jax(suites, kind):
    """Host verify and recover of every lane of the mixed block, against
    the JAX suite's host calls: the same verdict, the same key or both
    raise. Host recover reads v = 29 as 2, as the JAX host leg does."""
    port, jax_suite, lanes = suites[kind]
    p, j = port.signature_impl, jax_suite.signature_impl
    for label, h, pub, sig in lanes:
        assert p.verify(pub, h, sig) == j.verify(pub, h, sig), label
        try:
            want = j.recover(h, sig)
        except ValueError:
            with pytest.raises(ValueError):
                p.recover(h, sig)
        else:
            assert p.recover(h, sig) == want, label


@pytest.mark.parametrize("kind", SUITES)
def test_batch_verify_matches_jax(suites, batches, kind):
    _, _, lanes = suites[kind]
    got, want = batches[kind]["port"][0], batches[kind]["jax"][0]
    assert got.dtype == np.bool_ and got.shape == (LANES,)
    np.testing.assert_array_equal(got, want)
    port = suites[kind][0].signature_impl
    for i, (label, h, pub, sig) in enumerate(lanes):  # the host oracle too
        assert got[i] == port.verify(pub, h, sig), label
    assert got.any() and not got.all()


@pytest.mark.parametrize("kind", SUITES)
def test_batch_recover_matches_jax(suites, batches, kind):
    """Keys and ok bits equal the JAX suite's on every lane, a not-ok lane's
    key zero; on secp256k1 but for the small-r v = 29 lane, which the
    device rule rejects and the JAX host loop reads as v = 2."""
    _, _, lanes = suites[kind]
    _, pubs, ok = batches[kind]["port"]
    _, jpubs, jok = batches[kind]["jax"]
    assert pubs.dtype == np.uint8 and pubs.shape == (LANES, 64)
    assert ok.dtype == np.bool_ and ok.shape == (LANES,)
    assert not pubs[~ok].any()
    same = [i for i, lane in enumerate(lanes) if lane[0] != "small r, v = 29"]
    np.testing.assert_array_equal(ok[same], jok[same])
    np.testing.assert_array_equal(pubs[same], jpubs[same])
    assert ok.any() and not ok.all()


def test_v29_is_rejected_by_the_batch_and_aliased_by_the_host(suites, batches):
    """ROADMAP C: batch recover follows the device program (29 is not ok),
    host recover the reference (29 reads as 2); the JAX suite's host loop
    aliases in its batch too."""
    port, _, lanes = suites["ecdsa"]
    labels = [lane[0] for lane in lanes]
    i29, i2 = labels.index("small r, v = 29"), labels.index("small r, v = 2")
    _, pubs, ok = batches["ecdsa"]["port"]
    _, jpubs, jok = batches["ecdsa"]["jax"]
    assert ok[i2] and not ok[i29] and not pubs[i29].any()
    assert jok[i29] and bytes(jpubs[i29]) == bytes(pubs[i2])
    assert port.signature_impl.recover(lanes[i29][1], lanes[i29][3]) == bytes(pubs[i2])
    assert not ok[labels.index("v = 29")] and not ok[labels.index("v = 30")]


@pytest.mark.parametrize("kind", SUITES)
def test_hashes_and_addresses_match_jax(suites, kind):
    port, jax_suite, lanes = suites[kind]
    oracle = keccak256 if kind == "ecdsa" else sm3
    rng = np.random.default_rng(8)
    msgs = [rng.bytes(int(n)) for n in (0, 1, 64, 97, 136, 300)]
    digests = port.hash_batch(msgs)
    np.testing.assert_array_equal(digests, port.hash_batch_async(msgs)())
    assert digests.shape == (len(msgs), 32) and digests.dtype == np.uint8
    for m, d in zip(msgs, digests):
        assert bytes(d) == port.hash(m) == jax_suite.hash(m) == oracle(m)
    keys = [lane[2] for lane in lanes] + [bytes(64)]  # zero keys: two lanes
    addrs = port.calculate_address_batch(np.frombuffer(b"".join(keys), np.uint8).reshape(-1, 64))
    assert addrs.shape == (len(keys), 20) and addrs.dtype == np.uint8
    for k, a in zip(keys, addrs):
        assert bytes(a) == port.calculate_address(k) == jax_suite.calculate_address(k)
        assert bytes(a) == jright160(oracle(k)) == suite.right160(oracle(k))


@pytest.mark.parametrize("kind", SUITES)
def test_merkle_roots_trees_and_proofs_match_jax(suites, kind):
    """Roots and trees over 1, 5, 17 and 300 leaves equal the JAX host
    tree's; every proof checked verifies under the JAX verifier and
    encodes to the JAX proof's bytes (the light node's wire form)."""
    port, jax_suite, _ = suites[kind]
    hasher = port.hash_impl.name
    rng = np.random.default_rng(9)
    for n in (1, 5, 17, 300):
        leaves = rng.integers(0, 256, (n, 32), dtype=np.uint8)
        jtree = jmerkle.MerkleTree(leaves, hasher=hasher)
        tree = port.merkle_tree(leaves)
        assert port.merkle_root_async(leaves)() == jax_suite.merkle_root_async(leaves)() == jtree.root
        assert tree.root == jtree.root and (tree.n, tree.width) == (jtree.n, jtree.width)
        assert len(tree.levels) == len(jtree.levels)
        for lv, jlv in zip(tree.levels, jtree.levels):
            np.testing.assert_array_equal(lv, jlv)
        for i in sorted({0, n // 2, n - 1}):
            proof = tree.proof(i)
            assert jmerkle.MerkleTree.verify_proof(bytes(leaves[i]), i, n, proof, jtree.root, hasher=hasher)
            w, jw = FlatWriter(), FlatWriter()
            _write_items(w, proof)
            _write_items(jw, jtree.proof(i))
            assert w.out() == jw.out()


@pytest.mark.parametrize("kind", SUITES)
def test_empty_batches_match_jax_shapes(suites, kind, monkeypatch):
    """Zero rows give the JAX suite's shapes and dtypes. An empty batch
    skips the JAX suite's native loop and reaches its device leg, here
    swapped for that leg's bit-identical host loop (``_device_or_host``'s
    fallback), so no JAX program is traced; its hash batch, a JAX program
    too, is swapped for its single-item host hash a message at a time."""
    port, jax_suite, _ = suites[kind]
    monkeypatch.setattr(jsuite, "_device_or_host", lambda _device_fn, host_fn, *args: host_fn(*args))
    jhash = jax_suite.hash_impl
    monkeypatch.setattr(
        type(jhash), "hash_batch",
        lambda _self, msgs: np.frombuffer(b"".join(map(jhash.hash, msgs)), dtype=np.uint8).reshape(-1, 32),
    )
    sig, jsig = port.signature_impl, jax_suite.signature_impl
    h, p = np.zeros((0, 32), np.uint8), np.zeros((0, 64), np.uint8)
    s = np.zeros((0, sig.sig_len), np.uint8)
    pairs = (
        (sig.batch_verify(h, p, s), jsig.batch_verify(h, p, s)),
        *zip(sig.batch_recover(h, s), jsig.batch_recover(h, s)),
        (port.calculate_address_batch(p), jax_suite.calculate_address_batch(p)),
        (port.hash_batch([]), jax_suite.hash_batch([])),
    )
    for got, want in pairs:
        assert isinstance(got, np.ndarray) and isinstance(want, np.ndarray)
        assert got.shape == want.shape and got.dtype == want.dtype
    assert [got.shape for got, _ in pairs] == [(0,), (0, 64), (0,), (0, 20), (0, 32)]


@pytest.mark.parametrize("kind", SUITES)
def test_malformed_batches_raise(suites, kind):
    """A signature block of another width, or row counts that differ, raise
    instead of being re-split into rows that no longer line up with the
    hashes (65 rows of 64 bytes hold as many bytes as 64 rows of 65)."""
    port, _, lanes = suites[kind]
    sig = port.signature_impl
    n = 8
    hashes, pubs = _rows(lanes[:n], 1, 32), _rows(lanes[:n], 2, 64)
    sigs = _rows(lanes[:n], 3, sig.sig_len)
    resplit = np.zeros((sig.sig_len, 64), np.uint8)
    for call in (
        lambda: sig.batch_verify(np.zeros((64, 32), np.uint8), np.zeros((64, 64), np.uint8), resplit),
        lambda: sig.batch_recover(np.zeros((64, 32), np.uint8), resplit),
        lambda: sig.batch_verify(hashes, pubs, sigs.reshape(-1)),
        lambda: sig.batch_verify(hashes[:-1], pubs, sigs),
        lambda: sig.batch_verify(hashes, pubs[1:], sigs),
        lambda: sig.batch_recover(hashes, sigs[1:]),
        lambda: port.calculate_address_batch(np.zeros((64, 65), np.uint8)),
        lambda: port.calculate_address_batch(np.zeros(64 * 3, np.uint8)),
    ):
        with pytest.raises(ValueError):
            call()


def test_a_suite_has_one_device():
    """Both implementations of a suite run on the suite's one device."""
    cpu = torch.device("cpu")
    suite.CryptoSuite(suite.Keccak256(cpu), suite.Secp256k1Crypto(cpu))
    for hash_impl, sig_impl in (
        (suite.Keccak256(cpu), suite.Secp256k1Crypto()),
        (suite.SM3(), suite.SM2Crypto(cpu)),
    ):
        with pytest.raises(ValueError, match="one device"):
            suite.CryptoSuite(hash_impl, sig_impl)


# ---------------------------------------------------------------------------
# Ed25519Crypto (the QC certificates' scheme, consensus/qc.py)
# ---------------------------------------------------------------------------


def _ed_enc(y: int, sign: int = 0) -> bytes:
    return (y | sign << 255).to_bytes(32, "little")


def _ed25519_lanes():
    """(label, hash, pub32, sig96) for 32 lanes: valid signatures (R ‖ S ‖
    the signer's key), a lane of every bad kind for verify (on the key
    given), lanes the cofactored equation accepts, and for recover a carried
    key that differs from the given one and signatures cut to 95, 64, 10 and
    0 bytes."""
    lanes = []
    for i in range(LANES):
        seed = (0xED00 + 7919 * i).to_bytes(32, "little")
        h = {1: bytes(32), 2: b"\xff" * 32}.get(i, keccak256(b"ed25519 suite lane %d" % i))
        pub = ref_ed.seed_to_pubkey(seed)
        sig = ref_ed.sign(seed, h) + pub
        label = "valid"
        if i == 3:
            label, sig = "tampered R", bytes([sig[0] ^ 1]) + sig[1:]
        elif i == 4:
            label, sig = "tampered S", sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        elif i == 5:
            label, h = "wrong hash", keccak256(b"not the signed vote")
        elif i == 6:
            label, pub = "another signer's key", ref_ed.seed_to_pubkey(b"\x01" * 32)
        elif i == 7:
            label, pub = "key y = p", _ed_enc(ref_ed.P)
            sig = sig[:64] + pub
        elif i == 8:
            label, sig = "s = L", sig[:32] + ref_ed.L.to_bytes(32, "little") + sig[64:]
        elif i == 9:
            label, sig = "s = 2^256 - 1", sig[:32] + b"\xff" * 32 + sig[64:]
        elif i == 10:
            label, pub = "key x = 0, sign 1", _ed_enc(1, 1)
            sig = sig[:64] + pub
        elif i == 11:
            # a small-order key with R = r·B and s = r: accepted, cofactored
            label, pub = "small-order key", _ed_enc(ref_ed.P - 1)
            rc = ref_ed._compress(ref_ed._mul(0x5EED, ref_ed.BASE))
            sig = rc + (0x5EED).to_bytes(32, "little") + pub
        elif i == 12:
            label, h, pub, sig = "the zero row", bytes(32), bytes(32), bytes(96)
        elif i == 13:
            label, sig = "carried key wrong, given key right", sig[:64] + ref_ed.seed_to_pubkey(b"\x02" * 32)
        elif i == 14:
            label, pub = "carried key right, given key wrong", ref_ed.seed_to_pubkey(b"\x03" * 32)
        elif i in (15, 16, 17, 18):
            label, sig = f"signature of {(95, 64, 10, 0)[i - 15]} bytes", sig[: (95, 64, 10, 0)[i - 15]]
        lanes.append((label, h, pub, sig))
    return lanes


@pytest.fixture(scope="module")
def ed_impls(jax_host_only):
    return suite.Ed25519Crypto(torch.device("cpu")), jsuite.Ed25519Crypto(), _ed25519_lanes()


@pytest.fixture(scope="module")
def ed_batches(ed_impls):
    """Batch verify and recover on the mixed Ed25519 block, the port's (plain
    PyTorch, one call each) and the JAX suite's (its native host loop)."""
    port, jax_impl, lanes = ed_impls
    hashes, pubs, sigs = ([lane[k] for lane in lanes] for k in (1, 2, 3))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_kernels, "_library", lambda name: pytest.fail("kernel loader called on CPU"))
        for who, impl in (("port", port), ("jax", jax_impl)):
            out[who] = (impl.batch_verify(hashes, pubs, sigs), *impl.batch_recover(hashes, sigs))
    return out


def test_ed25519_keypairs_and_signatures_match_jax(ed_impls):
    """Equal keys and seeds (secret mod 2^256, little-endian); RFC 8032
    signatures equal byte for byte; each suite verifies and recovers the
    other's."""
    port, jax_impl, _ = ed_impls
    assert (port.name, port.sig_len) == (jax_impl.name, jax_impl.sig_len) == ("ed25519", 96)
    for secret in (1, 2, 0xC0FFEE, (1 << 256) + 5, (1 << 256) - 1):
        kp, jkp = port.generate_keypair(secret), jax_impl.generate_keypair(secret)
        assert kp.pub == jkp.pub and kp.secret == jkp.secret == secret % (1 << 256)
        h = keccak256(b"vote %d" % secret)
        sig = port.sign(kp, h)
        assert sig == jax_impl.sign(jkp, h) and len(sig) == port.sig_len
        assert port.verify(kp.pub, h, sig) and jax_impl.verify(kp.pub, h, sig)
        assert port.recover(h, sig) == jax_impl.recover(h, sig) == kp.pub
    fresh = port.generate_keypair()
    assert jax_impl.generate_keypair(fresh.secret).pub == fresh.pub


def test_ed25519_single_verify_and_recover_match_jax(ed_impls):
    port, jax_impl, lanes = ed_impls
    for label, h, pub, sig in lanes:
        assert port.verify(pub, h, sig) == jax_impl.verify(pub, h, sig), label
        try:
            want = jax_impl.recover(h, sig)
        except ValueError:
            with pytest.raises(ValueError):
                port.recover(h, sig)
        else:
            assert port.recover(h, sig) == want, label


def test_ed25519_batch_verify_matches_jax(ed_impls, ed_batches):
    """The same bit on every lane as the JAX suite and the host oracle; a
    signature shorter than 64 bytes lowers its bit and does not raise."""
    port, _, lanes = ed_impls
    got, want = ed_batches["port"][0], ed_batches["jax"][0]
    assert got.dtype == np.bool_ and got.shape == (LANES,)
    np.testing.assert_array_equal(got, want)
    for i, (label, h, pub, sig) in enumerate(lanes):
        assert got[i] == port.verify(pub, h, sig), label
    labels = [lane[0] for lane in lanes]
    assert got[labels.index("small-order key")] and got[labels.index("the zero row")]
    assert got.any() and not got.all()


def test_ed25519_batch_recover_matches_jax(ed_impls, ed_batches):
    """Keys and ok bits equal the JAX suite's on every lane; a not-ok lane's
    key is zero; a signature shorter than 96 bytes is not ok."""
    _, _, lanes = ed_impls
    _, pubs, ok = ed_batches["port"]
    _, jpubs, jok = ed_batches["jax"]
    assert pubs.dtype == np.uint8 and pubs.shape == (LANES, 32)
    assert ok.dtype == np.bool_ and ok.shape == (LANES,)
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_array_equal(pubs, jpubs)
    assert not pubs[~ok].any()
    for i, (label, _, _, sig) in enumerate(lanes):
        if len(sig) < 96:
            assert not ok[i], label
        elif ok[i]:
            assert bytes(pubs[i]) == sig[64:96], label
    assert ok.any() and not ok.all()


def test_ed25519_empty_batches(ed_impls, monkeypatch):
    """Zero items: the port returns (0,) bool and ((0, 32) uint8, (0,) bool)
    before any device work. The JAX suite's empty batch_verify, which skips
    its native loop, reaches its device leg, here swapped for the host loop
    of the same bits, and gives the same shape; its empty batch_recover
    raises (ROADMAP C records it), so the recover shapes are pinned here."""
    port, jax_impl, _ = ed_impls
    monkeypatch.setattr(jed, "verify_batch", lambda m, p, s: np.array(
        [ref_ed.verify(bytes(pp)[:32], bytes(mm), bytes(ss)[:64]) for mm, pp, ss in zip(m, p, s)], dtype=bool))
    got, want = port.batch_verify([], [], []), jax_impl.batch_verify([], [], [])
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (0,) and got.dtype == want.dtype
    keys, ok = port.batch_recover([], [])
    assert keys.shape == (0, 32) and keys.dtype == np.uint8 and ok.shape == (0,) and ok.dtype == np.bool_
    with pytest.raises(TypeError):
        jax_impl.batch_recover([], [])


def test_ed25519_batch_rows_must_line_up(ed_impls):
    port, _, lanes = ed_impls
    hashes, pubs, sigs = ([lane[k] for lane in lanes[:4]] for k in (1, 2, 3))
    for call in (
        lambda: port.batch_verify(hashes[:-1], pubs, sigs),
        lambda: port.batch_verify(hashes, pubs[1:], sigs),
        lambda: port.batch_recover(hashes, sigs[1:]),
    ):
        with pytest.raises(ValueError):
            call()
