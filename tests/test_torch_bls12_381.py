"""BLS12-381's aggregate-QC pairing check on the port, on the CPU: the
port's copy of the oracle (crypto/ref/bls12_381.py) against the JAX
package's; the plain PyTorch fields against the JAX eager fields at 2
lanes; the plain tower and twist steps against the oracle through
tests/test_bls.py's change of basis and the final exponentiation on the
Miller loop's outputs; the port's BLSCrypto
on a mixed batch of every lane kind against the JAX BLSCrypto, its rows
against the JAX device_inputs byte for byte and its GT elements against the
oracle's; and the CUDA kernel's arithmetic (csrc/bls12_381.cu) built as
host C++: its Fp product against Python integers, its whole pairing check
against the oracle. Every tolerance is exact. No JAX BLS program is
traced (the JAX fields run eagerly, as tests/test_bls.py runs them); a
plain pairing check costs seconds on the CPU whatever its lanes, so this
file makes one. The kernel itself runs only on the card, through
chip_smoke.py."""

import ctypes
import math
import random
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fisco_bcos_tpu.crypto import bls as jbls
from fisco_bcos_tpu.crypto.ref import bls12_381 as JR
from fisco_bcos_tpu.ops import bls12_381 as J
from fisco_bcos_tpu_torch.crypto import bls as pbls
from fisco_bcos_tpu_torch.crypto.ref import bls12_381 as R
from fisco_bcos_tpu_torch.ops import _kernels
from fisco_bcos_tpu_torch.ops import bls12_381 as K
from test_bls import _tower_host

P = R.P
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# The oracle copy
# ---------------------------------------------------------------------------


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except ValueError as e:
        return "raises", str(e)


def _g1_bytes_cases() -> list[bytes]:
    """Compressed G1 encodings: valid points and infinity, then one of each
    rejection: no compression flag, a bad infinity encoding, x >= p, an x
    with no root, a curve point outside the r-torsion."""
    good = [R.compress_g1(R.ec_mul(R.G1, k, R.FP_OPS)) for k in (1, 2, 0x1234567)] + [R.compress_g1(None)]
    no_root = next(x for x in range(1, 100) if R.fp_sqrt((x**3 + 4) % P) is None)
    off_group = next(x for x in range(1, 100) if R.fp_sqrt((x**3 + 4) % P) is not None)
    enc = lambda x, flags=0x80: bytes([x.to_bytes(48, "big")[0] | flags]) + x.to_bytes(48, "big")[1:]  # noqa: E731
    return good + [
        bytes([good[0][0] & 0x7F]) + good[0][1:],
        bytes([0xC0]) + b"\x00" * 46 + b"\x01",
        enc(P),
        enc(no_root),
        enc(off_group),
        enc(off_group, 0xA0),
    ]


def _g2_bytes_cases() -> list[bytes]:
    good = [R.compress_g2(R.ec_mul(R.G2, k, R.FP2_OPS)) for k in (1, 3)] + [R.compress_g2(None)]
    rhs = lambda x: R.f2_add(R.f2_mul(R.f2_sqr(x), x), R.XI_B)  # noqa: E731
    no_root = next((x, 0) for x in range(1, 100) if R.f2_sqrt(rhs((x, 0))) is None)
    off_group = next((x, 0) for x in range(1, 100) if R.f2_sqrt(rhs((x, 0))) is not None)
    enc = lambda x, flags=0x80: (  # noqa: E731
        bytes([x[1].to_bytes(48, "big")[0] | flags]) + x[1].to_bytes(48, "big")[1:] + x[0].to_bytes(48, "big")
    )
    return good + [
        bytes([good[0][0] & 0x7F]) + good[0][1:],
        bytes([0xC0]) + b"\x00" * 94 + b"\x01",
        enc((P, 0)),
        enc((0, P)),
        enc(no_root),
        enc(off_group),
    ]


def test_oracle_copy_matches_the_jax_oracle():
    """Parameters, derived cofactors, hash-to-G2 of seeded messages, keys,
    signatures, aggregates and the decoders (every rejection) as the JAX
    oracle gives them."""
    for name in ("P", "R_ORDER", "X_PARAM", "G1", "G2", "XI_B"):
        assert getattr(R, name) == getattr(JR, name), name
    assert R.g1_cofactor() == JR.g1_cofactor() and R.g2_cofactor() == JR.g2_cofactor()
    rng = random.Random(0xB15)
    for msg in (b"", rng.randbytes(32), rng.randbytes(77)):
        assert R.hash_to_g2(msg) == JR.hash_to_g2(msg)
    msg = rng.randbytes(32)
    keys = [R.keygen(rng.getrandbits(256)) for _ in range(3)]
    assert keys == [JR.keygen(s) for s in [k[0] for k in keys]]
    sigs = [R.sign(sk, msg) for sk, _ in keys]
    assert sigs == [JR.sign(sk, msg) for sk, _ in keys]
    assert R.aggregate_signatures(sigs) == JR.aggregate_signatures(sigs)
    assert R.aggregate_pubkeys([pk for _, pk in keys]) == JR.aggregate_pubkeys([pk for _, pk in keys])
    g1_cases, g2_cases = _g1_bytes_cases(), _g2_bytes_cases()
    outcomes = [_outcome(R.decompress_g1, b) for b in g1_cases] + [_outcome(R.decompress_g2, b) for b in g2_cases]
    assert outcomes == [_outcome(JR.decompress_g1, b) for b in g1_cases] + [
        _outcome(JR.decompress_g2, b) for b in g2_cases
    ]
    # every rejection kind is there: flags, infinity, range, root, subgroup
    reasons = {o[1] for o in outcomes if o[0] == "raises"}
    assert {"bad G1 encoding", "bad G1 infinity encoding", "G1 x out of range", "G1 x not on curve",
            "G1 point not in the r-torsion subgroup", "bad G2 encoding", "bad G2 infinity encoding",
            "G2 x out of range", "G2 x not on twist", "G2 point not in the r-torsion subgroup"} <= reasons


# ---------------------------------------------------------------------------
# The plain fields against the JAX eager fields (2 lanes) and the oracle
# ---------------------------------------------------------------------------


def _jax_fp(t: torch.Tensor):
    """[T, 24] port limbs -> the JAX [24, T] uint32 limb rows."""
    return jnp.asarray(t.numpy().T.astype(np.uint32))


def _port_fp(a) -> np.ndarray:
    return np.asarray(a).T.astype(np.int64)


def test_plain_fp_and_fp2_match_jax_eager():
    """Fp product, Fp2 product, f2_inv and f2_mul_xi: the same Montgomery
    limbs as the JAX package's eager functions (test_kernel_fp_montgomery,
    test_kernel_fp2_matches_reference)."""
    rng = random.Random(21)
    a = K.fp_from_int([rng.randrange(P) for _ in range(2)], CPU)
    b = K.fp_from_int([rng.randrange(P) for _ in range(2)], CPU)
    assert np.array_equal(K.fp_mul(a, b).numpy(), _port_fp(J.Fp.mul(_jax_fp(a), _jax_fp(b))))
    c = K.fp_from_int([rng.randrange(P) for _ in range(2)], CPU)
    x, y = torch.stack((a, b), 1), torch.stack((c, a), 1)  # [2, 2, 24]: two Fp2 lanes
    jx, jy = (_jax_fp(a), _jax_fp(b)), (_jax_fp(c), _jax_fp(a))

    def same(port, jax_pair):
        return np.array_equal(port.numpy(), np.stack([_port_fp(v) for v in jax_pair], 1))

    assert same(K.f2_mul(x, y), J.f2_mul(jx, jy))
    assert same(K.f2_inv(x), J.f2_inv(jx))
    assert same(K.f2_mul_xi(x), J.f2_mul_xi(jx))


def _to_jax_tower(t: torch.Tensor):
    """[1, 12, 24] flat port element -> the JAX tower tuple ((g0, g1, g2),
    (h0, h1, h2)) of Fp2 pairs of [24, 1] arrays."""
    fps = [_jax_fp(t[:, i]) for i in range(12)]
    pairs = [(fps[2 * i], fps[2 * i + 1]) for i in range(6)]
    return (tuple(pairs[:3]), tuple(pairs[3:]))


def _flat(t: torch.Tensor) -> tuple:
    """A port Fp12 through tests/test_bls.py's change of basis: the oracle's
    w-basis coefficients."""
    return _tower_host(J, _to_jax_tower(t))


def test_plain_tower_matches_the_oracle():
    """f12_mul, f12_sqr, f12_inv and f12_frob (k = 1, 2, 6) against the
    oracle's polynomial-basis Fp12; the port's own basis change is the
    test's."""
    rng = random.Random(23)
    a = tuple(rng.randrange(P) for _ in range(12))
    b = tuple(rng.randrange(P) for _ in range(12))
    ta, tb = K.tower_from_ref([a], CPU), K.tower_from_ref([b], CPU)
    assert _flat(ta) == a and K.tower_to_ref(ta) == [a]
    assert _flat(K.f12_mul(ta, tb)) == R.f12_mul(a, b)
    assert _flat(K.f12_sqr(ta)) == R.f12_mul(a, a)
    assert _flat(K.f12_inv(ta)) == R.f12_inv(a)
    for k in (1, 2, 6):
        assert _flat(K.f12_frob(ta, k)) == R.f12_frob(a, k), k
    # tower coefficients all p - 1 or 0 or 1: the largest unreduced sums and
    # products inside a tower product, and the zero and one edges
    edge = [K.tower_to_ref(K.tower_from_ref([v], CPU))[0] for v in ((P - 1,) * 12, (0,) * 12, (1,) + (0,) * 11)]
    te = K.tower_from_ref(edge, CPU)
    assert K.tower_to_ref(K.f12_mul(te, te.flip(0))) == [R.f12_mul(x, y) for x, y in zip(edge, edge[::-1])]


def test_plain_twist_steps_match_the_oracle():
    """A doubling and a mixed addition on the twist, brought back to affine:
    2·G2 and 2·G2 + 3·G2 = 5·G2, as the oracle's group law gives them."""
    q3 = R.ec_mul(R.G2, 3, R.FP2_OPS)
    f2 = lambda v: K.fp_from_int([v[0], v[1]], CPU)  # noqa: E731
    t = torch.stack((f2(R.G2[0]), f2(R.G2[1]), f2((1, 0))))[None]
    p = K.fp_from_int([5, 7], CPU)[None]  # any G1 point's coordinates: the line is not checked here

    def affine(t):
        (x0, x1), (y0, y1), (z0, z1) = [K.fp_to_int(t[0, i]) for i in range(3)]
        zi = R.f2_inv((z0, z1))
        zi2 = R.f2_sqr(zi)
        return R.f2_mul((x0, x1), zi2), R.f2_mul((y0, y1), R.f2_mul(zi, zi2))

    t2, _ = K.dbl_step(t, K.dbl_consts(p))
    assert affine(t2) == R.ec_double(R.G2, R.FP2_OPS)
    t5, _ = K.add_step(t2, torch.stack((f2(q3[0]), f2(q3[1])))[None], p)
    assert affine(t5) == R.ec_mul(R.G2, 5, R.FP2_OPS)


# ---------------------------------------------------------------------------
# The mixed batch: one lane of each kind, through the port's BLSCrypto
# ---------------------------------------------------------------------------


def _mixed_checks():
    """(pubs, msg, agg_sig) of every lane kind and what each means: a valid
    aggregate, an apk with one extra signer, a signature over the wrong
    message, a None apk (a malformed key), a None signature (malformed
    bytes), a single signer, and a whole committee on a second message."""
    rng = random.Random(0xA99)
    keys = [R.keygen(rng.getrandbits(256)) for _ in range(5)]
    msg, other = rng.randbytes(32), rng.randbytes(32)
    pubs = [pk for _, pk in keys]
    sig = lambda ids, m: R.aggregate_signatures([R.sign(keys[i][0], m) for i in ids])  # noqa: E731
    quorum = sig([0, 1, 2], msg)
    return [
        ("a valid aggregate", (tuple(pubs[:3]), msg, quorum)),
        ("an apk with one extra signer", (tuple(pubs[:4]), msg, quorum)),
        ("a signature on the wrong message", (tuple(pubs[:3]), msg, sig([0, 1, 2], other))),
        ("a None apk", ((pubs[0], b"\x00" * 48), msg, quorum)),
        ("a None signature", (tuple(pubs[:3]), msg, b"\x00" * 96)),
        ("a single signer", ((pubs[4],), msg, sig([4], msg))),
        ("the whole committee", (tuple(pubs), other, sig(range(5), other))),
    ]


def _jax_triples(checks):
    """The JAX class's decoded (apk, sig, hm) a lane."""
    out = []
    for pubs, msg, agg in checks:
        apk = jbls._apk_point(tuple(pubs)) if pubs else None
        sig = jbls._g2_point(agg)
        out.append((apk, sig, JR.hash_to_g2(msg) if apk is not None and sig is not None else None))
    return out


@pytest.fixture(scope="module")
def mixed():
    """The port's BLSCrypto on the CPU over the mixed batch, the one plain
    pairing check of this file: its bits, and the rows, Miller loop outputs
    and GT elements its plain version saw."""
    named = _mixed_checks()
    checks = [c for _, c in named]
    seen = {}
    real_gt, real_miller = K.pairing_gt_plain, K.miller2

    def gt_spy(rows):
        seen["rows"] = rows.clone()
        seen["gt"] = real_gt(rows)
        return seen["gt"]

    def miller_spy(ps, qs):
        seen["f"] = real_miller(ps, qs)
        return seen["f"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(K, "pairing_gt_plain", gt_spy)
        mp.setattr(K, "miller2", miller_spy)
        bits = pbls.BLSCrypto(CPU).aggregate_verify_batch(checks)
    return {"names": [n for n, _ in named], "checks": checks, "bits": bits, **seen}


def test_aggregate_verify_batch_matches_the_jax_class(mixed):
    """The port's bits equal the JAX BLSCrypto's (its host route on the CPU)
    and the JAX host_pairing_check_batch's on every lane; the lanes that
    should pass do."""
    want = jbls.BLSCrypto().aggregate_verify_batch(mixed["checks"])
    assert mixed["bits"].dtype == bool and list(mixed["bits"]) == list(want)
    assert list(want) == list(J.host_pairing_check_batch(_jax_triples(mixed["checks"])))
    passing = {n for n, ok in zip(mixed["names"], want) if ok}
    assert passing == {"a valid aggregate", "a single signer", "the whole committee"}


def test_rows_match_jax_device_inputs(mixed):
    """The rows the plain version saw equal the JAX device_inputs at the
    batch's size, byte for byte (rows_from_jax joins its 16-bit limbs); the
    port's own device_inputs gives them too, with the same valid bits."""
    triples = _jax_triples(mixed["checks"])
    arrays, jvalid = J.device_inputs(triples, pad_to=len(triples))
    want = K.rows_from_jax(arrays)
    assert mixed["rows"].numpy().tobytes() == want.tobytes()
    rows, valid = K.device_inputs(triples)
    assert rows.dtype == np.int32 and rows.tobytes() == want.tobytes()
    assert list(valid) == list(jvalid)


def _oracle_pairs(triples) -> list[list]:
    """The oracle's pairs a lane, [(-g1, σ), (apk, H(m))], on the lane's
    points or, where one is None, on the substitutes."""
    out = []
    for apk, sig, hm in triples:
        if apk is None or sig is None or hm is None:
            apk, sig, hm = K._SUB_APK, K._SUB_SIG, K._SUB_HM
        out.append([(JR.ec_neg(JR.G1, JR.FP_OPS), sig), (apk, hm)])
    return out


@pytest.fixture(scope="module")
def oracle_pairs(mixed):
    return _oracle_pairs(_jax_triples(mixed["checks"]))


@pytest.fixture(scope="module")
def oracle_gt(oracle_pairs):
    """The JAX oracle's final_exponentiation(miller_loop(...)) a lane."""
    return [JR.final_exponentiation(JR.miller_loop(pairs)) for pairs in oracle_pairs]


def test_oracle_copy_pairing_matches_the_jax_oracle(oracle_pairs, oracle_gt):
    """The copy's miller_loop, final_exponentiation and pairing_check equal
    the JAX oracle's on every lane of the mixed batch."""
    for pairs, gt in zip(oracle_pairs, oracle_gt):
        f = R.miller_loop(pairs)
        assert f == JR.miller_loop(pairs)
        assert R.final_exponentiation(f) == gt
        assert R.pairing_check(pairs) == JR.pairing_check(pairs) == (gt == JR.F12_ONE)


def test_plain_gt_elements_match_the_oracle(mixed, oracle_gt):
    """The GT element of each lane before the comparison equals the
    oracle's, and the plain verdict is its comparison with 1."""
    assert K.tower_to_ref(mixed["gt"]) == oracle_gt
    valid = K.device_inputs(_jax_triples(mixed["checks"]))[1]
    assert list(K.f12_eq_one(mixed["gt"]).numpy() & valid) == list(mixed["bits"])


def test_plain_final_exponentiation_matches_the_oracle(mixed):
    """The easy part and the hard part's chain, on each lane's Miller loop
    output: the oracle's final_exponentiation of the same element."""
    lanes = range(mixed["f"].shape[0])
    assert [_flat(mixed["gt"][i : i + 1]) for i in lanes] == [
        R.final_exponentiation(_flat(mixed["f"][i : i + 1])) for i in lanes
    ]


def test_empty_and_undecodable_batches_make_no_pairing(monkeypatch):
    """An empty batch gives bool[0]; a batch whose every lane fails to
    decode is rejected before any pairing; with no device named and no
    CUDA the entry points raise."""
    monkeypatch.setattr(K, "pairing_check_device", lambda rows: pytest.fail("a pairing ran"))
    crypto = pbls.BLSCrypto(CPU)
    assert K.pairing_check_batch([], device="cpu").shape == (0,)
    assert crypto.aggregate_verify_batch([]).shape == (0,)
    pubs, msg, _ = _mixed_checks()[0][1]
    assert list(crypto.aggregate_verify_batch([(pubs, msg, b"\x00" * 96), ((), msg, b"\x00" * 96)])) == [False] * 2
    assert not crypto.aggregate_verify(pubs, msg, b"\x80" + b"\x00" * 95)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            K.pairing_check_batch([(R.G1, R.G2, R.G2)])
        with pytest.raises(RuntimeError):
            pbls.BLSCrypto().aggregate_verify_batch([(pubs, msg, b"\x00" * 96)])
        with pytest.raises(RuntimeError):
            pbls.bls_suite()


def test_host_calls_match_the_jax_class():
    """sign, verify, aggregate, batch_verify and the keys equal the JAX
    class's (all on the host oracle in both)."""
    port, jax_ = pbls.BLSCrypto(CPU), jbls.BLSCrypto()
    kps = [port.generate_keypair(secret=0xB0 + i) for i in range(2)]
    assert [kp.pub for kp in kps] == [jax_.generate_keypair(secret=0xB0 + i).pub for i in range(2)]
    msg = bytes(range(32))
    sigs = [port.sign(kp, msg) for kp in kps]
    assert sigs == [jax_.sign(jax_.generate_keypair(secret=0xB0 + i), msg) for i in range(2)]
    assert port.aggregate(sigs) == jax_.aggregate(sigs)
    args = ([msg, msg[::-1]], [kps[0].pub, kps[1].pub], sigs)
    assert list(port.batch_verify(*args)) == list(jax_.batch_verify(*args)) == [True, False]
    with pytest.raises(ValueError):
        port.recover(msg, sigs[0])
    suite = pbls.bls_suite("cpu")
    assert suite.signature_impl.device == suite.hash_impl.device == CPU


# ---------------------------------------------------------------------------
# The kernel's arithmetic, built as host C++
# ---------------------------------------------------------------------------

SHIM = r"""
#include "{src}"

// lane i: r = a·b/R mod p (op 0), or a·a/R (op 1); alias: the output starts
// as a copy of a and the product reads its operands from it
extern "C" int host_fp_op(int op, const u32* a, const u32* b, u32* r, int n, int alias) {{
  for (int i = 0; i < n; i++) {{
    fp x, y, o;
    fp_load(x, a + BLS_NW * i);
    fp_load(y, b + BLS_NW * i);
    o = x;
    if (op == 0 && alias) fp_mul(o, o, y);
    else if (op == 0) fp_mul(o, x, y);
    else if (op == 1 && alias) fp_mul(o, o, o);
    else if (op == 1) fp_mul(o, x, x);
    else return -1;
    for (int k = 0; k < BLS_NW; k++) r[BLS_NW * i + k] = o.w[k];
  }}
  return 0;
}}

// each lane's pairing check: ok, its GT element (144 words), and the Fp
// products (all, then squarings) the lanes made together
extern "C" void host_pairing(const u32* rows, const u32* table, uint8_t* ok, u32* gt, int n,
                             unsigned long long* counts) {{
  bls_count_mul = bls_count_sqr = 0;
  for (int i = 0; i < n; i++) {{
    fp12 e;
    ok[i] = bls_pairing_lane(rows + (long)i * BLS_ROW_WORDS, table, e);
    const u32* w = e.c0.c0.c0.w;
    for (int k = 0; k < 12 * BLS_NW; k++) gt[(long)i * 12 * BLS_NW + k] = w[k];
  }}
  counts[0] = bls_count_mul + bls_count_sqr;
  counts[1] = bls_count_sqr;
}}

// the Fp products one step of a check makes: 0 an Fp12 squaring, 1 a
// doubling step, 2 an addition step, 3 a product by a line, 4 an Fp12
// inverse, 5 an Fp12 product, 6-8 the p^2-, p- and p^6-Frobenius
extern "C" unsigned long long host_step_products(int op, const u32* table) {{
  fp12 f, g;
  fp* c = &f.c0.c0.c0;
  for (int i = 0; i < 12; i++) {{
    fp_zero(c[i]);
    c[i].w[0] = 3 + i;
  }}
  const fp12 h = f;
  g2j t;
  t.x = f.c0.c0;
  t.y = f.c0.c1;
  t.z = f.c0.c2;
  fp2 c0, c2, c3;
  bls_count_mul = bls_count_sqr = 0;
  switch (op) {{
    case 0: fp12_sqr(g, f); break;
    case 1: dbl_step(t, c[0], c[1], c0, c2, c3); break;
    case 2: add_step(t, f.c1.c0, f.c1.c1, c[0], c[1], c0, c2, c3); break;
    case 3: fp12_mul_line(g, f, f.c1.c0, f.c1.c1, f.c1.c2); break;
    case 4: fp12_inv(g, f); break;
    case 5: fp12_mul(g, f, h); break;
    case 6: fp12_frob(g, f, 1, table); break;
    case 7: fp12_frob(g, f, 0, table); break;
    case 8: fp12_frob(g, f, 2, table); break;
    default: return ~0ull;
  }}
  return bls_count_mul + bls_count_sqr;
}}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's arithmetic for the host")
    d = tmp_path_factory.mktemp("bls_host")
    shim = d / "shim.cpp"
    shim.write_text(SHIM.format(src=_kernels.SOURCES["bls12_381"]))
    lib_path = d / "libbls_host.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(lib_path), str(shim)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.host_fp_op.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.host_fp_op.restype = ctypes.c_int
    lib.host_pairing.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    lib.host_pairing.restype = None
    lib.host_step_products.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.host_step_products.restype = ctypes.c_ulonglong
    return lib


def _words(vals) -> np.ndarray:
    return np.ascontiguousarray([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(12)] for v in vals], dtype=np.uint32)


def _ints(words: np.ndarray) -> list[int]:
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in words]


@pytest.mark.parametrize("alias", [False, True])
def test_kernel_fp_product_matches_python_ints(host_kernel, alias):
    """The kernel's CIOS product a·b·2^-384 mod p and its squaring, on edge
    and seeded operands within their domain (a·b < p·2^384: a up to
    2^384 - 1 against b < p; a squared below √(p·2^384)), and in place."""
    rinv = pow(K.R384, -1, P)
    rng = random.Random(0xF9)
    top = (1 << 384) - 1
    edge_a = [0, 1, 2, P - 1, P, P + 1, top, top - 1, 1 << 383, (1 << 383) - 1, 0xFFFFFFFF, 1 << 352]
    edge_b = [P - 1, P - 1, 1, 0, P - 1, 1, P - 1, 2, P - 2, (P + 1) // 2, P - 1, P - 1]
    a = edge_a + [rng.randrange(1 << 384) for _ in range(12)]
    b = edge_b + [rng.randrange(P) for _ in range(12)]
    sq_max = math.isqrt(P * K.R384 - 1)
    s = [0, 1, P - 1, P, sq_max, sq_max - 1, 1 << 381, (1 << 381) - 1] + [rng.randrange(sq_max) for _ in range(8)]
    for op, x, y, want in (
        (0, a, b, [u * v * rinv % P for u, v in zip(a, b)]),
        (1, s, s, [u * u * rinv % P for u in s]),
    ):
        xw, yw = _words(x), _words(y)
        out = np.zeros_like(xw)
        assert host_kernel.host_fp_op(op, xw.ctypes.data, yw.ctypes.data, out.ctypes.data, len(x), int(alias)) == 0
        assert _ints(out) == want, op


def test_kernel_pairing_check_matches_the_oracle(host_kernel, mixed, oracle_gt):
    """The kernel's whole pairing check on the mixed batch's rows: the
    oracle's bits and GT elements on every lane, and the Fp products a
    lane makes, the count chip_smoke.py's bound takes."""
    rows = np.ascontiguousarray(mixed["rows"].numpy())
    n = rows.shape[0]
    table = np.ascontiguousarray(K.KERNEL_TABLE)
    ok = np.zeros(n, dtype=np.uint8)
    gt = np.zeros((n, 144), dtype=np.uint32)
    counts = (ctypes.c_ulonglong * 2)()
    host_kernel.host_pairing(rows.ctypes.data, table.ctypes.data, ok.ctypes.data, gt.ctypes.data, n, counts)
    valid = K.device_inputs(_jax_triples(mixed["checks"]))[1]
    assert list(ok.astype(bool) & valid) == list(mixed["bits"])
    assert K.tower_to_ref(K.words_to_limbs(torch.from_numpy(gt.view(np.int32)))) == oracle_gt
    assert (counts[0] // n, counts[1] // n) == (chip_smoke.BLS_FP_PRODUCTS, chip_smoke.BLS_FP_SQUARINGS)
    assert counts[0] % n == 0 and counts[1] % n == 0


# the steps of chip_smoke.BLS_CHAIN in the order of host_step_products' ops
# (the Fp12 squarings of the hard part are the kernel's generic ones, and a
# conjugation its p^6-Frobenius)
_STEP_OPS = {"fp12_sqr": 0, "dbl": 1, "add": 2, "line": 3, "fp12_inv": 4, "fp12_mul": 5,
             "frob_p2": 6, "frob_p": 7, "conj": 8, "cyclo_sqr": 0}


def test_bound_chain_prices_the_kernels_steps(host_kernel):
    """chip_smoke.py's chain of a check (BLS_CHAIN), each step priced at
    the Fp products the kernel's host build makes for it, gives the
    products the whole check makes; priced at the least work
    (BLS_LEAST_FP), no step costs more than the kernel's, and the
    cyclotomic squarings half its generic ones."""
    table = np.ascontiguousarray(K.KERNEL_TABLE)
    made = {op: host_kernel.host_step_products(code, table.ctypes.data) for op, code in _STEP_OPS.items()}
    chain = chip_smoke.BLS_CHAIN
    assert sum(n * made[op] for op, n in chain.items()) == chip_smoke.BLS_FP_PRODUCTS
    least = chip_smoke.BLS_LEAST_FP
    assert set(least) == set(chain) == set(made)
    assert all(least[op] <= made[op] for op in chain)
    assert least["cyclo_sqr"] * 2 == made["cyclo_sqr"] == 36
    assert chip_smoke.BLS_LEAST_PRODUCTS == sum(n * least[op] for op, n in chain.items()) == 18_806
