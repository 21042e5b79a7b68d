"""BLS12-381's aggregate-QC pairing check on the port, on the CPU: the
port's copy of the oracle (crypto/ref/bls12_381.py) against the JAX
package's; the plain PyTorch fields against the JAX eager fields at 2
lanes; the plain tower and twist steps against the oracle through
tests/test_bls.py's change of basis and the final exponentiation on the
Miller loop's outputs; the port's BLSCrypto
on a mixed batch of every lane kind against the JAX BLSCrypto, its rows
against the JAX device_inputs byte for byte and its GT elements against the
oracle's; the kernel's programs (ops/bls12_381_programs.py: the committed
header is the generator's output, no row has a hazard between its lanes,
the script over Python integers gives the oracle's GT elements); and the
CUDA kernel's arithmetic (csrc/bls12_381.cu) built as host C++: its Fp
products and inversions against Python integers, its cyclotomic squaring
against the generic one, its whole pairing check against the oracle at 1,
3, 5 and 7 lanes. Every tolerance is exact. No JAX BLS program is traced
(the JAX fields run eagerly, as tests/test_bls.py runs them); a plain
pairing check costs seconds on the CPU whatever its lanes, so this file
makes one. The kernel itself runs only on the card, through
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
from fisco_bcos_tpu_torch.ops import bls12_381_programs as BP
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

// lane i: r = a·b/R mod p (op 0) or a·a/R (op 1) by bls_mul; a^-1 mod p
// (op 2) and, for a Montgomery a·R, (a·R)^-1·R^2 (op 3) by the divsteps;
// a + b (op 4) and a - b (op 5) mod p; alias: the output starts as a copy of
// a and the op reads its operands from it
extern "C" int host_fp_op(int op, const u32* a, const u32* b, u32* r, int n, int alias) {{
  for (int i = 0; i < n; i++) {{
    u32 x[BLS_NW], y[BLS_NW], o[BLS_NW];
    for (int k = 0; k < BLS_NW; k++) x[k] = a[BLS_NW * i + k], y[k] = b[BLS_NW * i + k], o[k] = x[k];
    const u32* u = alias ? o : x;
    switch (op) {{
      case 0: bls_mul(o, u, y); break;
      case 1: bls_mul(o, u, u); break;
      case 2: bls_inv_divstep_plain(o, u); break;
      case 3: bls_inv_divstep(o, u); break;
      case 4: bls_addsub(o, u, y, false); break;
      case 5: bls_addsub(o, u, y, true); break;
      default: return -1;
    }}
    for (int k = 0; k < BLS_NW; k++) r[BLS_NW * i + k] = o[k];
  }}
  return 0;
}}

// each lane's pairing check: ok, its GT element (144 words), and the Fp
// products (all, then squarings) the lanes made together
extern "C" void host_pairing(const u32* rows, const u32* table, uint8_t* ok, u32* gt, int n,
                             unsigned long long* counts) {{
  static u32 sl[BLS_SLOT_WORDS];
  bls_count_mul = bls_count_sqr = 0;
  for (int i = 0; i < n; i++)
    bls_pairing_check(rows + (long)i * BLS_ROW_WORDS, table, sl, ok + i, gt + (long)i * 12 * BLS_NW);
  counts[0] = bls_count_mul + bls_count_sqr;
  counts[1] = bls_count_sqr;
}}

// program `prog` over a check's slots (BLS_SLOT_WORDS words); returns the Fp
// products it made
extern "C" unsigned long long host_program(int prog, u32* slots) {{
  bls_count_mul = bls_count_sqr = 0;
  bls_run_program(prog, slots);
  return bls_count_mul + bls_count_sqr;
}}

extern "C" int host_slot_words() {{ return BLS_SLOT_WORDS; }}
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
    lib.host_program.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.host_program.restype = ctypes.c_ulonglong
    lib.host_slot_words.restype = ctypes.c_int
    return lib


def _words(vals) -> np.ndarray:
    return np.ascontiguousarray([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(12)] for v in vals], dtype=np.uint32)


def _ints(words: np.ndarray) -> list[int]:
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in words]


@pytest.mark.parametrize("alias", [False, True])
def test_kernel_fp_product_matches_python_ints(host_kernel, alias):
    """The kernel's product a·b·2^-384 mod p and its squaring, on edge and
    seeded operands within their domain (a·b < p·2^384: a up to 2^384 - 1
    against b < p; a squared below √(p·2^384)), and in place."""
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


@pytest.mark.parametrize("alias", [False, True])
def test_kernel_fp_inversion_matches_python_ints(host_kernel, alias):
    """The kernel's Fp inversion by the divsteps, plain (a^-1 mod p) and in
    the Montgomery domain ((a·R)^-1·R^2): Python's pow on edge and seeded
    operands below p, 0 -> 0, and in place."""
    rng = random.Random(0x1D5)
    a = [0, 1, 2, 3, P - 1, P - 2, (P + 1) // 2, 1 << 380, (1 << 380) - 1, 0xFFFFFFFF, 1 << 352]
    a += [rng.randrange(P) for _ in range(21)]
    inv = [pow(v, -1, P) if v else 0 for v in a]
    mont = [pow(v, -1, P) * K.R384 * K.R384 % P if v else 0 for v in a]
    for op, want in ((2, inv), (3, mont)):
        xw = _words(a)
        out = np.zeros_like(xw)
        assert host_kernel.host_fp_op(op, xw.ctypes.data, xw.ctypes.data, out.ctypes.data, len(a), int(alias)) == 0
        assert _ints(out) == want, op


@pytest.mark.parametrize("alias", [False, True])
def test_kernel_fp_sum_and_difference_match_python_ints(host_kernel, alias):
    """The kernel's sum and difference mod p (bls_addsub, one path for
    both) on canonical edge and seeded operands, and in place."""
    rng = random.Random(0xADD)
    edge = [0, 1, 2, P - 1, P - 2, (P - 1) // 2, (P + 1) // 2, 1 << 380, (1 << 380) - 1, 0xFFFFFFFF]
    a = [x for x in edge for _ in edge] + [rng.randrange(P) for _ in range(40)]
    b = [y for _ in edge for y in edge] + [rng.randrange(P) for _ in range(40)]
    sums, diffs = [(u + v) % P for u, v in zip(a, b)], [(u - v) % P for u, v in zip(a, b)]
    for op, want in ((4, sums), (5, diffs)):
        xw, yw = _words(a), _words(b)
        out = np.zeros_like(xw)
        assert host_kernel.host_fp_op(op, xw.ctypes.data, yw.ctypes.data, out.ctypes.data, len(a), int(alias)) == 0
        assert _ints(out) == want, op


def _host_check(host_kernel, rows: np.ndarray):
    rows = np.ascontiguousarray(rows)
    n = rows.shape[0]
    table = np.ascontiguousarray(K.KERNEL_TABLE)
    ok = np.zeros(n, dtype=np.uint8)
    gt = np.zeros((n, 144), dtype=np.uint32)
    counts = (ctypes.c_ulonglong * 2)()
    host_kernel.host_pairing(rows.ctypes.data, table.ctypes.data, ok.ctypes.data, gt.ctypes.data, n, counts)
    return ok.astype(bool), K.tower_to_ref(K.words_to_limbs(torch.from_numpy(gt.view(np.int32)))), counts


def test_kernel_pairing_check_matches_the_oracle(host_kernel, mixed, oracle_gt):
    """The kernel's whole pairing check on the mixed batch's rows: the
    oracle's bits and GT elements on every lane, and the Fp products a
    lane makes, the count chip_smoke.py prints beside the bound."""
    rows = mixed["rows"].numpy()
    n = rows.shape[0]
    ok, gt, counts = _host_check(host_kernel, rows)
    valid = K.device_inputs(_jax_triples(mixed["checks"]))[1]
    assert list(ok & valid) == list(mixed["bits"])
    assert gt == oracle_gt
    assert (counts[0] // n, counts[1] // n) == (chip_smoke.BLS_FP_PRODUCTS, chip_smoke.BLS_FP_SQUARINGS)
    assert counts[0] % n == 0 and counts[1] % n == 0


@pytest.mark.parametrize("lanes", [1, 3, 5])
def test_kernel_small_batches_match_the_oracle(host_kernel, mixed, oracle_gt, lanes):
    """Batches of 1, 3 and 5 checks, each lane its own check: the oracle's
    bits and GT elements."""
    rows = mixed["rows"].numpy()[:lanes]
    ok, gt, _ = _host_check(host_kernel, rows)
    valid = K.device_inputs(_jax_triples(mixed["checks"][:lanes]))[1]
    assert list(ok & valid) == list(mixed["bits"][:lanes])
    assert gt == oracle_gt[:lanes]


def test_programs_over_ints_match_the_oracle(mixed, oracle_gt):
    """The programs' script over Python integers (ops/bls12_381_programs.py
    run_check) on the mixed batch's rows: the oracle's GT elements, and
    its product count the kernel's less the inversion's."""
    table = _ints(np.asarray(K.KERNEL_TABLE).view(np.uint32).reshape(-1, 12))
    for row, want in zip(mixed["rows"].numpy(), oracle_gt):
        ok, gt = BP.run_check(_ints(row.view(np.uint32).reshape(-1, 12)), table)
        words = _words(gt).view(np.int32).reshape(1, 144)
        assert K.tower_to_ref(K.words_to_limbs(torch.from_numpy(words))) == [want]
        assert ok == (want == JR.F12_ONE)
    assert sum(BP.script_products().values()) + _INV_PRODUCTS == chip_smoke.BLS_FP_PRODUCTS


def test_programs_header_is_the_generators_output():
    """csrc/bls12_381_programs.cuh is what ops/bls12_381_programs.py
    writes (python -m fisco_bcos_tpu_torch.ops.bls12_381_programs)."""
    assert BP.HEADER.read_text() == BP.header_text()


def _header_array(name: str) -> list[int]:
    text = BP.HEADER.read_text()
    body = text[text.index(f"{name}) = {{") :]
    body = body[body.index("{") + 1 : body.index("};")]
    return [int(v.strip().rstrip("u"), 16) for v in body.replace("\n", " ").split(",") if v.strip()]


def test_program_rows_have_no_hazard():
    """Every row of every program in the committed header: at most BLS_G
    ops, of one kind, over slots below BLS_SLOTS, and no op writes a slot
    that another op of its row reads or writes (the lanes of a row run at
    once; the host build runs them in turn)."""
    rows, ops = _header_array("BLS_ROWS"), _header_array("BLS_OPS")
    slots = BP.compiled()["slots"]
    assert len(rows) == sum(len(p.rows) for p in BP.compiled()["programs"])
    for r, row in enumerate(rows):
        n, off = (row >> 1) & 127, row >> 8
        assert 1 <= n <= BP.G, r
        row_ops = [(o & 1023, (o >> 10) & 1023, (o >> 20) & 1023) for o in ops[off : off + n]]
        assert all(max(op) < slots for op in row_ops), r
        dsts = [d for d, _, _ in row_ops]
        assert len(set(dsts)) == len(dsts), r
        for j, (d, _, _) in enumerate(row_ops):
            assert all(d not in (a, b) for k, (_, a, b) in enumerate(row_ops) if k != j), (r, j)
    assert max(p.temps for p in BP.compiled()["programs"]) + BP.N_PINNED == slots


def _tower_words(elems) -> list[int]:
    """Oracle w-basis elements -> the tower's flat coefficients as
    Montgomery ints (the kernel's slots)."""
    out = []
    for flat in elems:
        for beta in range(2):
            for alpha in range(3):
                b = flat[2 * alpha + beta + 6]
                out += [(flat[2 * alpha + beta] + b) % P * K.R384 % P, b * K.R384 % P]
    return out


def _cyclo_program(host_kernel, elem) -> tuple:
    """The kernel's cyclotomic squaring program (register A <- A²) on one
    oracle element, through the g++ build: (the result, its products)."""
    progs = BP.compiled()["programs"]
    index = next(i for i, p in enumerate(progs) if p.key == ("cyclo", "A", "A"))
    slots = np.zeros(host_kernel.host_slot_words(), dtype=np.uint32)
    vals = _ints(np.asarray(K.KERNEL_TABLE).view(np.uint32).reshape(-1, 12))
    for slot, src, i in BP.LOADS:
        if src == "table":
            slots[12 * slot : 12 * slot + 12] = _words([vals[i]])[0]
    a0 = BP.PINNED["A_0"]
    slots[12 * a0 : 12 * a0 + 144] = _words(_tower_words([elem])).reshape(-1)
    made = host_kernel.host_program(index, slots.ctypes.data)
    words = slots[12 * a0 : 12 * a0 + 144].view(np.int32).reshape(1, 144)
    return K.tower_to_ref(K.words_to_limbs(torch.from_numpy(words.copy())))[0], made


def test_kernel_cyclotomic_squaring_matches_the_generic_squaring(host_kernel):
    """The kernel's Granger-Scott squaring, built with g++, on seeded
    elements of the cyclotomic subgroup (a random element after the easy
    part, f^((p⁶ - 1)(p² + 1))): the generic squaring's result, the
    plain version's f12_sqr and the oracle's product alike, in 18 Fp
    products. On an element outside the subgroup it differs."""
    rng = random.Random(0xC1C)
    for _ in range(3):
        a = tuple(rng.randrange(P) for _ in range(12))
        u = R.f12_mul(R.f12_frob(a, 6), R.f12_inv(a))
        m = R.f12_mul(R.f12_frob(u, 2), u)
        got, made = _cyclo_program(host_kernel, m)
        assert got == R.f12_mul(m, m) == K.tower_to_ref(K.f12_sqr(K.tower_from_ref([m], CPU)))[0]
        assert made == 18
    assert _cyclo_program(host_kernel, a)[0] != R.f12_mul(a, a)


# The Fp inversion's one product (the divsteps' result into the Montgomery
# domain) and the chain's steps as the kernel's programs make them:
# each step's products by the generator's tags, the programs' own counts
# checked against the g++ build's.
_INV_PRODUCTS = 1
_STEP_PROGRAMS = {"fp12_sqr": (("miller", False), 1), "dbl": (("miller", False), 2),
                  "line": (("miller", False), 2), "add": (("miller", True), 2),
                  "fp12_mul": (("mul", "A", "A", "F"), 1), "frob_p2": (("frob_p2", "A", "B"), 1),
                  "frob_p": (("frob_p", "C", "B"), 1), "conj": (("conj", "A", "A"), 1)}


def test_bound_chain_prices_the_kernels_steps(host_kernel):
    """chip_smoke.py's chain of a check (BLS_CHAIN), each step priced at
    the Fp products the kernel's programs make for it (the cyclotomic
    squaring by its g++ build), gives the products the whole check makes;
    priced at the least work (BLS_LEAST_FP), no step costs more than the
    kernel's, and the cyclotomic squaring is the least's 18."""
    progs = BP.compiled()["programs"]
    slots = np.zeros(host_kernel.host_slot_words(), dtype=np.uint32)
    by_key = {}
    for i, p in enumerate(progs):  # each program's g++ count is its tags' sum
        assert host_kernel.host_program(i, slots.ctypes.data) == sum(p.products.values()), p.key
        by_key[p.key] = p
    made = {op: by_key[key].products.get(op, 0) // n for op, (key, n) in _STEP_PROGRAMS.items()}
    made["fp12_inv"] = (by_key[("inv_a",)].products["fp12_inv"] + by_key[("inv_b",)].products["fp12_inv"]
                        + _INV_PRODUCTS)
    made["cyclo_sqr"] = _cyclo_program(host_kernel, R.F12_ONE)[1]
    chain = chip_smoke.BLS_CHAIN
    assert sum(n * made[op] for op, n in chain.items()) == chip_smoke.BLS_FP_PRODUCTS
    least = chip_smoke.BLS_LEAST_FP
    assert set(least) == set(chain) == set(made)
    assert all(least[op] <= made[op] for op in chain)
    assert least["cyclo_sqr"] == made["cyclo_sqr"] == 18
    assert chip_smoke.BLS_LEAST_PRODUCTS == sum(n * least[op] for op, n in chain.items()) == 18_806
