"""Port Ed25519 verification (plain PyTorch) against the JAX package's
``verify_batch`` (its ``_verify_xla``, traced once, at the 32-lane bucket
that tests/conftest.py sets) and both RFC 8032 oracles (the port's copy of
``crypto/ref/ed25519.py`` and the JAX package's), on one 32-lane batch
holding a lane of every kind: valid signatures, tampered ones, encodings
with y >= p, x = 0 with the sign bit set, s >= L, small-order keys and R,
mixed-order R and keys that the cofactored equation accepts, a y with no
root and the all-zero row. Also the comb table pinned to the JAX one,
decompression of the edge encodings against the ref's, and the CUDA
kernel's arithmetic built as host C++ against the plain version and the
oracle: the whole verification, and each quad program (doubling, addition,
mixed addition, the pair decompression) against the plain group law, a
quad's four lanes run one after another (the kernel itself runs only on the
card, through chip_smoke.py)."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fisco_bcos_tpu.crypto.ref import ed25519 as jref
from fisco_bcos_tpu.ops import ed25519 as jed
from fisco_bcos_tpu_torch import params
from fisco_bcos_tpu_torch.crypto.ref import ed25519 as ref
from fisco_bcos_tpu_torch.ops import _kernels, ed25519, limb

P, L, D = ref.P, ref.L, ref.D
LANES = 32  # one bucket of tests/conftest.py's FISCO_TEST_BUCKET
KERNEL_SRC = _kernels.SOURCES["ed25519_verify"]


def _enc(y: int, sign: int = 0) -> bytes:
    return (y | sign << 255).to_bytes(32, "little")


def _is_ident(pt) -> bool:
    return ref._eq_points(pt, ref.IDENT)


def _order8_point():
    """T8 = L·P for decompressed P, the first whose order is 8."""
    y = 2
    while True:
        pt = ref._decompress(_enc(y))
        if pt is not None:
            t = ref._mul(L, pt)
            if not _is_ident(ref._mul(4, t)):
                return t
        y += 1


def _no_root_y() -> int:
    """The least y < p whose x² = (y² - 1)/(d·y² + 1) has no root."""
    y = 2
    while ref._decompress(_enc(y)) is not None:
        y += 1
    return y


T8 = _order8_point()
EDGE_ENCODINGS = {
    "identity (y = 1)": _enc(1),
    "y = -1, order 2": _enc(P - 1),
    "y = 0, order 4": _enc(0),
    "y = 0, sign 1": _enc(0, 1),
    "order 8": ref._compress(T8),
    "x = 0, sign 1 (y = 1)": _enc(1, 1),
    "x = 0, sign 1 (y = -1)": _enc(P - 1, 1),
    "y = p": _enc(P),
    "y = 2^255 - 1": b"\xff" * 31 + b"\x7f",
    "y = p + 1, sign 1": _enc(P + 1, 1),
    "y with no root": _enc(_no_root_y()),
    "the base point": ref._compress(ref.BASE),
}


def _signer(i: int):
    seed = (0xED25519 + 104729 * i).to_bytes(32, "little")
    return seed, ref._clamp(ref._sha512(seed)), ref.seed_to_pubkey(seed)


def _sign_with(a: int, pub: bytes, msg: bytes, r: int, extra=None) -> bytes:
    """R = r·B (+ extra), s = r + k·a mod L, k the challenge of R ‖ pub ‖ msg:
    what the cofactored equation accepts for small-order parts."""
    rpt = ref._mul(r, ref.BASE)
    if extra is not None:
        rpt = ref._add(rpt, extra)
    rc = ref._compress(rpt)
    k = int.from_bytes(ref._sha512(rc + pub + msg), "little") % L
    return rc + ((r + k * a) % L).to_bytes(32, "little")


def _lanes():
    """(label, msg, pub32, sig64) for 32 lanes, one of every kind."""
    lanes = []
    for i in range(7):
        seed, _, pub = _signer(i)
        msg = (b"", b"x", b"ed25519 port lane %d" % i, bytes(32), b"\xff" * 64, bytes(100),
               bytes(range(256)) * 4)[i]
        lanes.append(("valid", msg, pub, ref.sign(seed, msg)))
    seed, a, pub = _signer(7)
    msg = b"the signed vote preimage"
    sig = ref.sign(seed, msg)
    s = int.from_bytes(sig[32:], "little")
    flip = lambda b, i: b[:i] + bytes([b[i] ^ 1]) + b[i + 1:]  # noqa: E731
    lanes += [
        ("tampered R", msg, pub, flip(sig, 3)),
        ("tampered S", msg, pub, flip(sig, 40)),
        ("tampered message", b"another vote", pub, sig),
        ("another signer's key", msg, _signer(8)[2], sig),
        ("key y = p", msg, _enc(P), sig),
        ("key y = 2^255 - 1", msg, b"\xff" * 31 + b"\x7f", sig),
        ("R y = p", msg, pub, _enc(P) + sig[32:]),
        ("key x = 0, sign 1 (y = 1)", msg, _enc(1, 1), sig),
        ("key x = 0, sign 1 (y = -1)", msg, _enc(P - 1, 1), sig),
        ("R x = 0, sign 1", msg, pub, _enc(1, 1) + sig[32:]),
        ("s = L", msg, pub, sig[:32] + L.to_bytes(32, "little")),
        ("s = 2^256 - 1", msg, pub, sig[:32] + b"\xff" * 32),
        ("s + L", msg, pub, sig[:32] + (s + L).to_bytes(32, "little")),
        ("key with no root", msg, _enc(_no_root_y()), sig),
        ("R with no root", msg, pub, _enc(_no_root_y()) + sig[32:]),
    ]
    r = 0x5EED
    for label, small in (("identity", _enc(1)), ("y = -1, order 2", _enc(P - 1)),
                         ("y = 0, order 4", _enc(0)), ("y = 0 sign 1, order 4", _enc(0, 1)),
                         ("order 8", ref._compress(T8))):
        lanes.append((f"small-order key: {label}", msg, small, _sign_with(0, small, msg, r)))
    lanes.append(("small-order R: order 8", msg, pub, _sign_with(a, pub, msg, 0, T8)))
    lanes.append(("small-order R: identity", msg, pub, _sign_with(a, pub, msg, 0)))
    lanes.append(("mixed-order R = r·B + T8", msg, pub, _sign_with(a, pub, msg, r, T8)))
    mixed_pub = ref._compress(ref._add(ref._mul(a, ref.BASE), T8))
    lanes.append(("mixed-order key a·B + T8", msg, mixed_pub, _sign_with(a, mixed_pub, msg, r)))
    lanes.append(("the zero row", b"", bytes(32), bytes(64)))
    assert len(lanes) == LANES
    return lanes


def _columns(lanes):
    return [lane[1] for lane in lanes], [lane[2] for lane in lanes], [lane[3] for lane in lanes]


@pytest.fixture(scope="module")
def verdicts():
    """Each lane's verdict: the port's plain batch (CPU), the JAX program
    (one trace of _verify_xla at the 32-lane bucket) and both oracles."""
    lanes = _lanes()
    msgs, pubs, sigs = _columns(lanes)
    with pytest.MonkeyPatch.context() as mp:
        # the plain version must never reach the kernel loader
        mp.setattr(_kernels, "_library", lambda name: pytest.fail("kernel loader called on CPU"))
        port = ed25519.verify_batch(msgs, pubs, sigs, device="cpu")
    return {
        "lanes": lanes,
        "port": port,
        "jax": np.asarray(jed.verify_batch(msgs, pubs, sigs)),
        "oracle": np.array([ref.verify(p, m, s) for m, p, s in zip(msgs, pubs, sigs)]),
        "jax oracle": np.array([jref.verify(p, m, s) for m, p, s in zip(msgs, pubs, sigs)]),
    }


def test_verify_matches_jax_and_both_oracles(verdicts):
    port = verdicts["port"]
    assert port.dtype == np.bool_ and port.shape == (LANES,)
    for who in ("jax", "oracle", "jax oracle"):
        np.testing.assert_array_equal(port, verdicts[who], err_msg=who)


def test_every_lane_kind_has_its_verdict(verdicts):
    """Valid and cofactor-accepted lanes pass; every tampered, out-of-range
    or undecodable lane fails."""
    accepted = ("valid", "small-order", "mixed-order", "the zero row")
    for (label, *_), ok in zip(verdicts["lanes"], verdicts["port"]):
        assert ok == label.startswith(accepted), label


def test_comb_table_is_the_jax_table():
    table = ed25519.b_comb_table()
    assert table.shape == (45, 16) and table.dtype == np.uint32
    np.testing.assert_array_equal(table, jed.b_comb_table())
    words = params.ed25519_comb_words()
    assert words.shape == (24, 8) and words.dtype == np.uint32
    np.testing.assert_array_equal(words, params.limbs16_to_words(jed.b_comb_table()[:24]))


def _limbs(enc: bytes):
    y = int.from_bytes(enc, "little")
    return limb.ints_to_rows([y & ((1 << 255) - 1)], "cpu"), torch.tensor([y >> 255])


def test_decompress_matches_reference_on_edge_encodings():
    E = ed25519.ed_ops("cpu")
    for label, enc in EDGE_ENCODINGS.items():
        y, sign = _limbs(enc)
        (x, yy, z, t), valid = ed25519.decompress(y, sign, E)
        want = ref._decompress(enc)
        assert bool(valid[0]) == (want is not None), label
        if want is None:
            continue
        canon = lambda v: limb.rows_to_ints(ed25519._canon(v, E))[0]  # noqa: E731
        assert (canon(x), canon(yy), canon(z), canon(t)) == want, label


def test_device_inputs_layout():
    """R ‖ S ‖ A ‖ k_neg little-endian a lane, the bucket padded with zero
    rows; short keys or signatures raise."""
    lanes = _lanes()[:3]
    msgs, pubs, sigs = _columns(lanes)
    rows = ed25519.device_inputs(msgs, [p + b"tail" for p in pubs], [s + bytes(32) for s in sigs], pad_to=5)
    assert rows.shape == (5, ed25519.ROW_BYTES) and rows.dtype == np.uint8
    assert not rows[3:].any()
    for row, m, p, s in zip(rows, msgs, pubs, sigs):
        k = int.from_bytes(ref._sha512(s[:32] + p + m), "little") % L
        assert bytes(row) == s + p + ((L - k) % L).to_bytes(32, "little")
    with pytest.raises(ValueError):
        ed25519.device_inputs(msgs, [p[:31] for p in pubs], sigs)
    with pytest.raises(ValueError):
        ed25519.device_inputs(msgs, pubs, [s[:63] for s in sigs])


HOST_SHIM = r"""
#include "{src}"

static void set_constants(u32* sl) {{  // one signature's slots, stride 1
  const u32 ONE[8] = {{1, 0, 0, 0, 0, 0, 0, 0}}, D[8] = ED25519_D, D2[8] = ED25519_D2;
  const u32 I[8] = ED25519_SQRT_M1;
  slot_put(sl, 1, ED_ONE, ONE);
  slot_put(sl, 1, ED_D, D);
  slot_put(sl, 1, ED_D2, D2);
  slot_put(sl, 1, ED_I, I);
}}

extern "C" void host_verify(const uint8_t* rows, const uint32_t* comb, uint8_t* ok, int n) {{
  u32 slots[ED25519_SLOT_WORDS];
  for (int i = 0; i < n; i++)
    ed25519_verify_lane(rows + ED25519_ROW_BYTES * i, (const u32 (*)[8])comb, slots, 1, ok + i);
}}

// out: the slots X, Y, Z, T, QP, QM, QT, QZ (A, cached) and the 4 of -R, cached
extern "C" int host_decompress_pair(const uint8_t* row, u32* out) {{
  u32 slots[ED25519_SLOT_WORDS] = {{0}};
  set_constants(slots);
  bool ok = ed_decompress_pair(row, slots, 1);
  for (int k = 0; k < 8; k++) slot_get(out + 8 * k, slots, 1, ED_X + k);
  for (int k = 0; k < 4; k++) slot_get(out + 64 + 8 * k, slots, 1, ED_NR + k);
  return ok;
}}

// A and R both the encoding (y, sign): A's x from ED_X; -1 unless R's, kept
// negated, is its negation
extern "C" int host_decompress(const u32* y, u32 sign, u32* x) {{
  u32 slots[ED25519_SLOT_WORDS] = {{0}}, nx[8], sum[8];
  uint8_t row[ED25519_ROW_BYTES] = {{0}};
  for (int i = 0; i < 32; i++) row[i] = row[64 + i] = (uint8_t)(y[i / 4] >> (8 * (i % 4)));
  row[31] |= (uint8_t)(sign << 7), row[95] |= (uint8_t)(sign << 7);
  set_constants(slots);
  bool ok = ed_decompress_pair(row, slots, 1);
  slot_get(x, slots, 1, ED_X);
  slot_get(nx, slots, 1, ED_RX);
  fe_add(sum, x, nx);
  return is_zero8(sum) ? ok : -1;
}}

// op 0: doubling, 1: addition of the cached q (4 slots), 2: mixed addition
// of the comb-form q (3 slots); p, out: X, Y, Z, T
extern "C" void host_point_op(int op, const u32* p, const u32* q, u32* out) {{
  u32 slots[ED25519_SLOT_WORDS] = {{0}};
  set_constants(slots);
  for (int k = 0; k < 4; k++) slot_put(slots, 1, ED_X + k, p + 8 * k);
  for (int k = 0; k < (op == 1 ? 4 : op == 2 ? 3 : 0); k++) slot_put(slots, 1, ED_QP + k, q + 8 * k);
  if (op == 0) ed_run(ED_DBL_AT, ED_DBL_LEN, slots, 1);
  if (op == 1) ed_run(ED_ADD_AT, ED_ADD_LEN, slots, 1);
  if (op == 2) ed_run(ED_MADD_AT, ED_MADD_LEN, slots, 1);
  for (int k = 0; k < 4; k++) slot_get(out + 8 * k, slots, 1, ED_X + k);
}}

// Hazards between a quad's lanes, row by row through every program as the
// card runs them: an op that reads a slot another lane wrote, or writes a
// slot another lane read or wrote, in its row or in an earlier row since the
// last sync (the decompression runs with no sync between its rows). The
// lanes would race on the card.
extern "C" int host_row_hazards(int* rows) {{
  int bad = 0;
  bool rd[4][ED25519_SLOTS] = {{}}, wr[4][ED25519_SLOTS] = {{}};  // since the last sync
  for (int r = 0; r < ED_PROG_ROWS; r++) {{
    *rows = r + 1;
    for (int j = 0; j < 4; j++) {{
      u32 op = ED_PROGS[r].op[j];
      rd[j][(op >> 16) & 0xFF] = rd[j][op >> 24] = wr[j][(op >> 8) & 0xFF] = true;
    }}
    for (int j = 0; j < 4; j++) {{
      u32 op = ED_PROGS[r].op[j];
      u32 d = (op >> 8) & 0xFF, a = (op >> 16) & 0xFF, b = op >> 24;
      for (int k = 0; k < 4; k++)
        if (k != j) bad += wr[k][a] + wr[k][b] + wr[k][d] + rd[k][d];
    }}
    bool unsynced = r >= ED_DECOMP_AT && r + 1 < ED_DECOMP_AT + ED_DECOMP_LEN;
    if (!unsynced) {{
      for (int j = 0; j < 4; j++)
        for (int s = 0; s < ED25519_SLOTS; s++) rd[j][s] = wr[j][s] = false;
    }}
  }}
  return bad;
}}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The kernel source's arithmetic compiled as host C++, a quad's four
    lanes run one after another."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's arithmetic for the host")
    d = tmp_path_factory.mktemp("ed25519_host")
    shim = d / "shim.cpp"
    shim.write_text(HOST_SHIM.format(src=KERNEL_SRC))
    lib_path = d / "libed25519_host.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(lib_path), str(shim)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.host_verify.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.host_decompress.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p]
    lib.host_decompress.restype = ctypes.c_int
    raw_decompress = lib.host_decompress

    def host_decompress(y, sign, x):  # -1 (R's x not the negation of A's) must not read as true
        ok = raw_decompress(y, sign, x)
        if ok == -1:
            raise AssertionError("host_decompress: R's negated x is not the negation of A's x")
        return ok

    lib.host_decompress = host_decompress
    lib.host_decompress_pair.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.host_decompress_pair.restype = ctypes.c_int
    lib.host_point_op.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.host_row_hazards.argtypes = [ctypes.c_void_p]
    lib.host_row_hazards.restype = ctypes.c_int
    comb = np.ascontiguousarray(params.ed25519_comb_words())

    def run(msgs, pubs, sigs):
        rows = ed25519.device_inputs(msgs, pubs, sigs, pad_to=len(msgs))
        ok = np.zeros(len(msgs), np.uint8)
        lib.host_verify(rows.ctypes.data, comb.ctypes.data, ok.ctypes.data, len(ok))
        return ok.astype(bool)

    run.lib = lib
    return run


def test_kernel_arithmetic_on_host_matches_plain(verdicts, host_kernel):
    got = host_kernel(*_columns(verdicts["lanes"]))
    np.testing.assert_array_equal(got, verdicts["port"])


def test_kernel_arithmetic_on_host_matches_reference(host_kernel):
    """Seeded random keys, messages of 0-200 bytes; a lane in four of each
    of a wrong message, a wrong S and a wrong key."""
    rng = np.random.default_rng(0xED)
    msgs, pubs, sigs = [], [], []
    for i in range(64):
        seed, msg = rng.bytes(32), rng.bytes(int(rng.integers(0, 200)))
        pub, sig = ref.seed_to_pubkey(seed), ref.sign(seed, msg)
        if i % 4 == 1:
            msg += b"!"
        elif i % 4 == 2:
            sig = sig[:32] + ((int.from_bytes(sig[32:], "little") + 1) % L).to_bytes(32, "little")
        elif i % 4 == 3:
            pub = ref.seed_to_pubkey(rng.bytes(32))
        msgs.append(msg), pubs.append(pub), sigs.append(sig)
    ok = host_kernel(msgs, pubs, sigs)
    assert ok.tolist() == [ref.verify(p, m, s) for m, p, s in zip(msgs, pubs, sigs)]
    assert ok[0::4].all() and not ok[1::4].any()


def test_kernel_decompression_on_host_matches_reference(host_kernel):
    """One exponentiation a point (RFC 8032 §5.1.3) gives the ref's point
    and validity on every edge encoding and on seeded random y."""
    rng = np.random.default_rng(0xDEC)
    encs = list(EDGE_ENCODINGS.values()) + [rng.bytes(32) for _ in range(48)]
    for enc in encs:
        v = int.from_bytes(enc, "little")
        y = np.array([(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)], np.uint32)
        y[7] &= 0x7FFFFFFF
        x = np.zeros(8, np.uint32)
        ok = host_kernel.lib.host_decompress(y.ctypes.data, v >> 255, x.ctypes.data)
        want = ref._decompress(enc)
        assert bool(ok) == (want is not None), enc.hex()
        if want is not None:
            assert sum(int(w) << (32 * i) for i, w in enumerate(x)) == want[0], enc.hex()


def _words(vals) -> np.ndarray:
    """Field elements -> their little-endian 32-bit words, concatenated."""
    return np.array([(v >> (32 * i)) & 0xFFFFFFFF for v in vals for i in range(8)], np.uint32)


def _ints(words: np.ndarray) -> list[int]:
    return [sum(int(w) << (32 * i) for i, w in enumerate(words[k : k + 8])) for k in range(0, len(words), 8)]


def _test_points():
    """Extended points (X, Y, Z, T) with Z scaled by a seeded factor: random
    multiples of B, the identity, the small-order points (orders 2, 4, 8)
    and a mixed-order point a·B + T8."""
    rng = np.random.default_rng(0x9AD)
    a = int.from_bytes(rng.bytes(32), "little")
    pts = [ref._mul(int.from_bytes(rng.bytes(32), "little"), ref.BASE) for _ in range(10)]
    pts += [ref.IDENT, ref._decompress(_enc(P - 1)), ref._decompress(_enc(0)),
            ref._decompress(_enc(0, 1)), T8, ref._add(ref._mul(a, ref.BASE), T8)]
    out = []
    for pt in pts:
        z = int.from_bytes(rng.bytes(32), "little") % (P - 1) + 1
        out.append(tuple(c * z % P for c in pt))
    return out


def _plain_columns(pts):
    return tuple(limb.ints_to_rows([pt[i] for pt in pts], "cpu") for i in range(len(pts[0])))


def _plain_ints(coords, E):
    return [limb.rows_to_ints(ed25519._canon(c, E)) for c in coords]


@pytest.mark.parametrize("op", ["double", "add", "madd"])
def test_quad_programs_on_host_match_plain_group_law(host_kernel, op):
    """Each quad program, its rows run lane by lane, gives the plain
    ed_double / ed_add / ed_madd's coordinates mod p exactly (the same
    formulas), on seeded points, the identity and small-order points, each
    against every addend of the set in turn."""
    E = ed25519.ed_ops("cpu")
    pts = _test_points()
    firsts = pts if op == "double" else [p1 for p1 in pts for _ in pts]
    seconds = pts if op == "double" else [p2 for _ in pts for p2 in pts]
    p1 = _plain_columns(firsts)
    if op == "double":
        want = _plain_ints(ed25519.ed_double(p1, E), E)
    elif op == "add":
        want = _plain_ints(ed25519.ed_add(p1, _plain_columns(seconds), E), E)
    else:
        affine = [(x * pow(z, -1, P) % P, y * pow(z, -1, P) % P) for x, y, z, _ in seconds]
        pre = [((y + x) % P, (y - x) % P, 2 * D * x * y % P) for x, y in affine]
        want = _plain_ints(ed25519.ed_madd(p1, _plain_columns(pre), E), E)
    kind = {"double": 0, "add": 1, "madd": 2}[op]
    out = np.zeros(32, np.uint32)
    for i, (pa, pb) in enumerate(zip(firsts, seconds)):
        x, y, z, t = pb
        cached = ((y + x) % P, (y - x) % P, 2 * D * t % P, 2 * z % P)
        q = _words(pre[i] if op == "madd" else cached)
        host_kernel.lib.host_point_op(kind, _words(pa).ctypes.data, q.ctypes.data, out.ctypes.data)
        assert _ints(out) == [c[i] for c in want], (op, i)


def test_quad_pair_decompression_on_host_matches_plain(host_kernel):
    """A and R decompressed side by side (lanes 0 and 1): A's point, its
    cached form and -R's cached form, and the validity of both, as the plain
    decompress gives them, on the edge encodings paired with valid points
    and seeded random encodings."""
    E = ed25519.ed_ops("cpu")
    rng = np.random.default_rng(0x5EC)
    base = ref._compress(ref.BASE)
    encs = list(EDGE_ENCODINGS.values()) + [rng.bytes(32) for _ in range(12)]
    pairs = [(e, base) for e in encs] + [(base, e) for e in encs] + [(encs[i], encs[-1 - i]) for i in range(len(encs))]
    def plain(encs):  # one batch of the plain decompress: canonical coordinates, valid
        ys = [int.from_bytes(e, "little") for e in encs]
        pt, valid = ed25519.decompress(
            limb.ints_to_rows([y & ((1 << 255) - 1) for y in ys], "cpu"), torch.tensor([y >> 255 for y in ys]), E
        )
        return list(zip(*_plain_ints(pt, E))), valid.tolist()

    (r_pts, r_ok), (a_pts, a_ok) = plain([r for r, _ in pairs]), plain([a for _, a in pairs])
    out = np.zeros(96, np.uint32)
    for i, (r_enc, a_enc) in enumerate(pairs):
        row = np.frombuffer(r_enc + bytes(32) + a_enc + bytes(32), np.uint8).copy()
        ok = host_kernel.lib.host_decompress_pair(row.ctypes.data, out.ctypes.data)
        assert bool(ok) == (a_ok[i] and r_ok[i]), (r_enc.hex(), a_enc.hex())
        if not ok:
            continue
        (x, y, z, t), (rx, ry, _, rt) = a_pts[i], r_pts[i]
        assert _ints(out) == [
            x, y, z, t, (y + x) % P, (y - x) % P, 2 * D * t % P, 2,
            (ry - rx) % P, (ry + rx) % P, -2 * D * rt % P, 2,
        ], (r_enc.hex(), a_enc.hex())


def test_quad_rows_have_no_hazards(host_kernel):
    """No row of any program writes a slot that another op of the row reads
    or writes, so the quad's lanes may run a row in any order."""
    rows = ctypes.c_int(0)
    assert host_kernel.lib.host_row_hazards(ctypes.byref(rows)) == 0
    assert rows.value > 280  # every program's rows were read
