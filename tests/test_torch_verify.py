"""Port secp256k1 verification (plain PyTorch) against the JAX package's
verify_batch at one 32-lane bucket, on valid lanes and every invalid kind,
plus the CUDA verify kernel's arithmetic built as host C++ on its byte-row
layout, its divstep s^-1 and signed 5-bit recoding against Python integers,
and its 64-row comb against the reference point arithmetic (the kernel
itself runs only on the card, through chip_smoke.py)."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from fisco_bcos_tpu.ops import secp256k1 as jsecp
from fisco_bcos_tpu_torch import params
from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref
from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256
from fisco_bcos_tpu_torch.ops import _kernels, secp256k1

C = ref.SECP256K1
KERNEL_SRC = _kernels.SOURCES["secp256k1_verify"]


def _off_curve_y(x: int) -> int:
    y = 1
    while (y * y - x**3 - 7) % C.p == 0:
        y += 1
    return y


def _vectors():
    """(hash, r, s, (qx, qy)) rows: valid signatures, then every invalid
    kind; 32 rows, one bucket."""
    rows = []
    for i in range(8):
        d = 0xBEEF + 104729 * i
        h = keccak256(b"port verify %d" % i)
        r, s, _ = ref.ecdsa_sign(h, d)
        rows.append((h, r, s, ref.privkey_to_pubkey(C, d)))
    d = 0xBEEF
    pub = ref.privkey_to_pubkey(C, d)
    for z in (bytes(32), C.n.to_bytes(32, "big"), b"\xff" * 32):  # u1 = 0, 0, z > n
        r, s, _ = ref.ecdsa_sign(z, d)
        rows.append((z, r, s, pub))
    h, r, s, pub = rows[0]
    qx, qy = pub
    rows += [
        (h, 0, s, pub),  # r = 0
        (h, r, 0, pub),  # s = 0
        (h, r, C.n, pub),  # s = n
        (h, r, (1 << 256) - 1, pub),  # s > n
        (h, C.n, s, pub),  # r = n
        (h, r, s, (C.p, qy)),  # qx >= p
        (h, r, s, (qx, C.p + 1)),  # qy >= p
        (h, r, s, (qx, _off_curve_y(qx))),  # Q off the curve
        (h, r, s, (0, 0)),  # Q = (0, 0)
        (keccak256(b"another message"), r, s, pub),  # wrong hash
        (h, r ^ (1 << 77), s, pub),  # corrupted r
        (h, r, s ^ (1 << 5), pub),  # corrupted s
        (h, 12345, s, pub),  # small r: r + n < p, the second compare runs
        (h, r, s, rows[1][3]),  # another signer's key
        (bytes(32), 0, 0, (0, 0)),  # a zero row
    ]
    return rows


def _arrays(rows):
    b = lambda v: v.to_bytes(32, "big")  # noqa: E731
    hashes = np.stack([np.frombuffer(h, dtype=np.uint8) for h, *_ in rows])
    rs = np.stack([np.frombuffer(b(r), dtype=np.uint8) for _, r, _, _ in rows])
    ss = np.stack([np.frombuffer(b(s), dtype=np.uint8) for _, _, s, _ in rows])
    pubs = np.stack([np.frombuffer(b(q[0]) + b(q[1]), dtype=np.uint8) for *_, q in rows])
    return hashes, rs, ss, pubs


def _oracle(rows):
    return [ref.ecdsa_verify(h, r, s, q) for h, r, s, q in rows]


@pytest.fixture(scope="module")
def verified():
    rows = _vectors()
    assert len(rows) <= 32  # one JAX bucket
    arrays = _arrays(rows)
    with pytest.MonkeyPatch.context() as mp:
        # the plain version must never reach the kernel loader
        mp.setattr(_kernels, "_library", lambda name: pytest.fail("kernel loader called on CPU"))
        port = secp256k1.verify_batch(*arrays, device="cpu")
    return rows, arrays, port, np.asarray(jsecp.verify_batch(*arrays))


def test_verify_matches_jax_bytewise(verified):
    _, _, port, jax_ok = verified
    assert port.dtype == np.bool_ and port.shape == jax_ok.shape
    np.testing.assert_array_equal(port, jax_ok)


def test_verify_matches_reference(verified):
    rows, _, port, _ = verified
    assert port.tolist() == _oracle(rows)
    assert port[:11].all() and not port[11:].any()


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The verify kernel source's arithmetic compiled as host C++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's arithmetic for the host")
    d = tmp_path_factory.mktemp("verify_host")
    shim = d / "shim.cpp"
    shim.write_text(
        f'#include "{KERNEL_SRC}"\n'
        'extern "C" void host_verify(const uint8_t* rows, const uint32_t* comb, uint8_t* ok, int n) {\n'
        "  u32 slots[VERIFY_SLOT_WORDS];  // one lane's slots, stride 1\n"
        "  for (int i = 0; i < n; i++)\n"
        "    verify_lane(rows + VERIFY_ROW_BYTES * i, (const u32 (*)[8])comb, slots, 1, ok + i);\n"
        "}\n"
        'extern "C" void host_inv(const u32* a, u32* r, int n) {\n'
        "  for (int i = 0; i < n; i++) fn_inv_divstep(r + 8 * i, a + 8 * i);\n"
        "}\n"
        'extern "C" void host_digits(const u32* k, int* d, int n) {  // MSB first\n'
        "  for (int i = 0; i < n; i++) {\n"
        "    u32 w[5];\n"
        "    win5_init(w, k + 5 * i);\n"
        "    for (int j = 0; j < VERIFY_WINDOWS; j++) d[VERIFY_WINDOWS * i + j] = win5_next(w);\n"
        "  }\n"
        "}\n"
    )
    lib_path = d / "libverify_host.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(lib_path), str(shim)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.host_verify.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.host_inv.argtypes = lib.host_digits.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    comb = np.ascontiguousarray(params.verify_comb_words())

    def run(hashes, rs, ss, pubs):
        rows = secp256k1.verify_rows(hashes, rs, ss, pubs, len(hashes))
        ok = np.zeros(len(hashes), np.uint8)
        lib.host_verify(rows.ctypes.data, comb.ctypes.data, ok.ctypes.data, len(ok))
        return ok.astype(bool)

    run.lib = lib
    return run


def test_kernel_arithmetic_on_host_matches_plain(verified, host_kernel):
    _, arrays, port, _ = verified
    np.testing.assert_array_equal(host_kernel(*arrays), port)


def test_kernel_arithmetic_on_host_matches_reference(host_kernel):
    rng = np.random.default_rng(29)
    rows = []
    for i in range(48):
        d = int.from_bytes(rng.bytes(32), "big") % (C.n - 1) + 1
        h = rng.bytes(32)
        r, s, _ = ref.ecdsa_sign(h, d)
        pub = ref.privkey_to_pubkey(C, d)
        if i % 4 == 1:
            h = rng.bytes(32)  # a wrong hash
        elif i % 4 == 2:
            s = int.from_bytes(rng.bytes(32), "big") % C.n or 1  # another s
        rows.append((h, r, s, pub))
    ok = host_kernel(*_arrays(rows))
    assert ok.tolist() == _oracle(rows)
    assert ok[0::4].all() and ok[3::4].all()


def _words(vals, nw: int) -> np.ndarray:
    return np.ascontiguousarray(
        [[(v >> (32 * i)) & 0xFFFFFFFF for i in range(nw)] for v in vals], dtype=np.uint32
    )


def test_divstep_inverse_matches_python(host_kernel):
    """The kernel's safegcd s^-1 equals pow(s, -1, n) on edge values (long
    runs of 0 and 1 bits among them) and 200 seeded random ones; s = 0
    returns 0 without a fault."""
    rng = np.random.default_rng(0x5AFE6CD)
    runs = [(1 << 200) - 1, ((1 << 128) - 1) << 100, (1 << 255) | 1, C.n - (1 << 129)]
    vals = [0, 1, 2, C.n - 1, C.n - 2, 1 << 255] + runs
    vals += [int.from_bytes(rng.bytes(32), "big") % C.n for _ in range(200)]
    a = _words(vals, 8)
    out = np.zeros_like(a)
    host_kernel.lib.host_inv(a.ctypes.data, out.ctypes.data, len(vals))
    got = [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in out]
    assert got == [pow(v, -1, C.n) if v else 0 for v in vals]


def test_signed_window_recoding_matches_python(host_kernel):
    """27 digits, MSB first, each in [-15, 16], with sum d_i·32^i = k, for
    edge scalars and seeded random GLV halves (ka, kb) and u1 halves."""
    from fisco_bcos_tpu_torch.ops.ec import glv_params

    P = glv_params()
    rng = np.random.default_rng(0xD161)
    all16 = sum(16 << (5 * i) for i in range(26))
    ks = [0, 1, 15, 16, 17, 31, (1 << 130) - 1, (1 << 128) - 1, all16, all16 >> 5]
    for _ in range(64):
        u2 = int.from_bytes(rng.bytes(32), "big") % C.n
        c1, c2 = (u2 * P.g1) >> 448, (u2 * P.g2) >> 448
        ks += [abs(u2 - (c1 * P.a1 + c2 * P.a2)), abs(c1 * P.b1_abs - c2 * P.b2)]
        u1 = int.from_bytes(rng.bytes(32), "big") % C.n
        ks += [u1 & ((1 << 128) - 1), u1 >> 128]
    k_words = _words(ks, 5)
    digits = np.zeros((len(ks), 27), np.int32)
    host_kernel.lib.host_digits(k_words.ctypes.data, digits.ctypes.data, len(ks))
    assert digits.min() >= -15 and digits.max() <= 16
    assert [sum(int(d) << (5 * (26 - j)) for j, d in enumerate(row)) for row in digits] == ks


def test_verify_comb_matches_reference_points():
    """The 64-row comb: x then y of c·G, then of c·2^128·G, c = 1..16."""
    words = params.verify_comb_words()
    assert words.shape == (64, 8) and words.dtype == np.uint32
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in words]
    for j, base in enumerate((1, 1 << 128)):
        for c in range(1, 17):
            x, y = ref.point_mul(C, c * base, (C.gx, C.gy))
            assert vals[32 * j + c - 1] == x and vals[32 * j + 16 + c - 1] == y
