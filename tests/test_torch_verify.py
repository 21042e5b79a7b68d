"""Port secp256k1 verification (plain PyTorch) against the JAX package's
verify_batch at one 32-lane bucket, on valid lanes and every invalid kind,
plus the CUDA verify kernel's arithmetic built as host C++ (the kernel
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
from fisco_bcos_tpu_torch.ops import _kernels, bigint, secp256k1

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
        'extern "C" void host_verify(const int32_t* z, const int32_t* r, const int32_t* s,\n'
        "    const int32_t* qx, const int32_t* qy, const uint32_t* comb, uint8_t* ok, int n) {\n"
        "  u32 slots[SLOT_WORDS];  // one lane's slots, stride 1\n"
        "  for (int i = 0; i < n; i++)\n"
        "    verify_lane(z + 16 * i, r + 16 * i, s + 16 * i, qx + 16 * i, qy + 16 * i,\n"
        "                (const u32 (*)[8])comb, slots, 1, ok + i);\n"
        "}\n"
    )
    lib_path = d / "libverify_host.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(lib_path), str(shim)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.host_verify.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int]
    comb = np.ascontiguousarray(params.default_tables().comb_words)

    def run(hashes, rs, ss, pubs):
        limbs = [
            np.ascontiguousarray(bigint.bytes_be_to_limbs(a).astype(np.int32))
            for a in (hashes, rs, ss, pubs[:, :32], pubs[:, 32:])
        ]
        ok = np.zeros(len(hashes), np.uint8)
        lib.host_verify(*(a.ctypes.data for a in limbs), comb.ctypes.data, ok.ctypes.data, len(ok))
        return ok.astype(bool)

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
