"""Port secp256k1 recovery (plain PyTorch) against the JAX package's
recover_batch at one 32-lane bucket, on valid and invalid lanes, plus the
CUDA kernel's source: its constants, and its arithmetic built as host C++
(the kernel itself runs only on the card, through chip_smoke.py)."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from fisco_bcos_tpu.ops import secp256k1 as jsecp
from fisco_bcos_tpu_torch import params
from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref
from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256
from fisco_bcos_tpu_torch.ops import _kernels, bigint, secp256k1

C = ref.SECP256K1
KERNEL_SRC = Path(_kernels.SOURCES["secp256k1_recover"])
# the field, GLV and exponent constants live in the header both secp256k1
# kernels include
CONSTANTS_SRC = _kernels.CSRC / "secp256k1_common.cuh"


def _non_residue_x() -> int:
    x = 1
    while pow((x**3 + 7) % C.p, (C.p - 1) // 2, C.p) == 1:
        x += 1
    return x


def _vectors():
    """(hash, r, s, v) rows: valid signatures, then every invalid kind."""
    rows = []
    for i in range(10):
        d = 0xC0FFEE + 7919 * i
        h = keccak256(b"port recover %d" % i)
        r, s, v = ref.ecdsa_sign(h, d)
        rows.append((h, r, s, v + (27 if i >= 7 else 0)))
    h, r, s, v = rows[0]
    rows += [(h, r, s, bad_v) for bad_v in (4, 29, 30)]
    rows += [(h, 0, s, v), (h, r, 0, v), (h, r, C.n, v), (h, r, (1 << 256) - 1, v)]
    rows += [(h, C.p - C.n, s, 2), (h, C.p - C.n + 1, s, 3)]  # x = r + n >= p
    rows += [(h, _non_residue_x(), s, 0)]  # x^3 + 7 has no square root
    rows += [(h, r ^ (1 << 77), s, v)]  # corrupted r: some other key or none
    rows += [(bytes(32), r, s, v), (b"\xff" * 32, r, s, v)]  # z = 0, z >= n
    rows += [(h, 12345, s, 2)]  # x = r + n < p, in range
    rows += [(bytes(32), 0, 0, 0)]  # a zero row
    return rows


def _arrays(rows):
    hashes = np.stack([np.frombuffer(h, dtype=np.uint8) for h, *_ in rows])
    sigs = np.stack(
        [
            np.frombuffer(r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([v]), dtype=np.uint8)
            for _, r, s, v in rows
        ]
    )
    return hashes, sigs


def _oracle(h, r, s, v):
    if v not in (0, 1, 2, 3, 27, 28):  # 29, 30 must not alias to 2, 3
        return None
    return ref.ecdsa_recover(h, r, s, v)


@pytest.fixture(scope="module")
def recovered():
    rows = _vectors()
    hashes, sigs = _arrays(rows)
    with pytest.MonkeyPatch.context() as mp:
        # the plain version must never reach the kernel loader
        mp.setattr(_kernels, "_library", lambda name: pytest.fail("kernel loader called on CPU"))
        port = secp256k1.recover_batch(hashes, sigs, device="cpu")
    jax_out = jsecp.recover_batch(hashes, sigs)
    return rows, port, jax_out


def test_recover_matches_jax_bytewise(recovered):
    _, (pubs, ok), (jpubs, jok) = recovered
    np.testing.assert_array_equal(pubs, np.asarray(jpubs))
    np.testing.assert_array_equal(ok, np.asarray(jok))


def test_recover_matches_reference(recovered):
    rows, (pubs, ok), _ = recovered
    for i, row in enumerate(rows):
        want = _oracle(*row)
        if want is None:
            assert not ok[i] and not pubs[i].any(), i
        else:
            assert ok[i], i
            assert bytes(pubs[i]) == want[0].to_bytes(32, "big") + want[1].to_bytes(32, "big")
    assert ok[:10].all() and not ok[10:20].any()


def _words_of(name: str, src: str) -> int:
    m = re.search(r"(?:#define\s+%s|u32\s+%s\[\d+\]\s*=)\s*\{([^}]*)\}" % (name, name), src)
    assert m, name
    words = [int(w.strip().rstrip("u"), 16) for w in m.group(1).replace("\\", "").split(",")]
    return sum(w << (32 * i) for i, w in enumerate(words))


def test_kernel_source_constants():
    assert f'#include "{CONSTANTS_SRC.name}"' in KERNEL_SRC.read_text()
    src = CONSTANTS_SRC.read_text()
    glv = params.build_tables().glv
    want = {
        "SECP_P": C.p,
        "SECP_N": C.n,
        "SECP_CN": (1 << 256) - C.n,
        "SECP_BETA": glv.beta,
        "GLV_G1": glv.g1,
        "GLV_G2": glv.g2,
        "GLV_A1": glv.a1,
        "GLV_B1": glv.b1_abs,
        "GLV_A2": glv.a2,
        "GLV_B2": glv.b2,
        "EXP_P_INV": C.p - 2,
        "EXP_P_SQRT": (C.p + 1) // 4,
        "EXP_N_INV": C.n - 2,
    }
    for name, value in want.items():
        assert _words_of(name, src) == value, name


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The kernel source's arithmetic compiled as host C++ (no __CUDACC__)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's arithmetic for the host")
    d = tmp_path_factory.mktemp("recover_host")
    shim = d / "shim.cpp"
    shim.write_text(
        f'#include "{KERNEL_SRC}"\n'
        'extern "C" void host_recover(const int32_t* z, const int32_t* r, const int32_t* s,\n'
        "    const int32_t* v, const uint32_t* comb, int32_t* qx, int32_t* qy, uint8_t* ok, int n) {\n"
        "  u32 slots[SLOT_WORDS];  // one lane's slots, stride 1\n"
        "  for (int i = 0; i < n; i++)\n"
        "    recover_lane(z + 16 * i, r + 16 * i, s + 16 * i, v[i], (const u32 (*)[8])comb,\n"
        "                 slots, 1, qx + 16 * i, qy + 16 * i, ok + i);\n"
        "}\n"
    )
    lib_path = d / "librecover_host.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(lib_path), str(shim)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.host_recover.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int]
    comb = np.ascontiguousarray(params.default_tables().comb_words)

    def run(hashes, sigs):
        n = len(hashes)
        z = bigint.bytes_be_to_limbs(hashes).astype(np.int32)
        r = bigint.bytes_be_to_limbs(sigs[:, :32]).astype(np.int32)
        s = bigint.bytes_be_to_limbs(sigs[:, 32:64]).astype(np.int32)
        v = np.ascontiguousarray(sigs[:, 64].astype(np.int32))
        qx = np.zeros((n, 16), np.int32)
        qy = np.zeros((n, 16), np.int32)
        ok = np.zeros(n, np.uint8)
        lib.host_recover(*(a.ctypes.data for a in (z, r, s, v, comb, qx, qy, ok)), n)
        pubs = np.concatenate([bigint.limbs_to_bytes_be(qx), bigint.limbs_to_bytes_be(qy)], axis=1)
        return pubs, ok.astype(bool)

    return run


def test_kernel_arithmetic_on_host_matches_plain(recovered, host_kernel):
    rows, (pubs, ok), _ = recovered
    hpubs, hok = host_kernel(*_arrays(rows))
    np.testing.assert_array_equal(hpubs, pubs)
    np.testing.assert_array_equal(hok, ok)


def test_kernel_arithmetic_on_host_matches_reference(host_kernel):
    rng = np.random.default_rng(17)
    rows = []
    for i in range(48):
        d = int.from_bytes(rng.bytes(32), "big") % (C.n - 1) + 1
        h = rng.bytes(32)
        r, s, v = ref.ecdsa_sign(h, d)
        if i % 4 == 1:
            r = int.from_bytes(rng.bytes(32), "big") % C.n or 1  # some x are non-residues
        rows.append((h, r, s, v))
    pubs, ok = host_kernel(*_arrays(rows))
    for i, row in enumerate(rows):
        want = _oracle(*row)
        got = (int.from_bytes(pubs[i, :32], "big"), int.from_bytes(pubs[i, 32:], "big")) if ok[i] else None
        assert got == want, i
