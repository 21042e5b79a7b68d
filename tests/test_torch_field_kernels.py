"""The CUDA kernels' field arithmetic, built as host C++ (the same row
layout as on the card, with the carry chains in portable C++): SM2's
Montgomery product and squaring (REDC by the form of p, no multiply),
secp256k1's products and 36-product squarings mod p and mod n, and
Ed25519's product, squaring and full reduction mod 2^255 - 19, against
Python integers and the plain PyTorch fields, on seeded random and edge
operands, and in place; and the kernels' launch design in their sources."""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest

from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref
from fisco_bcos_tpu_torch.crypto.ref import ed25519 as ref_ed25519
from fisco_bcos_tpu_torch.ops import _kernels, ed25519, limb

SM2 = ref.SM2_CURVE
SECP = ref.SECP256K1
P25519 = ref_ed25519.P
R = 1 << 256
R_INV = pow(R, -1, SM2.p)
TOP = R - 1

# op name -> (code in the shim, expected value of (a, b))
OPS = {
    "mm_mul": (0, lambda a, b: a * b * R_INV % SM2.p),
    "mm_sqr": (1, lambda a, b: a * a * R_INV % SM2.p),
    "fp_mul": (2, lambda a, b: a * b % SECP.p),
    "fp_sqr": (3, lambda a, b: a * a % SECP.p),
    "fn_mul": (4, lambda a, b: a * b % SECP.n),
    "fn_sqr": (5, lambda a, b: a * a % SECP.n),
    "fe_mul": (6, lambda a, b: a * b % P25519),
    "fe_sqr": (7, lambda a, b: a * a % P25519),
    "fe_canon": (8, lambda a, b: a % P25519),
}

SHIM = r"""
#include "{csrc}/sm2_verify.cu"
#include "{csrc}/secp256k1_common.cuh"
#include "{csrc}/ed25519_verify.cu"

// lane i: r[8i..] = op(a[8i..], b[8i..]). alias: each lane's output starts as a copy of a, and the op reads
// its operands from the output (r = a = b; the squarings r = a).
extern "C" int host_field_op(int op, const u32* a, const u32* b, u32* r, int n, int alias) {{
  for (int i = 0; i < n; i++) copy_w<8>(r + 8 * i, a + 8 * i);
  const u32* x = alias ? r : a;
  const u32* y = alias ? r : b;
  for (int i = 0; i < n; i++) {{
    u32* o = r + 8 * i;
    const u32* p = x + 8 * i;
    const u32* q = y + 8 * i;
    switch (op) {{
      case 0: mm_mul(o, p, q); break;
      case 1: mm_sqr(o, p); break;
      case 2: fp_mul(o, p, q); break;
      case 3: fp_sqr(o, p); break;
      case 4: fn_mul(o, p, q); break;
      case 5: fn_sqr(o, p); break;
      case 6: fe_mul(o, p, q); break;
      case 7: fe_sqr(o, p); break;
      case 8: copy_w<8>(o, p); fe_fold_top(o, 0); break;  // the full reduction
      default: return -1;
    }}
  }}
  return 0;
}}
"""


@pytest.fixture(scope="module")
def field_op(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels' arithmetic for the host")
    d = tmp_path_factory.mktemp("field_host")
    shim = d / "shim.cpp"
    shim.write_text(SHIM.format(csrc=_kernels.CSRC))
    lib_path = d / "libfield_host.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(lib_path), str(shim)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.host_field_op.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.host_field_op.restype = ctypes.c_int

    def run(name: str, a: list[int], b: list[int], alias: bool = False) -> list[int]:
        code, _ = OPS[name]
        aw, bw = _words(a), _words(b)
        out = np.zeros_like(aw)
        assert lib.host_field_op(code, aw.ctypes.data, bw.ctypes.data, out.ctypes.data, len(a), int(alias)) == 0
        return [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in out]

    return run


def _words(vals: list[int]) -> np.ndarray:
    return np.ascontiguousarray(
        [[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for v in vals], dtype=np.uint32
    )


def _operands(name: str) -> tuple[list[int], list[int]]:
    """Edge operands, then seeded random ones, each within the op's domain:
    SM2's products take a < 2^256 and b < p (a·b < p·R), its squarings
    a < p; secp256k1's take any 256-bit values. Sparse values make REDC
    steps with m = 0; (2^256 - 1)·(p - 1) lies just under p·R. Ed25519's
    ops take any 256-bit values: p, 2p - 1 and 2^256 - 1 are not reduced."""
    rng = np.random.default_rng(0xF1E1D)
    rand = [int.from_bytes(rng.bytes(32), "big") for _ in range(24)]
    if name.startswith("fe"):
        p = P25519
        edge = [0, 1, p - 1, p, p + 1, 2 * p - 1, 2 * p, TOP, 1 << 255, (1 << 255) - 1, 38, 19]
        return edge + rand, edge[::-1] + rand[::-1]
    if name.startswith("mm"):
        m = SM2.p
        sparse = [1, 2, 1 << 64, (1 << 160) + 1, (1 << 224) | 7, 1 << 255]
        a = [0, 1, m - 1, SM2.n - 1, TOP, TOP, TOP - 1, m - 2] + sparse + rand
        b = [5, m - 1, m - 1, 3, m - 1, 1, m - 2, m - 1] + sparse[::-1] + [v % m for v in rand[::-1]]
        if "sqr" in name:
            a = [v % m for v in a]
    else:
        a = [0, 1, SECP.p - 1, SECP.n - 1, TOP, TOP, SECP.p, SECP.n, 1 << 255, (1 << 128) - 1] + rand
        b = [TOP, TOP, SECP.p - 1, SECP.n - 1, TOP, 1, SECP.p, SECP.n + 1, 1 << 255, 1 << 128] + rand[::-1]
    return a, b


@pytest.mark.parametrize("name", sorted(OPS))
def test_field_op_matches_python_integers(field_op, name):
    a, b = _operands(name)
    want = OPS[name][1]
    assert field_op(name, a, b) == [want(x, y) for x, y in zip(a, b)]


@pytest.mark.parametrize("name", sorted(OPS))
def test_field_op_in_place(field_op, name):
    """r = a = b: every output word is written after every input is read."""
    a, _ = _operands(name)
    a = [v % SM2.p for v in a] if name.startswith("mm") else a  # a·a < p·R
    sqr = {"mm": "mm_sqr", "fp": "fp_sqr", "fn": "fn_sqr", "fe": "fe_sqr"}[name[:2]]
    want = OPS["fe_canon" if name == "fe_canon" else sqr][1]
    assert field_op(name, a, a, alias=True) == [want(x, x) for x in a]


@pytest.mark.parametrize("kind", ["sm2_p", "secp_p", "secp_n", "ed25519_p"])
def test_field_ops_match_the_plain_fields(field_op, kind):
    """The kernels' products and squarings equal the plain PyTorch fields
    (MontField for SM2's p, FoldField for secp256k1's p and n; for Ed25519
    the plain version's ring Z/2p, FoldField(2p), read canonically mod p as
    ops/ed25519.py's _canon reads it), and each squaring equals its product
    by itself; Ed25519's full reduction equals the ring's residue of the
    operand read the same way."""
    mul, sqr, F = {
        "sm2_p": ("mm_mul", "mm_sqr", limb.MontField(SM2.p, "cpu")),
        "secp_p": ("fp_mul", "fp_sqr", limb.FoldField(SECP.p, "cpu")),
        "secp_n": ("fn_mul", "fn_sqr", limb.FoldField(SECP.n, "cpu")),
        "ed25519_p": ("fe_mul", "fe_sqr", limb.FoldField(2 * P25519, "cpu")),
    }[kind]
    a, b = _operands(mul)
    sq, _ = _operands(sqr)
    rows = lambda vals: limb.ints_to_rows(vals, "cpu")  # noqa: E731
    read = lambda t: limb.rows_to_ints(t)  # noqa: E731
    if kind == "ed25519_p":
        E = ed25519.ed_ops("cpu")
        read = lambda t: limb.rows_to_ints(ed25519._canon(t, E))  # noqa: E731
        one = F.one(rows(a))
        assert field_op("fe_canon", a, a) == read(F.mul(rows(a), one))
    assert field_op(mul, a, b) == read(F.mul(rows(a), rows(b)))
    assert field_op(sqr, sq, sq) == read(F.sqr(rows(sq)))
    assert field_op(sqr, sq, sq) == field_op(mul, sq, sq)


@pytest.mark.parametrize("name", ["secp256k1_recover", "secp256k1_verify", "sm2_verify", "ed25519_verify"])
def test_kernel_launch_design(name):
    """One warp a block with up to 255 registers a thread, the lanes' slots
    in dynamic shared memory whose size is set before the launch (Ed25519:
    a signature's slots, a quad of lanes each, 8 signatures a block), every
    CUDA error of the entry point returned, the group law run as field-op
    programs and nothing out of line."""
    src = _kernels.SOURCES[name].read_text()
    headers = "".join(p.read_text() for p in _kernels.CSRC.glob("*.cuh"))
    threads = re.search(r"#define\s+(\w+_THREADS)\s+(\d+)", src)
    assert int(threads.group(2)) == 32
    assert f"__launch_bounds__({threads.group(1)}, 1)" in src
    assert "extern __shared__ uint4 s_slots[];" in src
    # verify has its own slots (16 table entries), Ed25519 its own layout
    # (8 cached entries of 4); recover and SM2 keep the shared count (15
    # entries), so their shared memory does not grow
    slot_words = {"secp256k1_verify": "VERIFY_SLOT_WORDS", "ed25519_verify": "ED25519_SLOT_WORDS"}.get(
        name, "SLOT_WORDS"
    )
    per_block = "ED25519_SIGS" if name == "ed25519_verify" else r"\w+_THREADS"
    assert re.search(rf"#define\s+\w+_SMEM_BYTES\s+\({slot_words} \* 4 \* {per_block}\)", src)
    assert "S_TAB, S_COUNT = S_TAB + 45" in headers and "#define SLOT_WORDS (S_COUNT * 8)" in headers
    if name == "secp256k1_verify":
        assert "#define VERIFY_TAB 16" in src and "#define VERIFY_SLOTS (S_TAB + 3 * VERIFY_TAB)" in src
        assert "#define VERIFY_SLOT_WORDS (VERIFY_SLOTS * 8)" in src
    if name == "ed25519_verify":
        assert "ED25519_SLOTS = ED_TAB + 4 * ED25519_TAB" in src
        assert "#define ED25519_SLOT_WORDS (ED25519_SLOTS * 8)" in src
        # the ladder runs every step through one call site of fop_run
        assert src.count("fop_run<Ed25519Field>(") == 1 and "ed_run(at, len, sl, stride);" in src
        # a quad of lanes a signature; the warp, converged, syncs whole, never the block
        assert "#define ED25519_SIGS (ED25519_THREADS / 4)" in src
        assert "__syncwarp()" in src
        assert src.count("__syncthreads()") == 1  # the comb's load, before any quad diverges
    launch = src[src.index(f'extern "C" int {name}_launch'):]
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in launch
    assert launch.count("err = ") == launch.count("if (err != cudaSuccess) return (int)err;") == 3
    assert f'extern "C" void {name}_geometry(int n, int* out)' in src
    assert "__noinline__" not in src + headers and "DEV_NOINLINE" not in src + headers
    field = {"sm2_verify": "Sm2Field", "ed25519_verify": "Ed25519Field"}.get(name, "SecpField")
    assert f"fop_run<{field}>(" in src + headers
