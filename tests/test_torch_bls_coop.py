"""The multi-pairing kernel's cooperative field layer and product tree, on
the CPU: csrc/bls12_381_coop.cuh's Fp product and sum split over a group of
lanes (a quad, and a pair), built as host C++ from the kernel's own source
with g++ (a group's lanes run in turn, a shuffle reads another lane's
element), against the one-lane bls_mul and bls_addsub bit for bit on 4,096
seeded operand pairs and on the edges; the kernel's multi-pairing through
the quad runner and the tree at 1, 2, 3, 5 and 9 pairs, its groups
finishing in turn and in reverse, against the oracle's GT element and
verdict, on lists made from seeded multiples of the generators (no
hash-to-G2). Every comparison is exact. The kernel itself runs only on the
card, through chip_smoke.py."""

import ctypes
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from fisco_bcos_tpu.crypto.ref import bls12_381 as JR
from fisco_bcos_tpu_torch.ops import _kernels
from fisco_bcos_tpu_torch.ops import bls12_381 as K
from fisco_bcos_tpu_torch.ops import bls12_381_programs as BP

P = JR.P
R = 1 << 384

SHIM = r"""
#include "{src}"

// operand pair i: bls_mul, the product on a group of L lanes, then a + b and
// a - b by bls_addsub and on the group (6 results of 12 words each)
template <int L>
static void ops(const u32* a, const u32* b, u32* out, int n) {{
  for (int i = 0; i < n; i++) {{
    const u32* x = a + BLS_NW * i;
    const u32* y = b + BLS_NW * i;
    u32* o = out + 6 * BLS_NW * i;
    bls_mul(o, x, y);
    bls_mul_coop<L>(o + BLS_NW, x, y, true);
    bls_addsub(o + 2 * BLS_NW, x, y, false);
    bls_addsub_coop<L>(o + 3 * BLS_NW, x, y, false, true);
    bls_addsub(o + 4 * BLS_NW, x, y, true);
    bls_addsub_coop<L>(o + 5 * BLS_NW, x, y, true, true);
  }}
}}

extern "C" int host_coop_ops(int lanes, const u32* a, const u32* b, u32* out, int n) {{
  if (lanes == 4) ops<4>(a, b, out, n);
  else if (lanes == 2) ops<2>(a, b, out, n);
  else return -1;
  return 0;
}}

// a multi-pairing of n pairs, the kernel's groups one after another (in
// turn, or from the last), each through its Miller phase and its climb of
// the product tree: ok, the GT element (144 words), the Fp products, and
// the group that reached the root
extern "C" int host_multi_pairing(const u32* rows, const u32* table, uint8_t* ok, u32* gt, int n, int reversed,
                                  unsigned long long* products) {{
  static u32 sl[BLS_MP_SMEM_WORDS];
  static u32 fs[16 * BLS_GT_WORDS];
  static unsigned cnt[16];
  const int groups = BLS_MP_GROUPS(n);
  if (groups > 16) return -1;
  bls_count_mul = bls_count_sqr = 0;
  for (int g = 0; g < groups; g++) cnt[g] = 0;
  int root = -1;
  for (int i = 0; i < groups; i++) {{
    const int g = reversed ? groups - 1 - i : i;
    bls_mp_miller(rows + (long)2 * g * BLS_PAIR_WORDS, n - 2 * g < 2 ? 1 : 2, table, sl);
    if (bls_mp_tree(fs, cnt, groups, g, sl)) {{
      bls_mp_finish(sl, ok, gt);
      root = g;
    }}
  }}
  *products = bls_count_mul + bls_count_sqr;
  return root;
}}
"""


@pytest.fixture(scope="module")
def coop_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's arithmetic for the host")
    d = tmp_path_factory.mktemp("bls_coop_host")
    shim = d / "shim.cpp"
    shim.write_text(SHIM.format(src=_kernels.SOURCES["bls12_381"]))
    lib_path = d / "libbls_coop_host.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(lib_path), str(shim)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.host_coop_ops.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.host_coop_ops.restype = ctypes.c_int
    lib.host_multi_pairing.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.host_multi_pairing.restype = ctypes.c_int
    return lib


def _words(vals) -> np.ndarray:
    return np.ascontiguousarray([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(12)] for v in vals], dtype=np.uint32)


def _ints(words: np.ndarray) -> list[int]:
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in words]


# 0, 1, p - 1, R mod p (the Montgomery 1), R² mod p, and values whose low
# words are all ones, below p
EDGES = (0, 1, P - 1, R % P, R * R % P, (1 << 32) - 1, (1 << 96) - 1, (1 << 192) - 1, (1 << 352) - 1,
         P - 1 - (1 << 64), (P >> 32 << 32) - 1)


def _operands(kind: str) -> tuple[list[int], list[int]]:
    if kind == "edges":
        pairs = [(a, b) for a in EDGES for b in EDGES]
        return [a for a, _ in pairs], [b for _, b in pairs]
    rng = random.Random(0xC00B)
    return [rng.randrange(P) for _ in range(4096)], [rng.randrange(P) for _ in range(4096)]


@pytest.mark.parametrize("lanes", [4, 2])
@pytest.mark.parametrize("kind", ["seeded", "edges"])
def test_group_ops_match_the_one_lane_ops(coop_lib, lanes, kind):
    """The product, the sum and the difference on a group of 4 lanes (the
    kernel's quad) and of 2 (the field bench's pair): bls_mul's and
    bls_addsub's words bit for bit, which are a·b·R^-1, a + b and a - b
    mod p, canonical."""
    a_vals, b_vals = _operands(kind)
    assert all(v < P for v in a_vals + b_vals)
    a, b = _words(a_vals), _words(b_vals)
    out = np.zeros((len(a_vals), 6, 12), dtype=np.uint32)
    assert coop_lib.host_coop_ops(lanes, a.ctypes.data, b.ctypes.data, out.ctypes.data, len(a_vals)) == 0
    for one, group in ((0, 1), (2, 3), (4, 5)):
        assert np.array_equal(out[:, group], out[:, one]), (lanes, kind, one)
    rinv = pow(R, -1, P)
    step = 1 if kind == "edges" else 64
    for i in range(0, len(a_vals), step):
        x, y = a_vals[i], b_vals[i]
        assert _ints(out[i, [1, 3, 5]]) == [x * y * rinv % P, (x + y) % P, (x - y) % P], (lanes, kind, i)


def _g1(k: int):
    return JR.ec_mul(JR.G1, k % JR.R_ORDER, JR.FP_OPS)


def _g2(k: int):
    return JR.ec_mul(JR.G2, k % JR.R_ORDER, JR.FP2_OPS)


def _pairs(n: int, accept: bool, rng: random.Random) -> list[tuple]:
    """n pairs (a·g1, b·g2) of seeded scalars; where `accept`, the last
    pair is (-(Σ a·b)·g1, g2), so the product of the pairings is 1."""
    scalars = [(rng.randrange(1, JR.R_ORDER), rng.randrange(1, JR.R_ORDER)) for _ in range(n)]
    if accept:
        scalars[-1] = (-sum(x * y for x, y in scalars[:-1]), 1)
    return [(_g1(x), _g2(y)) for x, y in scalars]


LISTS = {1: False, 2: True, 3: False, 5: False, 9: True}  # pairs -> accepted


@pytest.fixture(scope="module")
def lists():
    """{pairs: (rows, the oracle's GT element)} for each list of LISTS."""
    rng = random.Random(0x7E1D)
    out = {}
    for n, accept in LISTS.items():
        pairs = _pairs(n, accept, rng)
        out[n] = (K.multi_pairing_rows(pairs), JR.final_exponentiation(JR.miller_loop(pairs)))
    return out


@pytest.mark.parametrize("order", ["in turn", "reversed"])
@pytest.mark.parametrize("n", list(LISTS))
def test_tree_multi_pairing_matches_the_oracle(coop_lib, lists, n, order):
    """The kernel's multi-pairing built as host C++ through the quad runner
    and the product tree, its groups finishing in turn and in reverse (so
    that either child of a node arrives second; 9 pairs are 5 groups, odd
    at two levels): the oracle's GT element and verdict, the root reached
    by the last group to run, and the Fp products the programs count."""
    rows, want = lists[n]
    rows = np.ascontiguousarray(rows)
    table = np.ascontiguousarray(K.KERNEL_TABLE)
    ok = np.zeros(1, dtype=np.uint8)
    gt = np.zeros((1, 144), dtype=np.uint32)
    products = ctypes.c_ulonglong()
    reversed_ = order == "reversed"
    root = coop_lib.host_multi_pairing(rows.ctypes.data, table.ctypes.data, ok.ctypes.data, gt.ctypes.data, n,
                                       int(reversed_), ctypes.byref(products))
    groups = (n + 1) // 2
    assert root == (0 if reversed_ else groups - 1)
    assert K.tower_to_ref(K.words_to_limbs(torch.from_numpy(gt.view(np.int32)))) == [want]
    assert bool(ok[0]) == (want == JR.F12_ONE) == LISTS[n]
    assert products.value == sum(BP.multi_products(n).values()) + chip_smoke.BLS_FP_INV_PRODUCTS


def test_tree_depth_and_products():
    """The tree's depth is ⌈log2 groups⌉ products on the critical path, its
    products groups - 1 in all (multi_products unchanged by the tree): 6
    of 32 at 65 pairs, 8 of 128 at 257."""
    assert [BP.tree_depth(g) for g in (1, 2, 3, 5, 33, 129)] == [0, 1, 2, 3, 6, 8]
    c = BP.compiled()

    def products(entries) -> int:
        return sum(BP._products(entries).values())

    miller2, miller1 = products(c["script"][: BP.MILLER_LEN]), products(c["script1"])
    fmul, final = products([c["fmul"]]), products(c["script"][BP.MILLER_LEN :])
    for k, depth in ((65, 6), (257, 8), (9, 3), (2, 0)):
        groups = (k + 1) // 2
        assert BP.multi_critical_rows(k)["mul"] == BP.critical_rows()["mul"] + 2 * depth
        assert sum(BP.multi_products(k).values()) == (
            (k // 2) * miller2 + (k % 2) * miller1 + (groups - 1) * fmul + final
        )
