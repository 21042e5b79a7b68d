"""BLS12-381's multi-pairing on the port, on the CPU: header sync's one
aggregate check. The port's rows against the arguments the JAX
``multi_pairing_check`` hands its program ``_multi_pairing_xla`` (captured
by a monkeypatch, so no JAX BLS program is traced); the port's
``BLSCrypto.multi_pairing_verify`` against the JAX class (its host route on
the CPU), pair for pair; the plain version's GT elements and verdicts
against the oracle's ``final_exponentiation(miller_loop(live))`` on an
accepting and a rejecting fold of two aggregate checks and on the
accepting fold with a None pair; the kernel's programs over Python
integers and the CUDA kernel's multi-pairing built as host C++ (one, two
and three pairs; its groups through the product tree) against the oracle; the bound's least work against the
kernel's own. Every tolerance is exact. The kernel itself runs only on the
card, through chip_smoke.py."""

import ctypes
import random
import shutil
import subprocess

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

CPU = torch.device("cpu")
TABLE_VALS = [sum(int(w) << (32 * i) for i, w in enumerate(row))
              for row in np.asarray(K.KERNEL_TABLE).view(np.uint32).reshape(-1, 12)]


def _checks():
    """Seeded aggregate checks (pubs, msg, agg_sig) of a 4-member committee:
    a quorum of 3, a single signer, and the quorum's signature over another
    message (which fails)."""
    rng = random.Random(0x3417)
    keys = [R.keygen(rng.getrandbits(256)) for _ in range(4)]
    pubs = [pk for _, pk in keys]
    msg, single, other = rng.randbytes(32), rng.randbytes(32), rng.randbytes(32)
    quorum = R.aggregate_signatures([R.sign(keys[i][0], msg) for i in range(3)])
    return {
        "quorum": (tuple(pubs[:3]), msg, quorum),
        "single": ((pubs[3],), single, R.sign(keys[3][0], single)),
        "wrong message": (tuple(pubs[:3]), other, quorum),
    }


def _oracle_gt(pairs):
    live = [(p, q) for p, q in pairs if p is not None and q is not None]
    return JR.final_exponentiation(JR.miller_loop(live))


@pytest.fixture(scope="module")
def folds():
    """The port's BLSCrypto on the CPU folds an accepting set (the quorum and
    the single signer) and a rejecting one (the quorum and the wrong
    message), and multi_pairing_check runs the accepting fold's pairs with a
    None pair inserted: the verdicts, and the pairs, rows and GT elements
    the plain version saw (three plain multi-pairings of 3 pairs)."""
    c = _checks()
    sets = {"good": [c["quorum"], c["single"]], "bad": [c["quorum"], c["wrong message"]]}
    seen = []
    real_check, real_gt = K.multi_pairing_check, K.multi_pairing_gt_plain

    def check_spy(pairs, device=None):
        seen.append({"pairs": list(pairs)})
        return real_check(pairs, device)

    def gt_spy(rows):
        seen[-1].update(rows=rows.clone(), gt=real_gt(rows))
        return seen[-1]["gt"]

    crypto = pbls.BLSCrypto(CPU)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(K, "multi_pairing_check", check_spy)
        mp.setattr(K, "multi_pairing_gt_plain", gt_spy)
        bits = {name: crypto.multi_pairing_verify(checks) for name, checks in sets.items()}
        good_pairs = seen[0]["pairs"]
        with_none = good_pairs[:1] + [(None, good_pairs[1][1])] + good_pairs[1:] + [(good_pairs[0][0], None)]
        bits["good with a None pair"] = K.multi_pairing_check(with_none, device="cpu")
    return {"sets": sets, "bits": bits, **dict(zip(("good", "bad", "good with a None pair"), seen))}


def test_multi_pairing_verify_matches_the_jax_class(folds):
    """The port's verdicts equal the JAX BLSCrypto's (its host route on the
    CPU): the accepting fold True, the rejecting one False; both classes
    build the same pairs, (-g1, Σ r·σ) first, captured through the JAX
    host_multi_pairing_check and the port's multi_pairing_check."""
    captured = []
    real = J.host_multi_pairing_check
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J, "host_multi_pairing_check", lambda pairs: captured.append(list(pairs)) or real(pairs))
        want = {name: jbls.BLSCrypto().multi_pairing_verify(checks) for name, checks in folds["sets"].items()}
    assert want == {"good": True, "bad": False}
    assert {name: folds["bits"][name] for name in want} == want
    assert captured == [folds["good"]["pairs"], folds["bad"]["pairs"]]
    assert len(captured[0]) == 3 and captured[0][0][0] == JR.ec_neg(JR.G1, JR.FP_OPS)


def test_plain_gt_elements_match_the_oracle(folds):
    """Each plain multi-pairing's GT element equals the oracle's
    final_exponentiation(miller_loop(live)) of its pairs, and its verdict
    the comparison with 1; the None pairs are dropped from the rows, which
    equal the accepting fold's."""
    for name in ("good", "bad", "good with a None pair"):
        want = _oracle_gt(folds[name]["pairs"])
        assert K.tower_to_ref(folds[name]["gt"]) == [want], name
        assert folds["bits"][name] == (want == JR.F12_ONE), name
    assert folds["bits"]["good with a None pair"] is True
    assert torch.equal(folds["good with a None pair"]["rows"], folds["good"]["rows"])
    assert folds["good"]["rows"].shape == (3, K.PAIR_WORDS)


def test_rows_match_the_jax_program_inputs(folds):
    """multi_pairing_rows equals the arrays the JAX multi_pairing_check
    hands _multi_pairing_xla on its valid lanes (captured by a monkeypatch:
    no JAX program runs), and the lanes JAX marks valid are the live pairs
    in order."""
    pairs = folds["good with a None pair"]["pairs"] + folds["bad"]["pairs"][1:]
    captured = {}

    def fake_program(*args):
        captured["arrays"], captured["valid"] = args[:6], np.asarray(args[6])
        return np.array([True])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J, "_multi_pairing_xla", fake_program)
        assert J.multi_pairing_check(pairs) is True
    valid = captured["valid"]
    live = [p is not None and q is not None for p, q in pairs]
    assert valid.shape == (8,) and list(valid[: len(pairs)]) == live and not valid[len(pairs):].any()
    rows = K.multi_pairing_rows(pairs)
    assert rows.dtype == np.int32 and rows.shape == (sum(live), K.PAIR_WORDS)
    assert rows.tobytes() == K.multi_pairing_rows_from_jax(captured["arrays"], valid).tobytes()
    assert K.multi_pairing_rows([]).shape == (0, K.PAIR_WORDS)


def test_no_pairing_without_a_live_pair_or_a_decoded_check(monkeypatch):
    """An empty set is True, a set with an undecodable key, signature or an
    empty signer set False, as in the JAX class, and none runs a pairing; a
    list of only None pairs is True with no launch; with no device named
    and no CUDA both entry points raise."""
    monkeypatch.setattr(K, "multi_pairing_device", lambda rows: pytest.fail("a pairing ran"))
    c = _checks()
    pubs, msg, agg = c["quorum"]
    undecodable = {"empty": [], "a malformed key": [c["single"], ((pubs[0], b"\x00" * 48), msg, agg)],
                   "a malformed signature": [(pubs, msg, b"\x00" * 96)], "no signer": [((), msg, agg)]}
    crypto, jcrypto = pbls.BLSCrypto(CPU), jbls.BLSCrypto()
    for name, checks in undecodable.items():
        assert crypto.multi_pairing_verify(checks) == jcrypto.multi_pairing_verify(checks) == (name == "empty")
    all_none = [(None, R.G2), (R.G1, None), (None, None)]
    assert K.multi_pairing_check(all_none, device="cpu") is True and K.multi_pairing_check([], device="cpu")
    assert J.host_multi_pairing_check(all_none) is True
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            K.multi_pairing_check([(R.G1, R.G2)])
        with pytest.raises(RuntimeError):
            pbls.BLSCrypto().multi_pairing_verify([c["quorum"]])
    with pytest.raises(ValueError):
        _kernels.bls12_381_multi_pairing(torch.zeros((1, 72), dtype=torch.int32), K.kernel_table(CPU))


def _pair_ints(rows: torch.Tensor) -> list[list[int]]:
    w = rows.numpy().view(np.uint32).reshape(rows.shape[0], 6, 12)
    return [[sum(int(x) << (32 * i) for i, x in enumerate(v)) for v in pair] for pair in w]


def _gt_ref(gt_vals: list[int]):
    words = np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(12)] for v in gt_vals], dtype=np.uint32)
    return K.tower_to_ref(K.words_to_limbs(torch.from_numpy(words.view(np.int32).reshape(1, 144))))[0]


def test_programs_over_ints_match_the_oracle(folds):
    """The multi-pairing's programs over Python integers (run_multi: a
    group of two pairs on the check's Miller loop, the lone third on the
    one-pair loop, their product, the final exponentiation) on the
    accepting fold's rows: the oracle's GT element and verdict."""
    ok, gt = BP.run_multi(_pair_ints(folds["good"]["rows"]), TABLE_VALS)
    assert ok is True and _gt_ref(gt) == _oracle_gt(folds["good"]["pairs"])


SHIM = r"""
#include "{src}"

// a multi-pairing of n pairs, the kernel's groups one after another, each
// through its Miller phase and its climb of the product tree, the one at
// the root finishing on its slots: ok, the GT element (144 words), and the
// Fp products (all, then squarings)
extern "C" void host_multi_pairing(const u32* rows, const u32* table, uint8_t* ok, u32* gt, int n,
                                   unsigned long long* counts) {{
  static u32 sl[BLS_MP_SMEM_WORDS];
  static u32 fs[64 * BLS_GT_WORDS];
  static unsigned cnt[64];
  bls_count_mul = bls_count_sqr = 0;
  const int groups = BLS_MP_GROUPS(n);
  for (int g = 0; g < groups; g++) cnt[g] = 0;
  for (int g = 0; g < groups; g++) {{
    bls_mp_miller(rows + (long)2 * g * BLS_PAIR_WORDS, n - 2 * g < 2 ? 1 : 2, table, sl);
    if (bls_mp_tree(fs, cnt, groups, g, sl)) bls_mp_finish(sl, ok, gt);
  }}
  counts[0] = bls_count_mul + bls_count_sqr;
  counts[1] = bls_count_sqr;
}}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's arithmetic for the host")
    d = tmp_path_factory.mktemp("bls_multi_host")
    shim = d / "shim.cpp"
    shim.write_text(SHIM.format(src=_kernels.SOURCES["bls12_381"]))
    lib_path = d / "libbls_multi_host.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(lib_path), str(shim)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.host_multi_pairing.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    lib.host_multi_pairing.restype = None
    return lib


@pytest.mark.parametrize("pairs", [1, 2, 3])
def test_kernel_multi_pairing_matches_the_oracle(host_kernel, folds, pairs):
    """The kernel's multi-pairing built as host C++ (its groups run one
    after another) on the first 1, 2 and 3 pairs of the accepting fold (one
    lone pair, one group, a group and a lone pair): the oracle's verdict and
    GT element, and the Fp products the programs count."""
    rows = np.ascontiguousarray(folds["good"]["rows"].numpy()[:pairs])
    table = np.ascontiguousarray(K.KERNEL_TABLE)
    ok = np.zeros(1, dtype=np.uint8)
    gt = np.zeros((1, 144), dtype=np.uint32)
    counts = (ctypes.c_ulonglong * 2)()
    host_kernel.host_multi_pairing(rows.ctypes.data, table.ctypes.data, ok.ctypes.data, gt.ctypes.data, pairs,
                                   counts)
    want = _oracle_gt(folds["good"]["pairs"][:pairs])
    assert K.tower_to_ref(K.words_to_limbs(torch.from_numpy(gt.view(np.int32)))) == [want]
    assert bool(ok[0]) == (want == JR.F12_ONE) == (pairs == 3)
    assert counts[0] == sum(BP.multi_products(pairs).values()) + chip_smoke.BLS_FP_INV_PRODUCTS


def test_bound_counts_the_least_work_for_k_pairs():
    """chip_smoke.py's bound for K pairs: one shared squaring of f a bit,
    each pair's 63 doubling steps, 5 addition steps and 68 lines, one final
    exponentiation; below the kernel's own products (each group squares its
    own f, and the groups' f values are multiplied) at every K, equal to the
    check's least work at K = 2, and ~298,000 Fp products at 65 pairs."""
    for k in (1, 2, 3, 9, 65, 257):
        least = chip_smoke.bls_multi_least_products(k)
        assert least <= sum(BP.multi_products(k).values()) + chip_smoke.BLS_FP_INV_PRODUCTS, k
    assert chip_smoke.bls_multi_least_products(2) == chip_smoke.BLS_LEAST_PRODUCTS
    assert chip_smoke.bls_multi_least_products(65) == 298_022
    assert BP.multi_critical_rows(2) == BP.critical_rows()
    assert BP.multi_critical_rows(65)["mul"] == BP.critical_rows()["mul"] + 6 * 2
