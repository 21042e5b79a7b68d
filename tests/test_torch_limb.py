"""Port FoldField (plain PyTorch, int64 16-bit limbs) against Python ints and
against the JAX package's limb.FoldField on the same inputs.

Exact comparison everywhere: this is integer arithmetic, and one differing
residue forks consensus.
"""

import jax
import numpy as np
import pytest
import torch

from fisco_bcos_tpu.ops import ec as jec
from fisco_bcos_tpu.ops import limb as jlimb
from fisco_bcos_tpu_torch.crypto.ref.ecdsa import SECP256K1
from fisco_bcos_tpu_torch.ops import limb

P, N = SECP256K1.p, SECP256K1.n
R = 1 << 256
FIELDS = {"p": P, "n": N}


def _operands(m: int, seed: int):
    """(canonical, wide) operand lists: canonical values < m with the edges
    0, 1, m-1 and min(p, n)-1; wide adds 2^256-1 and max(p, n)-1."""
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(32), "big") for _ in range(26)]
    canonical = [0, 1, m - 1, min(P, N) - 1] + [x % m for x in rand]
    wide = [R - 1, max(P, N) - 1] + rand[:2] + canonical[4:]
    return canonical, wide


def _rows(vals):
    return limb.ints_to_rows(vals, "cpu")


def _jrows(vals):
    return np.stack([jlimb.int_to_rows(v) for v in vals], axis=1)


def _jax_field(name):
    C = jec.SECP256K1_OPS
    return C.F if name == "p" else C.Fn


@pytest.mark.parametrize("name", ["p", "n"])
def test_mul_sqr_small_match_ints_and_jax(name):
    m = FIELDS[name]
    F = limb.FoldField(m, "cpu")
    _, a = _operands(m, 1)
    b = list(reversed(a))
    got = {
        "mul": F.mul(_rows(a), _rows(b)),
        "sqr": F.sqr(_rows(a)),
        "small": F.mul_small(_rows(a), 21),
    }
    assert limb.rows_to_ints(got["mul"]) == [x * y % m for x, y in zip(a, b)]
    assert limb.rows_to_ints(got["sqr"]) == [x * x % m for x in a]
    assert limb.rows_to_ints(got["small"]) == [21 * x % m for x in a]

    JF = _jax_field(name)
    jmul, jsqr, jsmall = jax.jit(
        lambda x, y: (JF.mul(x, y), JF.sqr(x), JF.mul_small(x, 21))
    )(_jrows(a), _jrows(b))
    for key, ref in (("mul", jmul), ("sqr", jsqr), ("small", jsmall)):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref).astype(np.int64), err_msg=key)


@pytest.mark.parametrize("name", ["p", "n"])
def test_add_sub_neg_match_ints_and_jax(name):
    m = FIELDS[name]
    F = limb.FoldField(m, "cpu")
    a, _ = _operands(m, 2)
    b = a[::-1]
    ta, tb = _rows(a), _rows(b)
    got = {"add": F.add(ta, tb), "sub": F.sub(ta, tb), "neg": F.neg(ta)}
    assert limb.rows_to_ints(got["add"]) == [(x + y) % m for x, y in zip(a, b)]
    assert limb.rows_to_ints(got["sub"]) == [(x - y) % m for x, y in zip(a, b)]
    assert limb.rows_to_ints(got["neg"]) == [(-x) % m for x in a]

    JF = _jax_field(name)
    jadd, jsub, jneg = jax.jit(lambda x, y: (JF.add(x, y), JF.sub(x, y), JF.neg(x)))(
        _jrows(a), _jrows(b)
    )
    for key, ref in (("add", jadd), ("sub", jsub), ("neg", jneg)):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref).astype(np.int64), err_msg=key)


@pytest.mark.parametrize("name", ["p", "n"])
def test_inv_matches_ints_and_jax(name):
    m = FIELDS[name]
    F = limb.FoldField(m, "cpu")
    a, _ = _operands(m, 3)
    got = F.inv(_rows(a))
    assert limb.rows_to_ints(got) == [pow(x, m - 2, m) for x in a]  # 0 -> 0
    ref = jax.jit(_jax_field(name).inv)(_jrows(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int64))


def test_sqrt_matches_ints_and_jax():
    F = limb.FoldField(P, "cpu")
    a, _ = _operands(P, 4)
    a = a + [x * x % P for x in a[:6]]  # residues and non-residues alike
    got = F.sqrt(_rows(a))
    assert limb.rows_to_ints(got) == [pow(x, (P + 1) // 4, P) for x in a]
    ref = jax.jit(jec.SECP256K1_OPS.F.sqrt)(_jrows(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int64))
    roots = limb.rows_to_ints(got)
    for x, y in zip(a[-6:], roots[-6:]):
        assert y * y % P == x


def test_sqrt_refuses_n():
    with pytest.raises(ValueError):
        limb.FoldField(N, "cpu").sqrt(_rows([4]))


def test_carry_norm_and_compares():
    rng = np.random.default_rng(5)
    cols = torch.from_numpy(rng.integers(0, 1 << 36, size=(32, 8), dtype=np.int64))
    cols[30:] = 0  # keep the value inside the 33 output limbs, as a field product does
    cols[:, 0] = 0xFFFF  # a ripple of carries through every limb
    cols[0, 0] = 0x10000
    out = limb.carry_norm(cols, bits=36)
    want = [sum(int(cols[i, j]) << (16 * i) for i in range(32)) for j in range(8)]
    assert limb.rows_to_ints(out) == want
    assert int(out.max()) <= 0xFFFF
    a = [0, 1, P, R - 1, 5, 5]
    b = [1, 0, P, 0, 5, 6]
    assert limb.lt(_rows(a), _rows(b)).tolist() == [x < y for x, y in zip(a, b)]
    assert limb.eq(_rows(a), _rows(b)).tolist() == [x == y for x, y in zip(a, b)]
    diff, borrow = limb.sub_borrow(_rows(a), _rows(b))
    assert limb.rows_to_ints(diff) == [(x - y) % R for x, y in zip(a, b)]
    assert borrow.tolist() == [x < y for x, y in zip(a, b)]
