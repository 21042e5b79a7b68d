"""Port EC layer (plain PyTorch) against the JAX package and the reference:
the comb/GLV state, the GLV split, the complete group law on both curves
(a = 0 and SM2's a = -3 in the Montgomery domain), the curve check, the
batched inversion and both ladders."""

import jax
import numpy as np
import pytest
import torch

from fisco_bcos_tpu.ops import ec as jec
from fisco_bcos_tpu.ops import limb as jlimb
from fisco_bcos_tpu_torch import params
from fisco_bcos_tpu_torch.crypto.ref import ecdsa as ref
from fisco_bcos_tpu_torch.ops import ec, limb

C = ref.SECP256K1
LAMBDA = ec._SECP_LAMBDA


@pytest.fixture(scope="module")
def ops():
    return ec.CurveOps("cpu")


def test_tables_from_jax_equal_self_built():
    jax_tables = params.tables_from_jax(
        jec.g_comb_table_glv("secp256k1"), jec.glv_params("secp256k1")
    )
    own = params.build_tables()
    assert jax_tables.same_as(own)
    np.testing.assert_array_equal(ec.g_comb_table_glv(), jec.g_comb_table_glv("secp256k1"))
    np.testing.assert_array_equal(own.comb_limbs(), ec.g_comb_table_glv())
    assert own.comb_words.shape == (60, 8) and own.comb_words.dtype == np.uint32
    # row c-1 holds c·G, row 30+c-1 holds c·2^128·G (x), y 15 rows below
    for c in (1, 7, 15):
        x, y = ref.point_mul(C, c, (C.gx, C.gy))
        assert limb.rows_to_ints(own.comb_limbs()[[c - 1, 15 + c - 1]].T) == [x, y]
        hx, hy = ref.point_mul(C, c << 128, (C.gx, C.gy))
        assert limb.rows_to_ints(own.comb_limbs()[[30 + c - 1, 45 + c - 1]].T) == [hx, hy]


def test_tables_from_jax_rejects_bad_shape():
    with pytest.raises(ValueError):
        params.tables_from_jax(np.zeros((30, 16), np.uint32), jec.glv_params("secp256k1"))


def test_glv_decompose_matches_jax_and_recombines(ops):
    rng = np.random.default_rng(3)
    u2 = [0, 1, C.n - 1, LAMBDA, C.n - LAMBDA, 1 << 128, (1 << 255) % C.n]
    u2 += [int.from_bytes(rng.bytes(32), "big") % C.n for _ in range(17)]
    ka, sa, kb, sb = ec.glv_decompose(limb.ints_to_rows(u2, "cpu"), ops)
    jka, jsa, jkb, jsb = jax.jit(lambda u: jec.glv_decompose(u, jec.SECP256K1_OPS))(
        np.stack([jlimb.int_to_rows(v) for v in u2], axis=1)
    )
    np.testing.assert_array_equal(ka.numpy(), np.asarray(jka).astype(np.int64))
    np.testing.assert_array_equal(kb.numpy(), np.asarray(jkb).astype(np.int64))
    np.testing.assert_array_equal(sa.numpy(), np.asarray(jsa))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(jsb))
    for u, a, s_a, b, s_b in zip(u2, limb.rows_to_ints(ka), sa.tolist(), limb.rows_to_ints(kb), sb.tolist()):
        assert a < 1 << 131 and b < 1 << 131
        assert ((-a if s_a else a) + (-b if s_b else b) * LAMBDA - u) % C.n == 0


def _affine_ints(P, ops):
    x, y, inf = ec.pt_to_affine_batch(P, ops)
    pts = list(zip(limb.rows_to_ints(x), limb.rows_to_ints(y)))
    return [None if i else p for p, i in zip(pts, inf.tolist())]


def test_point_ops_match_reference(ops):
    """Generic add, identity operands, P == Q and P == -Q through the
    complete formulas, against the affine reference."""
    g = (C.gx, C.gy)
    g2 = ref.point_add(C, g, g)
    g5 = ref.point_mul(C, 5, g)
    neg_g = (C.gx, C.p - C.gy)
    lhs = [g, g, g, g2, None, g5]
    rhs = [g2, g, neg_g, g5, g, None]

    def proj(pts):
        xs = [0 if p is None else p[0] for p in pts]
        ys = [1 if p is None else p[1] for p in pts]
        zs = [0 if p is None else 1 for p in pts]
        return tuple(limb.ints_to_rows(v, "cpu") for v in (xs, ys, zs))

    want = [ref.point_add(C, a, b) for a, b in zip(lhs, rhs)]
    assert _affine_ints(ec.pt_add(proj(lhs), proj(rhs), ops), ops) == want

    # mixed addition: affine right operands that are genuine points
    rhs_aff = [g2, g, neg_g, g5, g, g2]
    x2 = limb.ints_to_rows([p[0] for p in rhs_aff], "cpu")
    y2 = limb.ints_to_rows([p[1] for p in rhs_aff], "cpu")
    want = [ref.point_add(C, a, b) for a, b in zip(lhs, rhs_aff)]
    assert _affine_ints(ec.pt_add_mixed(proj(lhs), (x2, y2), ops), ops) == want

    want = [ref.point_add(C, a, a) for a in lhs]
    assert _affine_ints(ec.pt_double(proj(lhs), ops), ops) == want


def test_lane_inv_matches_per_lane_fermat(ops):
    rng = np.random.default_rng(9)
    for width in (1, 5, 8, 13):
        vals = [0] + [int.from_bytes(rng.bytes(32), "big") % C.p for _ in range(width - 1)]
        got = ec.lane_inv(ops.F, limb.ints_to_rows(vals, "cpu"))
        assert limb.rows_to_ints(got) == [pow(v, C.p - 2, C.p) for v in vals]


def test_quad_mul_windowed_matches_reference(ops):
    """u1·G + u2·Q through the GLV split and the 33-window ladder."""
    rng = np.random.default_rng(13)
    q = ref.point_mul(C, 0xC0FFEE, (C.gx, C.gy))
    u1 = [0, 1, C.n - 1] + [int.from_bytes(rng.bytes(32), "big") % C.n for _ in range(3)]
    u2 = [1, 0, C.n - 1] + [int.from_bytes(rng.bytes(32), "big") % C.n for _ in range(3)]
    ka, sa, kb, sb = ec.glv_decompose(limb.ints_to_rows(u2, "cpu"), ops)
    qx = limb.ints_to_rows([q[0]] * len(u1), "cpu")
    qy = limb.ints_to_rows([q[1]] * len(u1), "cpu")
    table = torch.from_numpy(ec.g_comb_table_glv().astype(np.int64))
    P = ec.quad_mul_windowed(limb.ints_to_rows(u1, "cpu"), ka, sa, kb, sb, (qx, qy), ops, table)
    want = [
        ref.point_add(C, ref.point_mul(C, a, (C.gx, C.gy)), ref.point_mul(C, b, q))
        for a, b in zip(u1, u2)
    ]
    assert _affine_ints(P, ops) == want


# ---------------------------------------------------------------------------
# SM2: the generic-a law over the Montgomery field
# ---------------------------------------------------------------------------

S = ref.SM2_CURVE


@pytest.fixture(scope="module")
def sm2_ops():
    return ec.CurveOps("cpu", "sm2")


def _sm2_affine_ints(P, ops):
    F = ops.F
    x, y, inf = ec.pt_to_affine_batch(P, ops)
    pts = list(zip(limb.rows_to_ints(F.to_plain(x)), limb.rows_to_ints(F.to_plain(y))))
    return [None if i else p for p, i in zip(pts, inf.tolist())]


def _sm2_enc(vals, ops):
    return ops.F.from_plain(limb.ints_to_rows(vals, "cpu"))


def test_curve_ops_fields_and_constants(ops, sm2_ops):
    assert isinstance(ops.F, limb.FoldField) and ops.a_is_zero and ops.b3_small == 21
    assert isinstance(sm2_ops.F, limb.MontField) and sm2_ops.Fn is None
    assert sm2_ops.a_is_minus3 and not sm2_ops.a_is_zero and sm2_ops.b3_small is None
    R = 1 << 256
    assert limb.rows_to_ints(sm2_ops.b3_enc) == [3 * S.b % S.p * R % S.p]
    assert limb.rows_to_ints(sm2_ops.a_enc) == [S.a * R % S.p]
    J = jec.SM2_OPS
    for ours, theirs in ((sm2_ops.a_enc, J.a_enc), (sm2_ops.b_enc, J.b_enc), (sm2_ops.b3_enc, J.b3_enc)):
        np.testing.assert_array_equal(ours[:, 0].numpy(), theirs.astype(np.int64))


def test_sm2_point_ops_match_reference(sm2_ops):
    """RCB algorithms 1, 2, 3 with identity operands, P == Q and P == -Q."""
    g = (S.gx, S.gy)
    g2 = ref.point_add(S, g, g)
    g5 = ref.point_mul(S, 5, g)
    neg_g = (S.gx, S.p - S.gy)
    lhs = [g, g, g, g2, None, g5]
    rhs = [g2, g, neg_g, g5, g, None]

    def proj(pts):
        xs = [0 if p is None else p[0] for p in pts]
        ys = [1 if p is None else p[1] for p in pts]
        zs = [0 if p is None else 1 for p in pts]
        return tuple(_sm2_enc(v, sm2_ops) for v in (xs, ys, zs))

    want = [ref.point_add(S, a, b) for a, b in zip(lhs, rhs)]
    assert _sm2_affine_ints(ec.pt_add(proj(lhs), proj(rhs), sm2_ops), sm2_ops) == want
    rhs_aff = [g2, g, neg_g, g5, g, g2]
    aff = (_sm2_enc([p[0] for p in rhs_aff], sm2_ops), _sm2_enc([p[1] for p in rhs_aff], sm2_ops))
    want = [ref.point_add(S, a, b) for a, b in zip(lhs, rhs_aff)]
    assert _sm2_affine_ints(ec.pt_add_mixed(proj(lhs), aff, sm2_ops), sm2_ops) == want
    want = [ref.point_add(S, a, a) for a in lhs]
    assert _sm2_affine_ints(ec.pt_double(proj(lhs), sm2_ops), sm2_ops) == want


def test_on_curve_and_add_mod_n(ops, sm2_ops):
    for C_, o, enc in ((C, ops, lambda v: limb.ints_to_rows(v, "cpu")), (S, sm2_ops, lambda v: _sm2_enc(v, sm2_ops))):
        g5 = ref.point_mul(C_, 5, (C_.gx, C_.gy))
        xs = [C_.gx, g5[0], C_.gx, 0]
        ys = [C_.gy, g5[1], C_.gy ^ 1, 0]
        assert ec.on_curve(enc(xs), enc(ys), o).tolist() == [ref.on_curve(C_, p) for p in zip(xs, ys)]
        a = [0, 1, C_.n - 1, C_.n - 1, 12345]
        b = [0, C_.n - 1, C_.n - 1, 1, C_.n - 12345]
        got = ec.add_mod_n(limb.ints_to_rows(a, "cpu"), limb.ints_to_rows(b, "cpu"), o)
        assert limb.rows_to_ints(got) == [(x + y) % C_.n for x, y in zip(a, b)]


def test_dual_mul_windowed_matches_reference(sm2_ops):
    """k1·G + k2·Q over the 64-window ladder and the Montgomery comb."""
    rng = np.random.default_rng(23)
    q = ref.point_mul(S, 0xC0FFEE, (S.gx, S.gy))
    k1 = [0, 1, S.n - 1, 0] + [int.from_bytes(rng.bytes(32), "big") % S.n for _ in range(3)]
    k2 = [1, 0, S.n - 1, 0] + [int.from_bytes(rng.bytes(32), "big") % S.n for _ in range(3)]
    n = len(k1)
    Q = (_sm2_enc([q[0]] * n, sm2_ops), _sm2_enc([q[1]] * n, sm2_ops))
    table = torch.from_numpy(ec.g_comb_table("sm2").astype(np.int64))
    P = ec.dual_mul_windowed(limb.ints_to_rows(k1, "cpu"), limb.ints_to_rows(k2, "cpu"), Q, sm2_ops, table)
    want = [
        ref.point_add(S, ref.point_mul(S, a, (S.gx, S.gy)), ref.point_mul(S, b, q))
        for a, b in zip(k1, k2)
    ]
    assert _sm2_affine_ints(P, sm2_ops) == want


def test_scalar_windows_lsb_first():
    k = [0x123456789ABCDEF, (1 << 256) - 1, 0]
    w = ec.scalar_windows(limb.ints_to_rows(k, "cpu"))
    assert w.shape == (64, 3)
    for j, v in enumerate(k):
        assert [int(x) for x in w[:, j]] == [(v >> (4 * i)) & 0xF for i in range(64)]
