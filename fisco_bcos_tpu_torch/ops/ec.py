"""Batch elliptic-curve arithmetic in plain PyTorch for secp256k1 and SM2
(the port of the JAX package's ``ops/ec.py``).

A point is a homogeneous (X : Y : Z) tuple of ``[16, T]`` int64 limb-major
tensors in the curve's field domain (plain for secp256k1's fold field,
Montgomery for SM2), (0 : 1 : 0) the identity. The group law is the
Renes–Costello–Batina complete addition: for a = 0 algorithms 7, 8, 9 with
b3 = 3b = 21, for SM2's a = −3 algorithms 1, 2, 3 with a·x = −(3x) by
additions and 3b a full multiply. Identity operands, P == Q and P == −Q need
no special case.

``quad_mul_windowed`` is the secp256k1 GLV ladder: u1·G + (−1)^sa·ka·Q +
(−1)^sb·kb·λQ over 33 4-bit windows, with the runtime 15-entry Q table, its
β-scaled λQ view and the host-built G / 2^128·G combs.
``dual_mul_windowed`` is SM2's: k1·G + k2·Q over 64 windows with the Q table
and the [30, 16] comb of G, no GLV.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..crypto.ref.ecdsa import SECP256K1, SM2_CURVE, point_add, point_mul
from . import limb
from .limb import (
    FoldField,
    MontField,
    add_widen,
    carry_norm,
    conv_cols,
    const_col,
    cond_sub,
    eq,
    int_to_rows,
    is_zero,
    lt,
    select,
    sub_borrow,
)

WINDOW = 4
N_WINDOWS = 256 // WINDOW  # 64: the plain dual ladder
N_QWINDOWS = 33  # ceil(131 / WINDOW) + guard: |ka|, |kb| < 2^131
_R = 1 << 256

CURVES = {"secp256k1": SECP256K1, "sm2": SM2_CURVE}

_SECP_LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
_SECP_BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE


# ---------------------------------------------------------------------------
# GLV constants and the fixed-base combs (host, from the port's ref copy)
# ---------------------------------------------------------------------------


def _glv_basis(n: int, lam: int) -> tuple[int, int, int, int]:
    """Short lattice basis (a1, b1), (a2, b2) with a + b·λ ≡ 0 (mod n), via
    the GLV partial extended Euclid (half-GCD stop at √n), ordered so that
    b1 < 0 < b2."""
    rows = [(n, 0), (lam, 1)]
    while rows[-1][0] * rows[-1][0] >= n:
        q = rows[-2][0] // rows[-1][0]
        rows.append((rows[-2][0] - q * rows[-1][0], rows[-2][1] - q * rows[-1][1]))
    r1, t1 = rows[-1]
    r0, t0 = rows[-2]
    q = r0 // r1
    r2, t2 = r0 - q * r1, t0 - q * t1
    v1 = (r1, -t1)
    v2 = (r0, -t0) if r0 * r0 + t0 * t0 <= r2 * r2 + t2 * t2 else (r2, -t2)
    (a1, b1), (a2, b2) = v1, v2
    if b1 > 0:
        (a1, b1), (a2, b2) = (a2, b2), (a1, b1)
    if not (a1 > 0 and a2 > 0 and b1 < 0 < b2):
        raise ArithmeticError("GLV basis has unexpected signs")
    if (a1 + b1 * lam) % n or (a2 + b2 * lam) % n:
        raise ArithmeticError("GLV basis vectors are not in the lattice")
    return a1, b1, a2, b2


@dataclass(frozen=True)
class GlvParams:
    """GLV split constants as Python ints: φ(x, y) = (βx, y) = λ·(x, y);
    g1 = floor(b2·2^448/n), g2 = floor(−b1·2^448/n)."""

    beta: int
    g1: int
    g2: int
    a1: int
    b1_abs: int
    a2: int
    b2: int


@lru_cache(maxsize=None)
def glv_params() -> GlvParams:
    c = SECP256K1
    lam, beta = _SECP_LAMBDA, _SECP_BETA
    # pick the (λ, β) pairing that realises φ(x, y) = (βx, y) on this curve
    lx, ly = point_mul(c, lam, (c.gx, c.gy))
    if ly != c.gy:
        raise ArithmeticError("λ is not an endomorphism eigenvalue of G")
    if lx != beta * c.gx % c.p:
        beta = beta * beta % c.p
        if lx != beta * c.gx % c.p:
            raise ArithmeticError("no β matches λ")
    a1, b1, a2, b2 = _glv_basis(c.n, lam)
    return GlvParams(
        beta=beta,
        g1=b2 * (1 << 448) // c.n,
        g2=-b1 * (1 << 448) // c.n,
        a1=a1,
        b1_abs=-b1,
        a2=a2,
        b2=b2,
    )


def make_field(m: int, device) -> FoldField | MontField:
    """The JAX package's choice of field for a modulus: the pseudo-Mersenne
    fold when m = 2^256 − c with c < 2^132 (secp256k1's p and n), word
    Montgomery otherwise (SM2's p)."""
    return FoldField(m, device) if _R - m < 1 << 132 else MontField(m, device)


def _comb_rows(name: str, base) -> np.ndarray:
    """[30, 16] uint32, field domain: x of c·base in rows 0..14, y in rows
    15..29, c = 1..15."""
    c = CURVES[name]
    enc = make_field(c.p, "cpu").enc
    tab = np.zeros((30, limb.LIMBS), dtype=np.uint32)
    acc = None
    for k in range(1, 16):
        acc = point_add(c, acc, base)
        tab[k - 1] = enc(acc[0])
        tab[15 + k - 1] = enc(acc[1])
    return tab


@lru_cache(maxsize=None)
def g_comb_table(name: str) -> np.ndarray:
    """[30, 16] uint32 16-bit limbs: the field-domain affine c·G, c = 1..15
    (x rows 0..14, y rows 15..29) — the JAX package's ``g_comb_table``; for
    SM2 in the Montgomery domain, R = 2^256."""
    c = CURVES[name]
    return _comb_rows(name, (c.gx, c.gy))


@lru_cache(maxsize=None)
def g_comb_table_glv() -> np.ndarray:
    """[60, 16] uint32 16-bit limbs: the affine combs of G (rows 0..29) and
    H = 2^128·G (rows 30..59), each as 15 x rows then 15 y rows — the JAX
    package's ``g_comb_table_glv("secp256k1")`` layout."""
    c = SECP256K1
    h = point_mul(c, 1 << 128, (c.gx, c.gy))
    return np.concatenate([g_comb_table("secp256k1"), _comb_rows("secp256k1", h)], axis=0)


# ---------------------------------------------------------------------------
# Device context
# ---------------------------------------------------------------------------


class CurveOps:
    """One curve's field objects and constant columns on one device — the
    JAX package's ``CurveOps`` (``a_is_zero``, ``a_is_minus3``, ``a_enc``,
    ``b_enc``, ``b3_small``, ``b3_enc``, p and n), built for ``"secp256k1"``
    or ``"sm2"``. ``Fn`` is the scalar field when n is pseudo-Mersenne
    (secp256k1), else None (SM2 needs only plain-limb helpers mod n); the
    GLV columns exist for secp256k1 only."""

    def __init__(self, device, name: str = "secp256k1"):
        c = CURVES[name]
        self.name, self.curve = name, c
        F = self.F = make_field(c.p, device)
        self.Fn = FoldField(c.n, device) if _R - c.n < 1 << 132 else None
        b3 = 3 * c.b % c.p
        self.a_is_zero = c.a == 0
        self.a_is_minus3 = c.a == c.p - 3
        self.a_enc = const_col(F.enc(c.a), device)
        self.b_enc = const_col(F.enc(c.b), device)
        self.b3_small = b3 if b3 < 1 << 15 and isinstance(F, FoldField) else None
        self.b3_enc = const_col(F.enc(b3), device)
        self.p_col = const_col(int_to_rows(c.p), device)
        self.n_col = const_col(int_to_rows(c.n), device)
        if name != "secp256k1":
            return
        P = glv_params()
        self.beta_col = const_col(int_to_rows(P.beta), device)
        self.g1 = const_col(int_to_rows(P.g1, 21), device)
        self.g2 = const_col(int_to_rows(P.g2, 21), device)
        self.a1 = const_col(int_to_rows(P.a1, 9), device)
        self.b1_abs = const_col(int_to_rows(P.b1_abs, 9), device)
        self.a2 = const_col(int_to_rows(P.a2, 9), device)
        self.b2 = const_col(int_to_rows(P.b2, 9), device)


# ---------------------------------------------------------------------------
# Complete projective group law (Renes–Costello–Batina 2016)
# ---------------------------------------------------------------------------


def _b3_mul(x: torch.Tensor, C: CurveOps) -> torch.Tensor:
    if C.b3_small is not None:
        return C.F.mul_small(x, C.b3_small)
    return C.F.mul(x, C.b3_enc)


def _a_mul(x: torch.Tensor, C: CurveOps) -> torch.Tensor:
    """a·x; SM2's a = p − 3 makes this −(3x)."""
    F = C.F
    if C.a_is_minus3:
        return F.neg(F.mul_small(x, 3))
    return F.mul(x, C.a_enc)


def pt_add(P, Q, C: CurveOps):
    """Complete addition. a = 0: RCB algorithm 7 (12M + 2·b3); generic a:
    algorithm 1 (12M + 3·a + 2·b3)."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    F = C.F
    if C.a_is_zero:
        t0 = F.mul(X1, X2)
        t1 = F.mul(Y1, Y2)
        t2 = F.mul(Z1, Z2)
        t3 = F.mul(F.add(X1, Y1), F.add(X2, Y2))
        t3 = F.sub(t3, F.add(t0, t1))  # X1Y2 + X2Y1
        t4 = F.mul(F.add(Y1, Z1), F.add(Y2, Z2))
        t4 = F.sub(t4, F.add(t1, t2))  # Y1Z2 + Y2Z1
        x3 = F.mul(F.add(X1, Z1), F.add(X2, Z2))
        y3 = F.sub(x3, F.add(t0, t2))  # X1Z2 + X2Z1
        x3 = F.add(t0, t0)
        t0 = F.add(x3, t0)  # 3·X1X2
        t2 = _b3_mul(t2, C)
        z3 = F.add(t1, t2)
        t1 = F.sub(t1, t2)
        y3 = _b3_mul(y3, C)
        x3 = F.mul(t4, y3)
        t2 = F.mul(t3, t1)
        x3 = F.sub(t2, x3)
        y3 = F.mul(y3, t0)
        t1 = F.mul(t1, z3)
        y3 = F.add(t1, y3)
        t0 = F.mul(t0, t3)
        z3 = F.mul(z3, t4)
        z3 = F.add(z3, t0)
        return x3, y3, z3
    t0 = F.mul(X1, X2)
    t1 = F.mul(Y1, Y2)
    t2 = F.mul(Z1, Z2)
    t3 = F.mul(F.add(X1, Y1), F.add(X2, Y2))
    t3 = F.sub(t3, F.add(t0, t1))  # X1Y2 + X2Y1
    t4 = F.mul(F.add(X1, Z1), F.add(X2, Z2))
    t4 = F.sub(t4, F.add(t0, t2))  # X1Z2 + X2Z1
    t5 = F.mul(F.add(Y1, Z1), F.add(Y2, Z2))
    t5 = F.sub(t5, F.add(t1, t2))  # Y1Z2 + Y2Z1
    z3 = _a_mul(t4, C)
    x3 = _b3_mul(t2, C)
    z3 = F.add(x3, z3)
    x3 = F.sub(t1, z3)
    z3 = F.add(t1, z3)
    y3 = F.mul(x3, z3)
    t1 = F.add(t0, t0)
    t1 = F.add(t1, t0)  # 3·X1X2
    t2 = _a_mul(t2, C)
    t4b = _b3_mul(t4, C)
    t1 = F.add(t1, t2)
    t2 = _a_mul(F.sub(t0, t2), C)
    t4b = F.add(t4b, t2)
    t0 = F.mul(t1, t4b)
    y3 = F.add(y3, t0)
    t0 = F.mul(t5, t4b)
    x3 = F.mul(t3, x3)
    x3 = F.sub(x3, t0)
    t0 = F.mul(t3, t1)
    z3 = F.mul(t5, z3)
    z3 = F.add(z3, t0)
    return x3, y3, z3


def pt_add_mixed(P, A, C: CurveOps):
    """Complete mixed addition with affine A = (x2, y2), Z2 = 1 (A a genuine
    curve point, never the identity). a = 0: RCB algorithm 8 (11M + 2·b3);
    generic a: algorithm 2."""
    X1, Y1, Z1 = P
    X2, Y2 = A
    F = C.F
    if C.a_is_zero:
        t0 = F.mul(X1, X2)
        t1 = F.mul(Y1, Y2)
        t3 = F.mul(F.add(X2, Y2), F.add(X1, Y1))
        t3 = F.sub(t3, F.add(t0, t1))  # X1Y2 + X2Y1
        t4 = F.add(F.mul(X2, Z1), X1)  # X1 + X2Z1
        t5 = F.add(F.mul(Y2, Z1), Y1)  # Y1 + Y2Z1
        x3 = F.add(t0, t0)
        t0 = F.add(x3, t0)  # 3·X1X2
        t2 = _b3_mul(Z1, C)
        z3 = F.add(t1, t2)
        t1 = F.sub(t1, t2)
        y3 = _b3_mul(t4, C)
        x3 = F.mul(t5, y3)
        t2 = F.mul(t3, t1)
        x3 = F.sub(t2, x3)
        y3 = F.mul(y3, t0)
        t1 = F.mul(t1, z3)
        y3 = F.add(t1, y3)
        t0 = F.mul(t0, t3)
        z3 = F.mul(z3, t5)
        z3 = F.add(z3, t0)
        return x3, y3, z3
    t0 = F.mul(X1, X2)
    t1 = F.mul(Y1, Y2)
    t3 = F.mul(F.add(X2, Y2), F.add(X1, Y1))
    t3 = F.sub(t3, F.add(t0, t1))  # X1Y2 + X2Y1
    t4 = F.add(F.mul(X2, Z1), X1)  # X1 + X2Z1
    t5 = F.add(F.mul(Y2, Z1), Y1)  # Y1 + Y2Z1
    z3 = _a_mul(t4, C)
    x3 = _b3_mul(Z1, C)
    z3 = F.add(x3, z3)
    x3 = F.sub(t1, z3)
    z3 = F.add(t1, z3)
    y3 = F.mul(x3, z3)
    t1 = F.add(t0, t0)
    t1 = F.add(t1, t0)  # 3·X1X2
    t2 = _a_mul(Z1, C)
    t4b = _b3_mul(t4, C)
    t1 = F.add(t1, t2)
    t2 = _a_mul(F.sub(t0, t2), C)
    t4b = F.add(t4b, t2)
    t0 = F.mul(t1, t4b)
    y3 = F.add(y3, t0)
    t0 = F.mul(t5, t4b)
    x3 = F.mul(t3, x3)
    x3 = F.sub(x3, t0)
    t0 = F.mul(t3, t1)
    z3 = F.mul(t5, z3)
    z3 = F.add(z3, t0)
    return x3, y3, z3


def pt_double(P, C: CurveOps):
    """Complete doubling. a = 0: RCB algorithm 9 (6M + 2S + 1·b3); generic
    a: algorithm 3."""
    X, Y, Z = P
    F = C.F
    if C.a_is_zero:
        t0 = F.sqr(Y)
        z3 = F.add(t0, t0)
        z3 = F.add(z3, z3)
        z3 = F.add(z3, z3)  # 8·Y^2
        t1 = F.mul(Y, Z)
        t2 = F.sqr(Z)
        t2 = _b3_mul(t2, C)
        x3 = F.mul(t2, z3)
        y3 = F.add(t0, t2)
        z3 = F.mul(t1, z3)
        t1 = F.add(t2, t2)
        t2 = F.add(t1, t2)  # 3·b3·Z^2
        t0 = F.sub(t0, t2)
        y3 = F.mul(t0, y3)
        y3 = F.add(x3, y3)
        t1 = F.mul(X, Y)
        x3 = F.mul(t0, t1)
        x3 = F.add(x3, x3)
        return x3, y3, z3
    t0 = F.sqr(X)
    t1 = F.sqr(Y)
    t2 = F.sqr(Z)
    t3 = F.mul(X, Y)
    t3 = F.add(t3, t3)
    z3 = F.mul(X, Z)
    z3 = F.add(z3, z3)
    x3 = _a_mul(z3, C)
    y3 = _b3_mul(t2, C)
    y3 = F.add(x3, y3)
    x3 = F.sub(t1, y3)
    y3 = F.add(t1, y3)
    y3 = F.mul(x3, y3)
    x3 = F.mul(t3, x3)
    z3 = _b3_mul(z3, C)
    t2a = _a_mul(t2, C)
    t3 = _a_mul(F.sub(t0, t2a), C)
    t3 = F.add(t3, z3)
    z3 = F.add(t0, t0)
    t0 = F.add(z3, t0)
    t0 = F.add(t0, t2a)
    t0 = F.mul(t0, t3)
    y3 = F.add(y3, t0)
    t2 = F.mul(Y, Z)
    t2 = F.add(t2, t2)
    t0 = F.mul(t2, t3)
    x3 = F.sub(x3, t0)
    z3 = F.mul(t2, t1)
    z3 = F.add(z3, z3)
    z3 = F.add(z3, z3)
    return x3, y3, z3


def pt_infinity(like: torch.Tensor, C: CurveOps):
    """Projective identity (0 : 1 : 0), Y the field's one."""
    z = torch.zeros_like(like)
    return z, C.F.one(like).clone(), z


def on_curve(x_enc: torch.Tensor, y_enc: torch.Tensor, C: CurveOps) -> torch.Tensor:
    """y^2 == x^3 + a·x + b in the field domain -> bool[T]."""
    F = C.F
    rhs = F.mul(F.sqr(x_enc), x_enc)
    if not C.a_is_zero:
        rhs = F.add(rhs, F.mul(C.a_enc, x_enc))
    rhs = F.add(rhs, C.b_enc.expand_as(x_enc))
    return eq(F.sqr(y_enc), rhs)


# ---------------------------------------------------------------------------
# Scalar-range helpers (plain-domain limbs)
# ---------------------------------------------------------------------------


def valid_scalar(x: torch.Tensor, C: CurveOps) -> torch.Tensor:
    """1 <= x < n (signature component range check)."""
    return ~is_zero(x) & lt(x, C.n_col)


def reduce_mod_n(z: torch.Tensor, C: CurveOps) -> torch.Tensor:
    """z mod n for z < 2n (one conditional subtract; n > 2^255 on both
    curves, so any 256-bit z)."""
    return cond_sub(z, C.n_col)


def add_mod_n(a: torch.Tensor, b: torch.Tensor, C: CurveOps) -> torch.Tensor:
    """(a + b) mod n for plain a, b < n (no field object needed)."""
    return cond_sub(add_widen(a, b), C.n_col)


# ---------------------------------------------------------------------------
# Batched inversion (Montgomery's trick along the lane axis)
# ---------------------------------------------------------------------------


def lane_inv(F: FoldField | MontField, x: torch.Tensor) -> torch.Tensor:
    """Elementwise modular inverse of [16, T] in either field's domain with
    ONE Fermat exponentiation: a halving product tree over the lanes, one
    inversion of the root, and the down-sweep. 0 maps to 0; the inverse is
    unique, so the result equals a per-lane ``F.inv``."""
    t = x.shape[1]
    nz = ~is_zero(x)
    cur = select(nz, x, F.one(x))
    pw = 1 << max(0, (t - 1).bit_length())
    if pw != t:
        cur = torch.cat([cur, F._one.expand(limb.LIMBS, pw - t)], dim=1)
    stack = []
    while cur.shape[1] > 1:
        h = cur.shape[1] // 2
        a, b = cur[:, :h], cur[:, h:]
        stack.append((a, b))
        cur = F.mul(a, b)
    inv = F.inv(cur)
    for a, b in reversed(stack):
        inv = torch.cat([F.mul(inv, b), F.mul(inv, a)], dim=1)
    return select(nz, inv[:, :t], torch.zeros_like(x))


def pt_to_affine_batch(P, C: CurveOps):
    """(X : Y : Z) -> (x, y, inf_mask) with the Z inversion batched across
    lanes; identity lanes get x = y = 0."""
    X, Y, Z = P
    F = C.F
    zinv = lane_inv(F, Z)
    return F.mul(X, zinv), F.mul(Y, zinv), is_zero(Z)


# ---------------------------------------------------------------------------
# GLV decomposition and the windowed ladder
# ---------------------------------------------------------------------------


def _mul_c(x: torch.Tensor, c_col: torch.Tensor, out: int) -> torch.Tensor:
    return carry_norm(conv_cols(x, c_col, out))[:out]


def _abs_diff(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(|a - b| limbs, sign) for equal-width normalized a, b."""
    d1, borrow = sub_borrow(a, b)
    d2, _ = sub_borrow(b, a)
    return select(borrow, d2, d1), borrow


def glv_decompose(u2: torch.Tensor, C: CurveOps):
    """u2 [16, T] plain < n -> (ka, sa, kb, sb) with
    u2 ≡ (-1)^sa·ka + (-1)^sb·kb·λ (mod n) and ka, kb < 2^131.

    Rounding is floor Barrett, c_i = floor(u2·g_i / 2^448), exactly as in the
    JAX package (the congruence holds for any rounding; the bound is what
    N_QWINDOWS covers)."""
    c1 = _mul_c(u2, C.g1, 37)[28:37]
    c2 = _mul_c(u2, C.g2, 37)[28:37]
    s_a = add_widen(_mul_c(c1, C.a1, 17), _mul_c(c2, C.a2, 17))  # [18, T]
    ka, sa = _abs_diff(limb._fit(u2, 18), s_a)
    kb, sb = _abs_diff(_mul_c(c1, C.b1_abs, 17), _mul_c(c2, C.b2, 17))
    return ka[:16], sa, kb[:16], sb


def window_at(k: torch.Tensor, wi: int) -> torch.Tensor:
    """4-bit window ``wi`` (0 = LSB) of [16, T] plain limbs -> [T] in 0..15."""
    return (k[wi // 4] >> (WINDOW * (wi % 4))) & 0xF


def scalar_windows(k: torch.Tensor) -> torch.Tensor:
    """[16, T] plain limbs -> [64, T] 4-bit windows, LSB first."""
    shifts = (torch.arange(N_WINDOWS, device=k.device) % (16 // WINDOW)) * WINDOW
    return (k.repeat_interleave(16 // WINDOW, dim=0) >> shifts[:, None]) & 0xF


def _select15(tab: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """tab [15, L, T] (per lane) or [15, L] (shared), w [T] in 0..15 ->
    tab[w-1] as [L, T]; w == 0 lanes get tab[0] (callers mask them)."""
    idx = (w - 1).clamp(min=0)
    if tab.dim() == 2:
        return tab[idx].T
    t = tab.shape[-1]
    return torch.gather(tab, 0, idx.view(1, 1, t).expand(1, tab.shape[1], t))[0]


def _split_u1(u1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[16, T] -> 128-bit halves, each widened back to [16, T]."""
    lo = limb._fit(u1[:8], 16)
    hi = limb._fit(u1[8:], 16)
    return lo, hi


def _point_table(t1, C: CurveOps):
    """c·P for c = 1..15 by 14 complete additions -> three [15, 16, T]."""
    tab = [t1]
    for _ in range(14):
        tab.append(pt_add(tab[-1], t1, C))
    return tuple(torch.stack([e[i] for e in tab]) for i in range(3))


def dual_mul_windowed(k1, k2, Q, C: CurveOps, g_table: torch.Tensor):
    """k1·G + k2·Q — the SM2 verification ladder (the JAX scan form).

    k1, k2: [16, T] plain scalars (< n); Q: field-domain affine (x, y), not
    the identity (garbage lanes are fine, callers mask them); g_table: the
    [30, 16] limbs of :func:`g_comb_table` on the device.

    64 window steps, MSB first, of 4 doublings + one complete addition from
    the runtime 15-entry Q table + one mixed addition from the G comb; a
    lane whose window is 0 keeps its accumulator."""
    F = C.F
    tq_x, tq_y, tq_z = _point_table((Q[0], Q[1], F.one(k1)), C)
    w1 = scalar_windows(k1)
    w2 = scalar_windows(k2)
    tg_x, tg_y = g_table[:15], g_table[15:30]
    acc = pt_infinity(k1, C)
    for i in reversed(range(N_WINDOWS)):
        for _ in range(WINDOW):
            acc = pt_double(acc, C)
        w = w2[i]
        added = pt_add(acc, (_select15(tq_x, w), _select15(tq_y, w), _select15(tq_z, w)), C)
        acc = select(w == 0, acc, added)
        w = w1[i]
        madded = pt_add_mixed(acc, (_select15(tg_x, w), _select15(tg_y, w)), C)
        acc = select(w == 0, acc, madded)
    return acc


def quad_mul_windowed(u1, ka, sa, kb, sb, Q, C: CurveOps, g_table2: torch.Tensor):
    """u1·G + (-1)^sa·ka·Q + (-1)^sb·kb·(λQ) — the GLV ECDSA ladder.

    u1: [16, T] plain scalar (< n), split positionally against the G and
    2^128·G combs in ``g_table2`` ([60, 16] limbs, :func:`g_comb_table_glv`);
    (ka, sa, kb, sb) from :func:`glv_decompose`; Q: affine (x, y).

    33 window steps, MSB first, of 4 doublings + 2 complete adds (runtime Q
    table and its β-scaled λQ view) + 2 mixed adds (G combs); a lane whose
    window is 0 keeps its accumulator.
    """
    F = C.F
    t = u1.shape[1]
    ta_x, ta_y, ta_z = _point_table((Q[0], Q[1], F.one(u1)), C)
    # λ(X : Y : Z) = (βX : Y : Z): the 15 products as one [16, 15·T] mul
    tb_x = F.mul(ta_x.permute(1, 0, 2).reshape(16, 15 * t), C.beta_col)
    tb_x = tb_x.reshape(16, 15, t).permute(1, 0, 2)
    scalars = (ka, kb) + _split_u1(u1)
    combs = [(g_table2[base : base + 15], g_table2[base + 15 : base + 30]) for base in (0, 30)]

    acc = pt_infinity(u1, C)
    for i in reversed(range(N_QWINDOWS)):
        wa, wb, wlo, whi = (window_at(k, i) for k in scalars)
        for _ in range(WINDOW):
            acc = pt_double(acc, C)
        for w, tx, sgn in ((wa, ta_x, sa), (wb, tb_x, sb)):
            y = _select15(ta_y, w)
            y = select(sgn, F.neg(y), y)
            added = pt_add(acc, (_select15(tx, w), y, _select15(ta_z, w)), C)
            acc = select(w == 0, acc, added)
        for w, (tgx, tgy) in zip((wlo, whi), combs):
            madded = pt_add_mixed(acc, (_select15(tgx, w), _select15(tgy, w)), C)
            acc = select(w == 0, acc, madded)
    return acc
