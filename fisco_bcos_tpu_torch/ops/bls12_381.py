"""BLS12-381 aggregate-QC pairing check and multi-pairing: the hand-written
CUDA kernels and their plain PyTorch versions (the port of the JAX
package's ``ops/bls12_381.py`` programs ``_pairing_check_xla`` and
``_multi_pairing_xla`` and their host halves).

One lane is one quorum certificate: ok = e(-g1, σ) · e(apk, H(m)) == 1, the
optimal-ate pairing of BLS12-381 with the G2 points on the twist
E'(Fp2): y² = x³ + 4(1 + u). The split of labour is the JAX package's: the
host decompresses and checks the points and hashes the message to G2 (the
port's oracle, ``crypto/ref/bls12_381.py``, cached by ``crypto/bls.py``), the
device runs the pairing check.

The device input is one ``[B, 120]`` int32 row a lane (:data:`ROW_WORDS`):
ten Fp values in the Montgomery domain (R = 2^384), twelve little-endian
32-bit words each, in the JAX program's argument order: apk x, y; σ x0, x1,
y0, y1; H(m) x0, x1, y0, y1. The JAX package gives the same values as ten
``[B, 24]`` arrays of 16-bit limbs; :func:`rows_from_jax` joins those into
these rows. A CUDA tensor goes to ``csrc/bls12_381.cu``, a CPU tensor to
:func:`pairing_check_plain`.

The multi-pairing (header sync's one aggregate check) is True iff
∏ e(P_k, Q_k) == 1 over a list of (G1, G2) pairs, a pair with a None member
the identity: :func:`multi_pairing_rows` gives one ``[K, 72]`` int32 row a
live pair (P x, y; Q x0, x1, y0, y1), with no pad lane, and
:func:`multi_pairing_device` sends a CUDA tensor to the kernel's second
entry point, a CPU tensor to :func:`multi_pairing_plain`. A list with no
live pair is True and launches nothing.

The plain version computes what ``pairing_check_core`` computes: the same
tower Fp2 = Fp[u]/(u² + 1), Fp6 = Fp2[v]/(v³ − ξ), Fp12 = Fp6[w]/(w² − v),
ξ = 1 + u, with Karatsuba products, the Frobenius constants computed from
the oracle, the twist's Jacobian doubling and mixed-addition steps with
their denominator-free lines, the double Miller loop with shared
squarings (conjugated for x < 0) and the final exponentiation. Its hard
part follows the oracle's chain for 3(p⁴ − p² + 1)/r (``final_exponentiation``):
the same integer exponent as the JAX scan over its bits, so the same GT
element.

Its layout is set by the CPU's cost per torch call, not by the arithmetic:
an Fp value is 24 16-bit limbs in int64 along the last axis, and the
tower's coefficients stack on the axes before it, so that an Fp12 product
is three calls on stacked tensors: the Karatsuba sums of both operands
(:data:`_MAPS` ``"f12"`` in-map), the 54 Fp products at once
(:func:`fp_mul`) and the recombination (the out-map). Every linear map
(sums, differences, small multiples) is one integer matrix applied to the
stacked coefficients followed by one reduction to the canonical residue
(:func:`_combine`); the tower's values are canonical (< p) between its
operations, the sums and products inside one left unreduced.
"""

from __future__ import annotations

import threading
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F_nn

from . import _kernels
from ..crypto.ref import bls12_381 as ref
from ..device import resolve_device

P = ref.P
R384 = 1 << 384
NL = 24  # 16-bit limbs of an Fp value in the plain version
NW = 12  # 32-bit words of an Fp value in the rows and the kernel
ROW_VALUES = 10  # apk x, y; sig x0, x1, y0, y1; hm x0, x1, y0, y1
ROW_WORDS = ROW_VALUES * NW
MASK = 0xFFFF

# |x| MSB first, the leading bit consumed by the loops' start (the JAX
# _X_ABS_BITS)
X_ABS_BITS = tuple(int(b) for b in bin(-ref.X_PARAM)[2:])[1:]


def _mont(x: int) -> int:
    return x * R384 % P


def _limbs(x: int, n: int = NL) -> list[int]:
    return [(x >> (16 * i)) & MASK for i in range(n)]


def _from_limbs(row) -> int:
    return sum(int(v) << (16 * i) for i, v in enumerate(row))


# ---------------------------------------------------------------------------
# Constants of the limb arithmetic
# ---------------------------------------------------------------------------

# p with every limb but the top at or above 0xFFFF (limb 0 above 0xFFFF),
# over 26 limbs, the top -1: adding it once for each subtracted canonical
# value keeps limbs 0..24 non-negative.
_PB = [_limbs(P)[0] + 0x10000] + [v + 0xFFFF for v in _limbs(P)[1:]] + [0xFFFF, -1]
assert sum(v << (16 * i) for i, v in enumerate(_PB)) == P
# 2^400 - p over 26 limbs: adding j of it to v gives v - j·p + j·2^400, whose
# top limb after normalisation is j exactly when v >= j·p
_NP = _limbs((1 << 400) - P, 25) + [0]
_MPRIME = (-pow(P, -1, R384)) % R384


def _toeplitz(x: int, cols: int) -> np.ndarray:
    """[24, cols] matrix T of the constant x: (a @ T)[k] = Σ_i a_i·x_{k-i},
    the column sums of a·x (columns at or above `cols` dropped)."""
    xl = _limbs(x)
    t = np.zeros((NL, cols), dtype=np.float64)
    for i in range(NL):
        for j in range(NL):
            if i + j < cols:
                t[i, i + j] = xl[j]
    return t


_HOST_CONSTS = {
    "pb": np.array(_PB, dtype=np.int64),
    "np": np.array(_NP, dtype=np.int64),
    "p_toep": _toeplitz(P, 2 * NL - 1),
    "mprime_toep": _toeplitz(_MPRIME, NL + 1),
    "bits": np.arange(2 * NL, dtype=np.int64),
    "inv_p": np.array([2.0 ** (16 * i) / P for i in range(26)]),
}
_CONSTS: dict = {}
_CONSTS_LOCK = threading.Lock()


def _const(name: str, device: torch.device) -> torch.Tensor:
    """A constant tensor of this module on `device`, uploaded once."""
    key = (name, device)
    t = _CONSTS.get(key)
    if t is None:
        with _CONSTS_LOCK:
            t = _CONSTS.get(key)
            if t is None:
                t = _CONSTS[key] = torch.from_numpy(_HOST_CONSTS[name]).to(device)
    return t


# ---------------------------------------------------------------------------
# Limb arithmetic: normalisation, reduction, linear maps, the Montgomery product
# ---------------------------------------------------------------------------


def _carry(x: torch.Tensor, bits: int) -> torch.Tensor:
    """x [..., n] int64 with limbs 0..n-2 non-negative and below 2^bits and
    a small top limb of any sign -> the same value with limbs 0..n-2 in
    [0, 0x10000] and the rest in the top limb (a new tensor)."""
    while True:
        # each limb but the top keeps its low 16 bits, its high part moves up
        lo = x & MASK
        lo[..., -1] = x[..., -1]
        lo[..., 1:] += x[..., :-1] >> 16
        x = lo
        if bits <= 17:  # limbs 0..n-2 are now at most 0x10000
            break
        bits = max(bits - 16, 16) + 1
    return x


def _norm(x: torch.Tensor, bits: int) -> torch.Tensor:
    """As :func:`_carry`, with limbs 0..n-2 in [0, 0xFFFF]: the digits."""
    x = _carry(x, bits)
    # the 0/1 ripple left, resolved in one add a value: with A = generate |
    # propagate (a limb of at least 0xFFFF) and G = generate (0x10000)
    # packed as bits, the carries into every position are (A + G) ^ A ^ G
    body = x[..., :-1]
    n1 = body.shape[-1]
    w = _const("bits", x.device)[:n1]
    g = ((body >> 16) << w).sum(-1)
    a = (((body + 1) >> 16) << w).sum(-1)
    s = a + g
    body += ((s ^ a ^ g)[..., None] >> w) & 1
    body &= MASK
    x[..., -1] += (s >> n1) & 1
    return x


def _reduce(x: torch.Tensor, kmax: int, bits: int) -> torch.Tensor:
    """x [..., 26] int64 (limbs 0..24 non-negative, below 2^bits; top limb
    small) of a value v in [0, (kmax + 1)·p) -> v mod p as [..., 24]
    canonical limbs. The candidates v - j·p, normalised in one stack, and
    the last that is not negative: every j up to kmax when kmax is small,
    else the three around q = floor(v/p) estimated in float64 (off by less
    than one: the estimate's error is some 2^-40 of a unit)."""
    shape = (-1,) + (1,) * (x.dim() - 1)
    if kmax <= 2:
        j = torch.arange(kmax + 1, device=x.device).view(shape + (1,))
    else:
        q = torch.floor(x.to(torch.float64) @ _const("inv_p", x.device)).to(torch.int64)
        j = ((q - 1).clamp_min(0)[None] + _const("bits", x.device)[:3].view(shape))[..., None]
    y = _norm(x + j * _const("np", x.device), max(bits, 16 + (kmax + 2).bit_length()) + 1)
    idx = (y[..., -1] >= j[..., 0]).sum(0) - 1
    return torch.take_along_dim(y[..., :NL], idx[None, ..., None], 0)[0]


def _combine(mat: torch.Tensor, neg: torch.Tensor, kmax: int, x: torch.Tensor) -> torch.Tensor:
    """out[..., o, :] = Σ_i mat[o, i]·x[..., i, :] mod p for x [..., I, 24 or
    25] with limbs 0..23 in [0, 0x10001] and a small limb 24, and a small
    integer matrix mat [O, I] (float64; `neg` [O, 1] the bias, in units of
    p, that keeps every row's value non-negative; the rows' values below
    (kmax + 1)·p; a bias of at least 2 a negative entry where the limbs pass
    0xFFFF). The products are exact in float64 (each below 2^32)."""
    y = (mat @ x.to(torch.float64)).to(torch.int64)
    y = F_nn.pad(y, (0, 26 - y.shape[-1])) + neg * _const("pb", x.device)
    return _reduce(y, kmax, bits=(4 * (kmax + 1) << 16).bit_length())


def _mul_bound(ab: int) -> int:
    """fp_mul's (t + m·p)/R < (ab·p/R + 1 + 2^-16)·p, in whole units of p."""
    return -(-(ab * P * 2**16 + R384 * (2**16 + 1)) // (R384 * 2**16))


def fp_mul(a: torch.Tensor, b: torch.Tensor, ab: int = 1, reduce: bool = True) -> torch.Tensor:
    """Montgomery product a·b/R mod p of [..., 24] operands (broadcast
    against each other) with non-negative limbs and a·b < ab·p², each limb
    of a times each of b below ab·2^32 (canonical operands: ab = 1): the
    column sums of a·b, then REDC by R = 2^384 as whole numbers
    (m ≡ t·(-p⁻¹) mod R, then (t + m·p)/R), then one reduction; or, with
    `reduce` False, (t + m·p)/R as 25 limbs (limbs 0..23 at most 0x10001),
    below _mul_bound(ab)·p. t mod R and m are carried but not normalised:
    their limbs at most 0x10000, congruent mod R, m below R·(1 + 2^-16).
    Every product rides float64, exact: each column sum is below 2^53."""
    bits = (24 * ab << 32).bit_length()
    dev = a.device
    # column k of a·b sums a_i·b_j over i + j = k: the outer product padded
    # to rows of 48 and read back as rows of 47 puts a_i·b_j at (i, i + j)
    prod = a.to(torch.float64)[..., :, None] * b.to(torch.float64)[..., None, :]
    lead = prod.shape[:-2]
    t = F_nn.pad(prod, (0, NL)).reshape(*lead, NL * 2 * NL)[..., : NL * (2 * NL - 1)]
    t = t.reshape(*lead, NL, 2 * NL - 1).sum(-2).to(torch.int64)  # [..., 47]
    lo = _carry(t[..., : NL + 1], bits)[..., :NL]  # ≡ t mod R (limb 24 takes the carries, dropped)
    m = _carry((lo.to(torch.float64) @ _const("mprime_toep", dev)).to(torch.int64), 38)[..., :NL]
    mp = (m.to(torch.float64) @ _const("p_toep", dev)).to(torch.int64)  # [..., 47]
    u = _carry(F_nn.pad(t + mp, (0, 2)), bits + 1)
    # t + m·p ≡ 0 mod R: its low 24 limbs (each at most 0x10000) sum to 0 or
    # to R, R exactly when one is not 0
    hi = u[..., NL:]
    hi[..., 0] += (u[..., :NL] != 0).any(-1)
    if not reduce:
        return hi
    return _reduce(F_nn.pad(hi, (0, 1)), _mul_bound(ab) - 1, bits=17)


def fp_from_int(vals, device) -> torch.Tensor:
    """Python ints -> [len, 24] canonical Montgomery limbs."""
    return torch.tensor([_limbs(_mont(v % P)) for v in vals], dtype=torch.int64, device=device)


def fp_to_int(t: torch.Tensor) -> list[int]:
    """[..., 24] Montgomery limbs -> Python ints (plain domain), flattened."""
    rinv = pow(R384, -1, P)
    rows = t.reshape(-1, NL).cpu().numpy()
    return [_from_limbs(r) * rinv % P for r in rows]


# ---------------------------------------------------------------------------
# The tower's linear maps and Karatsuba products, as integer matrices
# ---------------------------------------------------------------------------
#
# An element of Fp2 / Fp6 / Fp12 is its coefficients stacked on one axis of
# 2 / 6 / 12 Fp values (the order of the JAX tuples: Fp12 = (g, h), g and h
# in Fp6 = (c0, c1, c2) in Fp2 = (re, im)). A Karatsuba product of x and y
# is: the same in-map on both operands (each Fp multiplicand a sum of
# coefficients), the Fp products, then the out-map. Both maps are derived
# here by running the JAX formulas (:178-357) over integer coefficient
# vectors, so no matrix is written by hand.


def _xi(a):
    """a·(1 + u) on a pair of symbolic Fp values."""
    return (a[0] - a[1], a[0] + a[1])


def _f2_in(x):
    return [x[0], x[1], x[0] + x[1]]


def _f2_out(v):
    return (v[0] - v[1], v[2] - v[0] - v[1])


def _f2_add(a, b):
    return (a[0] + b[0], a[1] + b[1])


def _f2_sub(a, b):
    return (a[0] - b[0], a[1] - b[1])


def _f6_in(x):
    pairs = [x[0], x[1], x[2], _f2_add(x[1], x[2]), _f2_add(x[0], x[1]), _f2_add(x[0], x[2])]
    return [m for p in pairs for m in _f2_in(p)]


def _f6_out(v):
    v0, v1, v2, t0, t1, t2 = (_f2_out(v[3 * i : 3 * i + 3]) for i in range(6))
    c0 = _f2_add(v0, _xi(_f2_sub(t0, _f2_add(v1, v2))))
    c1 = _f2_add(_f2_sub(t1, _f2_add(v0, v1)), _xi(v2))
    c2 = _f2_add(_f2_sub(t2, _f2_add(v0, v2)), v1)
    return (c0, c1, c2)


def _f6_add(a, b):
    return tuple(_f2_add(x, y) for x, y in zip(a, b))


def _f12_in(x):
    g, h = x
    return _f6_in(g) + _f6_in(h) + _f6_in(_f6_add(g, h))


def _f12_out(v):
    vg, vh, t = _f6_out(v[:18]), _f6_out(v[18:36]), _f6_out(v[36:])
    mul_v = (_xi(vh[2]), vh[0], vh[1])
    w_part = tuple(_f2_sub(_f2_sub(x, y), z) for x, y, z in zip(t, vg, vh))
    return (_f6_add(vg, mul_v), w_part)


def _flatten(x) -> list:
    if isinstance(x, np.ndarray):
        return [x]
    return [v for part in x for v in _flatten(part)]


def _nest(vals: list, shape: tuple):
    """Flat list -> nested tuples of the tower shape (e.g. (2, 3, 2))."""
    if len(shape) == 1:
        return tuple(vals)
    step = len(vals) // shape[0]
    return tuple(_nest(vals[i * step : (i + 1) * step], shape[1:]) for i in range(shape[0]))


def _karatsuba(shape: tuple, f_in, f_out) -> tuple[np.ndarray, np.ndarray]:
    n = int(np.prod(shape))
    unit = np.eye(n, dtype=np.int64)
    m_in = np.stack(f_in(_nest(list(unit), shape)))
    k = m_in.shape[0]
    m_out = np.stack(_flatten(f_out(list(np.eye(k, dtype=np.int64)))))
    return m_in, m_out


_MAPS = {
    "f2": _karatsuba((2,), _f2_in, _f2_out),
    "f6": _karatsuba((3, 2), _f6_in, _f6_out),
    "f12": _karatsuba((2, 3, 2), _f12_in, _f12_out),
}
_MATS: dict = {}


def _mat(key, mat: np.ndarray, device: torch.device, in_bound: int = 1):
    """(float64 matrix, [O, 1] bias in units of p, kmax) of a small integer
    matrix applied to values below in_bound·p, on `device`, built once."""
    k = (key, device, in_bound)
    out = _MATS.get(k)
    if out is None:
        mat = np.asarray(mat, dtype=np.int64)
        neg = in_bound * np.where(mat < 0, -mat, 0).sum(1, keepdims=True)
        kmax = in_bound * int(np.abs(mat).sum(1).max()) - 1
        out = (torch.from_numpy(mat.astype(np.float64)).to(device), torch.from_numpy(neg).to(device), kmax)
        with _CONSTS_LOCK:
            _MATS.setdefault(k, out)
    return out


def _apply(key, mat: np.ndarray, x: torch.Tensor, in_bound: int = 1) -> torch.Tensor:
    m, neg, kmax = _mat(key, mat, x.device, in_bound)
    return _combine(m, neg, kmax, x)


def _tower_mul(level: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Karatsuba product at `level` of flat [..., n, 24] elements (broadcast
    against each other): the in-map of both operands (sums of at most s
    coefficients, left unreduced: fp_mul takes them with ab = s²), one
    batched fp_mul left unreduced, the out-map and its one reduction."""
    m_in, m_out = _MAPS[level]
    a, b = torch.broadcast_tensors(a, b)
    m, _, kin = _mat((level, "in"), m_in, a.device)
    ins = (m @ torch.stack((a, b)).to(torch.float64)).to(torch.int64)
    ab = (kin + 1) ** 2
    u = fp_mul(ins[0], ins[1], ab=ab, reduce=False)
    return _apply((level, "out"), m_out, u, in_bound=_mul_bound(ab))


def lin(coefs, xs) -> torch.Tensor:
    """Σ coefs[i]·xs[i] mod p for canonical values of one shape [..., c, 24]
    (broadcast against each other); coefs may be a list of rows, giving a
    stack of outputs on a new axis before the coefficients', in one
    reduction."""
    rows = [coefs] if not isinstance(coefs[0], (list, tuple)) else coefs
    xs = torch.broadcast_tensors(*xs)
    c = xs[0].shape[-2]
    mat = np.kron(np.array(rows, dtype=np.int64), np.eye(c, dtype=np.int64))  # [O·c, n·c]
    x = torch.stack(xs, -3).flatten(-3, -2)
    out = _apply(("lin", tuple(map(tuple, rows)), c), mat, x).unflatten(-2, (len(rows), c))
    return out if isinstance(coefs[0], (list, tuple)) else out[..., 0, :, :]


# Fp2: [..., 2, 24]; Fp6: [..., 6, 24]; Fp12: [..., 12, 24] (flat)


def f2_mul(a, b):
    return _tower_mul("f2", a, b)


def f2_sqr(a):
    return _tower_mul("f2", a, a)


def f2_mul_xi(a):
    return _apply("xi", np.array([[1, -1], [1, 1]]), a)


def f2_conj(a):
    return _apply("conj", np.diag([1, -1]), a)


def fp_pow(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a static exponent: 4-bit windows, MSB first (a window of 0
    needs no product)."""
    tab = [None, a]
    for i in range(2, 16):
        tab.append(fp_mul(tab[i - 1], a))
    out = None
    for shift in range(4 * ((e.bit_length() + 3) // 4) - 4, -1, -4):
        if out is not None:
            for _ in range(4):
                out = fp_mul(out, out)
        d = (e >> shift) & 15
        if d:
            out = tab[d] if out is None else fp_mul(out, tab[d])
    return out


def fp_inv(a):
    """a^-1 = a^(p-2) (0 -> 0)."""
    return fp_pow(a, P - 2)


def f2_inv(a):
    sq = fp_mul(a, a)  # a0², a1²
    ni = fp_inv(lin([1, 1], [sq[..., 0:1, :], sq[..., 1:2, :]]))
    return f2_conj(fp_mul(a, ni))


def f6_mul(a, b):
    return _tower_mul("f6", a, b)


def _f6_parts(a):
    return a[..., 0:2, :], a[..., 2:4, :], a[..., 4:6, :]


def f6_mul_v(a):
    """a·v: (ξ·a2, a0, a1)."""
    a0, a1, a2 = _f6_parts(a)
    return torch.cat((f2_mul_xi(a2), a0, a1), -2)


def f6_inv(a):
    """The v³ = ξ tower inversion of the JAX f6_inv."""
    a0, a1, a2 = _f6_parts(a)
    sq = f2_mul(torch.stack((a0, a2, a1, a1, a0, a0), -3), torch.stack((a0, a2, a1, a2, a1, a2), -3))
    s00, s22, s11, p12, p01, p02 = sq.unbind(-3)
    c0 = lin([1, -1], [s00, f2_mul_xi(p12)])
    c1 = lin([1, -1], [f2_mul_xi(s22), p01])
    c2 = lin([1, -1], [s11, p02])
    q = f2_mul(torch.stack((a0, a1, a2), -3), torch.stack((c0, c2, c1), -3))
    t = lin([1, 1], [q[..., 0, :, :], f2_mul_xi(lin([1, 1], [q[..., 1, :, :], q[..., 2, :, :]]))])
    return f2_mul(torch.stack((c0, c1, c2), -3), f2_inv(t)[..., None, :, :]).flatten(-3, -2)


def f12_mul(a, b):
    return _tower_mul("f12", a, b)


def f12_sqr(a):
    return _tower_mul("f12", a, a)


def f12_inv(a):
    """(g, h)^-1 = (g·t, -h·t), t = (g² - v·h²)^-1."""
    g, h = a[..., :6, :], a[..., 6:, :]
    sq = f6_mul(torch.stack((g, h)), torch.stack((g, h)))
    t = f6_inv(lin([1, -1], [sq[0], f6_mul_v(sq[1])]))
    gh = f6_mul(a.unflatten(-2, (2, 6)), t[..., None, :, :])
    return lin([[1, 0], [0, -1]], [gh[..., 0, :, :], gh[..., 1, :, :]]).flatten(-3, -2)


def f12_one(like: torch.Tensor) -> torch.Tensor:
    one = torch.zeros(like.shape[:-2] + (12, NL), dtype=torch.int64, device=like.device)
    one[..., 0, :] = torch.tensor(_limbs(_mont(1)), device=like.device)
    return one


def f12_eq_one(a: torch.Tensor) -> torch.Tensor:
    """[...] bool: a == 1."""
    return (a == f12_one(a)).flatten(-2).all(-1)


@lru_cache(maxsize=None)
def frob_gammas(k: int) -> tuple[tuple[int, int], ...]:
    """γ_k(a, b) = ξ^(a(p^k - 1)/3 + b(p^k - 1)/6) in Fp2 for the six tower
    monomials v^a w^b, in the flat order (b, a): computed with the oracle's
    exact integer arithmetic (the JAX _frob_consts)."""
    out = []
    for b_pow in range(2):
        for a_pow in range(3):
            e = a_pow * (P**k - 1) // 3 + b_pow * (P**k - 1) // 6
            g, base = ref.F2_ONE, ref.XI
            while e:
                if e & 1:
                    g = ref.f2_mul(g, base)
                base = ref.f2_sqr(base)
                e >>= 1
            out.append(g)
    return tuple(out)


def f12_frob(f, k: int):
    """f^(p^k): each Fp2 coefficient conjugated (k odd), times its γ."""
    c = f.unflatten(-2, (6, 2))
    if k % 2:
        c = f2_conj(c)
    gam = fp_from_int([v for g in frob_gammas(k) for v in g], f.device).view(6, 2, NL)
    return f2_mul(c, gam).flatten(-3, -2)


# ---------------------------------------------------------------------------
# The twist's Jacobian steps (the JAX _dbl_step :461, _add_step :476)
# ---------------------------------------------------------------------------


def _line(c0, c2, c3):
    """The sparse line (c0 + c2·v) + (c3·v)·w as a dense flat Fp12."""
    z = torch.zeros_like(c0)
    return torch.cat((c0, c2, z, z, c3, z), -2)


def dbl_step(t, pc):
    """T = (X, Y, Z) [..., 3, 2, 24] Jacobian on the twist, pc [..., 2, 2,
    24] the G1 point's (-3·xp, 2·yp) as Fp2 values (imaginary parts 0) ->
    (2T, the tangent's line as a flat Fp12), the JAX _dbl_step's values:
    c0 = 3X³ - 2Y², c2 = -3X²Z²·xp, c3 = 2YZ³·yp; 2T by dbl-2009-l, with
    D = 2((X + Y²)² - X² - Y⁴) = 4XY² and E = 3X². Three stages of
    products."""
    x, y, z = t.unbind(-3)
    x2, z2, y2, yz = f2_mul(torch.stack((x, z, y, y), -3), torch.stack((x, z, y, z), -3)).unbind(-3)
    x3, x2z2, c, xy2, x4, z2yp2 = f2_mul(
        torch.stack((x2, x2, y2, x, x2, z2), -3), torch.stack((x, z2, y2, y2, x2, pc[..., 1, :, :]), -3)
    ).unbind(-3)
    # c0 = 3X³ - 2Y², E = 3X², D - X' = 12XY² - 9X⁴, X' = E² - 2D = 9X⁴ - 8XY², Z' = 2YZ
    c0, e, d_x3n, x3n, z3n = lin(
        [[3, -2, 0, 0, 0, 0], [0, 0, 3, 0, 0, 0], [0, 0, 0, 12, -9, 0], [0, 0, 0, -8, 9, 0],
         [0, 0, 0, 0, 0, 2]],
        [x3, y2, x2, xy2, x4, yz],
    ).unbind(-3)
    ed, c2, c3 = f2_mul(torch.stack((e, x2z2, yz), -3), torch.stack((d_x3n, pc[..., 0, :, :], z2yp2), -3)).unbind(-3)
    y3n = lin([1, -8], [ed, c])  # Y' = E(D - X') - 8Y⁴
    return torch.stack((x3n, y3n, z3n), -3), _line(c0, c2, c3)


def dbl_consts(p):
    """(-3·xp, 2·yp) as Fp2 values [..., 2, 2, 24] of G1 points p [..., 2, 24]."""
    s = lin([[-3, 0], [0, 2]], [p[..., 0:1, :], p[..., 1:2, :]])  # [..., 2, 1, 24]
    return torch.cat((s, torch.zeros_like(s)), -2)


def add_step(t, q, p):
    """T [..., 3, 2, 24] Jacobian, q = (xq, yq) [..., 2, 2, 24] affine on the
    twist, p = (xp, yp) [..., 2, 24] -> (T + Q by madd-2007-bl, the chord's
    line at p): with N = Y - yq·Z³, D = X - xq·Z², c0 = N·xq - D·Z·yq,
    c2 = -N·xp, c3 = D·Z·yp."""
    x, y, z = t.unbind(-3)
    xq, yq = q.unbind(-3)
    z2 = f2_sqr(z)
    z3, u2 = f2_mul(torch.stack((z, xq), -3), z2[..., None, :, :]).unbind(-3)
    s2 = f2_mul(yq, z3)  # yq·Z³, the madd's S2
    # N = Y - S2, D = X - U2, H = U2 - X, r = 2(S2 - Y), Z + H
    n, d, h, r, zh = lin(
        [[1, -1, 0, 0, 0], [0, 0, 1, -1, 0], [0, 0, -1, 1, 0], [-2, 2, 0, 0, 0], [0, 0, -1, 1, 1]],
        [y, s2, x, u2, z],
    ).unbind(-3)
    dz, nxq, hh, zh2, r2 = f2_mul(torch.stack((d, n, h, zh, r), -3), torch.stack((z, xq, h, zh, r), -3)).unbind(-3)
    i4 = lin([4], [hh])
    dzyq, j, v = f2_mul(torch.stack((dz, h, x), -3), torch.stack((yq, i4, i4), -3)).unbind(-3)
    # c0 = N·xq - DZ·yq, X' = r² - J - 2V, V - X' = 3V - r² + J, Z' = (Z + H)² - Z² - H²
    c0, x3, v_x3, z3n = lin(
        [[1, -1, 0, 0, 0, 0, 0, 0], [0, 0, 1, -1, -2, 0, 0, 0], [0, 0, -1, 1, 3, 0, 0, 0],
         [0, 0, 0, 0, 0, 1, -1, -1]],
        [nxq, dzyq, r2, j, v, zh2, z2, hh],
    ).unbind(-3)
    rv, yj = f2_mul(torch.stack((r, y), -3), torch.stack((v_x3, j), -3)).unbind(-3)
    c2c3 = _scale(torch.stack((n, dz), -3), p)
    # Y' = r(V - X') - 2YJ, c2 = -N·xp
    y3, c2 = lin([[1, -2, 0], [0, 0, -1]], [rv, yj, c2c3[..., 0, :, :]]).unbind(-3)
    return torch.stack((x3, y3, z3n), -3), _line(c0, c2, c2c3[..., 1, :, :])


def _scale(c: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Fp2 values c [..., 2, 2, 24] times (xp, yp) [..., 2, 24]: the first by
    xp, the second by yp, component by component."""
    return fp_mul(c, p[..., None, :])


# ---------------------------------------------------------------------------
# The Miller loop, the final exponentiation, the check (the JAX :498-587)
# ---------------------------------------------------------------------------


def f12_prod(xs):
    """The product of [B, n, 12, 24] Fp12 elements over axis 1 (n >= 1), a
    halving tree: one batched product a level."""
    while xs.shape[1] > 1:
        half = xs.shape[1] // 2
        xs = torch.cat((f12_mul(xs[:, :half], xs[:, half : 2 * half]), xs[:, 2 * half :]), 1)
    return xs[:, 0]


def miller_loop(ps, qs):
    """∏_k f_{|x|}(P_k, Q_k), conjugated for x < 0: ps [B, K, 2, 24] the G1
    points (x, y), qs [B, K, 2, 2, 24] the twist points (x, y), the K pairs'
    steps stacked on axis 1; one shared squaring of f a bit, multiplied with
    the K lines in one tree (f·l_1 and f·l_2 first). The bits of |x| are
    static, so a bit of 0 runs no addition step (the JAX scan runs it and
    selects)."""
    one = fp_from_int([1], ps.device).expand(qs.shape[:-3] + (2, NL)) * torch.tensor([1, 0], device=ps.device)[:, None]
    t = torch.cat((qs, one[..., None, :, :]), -3)  # (X, Y, Z = 1)
    f = f12_one(ps[:, 0])[:, None]
    pc = dbl_consts(ps)
    for bit in X_ABS_BITS:
        t, lines = dbl_step(t, pc)
        f = f12_prod(torch.cat((f, f, lines), 1))[:, None]
        if bit:
            t, lines = add_step(t, qs, ps)
            f = f12_prod(torch.cat((f, lines), 1))[:, None]
    return f12_frob(f[:, 0], 6)


def miller2(ps, qs):
    """f_{|x|}(P1, Q1)·f_{|x|}(P2, Q2), conjugated for x < 0: ps [B, 2, 2,
    24], qs [B, 2, 2, 2, 24] (the check's two pairs, :func:`miller_loop`)."""
    return miller_loop(ps, qs)


def _cyclo_pow_abs_x(a):
    """a^|x|, square and multiply over the bits of |x| (the oracle's)."""
    out = a
    for bit in X_ABS_BITS:
        out = f12_sqr(out)
        if bit:
            out = f12_mul(out, a)
    return out


def final_exp(f):
    """f^((p¹² - 1)/r), up to the oracle's fixed cube: the easy part
    (p⁶ - 1)(p² + 1), then the oracle's chain for 3(p⁴ - p² + 1)/r (conj =
    the p⁶-Frobenius, the inverse in the cyclotomic subgroup)."""
    m = f12_mul(f12_frob(f, 6), f12_inv(f))
    m = f12_mul(f12_frob(m, 2), m)
    a1 = _cyclo_pow_abs_x(m)  # m^|x|
    mx2 = _cyclo_pow_abs_x(a1)  # m^(x²)
    g = f12_mul(f12_mul(mx2, f12_sqr(a1)), m)  # m^((x - 1)²)
    h = f12_mul(f12_frob(_cyclo_pow_abs_x(g), 6), f12_frob(g, 1))  # g^(x + p)
    hx2 = _cyclo_pow_abs_x(_cyclo_pow_abs_x(h))  # h^(x²)
    k = f12_mul(f12_mul(hx2, f12_frob(h, 2)), f12_frob(h, 6))  # h^(x² + p² - 1)
    return f12_mul(k, f12_mul(f12_sqr(m), m))  # k·m³


def words_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """[B, 12·k] int32 little-endian words -> [B, k, 24] int64 16-bit limbs
    (the rows' ten values, or the kernel's GT elements)."""
    w = words.to(torch.int64).view(words.shape[0], -1, NW) & 0xFFFFFFFF
    return torch.stack((w & MASK, w >> 16), -1).flatten(-2)


def _neg_g1(device) -> torch.Tensor:
    return fp_from_int([ref.G1_X, (-ref.G1_Y) % P], device)


@torch.inference_mode()
def pairing_gt_plain(rows: torch.Tensor) -> torch.Tensor:
    """The GT element of each lane before the equality check:
    final_exp(f_{|x|}(-g1, σ)·f_{|x|}(apk, H(m))), [B, 12, 24] canonical
    Montgomery limbs in the flat tower order."""
    v = words_to_limbs(rows)
    ps = torch.stack((_neg_g1(rows.device).expand(v.shape[0], 2, NL), v[:, 0:2]), 1)
    qs = torch.stack((v[:, 2:6], v[:, 6:10]), 1).unflatten(-2, (2, 2))
    return final_exp(miller2(ps, qs))


def pairing_check_plain(rows: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel, in its public layout: [B,
    120] int32 rows -> ok bool[B] (e(-g1, σ)·e(apk, H(m)) == 1), on the
    rows' device."""
    if not rows.shape[0]:
        return torch.zeros(0, dtype=torch.bool, device=rows.device)
    return f12_eq_one(pairing_gt_plain(rows))


@torch.inference_mode()
def multi_pairing_gt_plain(rows: torch.Tensor) -> torch.Tensor:
    """The multi-pairing's GT element before the comparison:
    final_exp(∏_k f_{|x|}(P_k, Q_k)) over rows [K, 72] int32 (K >= 1,
    :func:`multi_pairing_rows`), [1, 12, 24] canonical Montgomery limbs in
    the flat tower order."""
    v = words_to_limbs(rows)[None]  # [1, K, 6, 24]
    return final_exp(miller_loop(v[:, :, 0:2], v[:, :, 2:6].unflatten(-2, (2, 2))))


def multi_pairing_plain(rows: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the multi-pairing kernel: rows [K, 72]
    int32 (K >= 1) -> ok bool[1], ∏ e(P_k, Q_k) == 1 (the JAX program's
    ok[1]), on the rows' device."""
    return f12_eq_one(multi_pairing_gt_plain(rows))


# ---------------------------------------------------------------------------
# Device entry point
# ---------------------------------------------------------------------------


def _kernel_table() -> np.ndarray:
    """The kernel's constants, int32 words: the Montgomery 1, -g1 (x, y),
    then γ_k for k = 1, 2, 6, six Fp2 values each in the flat order, every
    Fp value as 12 little-endian words in the Montgomery domain."""
    vals = [1, ref.G1_X, (-ref.G1_Y) % P]
    for k in (1, 2, 6):
        vals += [v for g in frob_gammas(k) for v in g]
    words = [(_mont(v) >> (32 * i)) & 0xFFFFFFFF for v in vals for i in range(NW)]
    return np.array(words, dtype=np.uint32).view(np.int32)


KERNEL_TABLE = _kernel_table()
assert KERNEL_TABLE.shape == (_kernels.BLS_TABLE_WORDS,)


@lru_cache(maxsize=None)
def kernel_table(device: torch.device) -> torch.Tensor:
    """:data:`KERNEL_TABLE` on `device`, uploaded once."""
    return torch.from_numpy(KERNEL_TABLE.copy()).to(device)


def pairing_check_device(rows: torch.Tensor) -> torch.Tensor:
    """Batch pairing check: rows [B, 120] int32 (:func:`device_inputs`) ->
    ok bool[B]. CUDA tensors go to the CUDA kernel (or an exception); CPU
    tensors to the plain version."""
    if rows.device.type == "cuda":
        return _kernels.bls12_381_pairing_check(rows, kernel_table(rows.device))
    if rows.device.type == "cpu":
        return pairing_check_plain(rows)
    raise ValueError(f"pairing_check_device: unsupported device {rows.device}")


def multi_pairing_device(rows: torch.Tensor) -> torch.Tensor:
    """Multi-pairing: rows [K, 72] int32 (:func:`multi_pairing_rows`, K >=
    1) -> ok bool[1]. CUDA tensors go to the CUDA kernel (or an exception);
    CPU tensors to the plain version."""
    if rows.device.type == "cuda":
        return _kernels.bls12_381_multi_pairing(rows, kernel_table(rows.device))
    if rows.device.type == "cpu":
        return multi_pairing_plain(rows)
    raise ValueError(f"multi_pairing_device: unsupported device {rows.device}")


# ---------------------------------------------------------------------------
# Host halves (the JAX :628-750)
# ---------------------------------------------------------------------------

# masked-out lanes get well-formed but non-verifying substitutes (distinct
# multiples of the generators), so even a masking bug cannot turn an
# invalid lane into an accepting one
_SUB_APK = ref.G1
_SUB_SIG = ref.G2
_SUB_HM = ref.ec_mul(ref.G2, 2, ref.FP2_OPS)


def _words(x: int) -> list[int]:
    m = _mont(x)
    return [(m >> (32 * i)) & 0xFFFFFFFF for i in range(NW)]


def device_inputs(checks) -> tuple[np.ndarray, np.ndarray]:
    """checks: [(apk | None, sig | None, hm | None)] affine oracle points ->
    (rows [B, 120] int32, valid bool[B]): exactly B lanes, no pad lanes; a
    lane with a None point gets the substitutes and valid False."""
    rows = np.zeros((len(checks), ROW_WORDS), dtype=np.uint32)
    valid = np.zeros(len(checks), dtype=bool)
    for i, pts in enumerate(checks):
        if all(pt is not None for pt in pts):
            apk, sig, hm = pts
            valid[i] = True
        else:
            apk, sig, hm = _SUB_APK, _SUB_SIG, _SUB_HM
        vals = (apk[0], apk[1], sig[0][0], sig[0][1], sig[1][0], sig[1][1],
                hm[0][0], hm[0][1], hm[1][0], hm[1][1])
        rows[i] = [w for v in vals for w in _words(v)]
    return rows.view(np.int32), valid


def rows_from_jax(arrays) -> np.ndarray:
    """The JAX package's ``device_inputs`` arrays (ten [B, 24] arrays of
    16-bit limbs; or any number, six for the multi-pairing) -> the port's
    [B, 120] int32 rows (12 words a value), the same values."""
    limbs = np.stack([np.asarray(a, dtype=np.uint32) for a in arrays], 1)  # [B, 10, 24]
    words = limbs[..., 0::2] | (limbs[..., 1::2] << 16)
    return np.ascontiguousarray(words.reshape(limbs.shape[0], -1)).view(np.int32)


def pairing_check_batch(checks, device=None) -> np.ndarray:
    """Host API: (apk, sig, hm) affine point triples (None = invalid) ->
    bool[B], ok & valid. Runs on the CUDA card unless ``device`` names
    another: one upload of the rows, one launch, one download; an empty
    batch launches nothing."""
    dev = resolve_device(device)
    if not checks:
        return np.zeros(0, dtype=bool)
    rows, valid = device_inputs(checks)
    ok = pairing_check_device(torch.from_numpy(rows).to(dev))
    return ok.cpu().numpy() & valid


def host_pairing_check_batch(checks) -> np.ndarray:
    """The same contract on the port's oracle, a lane at a time."""
    out = np.zeros(len(checks), dtype=bool)
    for i, (apk, sig, hm) in enumerate(checks):
        if apk is None or sig is None or hm is None:
            continue
        out[i] = ref.pairing_check([(ref.ec_neg(ref.G1, ref.FP_OPS), sig), (apk, hm)])
    return out


PAIR_WORDS = 6 * NW  # a multi-pairing pair's row: P x, y; Q x0, x1, y0, y1


def multi_pairing_rows(pairs) -> np.ndarray:
    """(G1, G2) affine oracle point pairs -> [K, 72] int32 rows of the live
    pairs, in order: a pair with a None member contributes the identity
    (the JAX convention, ``ref.pairing_check``), so it is dropped; the JAX
    program's valid lanes, with no pad lane."""
    live = [(p, q) for p, q in pairs if p is not None and q is not None]
    rows = np.zeros((len(live), PAIR_WORDS), dtype=np.uint32)
    for i, (p, q) in enumerate(live):
        rows[i] = [w for v in (p[0], p[1], q[0][0], q[0][1], q[1][0], q[1][1]) for w in _words(v)]
    return rows.view(np.int32)


def multi_pairing_rows_from_jax(arrays, valid) -> np.ndarray:
    """The JAX ``multi_pairing_check``'s arguments to ``_multi_pairing_xla``
    (six [B, 24] arrays of 16-bit limbs, valid bool[B]) -> the port's [K,
    72] int32 rows of its valid lanes, the same values."""
    return rows_from_jax(arrays)[np.asarray(valid, dtype=bool)]


def multi_pairing_pad(n: int) -> int:
    """The lane count the JAX multi-pairing program pads an n-pair product
    to: the next power of two, at least 1. The port pads nothing; its
    device span keys the multi-pairing by this number, as the JAX one
    does."""
    b = 1
    while b < max(n, 1):
        b *= 2
    return b


def multi_pairing_check(pairs, device=None) -> bool:
    """True iff ∏ e(P_k, Q_k) == 1 over (G1, G2) affine oracle point pairs,
    a pair with a None member the identity. Runs on the CUDA card unless
    ``device`` names another: one upload of the live pairs' rows, one
    kernel call, one download; a list with no live pair is True (the empty
    product) and launches nothing."""
    dev = resolve_device(device)
    rows = multi_pairing_rows(pairs)
    if not rows.shape[0]:
        return True
    return bool(multi_pairing_device(torch.from_numpy(rows).to(dev)).cpu()[0])


def host_multi_pairing_check(pairs) -> bool:
    """The same contract on the port's oracle: one Miller product, one
    final exponentiation."""
    return ref.pairing_check(list(pairs))


def hash_to_g2(msg: bytes):
    """Hash-to-G2 on the host (the oracle's, cached there), the host half of
    BLSCrypto's aggregate check."""
    return ref.hash_to_g2(msg)


# ---------------------------------------------------------------------------
# The oracle's flat w-basis and the tower (tests and chip_smoke.py compare
# GT elements through it)
# ---------------------------------------------------------------------------


def tower_to_ref(t: torch.Tensor) -> list[tuple]:
    """[B, 12, 24] flat tower elements -> the oracle's w-basis tuples: the
    tower coefficient (a, b) at v^α w^β is (a - b) at w^(2α+β) and b at
    w^(2α+β+6)."""
    vals = fp_to_int(t)
    out = []
    for lane in range(len(vals) // 12):
        c = vals[12 * lane : 12 * lane + 12]
        flat = [0] * 12
        for beta in range(2):
            for alpha in range(3):
                a, b = c[beta * 6 + alpha * 2], c[beta * 6 + alpha * 2 + 1]
                flat[2 * alpha + beta] = (a - b) % P
                flat[2 * alpha + beta + 6] = b
        out.append(tuple(flat))
    return out


def tower_from_ref(elems, device) -> torch.Tensor:
    """The oracle's w-basis tuples -> [B, 12, 24] flat tower elements."""
    vals = []
    for flat in elems:
        for beta in range(2):
            for alpha in range(3):
                b = flat[2 * alpha + beta + 6]
                vals += [(flat[2 * alpha + beta] + b) % P, b]
    return fp_from_int(vals, device).view(len(elems), 12, NL)
