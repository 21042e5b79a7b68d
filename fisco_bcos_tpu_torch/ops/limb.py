"""Limb-major 256-bit modular arithmetic in plain PyTorch.

Port of the JAX package's ``ops/limb.py`` FoldField path: a 256-bit number
is 16 little-endian 16-bit limbs along axis 0 of an ``[L, T]`` tensor, the
batch on axis 1. The limbs ride int64, because PyTorch on the CPU has no
uint32 add, shift or compare; a partial product of two limbs is < 2^32 and a
column of 16 of them < 2^36, far inside int64.

This is the plain version of the CUDA kernels' arithmetic: the CPU tests
run it against the JAX package, and ``chip_smoke.py`` runs it on the card
against the kernels. The Kogge–Stone carry trees and scatter-free
concatenations of the JAX code exist for Mosaic/XLA; here a ripple of 0/1
carries is resolved in one integer add per lane (see :func:`_carry_in`).

Two fields share one interface (``enc``, ``one``, ``from_plain``,
``to_plain``, ``mul``, ``sqr``, ``mul_small``, ``add``, ``sub``, ``neg``,
``inv``, ``sqrt``): ``FoldField`` for pseudo-Mersenne m = 2^256 − c
(secp256k1's p and n, plain-domain values) and ``MontField`` for any odd m
(SM2's p, Montgomery-domain values, word REDC). Every field op returns the
canonical residue in [0, m) for canonical inputs (``mul``/``sqr`` for any
256-bit inputs, ``MontField`` as long as a·b < m·2^256).
"""

from __future__ import annotations

import numpy as np
import torch

LIMBS = 16
LIMB_BITS = 16
MASK = 0xFFFF
_R = 1 << 256


def int_to_rows(x: int, width: int = LIMBS) -> np.ndarray:
    """Python int -> [width] int64 little-endian 16-bit limbs."""
    if not 0 <= x < 1 << (LIMB_BITS * width):
        raise ValueError("int_to_rows: out of range")
    return np.array(
        [(x >> (LIMB_BITS * i)) & MASK for i in range(width)], dtype=np.int64
    )


def rows_to_ints(a) -> list[int]:
    """[L, T] limbs -> list of T Python ints (host-side, for tests)."""
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a, dtype=np.int64)
    return [
        sum(int(a[i, j]) << (LIMB_BITS * i) for i in range(a.shape[0]))
        for j in range(a.shape[1])
    ]


def ints_to_rows(vals, device) -> torch.Tensor:
    """List of Python ints -> [16, T] int64 limb-major tensor."""
    arr = np.stack([int_to_rows(int(v)) for v in vals], axis=1)
    return torch.from_numpy(arr).to(device)


def const_col(limbs_np, device) -> torch.Tensor:
    """[L] host constant -> [L, 1] column that broadcasts over the lanes."""
    return torch.as_tensor(np.asarray(limbs_np, dtype=np.int64), device=device)[:, None]


# torch.nn.functional.pad's constant mode without its Python dispatch, which
# costs as much as the op on these small tensors
_pad = torch.constant_pad_nd


def _fit(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Truncate or zero-extend axis 0 of [L, T] to `rows`."""
    if x.shape[0] >= rows:
        return x[:rows]
    return _pad(x, (0, 0, 0, rows - x.shape[0]))


# ---------------------------------------------------------------------------
# Carry machinery
# ---------------------------------------------------------------------------


_BIT_COLS: dict = {}


def _bit_cols(L: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """([L, 1] bit positions, [L, 1] their weights 2^i) on `device`, made
    once a (width, device)."""
    key = (L, device)
    cols = _BIT_COLS.get(key)
    if cols is None:
        bits = torch.arange(L, device=device)[:, None]
        cols = _BIT_COLS[key] = (bits, 1 << bits)
    return cols


def _carry_in(g: torch.Tensor, p: torch.Tensor, carry_out: bool = True):
    """Per-position 0/1 carry-in from generate/propagate bits (bool [L, T],
    mutually exclusive), plus the carry-out of the top position (bool [T])
    when `carry_out`.

    The chain is a binary add: pack A = g|p and B = g as L-bit integers per
    lane; position i then sees a+b = 2 (generate), 1 (propagate) or 0 (kill),
    and the carries into every bit are (A + B) ^ A ^ B. L ≤ 40 here."""
    L = g.shape[0]
    bits, w = _bit_cols(L, g.device)
    a = ((g | p) * w).sum(0)
    b = (g * w).sum(0)
    s = a + b
    cin = ((s ^ a ^ b)[None, :] >> bits) & 1
    return (cin, ((s >> L) & 1).bool()) if carry_out else cin


def carry_norm(cols: torch.Tensor, bits: int = 40) -> torch.Tensor:
    """Carry-propagate non-negative column sums (each < 2^bits, bits ≤ 62):
    [L, T] -> [L+1, T] normalized 16-bit limbs (top row = final carry-out)."""
    x = _pad(cols, (0, 0, 0, 1))
    b = bits
    while True:
        # value unchanged: limb i keeps its low 16 bits, its high part moves up
        hi = x >> LIMB_BITS
        x = x & MASK
        x[1:] += hi[:-1]
        if b <= 32:  # inputs < 2^32 -> every limb now ≤ 2·0xFFFF
            break
        b = max(b - LIMB_BITS, LIMB_BITS) + 1
    return (x + _carry_in(x > MASK, x == MASK, carry_out=False)) & MASK


def sub_borrow(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(a - b) limbwise over axis 0 -> (diff [L, T], borrow_out bool [T])."""
    bin_, bout = _carry_in(a < b, a == b)
    return (a - b - bin_) & MASK, bout


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(0)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(0)


def lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _, borrow = sub_borrow(a, b)
    return borrow


def select(cond: torch.Tensor, a, b):
    """cond [T] -> cond ? a : b over [..., T] operands (or tuples of them)."""
    if isinstance(a, tuple):
        return tuple(select(cond, x, y) for x, y in zip(a, b))
    return torch.where(cond, a, b)


# ---------------------------------------------------------------------------
# Multiplication
# ---------------------------------------------------------------------------


def conv_cols(a: torch.Tensor, b: torch.Tensor, out: int) -> torch.Tensor:
    """Column sums of a*b: [Ha, T] x [Hb, T or 1] -> [out, T] raw columns
    (column k = Σ_{i+j=k} a_i·b_j; columns at or above `out` are dropped,
    callers prove them zero).

    The outer product [Ha, Hb, T] is padded to Hb' = Ha+Hb along j and read
    back as [Ha, Ha+Hb-1]: entry (i, j) then lands in row i, column i+j, so
    one sum over rows gives every column."""
    ha, hb = a.shape[0], b.shape[0]
    w = ha + hb - 1
    prod = a[:, None, :] * b[None, :, :]
    t = prod.shape[-1]
    flat = _pad(prod, (0, 0, 0, w + 1 - hb)).reshape(ha * (w + 1), t)
    cols = flat[: ha * w].reshape(ha, w, t).sum(0)
    return _fit(cols, out)


def add_widen(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact add of two normalized operands (equal or different widths) ->
    [max(L)+1, T] normalized."""
    w = max(a.shape[0], b.shape[0])
    return carry_norm(_fit(a, w) + _fit(b, w), bits=17)


def cond_sub(x: torch.Tensor, m_col: torch.Tensor) -> torch.Tensor:
    """x - m if x >= m else x, for normalized x < 2m. Returns [16, T]."""
    diff, borrow = sub_borrow(x, _fit(m_col, x.shape[0]))
    return select(~borrow, diff, x)[:LIMBS]


# ---------------------------------------------------------------------------
# Fields: pseudo-Mersenne fold (plain domain) and Montgomery (REDC)
# ---------------------------------------------------------------------------


class _Field:
    """What both fields share: the modulus, add/sub/neg on canonical
    residues, and Fermat inversion / the p ≡ 3 (mod 4) square root through
    the field's own mul."""

    def __init__(self, m: int, one: int, device):
        self.m_int = m
        self.m_col = const_col(int_to_rows(m), device)
        self._one = const_col(int_to_rows(one), device)

    def one(self, like: torch.Tensor) -> torch.Tensor:
        """The field's 1 (its own domain), broadcast over like's lanes."""
        return self._one.expand(LIMBS, like.shape[-1])

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return cond_sub(add_widen(a, b), self.m_col)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        diff, borrow = sub_borrow(a, b)
        plus = add_widen(diff, self.m_col)[:LIMBS]
        return select(borrow, plus, diff)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self.sub(torch.zeros_like(a), a)

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """a^-1 mod m for prime m (Fermat); 0 -> 0."""
        return pow_static(self, a, self.m_int - 2)

    def sqrt(self, a: torch.Tensor) -> torch.Tensor:
        """Square-root candidate for m ≡ 3 (mod 4): a^((m+1)/4). The caller
        checks sqr(result) == a to detect non-residues."""
        if self.m_int % 4 != 3:
            raise ValueError("sqrt needs m ≡ 3 (mod 4)")
        return pow_static(self, a, (self.m_int + 1) // 4)


class FoldField(_Field):
    """GF(m) for m = 2^256 - c (c ≤ ~2^130): plain-domain values, reduction
    by folding hi·c back into the low words. Constants live on `device`."""

    def __init__(self, m: int, device):
        c = _R - m
        if not 0 < c < 1 << 132:
            raise ValueError("FoldField needs m = 2^256 - c with small c")
        super().__init__(m, 1, device)
        self.c_col = const_col(int_to_rows(c, (c.bit_length() + 15) // 16), device)

    # -- domain conversions (plain domain: all identity) --
    def enc(self, v: int) -> np.ndarray:
        return int_to_rows(v % self.m_int)

    def from_plain(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def to_plain(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def reduce_wide(self, x: torch.Tensor, bound: int) -> torch.Tensor:
        """x (normalized limbs, value < bound) -> x mod m: fold
        lo + hi·2^256 ≡ lo + hi·c until the value bound drops below 2m,
        then one conditional subtract (the JAX package's schedule)."""
        c_int = _R - self.m_int
        while bound > 2 * self.m_int:
            lo, hi = x[:LIMBS], x[LIMBS:]
            if hi.shape[0] == 0:
                break
            hi_max = (bound - 1) >> 256
            bound = (_R - 1) + hi_max * c_int + 1
            width = max((bound - 1).bit_length() + 15, 17 * 16) // 16
            cols = conv_cols(hi, self.c_col, width) + _fit(lo, width)
            x = carry_norm(cols)[:width]
        return cond_sub(x, self.m_col)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        # 16 products of two limbs per column: every column < 2^36
        wide = carry_norm(conv_cols(a, b, 2 * LIMBS), bits=36)[: 2 * LIMBS]
        return self.reduce_wide(wide, (_R - 1) ** 2 + 1)

    def sqr(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    def mul_small(self, a: torch.Tensor, c: int) -> torch.Tensor:
        """a * c for a small host constant 0 < c < 2^15 (secp256k1's 3b = 21)."""
        if not 0 < c < 1 << 15:
            raise ValueError("mul_small needs 0 < c < 2^15")
        wide = carry_norm(a * c, bits=31)[: LIMBS + 1]
        return self.reduce_wide(wide, (_R - 1) * c + 1)


class MontField(_Field):
    """GF(m) for any odd m < 2^256: Montgomery-domain values x·R mod m
    (R = 2^256), word REDC reduction — the JAX package's ``MontField``, the
    default field of SM2's p. Every op returns the canonical residue; REDC of
    a t < m·R is unique, so any correct REDC gives the same bits."""

    def __init__(self, m: int, device):
        if m % 2 == 0 or not 2 < m < _R:
            raise ValueError("MontField needs an odd modulus < 2^256")
        super().__init__(m, _R % m, device)
        self.mprime_int = (-pow(m, -1, _R)) % _R  # -m^-1 mod 2^256
        self.r1_int = _R % m  # R mod m, the field's 1
        self.r2_int = _R * _R % m  # R^2 mod m
        self.mprime_col = const_col(int_to_rows(self.mprime_int), device)
        self.r2_col = const_col(int_to_rows(self.r2_int), device)

    def enc(self, v: int) -> np.ndarray:
        return int_to_rows((v % self.m_int) * _R % self.m_int)

    def redc(self, t: torch.Tensor) -> torch.Tensor:
        """t [32, T] normalized, t < m·R -> t·R^-1 mod m, [16, T]."""
        m_val = carry_norm(conv_cols(t[:LIMBS], self.mprime_col, LIMBS), bits=36)[:LIMBS]
        mm = carry_norm(conv_cols(m_val, self.m_col, 2 * LIMBS), bits=36)[: 2 * LIMBS]
        s = add_widen(t, mm)  # [33, T]; the low 16 limbs are zero
        return cond_sub(s[LIMBS:], self.m_col)

    def from_plain(self, x: torch.Tensor) -> torch.Tensor:
        """Any 256-bit plain x -> x·R mod m (x·R^2 < m·R, so REDC applies)."""
        return self.mul(x, self.r2_col)

    def to_plain(self, x: torch.Tensor) -> torch.Tensor:
        return self.redc(_fit(x, 2 * LIMBS))

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.redc(carry_norm(conv_cols(a, b, 2 * LIMBS), bits=36)[: 2 * LIMBS])

    def sqr(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    def mul_small(self, a: torch.Tensor, c: int) -> torch.Tensor:
        """a * c for tiny c by an addition chain on the bits of c, MSB first
        (scaling commutes with the Montgomery form; the a = -3 law's c = 3)."""
        if not 0 < c < 32:
            raise ValueError("MontField.mul_small supports 0 < c < 32")
        acc = None
        for bit in bin(c)[2:]:
            if acc is not None:
                acc = self.add(acc, acc)
            if bit == "1":
                acc = a if acc is None else self.add(acc, a)
        return acc


# ---------------------------------------------------------------------------
# Windowed exponentiation with a static exponent
# ---------------------------------------------------------------------------

_POW_W = 4


def _exp_windows(e: int) -> list[int]:
    """Static exponent -> MSB-first 4-bit windows (leading zeros stripped)."""
    if e <= 0:
        raise ValueError("pow_static needs a positive exponent")
    nw = (e.bit_length() + _POW_W - 1) // _POW_W
    return [(e >> (_POW_W * i)) & 0xF for i in range(nw - 1, -1, -1)]


def pow_static(F: _Field, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e in field F for a fixed Python-int exponent: 4-bit windows, MSB
    first, 4 squarings + one table multiply per nonzero window."""
    wins = _exp_windows(e)
    tab = [a]
    for _ in range(14):
        tab.append(F.mul(tab[-1], a))
    acc = tab[wins[0] - 1]
    for c in wins[1:]:
        for _ in range(_POW_W):
            acc = F.sqr(acc)
        if c:
            acc = F.mul(acc, tab[c - 1])
    return acc
