"""The BLS12-381 pairing kernel's programs (csrc/bls12_381_programs.cuh),
generated here from the tower's formulas.

``csrc/bls12_381.cu`` runs one pairing check on a group of :data:`G` lanes.
What it runs is data: programs of rows, each row up to G independent
field ops of one kind (an Fp product, or an Fp sum or difference) over the
check's slots in shared memory, lane j of the group running op j of a row,
then a sync. This module writes those programs:

- the tower's formulas (Fp2, Fp6, Fp12, the twist's projective steps with
  their lines, the 13-product sparse line product, the Granger-Scott
  cyclotomic squaring, the Frobenius maps, the Fp12 inverse down to one Fp
  inversion) are written once, over symbolic values, as a DAG of Fp ops
  (:class:`Builder`);
- a list scheduler packs each program's DAG into rows of one kind, the ops
  on the longest remaining path first (:func:`_schedule`);
- the slots are allocated per row: a temporary's slot is free again only in
  the row after its last read, so no op of a row writes a slot another op
  of that row reads (:func:`_allocate`; the tests walk every row for such
  hazards again);
- the script (:func:`_script_keys`) is the whole check as a sequence of program
  runs: the set-up, 63 Miller-loop iterations (those at a set bit of |x|
  with the addition steps), the easy part of the final exponentiation
  around one Fp inversion (:data:`INV`, run by one lane), and the hard
  part's chain with its five powers by |x|.

The multi-pairing (``bls12_381_multi_pairing_launch``) reuses them: a group
of two pairs runs the check's Miller loop with both G1 points from its rows
(:data:`MP_LOADS`), a lone last pair a one-pair Miller loop
(:data:`MILLER1_KEYS`), the groups' f values meet by a tree of products
(:data:`FMUL_KEY`; :func:`tree_depth` of them on the critical path), and
the group at the root runs the check's final exponentiation. Its kernel
runs the same rows on a quad of lanes an Fp op.

``python -m fisco_bcos_tpu_torch.ops.bls12_381_programs`` writes the header;
tests/test_torch_bls12_381.py checks that the committed header is this
module's output, and runs the script over Python integers
(:func:`run_check`, :func:`run_multi`) against the oracle. Pure Python: no
torch.
"""

from __future__ import annotations

import sys
from functools import lru_cache
from pathlib import Path

from ..crypto.ref import bls12_381 as ref

P = ref.P
R384 = 1 << 384
RINV = pow(R384, -1, P)
X_ABS = -ref.X_PARAM
X_BITS = tuple(int(b) for b in bin(X_ABS)[3:])  # |x| below its top bit, MSB first: 63 bits, 5 set
G = 32  # lanes a check: one warp
HEADER = Path(__file__).resolve().parent.parent / "csrc" / "bls12_381_programs.cuh"

MUL, ADDSUB = 0, 1  # the kinds of a row
INV = 255  # the script's entry for the Fp inversion of slot N (one lane)
# a row's cost in a mul row's units, for the scheduler's priorities (the
# field bench's cycles: a product is ~10 sums)
_COST = {MUL: 10, ADDSUB: 1}


# ---------------------------------------------------------------------------
# The pinned slots: what lives across programs
# ---------------------------------------------------------------------------


def _pinned() -> dict[str, int]:
    """Name -> slot of every value that lives across programs (or is loaded
    by the kernel); the temporaries follow them."""
    names = ["ZERO", "ONE"]
    for k in (1, 2):
        names += [f"XP{k}", f"YP{k}", f"NXP{k}", f"N3XP{k}"]  # the G1 point, -x_P, -3x_P
        names += [f"QX{k}_0", f"QX{k}_1", f"QY{k}_0", f"QY{k}_1"]  # the twist point, affine
        names += [f"T{k}_{i}" for i in range(6)]  # the accumulator (X, Y, Z), homogeneous
    names += [f"G1_{i}" for i in range(2, 12)]  # γ1 for the coefficients 1..5 (Fp2)
    names += [f"G2_{i}" for i in range(1, 6)]  # γ2 for the coefficients 1..5 (in Fp)
    for reg in ("F", "A", "B", "C"):  # Fp12 registers: the Miller loop's f (then m), the chain's
        names += [f"{reg}_{i}" for i in range(12)]
    names += [f"IC_{i}" for i in range(6)] + ["IT_0", "IT_1", "N"]  # the inverse's halves
    return {n: i for i, n in enumerate(names)}


PINNED = _pinned()
N_PINNED = len(PINNED)

# What the kernel loads into slots before the script: (slot, source, index),
# source "row" (the lane's row: apk x, y; σ x0, x1, y0, y1; H(m) ...) or
# "table" (ops/bls12_381.py kernel_table: 0 the Montgomery 1, 1-2 -g1, then
# γ1, γ2, γ6 as six Fp2 values each, c0 then c1) or "zero".
LOADS = (
    [(PINNED["ZERO"], "zero", 0), (PINNED["ONE"], "table", 0), (PINNED["XP1"], "table", 1),
     (PINNED["YP1"], "table", 2), (PINNED["XP2"], "row", 0), (PINNED["YP2"], "row", 1)]
    + [(PINNED[f"{n}1_{i}"], "row", 2 + 2 * j + i) for j, n in enumerate(("QX", "QY")) for i in range(2)]
    + [(PINNED[f"{n}2_{i}"], "row", 6 + 2 * j + i) for j, n in enumerate(("QX", "QY")) for i in range(2)]
    + [(PINNED[f"G1_{i}"], "table", 3 + i) for i in range(2, 12)]
    + [(PINNED[f"G2_{i}"], "table", 3 + 12 + 2 * i) for i in range(1, 6)]
)
# A multi-pairing group's loads: two consecutive rows of six values (P x,
# y; Q x0, x1, y0, y1, the JAX program's argument order) as pairs 1 and 2,
# the Montgomery 1 and the Frobenius constants (the final exponentiation
# runs on the last group's slots). The kernel skips the row values past its
# group's pairs (a lone last pair).
MP_LOADS = (
    [(PINNED["ZERO"], "zero", 0), (PINNED["ONE"], "table", 0)]
    + [(PINNED[name], "row", 6 * (k - 1) + j) for k in (1, 2) for j, name in enumerate(
        (f"XP{k}", f"YP{k}", f"QX{k}_0", f"QX{k}_1", f"QY{k}_0", f"QY{k}_1"))]
    + [(PINNED[f"G1_{i}"], "table", 3 + i) for i in range(2, 12)]
    + [(PINNED[f"G2_{i}"], "table", 3 + 12 + 2 * i) for i in range(1, 6)]
)


# ---------------------------------------------------------------------------
# Building a program: a DAG of Fp ops over symbolic values
# ---------------------------------------------------------------------------


class Builder:
    """One program's DAG. A value is an int: -1 - slot for a pinned slot's
    value at the program's start, else the index of the op that makes it.
    Every op carries the step of the chain it belongs to (`tag`), for the
    count of products a step makes."""

    def __init__(self):
        # (kind, sources, signs, tag): a product of two sources, or a sum
        # s0 ± s1, its sign 1 where it subtracts
        self.ops: list[tuple[int, tuple, tuple, str]] = []
        self.outs: dict[int, int] = {}  # pinned slot -> value
        self.tag = ""

    def pin(self, name: str) -> int:
        return -1 - PINNED[name]

    def _op(self, kind, srcs, signs) -> int:
        self.ops.append((kind, srcs, signs, self.tag))
        return len(self.ops) - 1

    def mul(self, a, b):
        return self._op(MUL, (a, b), ())

    def add(self, a, b):
        return self._op(ADDSUB, (a, b), (0,))

    def sub(self, a, b):
        return self._op(ADDSUB, (a, b), (1,))

    def out(self, name: str, v: int) -> None:
        self.outs[PINNED[name]] = v

    # -- Fp2 = Fp[u]/(u² + 1): pairs --
    def f2_add(self, a, b):
        return (self.add(a[0], b[0]), self.add(a[1], b[1]))

    def f2_sub(self, a, b):
        return (self.sub(a[0], b[0]), self.sub(a[1], b[1]))

    def f2_neg(self, a):
        z = self.pin("ZERO")
        return (self.sub(z, a[0]), self.sub(z, a[1]))

    def f2_conj(self, a):
        return (a[0], self.sub(self.pin("ZERO"), a[1]))

    def f2_dbl(self, a):
        return self.f2_add(a, a)

    def f2_mul(self, a, b):  # Karatsuba: 3 products
        v0, v1 = self.mul(a[0], b[0]), self.mul(a[1], b[1])
        s = self.mul(self.add(a[0], a[1]), self.add(b[0], b[1]))
        return (self.sub(v0, v1), self.sub(self.sub(s, v0), v1))

    def f2_sqr(self, a):  # ((a0 + a1)(a0 - a1), a0·2a1): 2 products, the doubling before them
        return (self.mul(self.add(a[0], a[1]), self.sub(a[0], a[1])), self.mul(a[0], self.add(a[1], a[1])))

    def f2_mul_fp(self, a, s):
        return (self.mul(a[0], s), self.mul(a[1], s))

    def f2_mul_xi(self, a):  # ·(1 + u) = (a0 - a1, a0 + a1)
        return (self.sub(a[0], a[1]), self.add(a[0], a[1]))

    # -- Fp6 = Fp2[v]/(v³ - ξ): triples of pairs --
    def f6_add(self, a, b):
        return tuple(self.f2_add(x, y) for x, y in zip(a, b))

    def f6_sub(self, a, b):
        return tuple(self.f2_sub(x, y) for x, y in zip(a, b))

    def f6_mul_v(self, a):
        return (self.f2_mul_xi(a[2]), a[0], a[1])

    def f6_mul(self, a, b):  # Karatsuba: 6 Fp2 products (the JAX f6_mul)
        v0, v1, v2 = (self.f2_mul(a[i], b[i]) for i in range(3))
        t = self.f2_mul(self.f2_add(a[1], a[2]), self.f2_add(b[1], b[2]))
        c0 = self.f2_add(v0, self.f2_mul_xi(self.f2_sub(self.f2_sub(t, v1), v2)))
        t = self.f2_mul(self.f2_add(a[0], a[1]), self.f2_add(b[0], b[1]))
        c1 = self.f2_add(self.f2_sub(self.f2_sub(t, v0), v1), self.f2_mul_xi(v2))
        t = self.f2_mul(self.f2_add(a[0], a[2]), self.f2_add(b[0], b[2]))
        c2 = self.f2_add(self.f2_sub(self.f2_sub(t, v0), v2), v1)
        return (c0, c1, c2)

    def f6_mul_by_01(self, a, b0, b1):  # a·(b0 + b1·v): 5 Fp2 products
        v0, v1 = self.f2_mul(a[0], b0), self.f2_mul(a[1], b1)
        t = self.f2_mul(self.f2_add(a[0], a[1]), self.f2_add(b0, b1))
        c0 = self.f2_add(v0, self.f2_mul_xi(self.f2_mul(a[2], b1)))
        c1 = self.f2_sub(self.f2_sub(t, v0), v1)
        c2 = self.f2_add(v1, self.f2_mul(a[2], b0))
        return (c0, c1, c2)

    def f6_mul_by_1(self, a, b1):  # a·(b1·v): 3 Fp2 products
        return (self.f2_mul_xi(self.f2_mul(a[2], b1)), self.f2_mul(a[0], b1), self.f2_mul(a[1], b1))

    # -- Fp12 = Fp6[w]/(w² - v): (g, h), flat order g0 g1 g2 h0 h1 h2 --
    def f12(self, reg: str):
        c = [(self.pin(f"{reg}_{2 * i}"), self.pin(f"{reg}_{2 * i + 1}")) for i in range(6)]
        return (tuple(c[:3]), tuple(c[3:]))

    def f12_out(self, reg: str, f) -> None:
        for i, c in enumerate(f[0] + f[1]):
            self.out(f"{reg}_{2 * i}", c[0])
            self.out(f"{reg}_{2 * i + 1}", c[1])

    def f12_mul(self, a, b):  # Karatsuba: 18 Fp2 products
        vg, vh = self.f6_mul(a[0], b[0]), self.f6_mul(a[1], b[1])
        s = self.f6_mul(self.f6_add(a[0], a[1]), self.f6_add(b[0], b[1]))
        return (self.f6_add(vg, self.f6_mul_v(vh)), self.f6_sub(self.f6_sub(s, vg), vh))

    def f12_sqr(self, a):  # the JAX f12_sqr: 12 Fp2 products
        g, h = a
        v0 = self.f6_mul(g, h)
        t = self.f6_mul(self.f6_add(g, h), self.f6_add(g, self.f6_mul_v(h)))
        return (self.f6_sub(self.f6_sub(t, v0), self.f6_mul_v(v0)), self.f6_add(v0, v0))

    def f12_mul_line(self, f, c0, c2, c3):  # f·((c0 + c2·v) + c3·v·w): 13 Fp2 products
        g, h = f
        a = self.f6_mul_by_01(g, c0, c2)
        b = self.f6_mul_by_1(h, c3)
        e = self.f6_mul_by_01(self.f6_add(g, h), c0, self.f2_add(c2, c3))
        return (self.f6_add(a, self.f6_mul_v(b)), self.f6_sub(self.f6_sub(e, a), b))

    def _fp4_sqr(self, a, b):  # (a + b·s)², s² = ξ: (a² + ξ·b², 2ab), 3 Fp2 squarings
        t0, t1 = self.f2_sqr(a), self.f2_sqr(b)
        c1 = self.f2_sub(self.f2_sub(self.f2_sqr(self.f2_add(a, b)), t0), t1)
        return self.f2_add(self.f2_mul_xi(t1), t0), c1

    def f12_cyclo_sqr(self, f):
        """Granger-Scott (eprint 2009/565) for an element of the cyclotomic
        subgroup: 9 Fp2 squarings. Over Fp4 = Fp2[s]/(s² - ξ), s = w³,
        f = A + B·w + C·w² with A = g0 + h1·s, B = h0 + g2·s, C = g1 + h2·s
        (w³ = s, w⁶ = ξ), and f² = (3A² - 2Ā) + (3s·C² + 2B̄)·w + (3B² - 2C̄)·w²,
        Ā the conjugate over Fp2 (s -> -s)."""
        (g0, g1, g2), (h0, h1, h2) = f
        a0, a1 = self._fp4_sqr(g0, h1)  # A²
        b0, b1 = self._fp4_sqr(h0, g2)  # B²
        c0, c1 = self._fp4_sqr(g1, h2)  # C²

        # 3t ∓ 2x as 2t + (t ∓ 2x): two sums after t, 2x made from the input
        # while the products run
        def three_minus_two(t, x):
            return self.f2_add(self.f2_dbl(t), self.f2_sub(t, self.f2_dbl(x)))

        def three_plus_two(t, x):
            return self.f2_add(self.f2_dbl(t), self.f2_add(t, self.f2_dbl(x)))

        g0n, h1n = three_minus_two(a0, g0), three_plus_two(a1, h1)
        h0n, g2n = three_plus_two(self.f2_mul_xi(c1), h0), three_minus_two(c0, g2)
        g1n, h2n = three_minus_two(b0, g1), three_plus_two(b1, h2)
        return ((g0n, g1n, g2n), (h0n, h1n, h2n))

    def f12_conj(self, f):  # f^(p⁶): h negated (γ6 = 1, 1, 1, -1, -1, -1)
        return (f[0], tuple(self.f2_neg(c) for c in f[1]))

    def f12_frob_p(self, f):  # f^p: each coefficient conjugated, times γ1 (γ1 of 1 is 1)
        c = [self.f2_conj(x) for x in f[0] + f[1]]
        c = [c[0]] + [self.f2_mul(c[i], (self.pin(f"G1_{2 * i}"), self.pin(f"G1_{2 * i + 1}")))
                      for i in range(1, 6)]
        return (tuple(c[:3]), tuple(c[3:]))

    def f12_frob_p2(self, f):  # f^(p²): times γ2, which lies in Fp
        c = list(f[0] + f[1])
        c = [c[0]] + [self.f2_mul_fp(c[i], self.pin(f"G2_{i}")) for i in range(1, 6)]
        return (tuple(c[:3]), tuple(c[3:]))

    # -- the twist's steps, homogeneous projective (X : Y : Z), x = X/Z --
    def dbl_step(self, t, n3xp, yp):
        """T <- 2T with the tangent at T through P (Costello-Lange-Naehrig,
        eprint 2009/615; Aranha et al., eprint 2010/526 §4), every output
        scaled by 4 so that no halving is needed. On E': y² = x³ + b',
        b' = 4ξ: B = Y², C = Z², E = 3b'·C, F = 3E, H = (Y + Z)² - B - C =
        2YZ; X3 = 2XY·(B - F), Y3 = (B + F)² - 12E², Z3 = 4B·H. The line,
        the JAX tangent (c0 + c2·v) + c3·v·w times Z²/Z_J⁶ (an Fp2 factor,
        which the final exponentiation kills): c0 = B - E (= Y² - 3b'Z²),
        c2 = -3X²·x_P, c3 = H·y_P. 3 Fp2 products, 6 squarings, 4 Fp
        products."""
        x, y, z = t
        a = self.f2_mul(x, y)
        b, c = self.f2_sqr(y), self.f2_sqr(z)
        xc = self.f2_mul_xi(c)  # E = 12ξ·C
        e4 = self.f2_dbl(self.f2_dbl(xc))
        e = self.f2_add(self.f2_dbl(e4), e4)
        f = self.f2_add(self.f2_dbl(e), e)
        xx = self.f2_sqr(x)
        h = self.f2_sub(self.f2_sub(self.f2_sqr(self.f2_add(y, z)), b), c)
        x3 = self.f2_mul(self.f2_dbl(a), self.f2_sub(b, f))
        ee4 = self.f2_dbl(self.f2_dbl(self.f2_sqr(e)))
        y3 = self.f2_sub(self.f2_sqr(self.f2_add(b, f)), self.f2_add(self.f2_dbl(ee4), ee4))
        z3 = self.f2_mul(self.f2_dbl(self.f2_dbl(b)), h)
        line = (self.f2_sub(b, e), self.f2_mul_fp(xx, n3xp), self.f2_mul_fp(h, yp))
        return (x3, y3, z3), line

    def add_step(self, t, q, nxp, yp):
        """T <- T + Q, Q affine, with the chord through T and Q at P (the
        same sources, §5): θ = Y - y_Q·Z, λ = X - x_Q·Z, C = θ², D = λ²,
        E = λ·D, F = Z·C, G = X·D, H = E + F - 2G; X3 = λ·H, Y3 = θ·(G - H)
        - Y·E, Z3 = Z·E. The line, the JAX chord times an Fp2 factor:
        c0 = θ·x_Q - λ·y_Q, c2 = -θ·x_P, c3 = λ·y_P. 11 Fp2 products,
        2 squarings, 4 Fp products."""
        x, y, z = t
        xq, yq = q
        th = self.f2_sub(y, self.f2_mul(yq, z))
        la = self.f2_sub(x, self.f2_mul(xq, z))
        c, d = self.f2_sqr(th), self.f2_sqr(la)
        e = self.f2_mul(la, d)
        f = self.f2_mul(z, c)
        g = self.f2_mul(x, d)
        h = self.f2_sub(self.f2_add(e, f), self.f2_dbl(g))
        x3 = self.f2_mul(la, h)
        y3 = self.f2_sub(self.f2_mul(th, self.f2_sub(g, h)), self.f2_mul(y, e))
        z3 = self.f2_mul(z, e)
        line = (self.f2_sub(self.f2_mul(th, xq), self.f2_mul(la, yq)), self.f2_mul_fp(th, nxp),
                self.f2_mul_fp(la, yp))
        return (x3, y3, z3), line


# ---------------------------------------------------------------------------
# The programs
# ---------------------------------------------------------------------------


def _twist(b: Builder, k: int):
    t = tuple((b.pin(f"T{k}_{2 * i}"), b.pin(f"T{k}_{2 * i + 1}")) for i in range(3))
    q = ((b.pin(f"QX{k}_0"), b.pin(f"QX{k}_1")), (b.pin(f"QY{k}_0"), b.pin(f"QY{k}_1")))
    return t, q


def _twist_out(b: Builder, k: int, t) -> None:
    for i, c in enumerate(t):
        b.out(f"T{k}_{2 * i}", c[0])
        b.out(f"T{k}_{2 * i + 1}", c[1])


def prog_setup(b: Builder, pairs: tuple = (1, 2)) -> None:
    """-x_P, -3x_P a pair; T = (x_Q : y_Q : 1); f = 1."""
    for k in pairs:
        nxp = b.sub(b.pin("ZERO"), b.pin(f"XP{k}"))
        b.out(f"NXP{k}", nxp)
        b.out(f"N3XP{k}", b.add(b.add(nxp, nxp), nxp))
        _, q = _twist(b, k)
        _twist_out(b, k, (q[0], q[1], (b.pin("ONE"), b.pin("ZERO"))))
    one, zero = b.pin("ONE"), b.pin("ZERO")
    b.f12_out("F", (((one, zero), (zero, zero), (zero, zero)), ((zero, zero),) * 3))


def prog_miller(b: Builder, with_add: bool, pairs: tuple = (1, 2)) -> None:
    """One iteration of the Miller loop over `pairs` (the check's: both):
    f <- f²·l_T1·l_T2 with T <- 2T for each pair, one squaring of f for all,
    then, at a set bit, f·l·l with T <- T + Q."""
    b.tag = "fp12_sqr"
    f = b.f12_sqr(b.f12("F"))
    ts = {}
    for k in pairs:
        t, _ = _twist(b, k)
        b.tag = "dbl"
        ts[k], line = b.dbl_step(t, b.pin(f"N3XP{k}"), b.pin(f"YP{k}"))
        b.tag = "line"
        f = b.f12_mul_line(f, *line)
    if with_add:
        for k in pairs:
            _, q = _twist(b, k)
            b.tag = "add"
            ts[k], line = b.add_step(ts[k], q, b.pin(f"NXP{k}"), b.pin(f"YP{k}"))
            b.tag = "line"
            f = b.f12_mul_line(f, *line)
    b.f12_out("F", f)
    for k in pairs:
        _twist_out(b, k, ts[k])


def prog_conj_f(b: Builder) -> None:
    """f conjugated for x < 0."""
    b.tag = "conj"
    b.f12_out("F", b.f12_conj(b.f12("F")))


def prog_inv_a(b: Builder) -> None:
    """The Fp12 inverse of f, down to one Fp value: s = g² - v·h² (Fp6),
    its adjugate c (the JAX f6_inv), t = s0·c0 + ξ(s1·c2 + s2·c1) (Fp2),
    N = t0² + t1²."""
    b.tag = "fp12_inv"
    g, h = b.f12("F")
    s = b.f6_sub(b.f6_mul(g, g), b.f6_mul_v(b.f6_mul(h, h)))
    c0 = b.f2_sub(b.f2_sqr(s[0]), b.f2_mul_xi(b.f2_mul(s[1], s[2])))
    c1 = b.f2_sub(b.f2_mul_xi(b.f2_sqr(s[2])), b.f2_mul(s[0], s[1]))
    c2 = b.f2_sub(b.f2_sqr(s[1]), b.f2_mul(s[0], s[2]))
    t = b.f2_add(b.f2_mul(s[0], c0), b.f2_mul_xi(b.f2_add(b.f2_mul(s[1], c2), b.f2_mul(s[2], c1))))
    for i, c in enumerate((c0, c1, c2)):
        b.out(f"IC_{2 * i}", c[0])
        b.out(f"IC_{2 * i + 1}", c[1])
    b.out("IT_0", t[0])
    b.out("IT_1", t[1])
    b.out("N", b.add(b.mul(t[0], t[0]), b.mul(t[1], t[1])))


def prog_inv_b(b: Builder) -> None:
    """From N^-1: t^-1 = (t0·N^-1, -t1·N^-1), s^-1 = c·t^-1, f^-1 =
    (g·s^-1, -h·s^-1); then the easy part m = f^((p⁶ - 1)(p² + 1)) =
    u^(p²)·u with u = conj(f)·f^-1, into the register M (= F)."""
    b.tag = "fp12_inv"
    n = b.pin("N")
    ti = (b.mul(b.pin("IT_0"), n), b.sub(b.pin("ZERO"), b.mul(b.pin("IT_1"), n)))
    si = tuple(b.f2_mul((b.pin(f"IC_{2 * i}"), b.pin(f"IC_{2 * i + 1}")), ti) for i in range(3))
    f = b.f12("F")
    g_inv, h_inv = b.f6_mul(f[0], si), b.f6_mul(f[1], si)
    finv = (g_inv, tuple(b.f2_neg(c) for c in h_inv))
    b.tag = "conj"
    fc = b.f12_conj(f)
    b.tag = "fp12_mul"
    u = b.f12_mul(fc, finv)
    b.tag = "frob_p2"
    u2 = b.f12_frob_p2(u)
    b.tag = "fp12_mul"
    b.f12_out("F", b.f12_mul(u2, u))


def prog_cyclo(b: Builder, dst: str, src: str) -> None:
    b.tag = "cyclo_sqr"
    b.f12_out(dst, b.f12_cyclo_sqr(b.f12(src)))


def prog_mul(b: Builder, dst: str, x: str, y: str) -> None:
    b.tag = "fp12_mul"
    b.f12_out(dst, b.f12_mul(b.f12(x), b.f12(y)))


def prog_copy(b: Builder, dst: str, src: str) -> None:
    b.f12_out(dst, b.f12(src))


def prog_conj(b: Builder, dst: str, src: str) -> None:
    b.tag = "conj"
    b.f12_out(dst, b.f12_conj(b.f12(src)))


def prog_frob_p(b: Builder, dst: str, src: str) -> None:
    b.tag = "frob_p"
    b.f12_out(dst, b.f12_frob_p(b.f12(src)))


def prog_frob_p2(b: Builder, dst: str, src: str) -> None:
    b.tag = "frob_p2"
    b.f12_out(dst, b.f12_frob_p2(b.f12(src)))


_PROGRAM_FNS = {
    "setup": prog_setup, "miller": prog_miller, "conj_f": prog_conj_f, "inv_a": prog_inv_a,
    "inv_b": prog_inv_b, "cyclo": prog_cyclo, "mul": prog_mul, "copy": prog_copy, "conj": prog_conj,
    "frob_p": prog_frob_p, "frob_p2": prog_frob_p2,
}


def build(key: tuple) -> Builder:
    """The DAG of program `key`: (name, *arguments)."""
    b = Builder()
    _PROGRAM_FNS[key[0]](b, *key[1:])
    return b


def _pow_abs_x(dst: str, src: str) -> list[tuple]:
    """dst = src^|x| (src stays): square and multiply over the bits of |x|
    below the top one, the squarings cyclotomic."""
    out = [("copy", dst, src)]
    for bit in X_BITS:
        out.append(("cyclo", dst, dst))
        if bit:
            out.append(("mul", dst, dst, src))
    return out


def _miller_keys(pairs: tuple | None = None) -> list[tuple]:
    """The Miller loop as program keys: the set-up, an iteration a bit of
    |x|, f conjugated; over `pairs` (None: the check's keys, both pairs)."""
    extra = () if pairs is None else (pairs,)
    return [("setup", *extra)] + [("miller", bool(bit), *extra) for bit in X_BITS] + [("conj_f",)]


def _script_keys() -> list:
    """The whole check as program keys (and INV), in order: the register
    F is the Miller loop's f, then the easy part's m."""
    keys: list = _miller_keys()
    keys += [("inv_a",), INV, ("inv_b",)]
    # the oracle's chain for 3(p⁴ - p² + 1)/r with m in F:
    keys += _pow_abs_x("A", "F")  # a = m^|x|
    keys += _pow_abs_x("B", "A")  # b = m^(x²)
    keys += [("cyclo", "A", "A"), ("mul", "B", "B", "A"), ("mul", "B", "B", "F")]  # g = m^((x - 1)²)
    keys += _pow_abs_x("A", "B")  # g^|x|
    keys += [("conj", "A", "A"), ("frob_p", "C", "B"), ("mul", "B", "A", "C")]  # h = g^(x + p)
    keys += _pow_abs_x("A", "B") + _pow_abs_x("C", "A")  # h^(x²)
    keys += [("frob_p2", "A", "B"), ("mul", "C", "C", "A"), ("conj", "A", "B"),
             ("mul", "C", "C", "A")]  # h^(x² + p² - 1)
    keys += [("cyclo", "A", "F"), ("mul", "A", "A", "F"), ("mul", "C", "C", "A")]  # ·m³
    return keys


GT_REG = "C"  # the register that holds the GT element at the end
MILLER_LEN = len(_miller_keys())  # the check's script opens with its Miller loop
# the multi-pairing's own programs: the Miller loop of a lone last pair, and
# F <- F·A, the product of two groups' f values
MILLER1_KEYS = _miller_keys((1,))
FMUL_KEY = ("mul", "F", "F", "A")


# ---------------------------------------------------------------------------
# Scheduling and slot allocation
# ---------------------------------------------------------------------------


class Program:
    """A scheduled program: rows of (kind, [(dst, a, b, sub), ...]), slots
    resolved; `temps` the temporaries it uses; `products` its Fp products
    by tag."""

    def __init__(self, key, rows, temps, products):
        self.key, self.rows, self.temps, self.products = key, rows, temps, products


def _users(b: Builder) -> list[list[int]]:
    users: list[list[int]] = [[] for _ in b.ops]
    for i, (_, srcs, _, _) in enumerate(b.ops):
        for v in set(srcs):
            if v >= 0:
                users[v].append(i)
    return users


def _schedule(b: Builder) -> list[list[int]]:
    """Rows of op indices: each row one kind, at most G ops whose
    operands all come from earlier rows, the ready ops on the longest
    remaining path (by cost) first. A row of products waits while a ready
    sum still leads to a product that is not ready, so that a level's
    products share rows (a row of sums costs a seventh of one of products)."""
    n = len(b.ops)
    users = _users(b)
    prio = [0] * n
    feeds = [False] * n  # a sum whose value reaches a product through sums only
    for i in range(n - 1, -1, -1):
        prio[i] = _COST[b.ops[i][0]] + max((prio[u] for u in users[i]), default=0)
        feeds[i] = any(b.ops[u][0] == MUL or feeds[u] for u in users[i])
    waiting = [sum(1 for v in set(srcs) if v >= 0) for (_, srcs, _, _) in b.ops]
    ready = {i for i in range(n) if waiting[i] == 0}
    rows = []
    while ready:
        muls = [i for i in ready if b.ops[i][0] == MUL]
        sums = [i for i in ready if b.ops[i][0] != MUL]
        kind = MUL if muls and (len(muls) >= G or not any(feeds[i] for i in sums)) else ADDSUB
        if not (sums if kind == ADDSUB else muls):
            kind = MUL
        row = sorted(muls if kind == MUL else sums, key=lambda i: (-prio[i], i))[:G]
        rows.append(row)
        ready -= set(row)
        for i in row:
            for u in users[i]:
                waiting[u] -= 1
                if waiting[u] == 0:
                    ready.add(u)
    assert sum(map(len, rows)) == n, "a cycle in a program"
    return rows


def _prune(b: Builder) -> None:
    """Drop the ops no output needs (an Fp12 formula's unused halves), and
    renumber."""
    live = set()
    stack = [v for v in b.outs.values() if v >= 0]
    while stack:
        v = stack.pop()
        if v in live:
            continue
        live.add(v)
        stack += [x for x in b.ops[v][1] if x >= 0]
    keep = sorted(live)
    new = {old: i for i, old in enumerate(keep)}
    ren = lambda v: v if v < 0 else new[v]  # noqa: E731
    b.ops = [(k, tuple(map(ren, srcs)), signs, t) for (k, srcs, signs, t) in (b.ops[i] for i in keep)]
    b.outs = {slot: ren(v) for slot, v in b.outs.items()}


def _allocate(b: Builder, rows: list[list[int]]) -> tuple[list, int]:
    """Slots for the scheduled ops. A temporary's slot is reused only from
    the row after its value's last read; an output is made in its pinned
    slot where the value it replaces was last read in an earlier row, else
    in a temporary and copied at the end (a sum with ZERO). Returns the rows
    with slots, and the temporaries used."""
    n = len(b.ops)
    row_of = {i: r for r, row in enumerate(rows) for i in row}
    end = len(rows)  # outputs are read "at the end"
    last = [-1] * n  # last row reading op i's value
    pin_last: dict[int, int] = {}  # pinned slot -> last row reading its starting value
    for i, (_, srcs, _, _) in enumerate(b.ops):
        for v in srcs:
            if v >= 0:
                last[v] = max(last[v], row_of[i])
            else:
                pin_last[-1 - v] = max(pin_last.get(-1 - v, -1), row_of[i])
    want = {}  # op -> pinned slot it should be made in
    copies = []  # (pinned slot, source value) to copy at the end
    for slot, v in sorted(b.outs.items()):
        if v >= 0 and v not in want and pin_last.get(slot, -1) < row_of[v]:
            want[v] = slot
        elif not (v < 0 and -1 - v == slot):
            copies.append((slot, v))
    made_in_place = set(want.values())
    for slot, v in copies:
        assert v >= 0 or -1 - v not in made_in_place, "a copy from a slot the program overwrites"
        if v >= 0:
            last[v] = end
        else:
            pin_last[-1 - v] = end
    slot_of: dict[int, int] = {}
    free: list[int] = []
    n_temps = 0
    expire: dict[int, list[int]] = {}
    for i in range(n):
        if i not in want:
            expire.setdefault(last[i], []).append(i)
    res = lambda v: -1 - v if v < 0 else slot_of[v]  # noqa: E731
    out_rows = []
    for r, row in enumerate(rows):
        for i in expire.get(r - 1, []):
            if i in slot_of:
                free.append(slot_of[i])
        free.sort(reverse=True)
        ops = []
        for i in row:
            _, srcs, signs, _ = b.ops[i]
            if i in want:
                slot_of[i] = want[i]
            else:
                if not free:
                    free.append(N_PINNED + n_temps)
                    n_temps += 1
                slot_of[i] = free.pop()
            ops.append((slot_of[i], tuple(map(res, srcs)), signs))
        out_rows.append((b.ops[row[0]][0], ops))
    if copies:
        zero = PINNED["ZERO"]
        for k in range(0, len(copies), G):
            out_rows.append((ADDSUB, [(slot, (res(v), zero), (0,)) for slot, v in copies[k:k + G]]))
    return out_rows, n_temps


@lru_cache(maxsize=None)
def program(key: tuple) -> Program:
    b = build(key)
    _prune(b)
    rows, temps = _allocate(b, _schedule(b))
    products: dict[str, int] = {}
    for kind, _, _, tag in b.ops:
        if kind == MUL:
            products[tag] = products.get(tag, 0) + 1
    return Program(key, rows, temps, products)


@lru_cache(maxsize=None)
def compiled() -> dict:
    """The check's script and its programs, in the order of their first
    use, then the multi-pairing's: {"programs": [Program], "script": [program
    index or INV] (the check), "script1": [program index] (a lone pair's
    Miller loop), "fmul": the index of F <- F·A, "slots"}."""
    keys = _script_keys()
    order: list = []
    for k in keys + MILLER1_KEYS + [FMUL_KEY]:
        if k != INV and k not in order:
            order.append(k)
    progs = [program(k) for k in order]
    index = {k: i for i, k in enumerate(order)}
    return {"programs": progs, "script": [INV if k == INV else index[k] for k in keys],
            "script1": [index[k] for k in MILLER1_KEYS], "fmul": index[FMUL_KEY],
            "slots": N_PINNED + max(p.temps for p in progs)}


# ---------------------------------------------------------------------------
# Over Python integers: the programs' semantics, and a whole check
# ---------------------------------------------------------------------------


def run_program(prog: Program, slots: list[int]) -> None:
    """One program over a check's slots (Montgomery residues, ints): each
    row's ops read before any writes, as the lanes of a row do."""
    for kind, ops in prog.rows:
        if kind == MUL:
            vals = [slots[a] * slots[b] * RINV % P for _, (a, b), _ in ops]
        else:
            vals = [(slots[a] - slots[b] if sub else slots[a] + slots[b]) % P for _, (a, b), (sub,) in ops]
        for (d, _, _), v in zip(ops, vals):
            slots[d] = v


def _load(loads, row_vals: list[int], table_vals: list[int]) -> list[int]:
    """A group's slots after the kernel's loads: the row values it has (a
    load past them is skipped, as in the kernel), the table's, zero."""
    slots = [0] * compiled()["slots"]
    for slot, src, i in loads:
        if src == "zero":
            slots[slot] = 0
        elif src == "table":
            slots[slot] = table_vals[i]
        elif i < len(row_vals):
            slots[slot] = row_vals[i]
    return slots


def _run_script(entries, slots: list[int]) -> None:
    c = compiled()
    for entry in entries:
        if entry == INV:
            n = slots[PINNED["N"]]
            slots[PINNED["N"]] = pow(n * RINV, P - 2, P) * R384 % P  # (a·R)^-1 -> a^-1·R
        else:
            run_program(c["programs"][entry], slots)


def _register(slots: list[int], reg: str) -> list[int]:
    return [slots[PINNED[f"{reg}_{i}"]] for i in range(12)]


def _gt_result(slots: list[int], table_vals: list[int]) -> tuple[bool, list[int]]:
    gt = _register(slots, GT_REG)
    return gt == [table_vals[0]] + [0] * 11, gt


def run_check(row_vals: list[int], table_vals: list[int]) -> tuple[bool, list[int]]:
    """The kernel's check over Python ints: the row's ten and the table's
    Fp values (Montgomery residues) -> (ok, the GT element's 12 Fp values,
    Montgomery, in the tower's flat order)."""
    slots = _load(LOADS, row_vals, table_vals)
    _run_script(compiled()["script"], slots)
    return _gt_result(slots, table_vals)


def multi_groups(k: int) -> list[int]:
    """The pairs of each group of a K-pair multi-pairing: two a group, the
    last alone when K is odd."""
    return [min(2, k - i) for i in range(0, k, 2)]


def run_multi(pair_vals: list[list[int]], table_vals: list[int]) -> tuple[bool, list[int]]:
    """The multi-pairing kernel over Python ints: K pairs' six Fp values
    each (Montgomery) -> (∏ e(P, Q) == 1, the GT element). Each group of two
    pairs runs the check's Miller loop, a lone last pair the one-pair loop;
    then the groups' f values meet by the kernel's tree (a level's pairs of
    nodes multiplied, F <- F·A, a lone last node carried up) and the root
    runs the check's final exponentiation."""
    c = compiled()
    fs = []
    for g, n in enumerate(multi_groups(len(pair_vals))):
        slots = _load(MP_LOADS, [v for pair in pair_vals[2 * g : 2 * g + n] for v in pair], table_vals)
        _run_script(c["script"][:MILLER_LEN] if n == 2 else c["script1"], slots)
        fs.append(_register(slots, "F"))
    while len(fs) > 1:
        level = []
        for left, right in zip(fs[::2], fs[1::2]):
            for i in range(12):
                slots[PINNED[f"F_{i}"]], slots[PINNED[f"A_{i}"]] = left[i], right[i]
            run_program(c["programs"][c["fmul"]], slots)
            level.append(_register(slots, "F"))
        fs = level + fs[len(level) * 2 :]
    for i, v in enumerate(fs[0]):
        slots[PINNED[f"F_{i}"]] = v
    _run_script(c["script"][MILLER_LEN:], slots)
    return _gt_result(slots, table_vals)


def tree_depth(groups: int) -> int:
    """Products on the critical path of the kernel's tree over `groups`
    groups: ⌈log2 groups⌉."""
    return (groups - 1).bit_length()


def _multi_entries(k: int) -> tuple[list, list]:
    """A K-pair multi-pairing's program runs: (every group's, the tree's
    ⌈K/2⌉ - 1 products and the final exponentiation; the critical path: the
    longest group's, the tree's depth in products, the final
    exponentiation)."""
    c = compiled()
    groups = [c["script"][:MILLER_LEN] if n == 2 else c["script1"] for n in multi_groups(k)]
    final = c["script"][MILLER_LEN:]
    every = [e for g in groups for e in g] + [c["fmul"]] * (len(groups) - 1) + final
    return every, max(groups, key=len) + [c["fmul"]] * tree_depth(len(groups)) + final


def _products(entries) -> dict[str, int]:
    c = compiled()
    out: dict[str, int] = {}
    for entry in entries:
        if entry != INV:
            for tag, n in c["programs"][entry].products.items():
                out[tag] = out.get(tag, 0) + n
    return out


def _rows(entries) -> dict[str, int]:
    c = compiled()
    out = {MUL: 0, ADDSUB: 0}
    for entry in entries:
        if entry != INV:
            for kind, _ in c["programs"][entry].rows:
                out[kind] += 1
    return {"mul": out[MUL], "addsub": out[ADDSUB], "inversions": list(entries).count(INV)}


def script_products() -> dict[str, int]:
    """Fp products of a whole check by tag (the inversion not included)."""
    return _products(compiled()["script"])


def critical_rows() -> dict[str, int]:
    """Rows of each kind a whole check runs, one after another (with the
    inversion apart)."""
    return _rows(compiled()["script"])


def multi_products(k: int) -> dict[str, int]:
    """Fp products of a K-pair multi-pairing by tag, every group's (the
    inversion not included)."""
    return _products(_multi_entries(k)[0])


def multi_critical_rows(k: int) -> dict[str, int]:
    """Rows of each kind on a K-pair multi-pairing's critical path: one
    group's Miller loop (the groups run side by side), the tree's depth in
    products and the final exponentiation."""
    return _rows(_multi_entries(k)[1])


# ---------------------------------------------------------------------------
# The header
# ---------------------------------------------------------------------------


def header_text() -> str:
    c = compiled()
    ops, rows, at = [], [], [0]
    for p in c["programs"]:
        for kind, row in p.rows:
            assert len(row) <= G and len(ops) < 1 << 24
            rows.append(kind | len(row) << 1 | len(ops) << 8)
            for d, (a, b), signs in row:
                assert max(d, a, b) < 1 << 10
                ops.append(d | a << 10 | b << 20 | (signs[0] if signs else 0) << 30)
        at.append(len(rows))
    assert len(c["programs"]) < INV

    def words(vals, per=8) -> str:
        return "\n".join("    " + " ".join(f"{v:#x}u," for v in vals[i:i + per]) for i in range(0, len(vals), per))

    counts = critical_rows()
    load_src = {"zero": 0, "row": 1, "table": 2}
    lines = [
        "// Generated by fisco_bcos_tpu_torch/ops/bls12_381_programs.py; do not edit.",
        "// python -m fisco_bcos_tpu_torch.ops.bls12_381_programs writes it again.",
        f"// {len(c['programs'])} programs, {len(rows)} rows, {len(ops)} ops; a check runs",
        f"// {len(c['script'])} programs: {counts['mul']} rows of products, {counts['addsub']} rows of sums,",
        f"// and {counts['inversions']} Fp inversion. A multi-pairing's groups run the check's Miller",
        "// loop, entries [0, BLS_SCRIPT_FINAL), or a lone pair's, [BLS_SCRIPT_MILLER1,",
        "// BLS_SCRIPT_MILLER1_END); its product group the entry BLS_SCRIPT_FMUL a group, then",
        "// [BLS_SCRIPT_FINAL, BLS_SCRIPT_LEN).",
        "",
        "#ifndef FISCO_BLS12_381_PROGRAMS_CUH",
        "#define FISCO_BLS12_381_PROGRAMS_CUH",
        "",
        f"#define BLS_G {G}",
        f"#define BLS_SLOTS {c['slots']}",
        f"#define BLS_PINNED {N_PINNED}",
        f"#define BLS_N_PROGS {len(c['programs'])}",
        f"#define BLS_N_ROWS {len(rows)}",
        f"#define BLS_N_OPS {len(ops)}",
        f"#define BLS_SCRIPT_LEN {len(c['script'])}",
        f"#define BLS_SCRIPT_FINAL {MILLER_LEN}  // the final exponentiation's first entry",
        f"#define BLS_SCRIPT_MILLER1 {len(c['script'])}",
        f"#define BLS_SCRIPT_MILLER1_END {len(c['script']) + len(c['script1'])}",
        f"#define BLS_SCRIPT_FMUL {len(c['script']) + len(c['script1'])}  // F <- F·A",
        f"#define BLS_N_LOADS {len(LOADS)}",
        f"#define BLS_N_MP_LOADS {len(MP_LOADS)}",
        f"#define BLS_INV {INV}",
        f"#define BLS_S_N {PINNED['N']}",
        f"#define BLS_S_GT {PINNED[GT_REG + '_0']}",
        f"#define BLS_S_ONE {PINNED['ONE']}",
        f"#define BLS_S_F {PINNED['F_0']}",
        f"#define BLS_S_A {PINNED['A_0']}",
        "",
        "// a row: kind (bit 0: 0 products, 1 sums), ops (bits 1-7), first op (bits 8-31);",
        "// an op: d | a << 10 | b << 20 | sub << 30 over slots",
        "BLS_PROG_ARRAY(u32, BLS_ROWS) = {",
        words(rows),
        "};",
        "BLS_PROG_ARRAY(u32, BLS_OPS) = {",
        words(ops),
        "};",
        "// program i is rows [BLS_PROG_AT[i], BLS_PROG_AT[i + 1])",
        "BLS_PROG_ARRAY(u32, BLS_PROG_AT) = {",
        words(at, 12),
        "};",
        "// the check: program indices in order, BLS_INV the Fp inversion of slot BLS_S_N;",
        "// then a lone pair's Miller loop, and F <- F·A",
        "BLS_PROG_ARRAY(uint8_t, BLS_SCRIPT) = {",
        words(c["script"] + c["script1"] + [c["fmul"]], 16),
        "};",
        "// slot | source << 10 | index << 12 (source 0 zero, 1 the row, 2 the table)",
        "BLS_PROG_ARRAY(u32, BLS_LOADS) = {",
        words([s | load_src[src] << 10 | i << 12 for s, src, i in LOADS]),
        "};",
        "// a multi-pairing group's loads, the same form",
        "BLS_PROG_ARRAY(u32, BLS_MP_LOADS) = {",
        words([s | load_src[src] << 10 | i << 12 for s, src, i in MP_LOADS]),
        "};",
        "",
        "#endif  // FISCO_BLS12_381_PROGRAMS_CUH",
        "",
    ]
    return "\n".join(lines)


def main() -> int:
    HEADER.write_text(header_text())
    print(f"wrote {HEADER}: {critical_rows()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
