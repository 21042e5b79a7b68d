"""Pure-Python BLS12-381 reference: tower fields, curves, optimal-ate
pairing, aggregate BLS signatures — the port's copy of the JAX package's
``crypto/ref/bls12_381.py``, the host oracle of the port's pairing check
(``ops/bls12_381.py``, ``csrc/bls12_381.cu``) and of ``crypto/bls.py``'s
single-item calls.

This is the QC subsystem's bit-exact ground truth (the role
crypto/ref/ed25519.py plays for the Ed25519 plane): single-item sign /
verify / aggregate run here, and the pairing kernel and its plain PyTorch
version are pinned against these functions in tests. Design choices made for verifiability
over cleverness:

- **Fp12 in one polynomial basis.** Fp12 = Fp[w]/(w^12 - 2w^6 + 2)
  (w^6 = 1 + u, u^2 = -1 — the standard tower flattened), so
  multiplication is generic polynomial arithmetic and inversion is the
  extended Euclid over Fp[w]: no hand-copied tower inversion formulas on
  the reference path. The device kernel uses the Karatsuba tower; tests
  cross-check it against this basis through the (trivial) change-of-basis.
- **Miller loop with the G2 accumulator on the twist.** T stays in
  affine Fp2 on E': y^2 = x^3 + 4(1+u); the line through untwisted points
  is assembled directly in its sparse w-basis form (coefficients at
  w^0/w^2/w^3 after the w^3 normalization — every normalization factor
  lies in a subfield of Fp12 killed by the final exponentiation, the
  standard denominator-elimination argument).
- **Hard part by the BLS12 chain, verified symbolically.** The exponent
  identity 3(p^4-p^2+1)/r = (x-1)^2 (x+p) (x^2+p^2-1) + 3 is asserted
  over Python ints at import; exponentiating by the 3x multiple is sound
  because GT has prime order r != 3 (cubing is a bijection). Conjugation
  serves as inversion only after the easy part (cyclotomic subgroup).
- **Derived, not transcribed, group orders.** The G2 cofactor is found
  by testing the six possible twist orders against sample curve points
  (exact integer arithmetic, cached) instead of pasting a 500-bit
  constant; the published h1 = (x-1)^2/3 is functionally asserted before
  use. A memory-slip in a magic number can't ship silently.
- **hash-to-G2 is deterministic try-and-increment** (SHA-256 counter
  expansion, complex-method Fp2 sqrt, cofactor clearing) — NOT RFC 9380
  SSWU: this chain defines its own QC wire format and needs determinism
  and uniform committee agreement, not cross-ecosystem interop. The
  isogeny constant tables RFC 9380 needs are exactly the kind of
  transcription this module refuses to depend on. Swapping in SSWU later
  only changes this one function.

Scheme: minimal-pubkey-size BLS (pubkeys in G1, 48-byte compressed;
signatures in G2, 96-byte compressed), same-message aggregation — the
quorum-certificate case where every vote signs one header hash, so one
pairing check e(g1, agg_sig) == e(agg_pk, H(m)) admits the whole quorum.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R_ORDER = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
X_PARAM = -0xD201000000010000  # the (negative) BLS parameter x
B_G1 = 4  # E:  y^2 = x^3 + 4
B_G2 = (4, 4)  # E': y^2 = x^3 + 4(1+u)

G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
G2_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

# the hard-part identity the final exponentiation chain implements; if it
# ever failed the chain below would be silently wrong, so it is proved
# over exact ints before anything imports far enough to call pairing()
assert (
    (X_PARAM - 1) ** 2 * (X_PARAM + P) * (X_PARAM**2 + P**2 - 1) + 3
    == 3 * ((P**4 - P**2 + 1) // R_ORDER)
), "BLS12 hard-part exponent decomposition does not hold"
assert P % 4 == 3  # Fp sqrt via a^((p+1)/4)
assert (P - 1) % 6 == 0

# ---------------------------------------------------------------------------
# Fp
# ---------------------------------------------------------------------------


def fp_inv(a: int) -> int:
    return pow(a, P - 2, P) if a else 0


def fp_legendre(a: int) -> int:
    """1 for QR, -1 for non-residue, 0 for 0."""
    if a % P == 0:
        return 0
    return 1 if pow(a, (P - 1) // 2, P) == 1 else -1


def fp_sqrt(a: int) -> int | None:
    r = pow(a, (P + 1) // 4, P)
    return r if r * r % P == a % P else None


# ---------------------------------------------------------------------------
# Fp2 = Fp[u]/(u^2 + 1) — tuples (c0, c1)
# ---------------------------------------------------------------------------

F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (1, 1)  # the sextic non-residue 1 + u (w^6 = XI)


def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return (-a[0] % P, -a[1] % P)


def f2_mul(a, b):
    v0 = a[0] * b[0] % P
    v1 = a[1] * b[1] % P
    c1 = ((a[0] + a[1]) * (b[0] + b[1]) - v0 - v1) % P
    return ((v0 - v1) % P, c1)


def f2_sqr(a):
    return f2_mul(a, a)


def f2_muli(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def f2_inv(a):
    n = (a[0] * a[0] + a[1] * a[1]) % P
    ni = fp_inv(n)
    return (a[0] * ni % P, -a[1] * ni % P)


def f2_conj(a):
    return (a[0], -a[1] % P)


def f2_is_zero(a) -> bool:
    return a[0] % P == 0 and a[1] % P == 0


def f2_sqrt(a):
    """Complex-method square root in Fp2 (p ≡ 3 mod 4); None when `a` is
    a non-residue. The candidate is always re-checked by squaring, so a
    wrong branch can only return None, never a bad root."""
    a = (a[0] % P, a[1] % P)
    if a == F2_ZERO:
        return F2_ZERO
    if a[1] == 0:
        r = fp_sqrt(a[0])
        if r is not None:
            return (r, 0)
        r = fp_sqrt(-a[0] % P)  # (u*t)^2 = -t^2
        return (0, r) if r is not None else None
    n = (a[0] * a[0] + a[1] * a[1]) % P
    alpha = fp_sqrt(n)
    if alpha is None:
        return None
    inv2 = fp_inv(2)
    for al in (alpha, -alpha % P):
        delta = (a[0] + al) * inv2 % P
        x0 = fp_sqrt(delta)
        if x0 is None or x0 == 0:
            continue
        x1 = a[1] * fp_inv(2 * x0 % P) % P
        cand = (x0, x1)
        if f2_sqr(cand) == a:
            return cand
    return None


def f2_sign(a) -> int:
    """Deterministic sign for compression: 1 when `a` is the
    lexicographically larger of {a, -a} (c1 first, then c0)."""
    if a[1] % P != 0:
        return 1 if a[1] % P > (P - 1) // 2 else 0
    return 1 if a[0] % P > (P - 1) // 2 else 0


# ---------------------------------------------------------------------------
# Short-Weierstrass affine groups over a pluggable field (Fp and Fp2)
# ---------------------------------------------------------------------------
# Points are (x, y) tuples or None for infinity. A field is described by a
# small ops record so ONE set of formulas serves both curves — formula
# duplication is how sign errors creep in.


class _FieldOps:
    __slots__ = ("add", "sub", "mul", "sqr", "inv", "neg", "muli", "b")

    def __init__(self, add, sub, mul, sqr, inv, neg, muli, b):
        self.add, self.sub, self.mul, self.sqr = add, sub, mul, sqr
        self.inv, self.neg, self.muli, self.b = inv, neg, muli, b


FP_OPS = _FieldOps(
    add=lambda a, b: (a + b) % P,
    sub=lambda a, b: (a - b) % P,
    mul=lambda a, b: a * b % P,
    sqr=lambda a: a * a % P,
    inv=fp_inv,
    neg=lambda a: -a % P,
    muli=lambda a, k: a * k % P,
    b=B_G1,
)

FP2_OPS = _FieldOps(
    add=f2_add,
    sub=f2_sub,
    mul=f2_mul,
    sqr=f2_sqr,
    inv=f2_inv,
    neg=f2_neg,
    muli=f2_muli,
    b=B_G2,
)


def ec_neg(pt, F: _FieldOps):
    return None if pt is None else (pt[0], F.neg(pt[1]))


def ec_double(pt, F: _FieldOps):
    if pt is None:
        return None
    x, y = pt
    lam = F.mul(F.muli(F.sqr(x), 3), F.inv(F.muli(y, 2)))
    x3 = F.sub(F.sqr(lam), F.muli(x, 2))
    y3 = F.sub(F.mul(lam, F.sub(x, x3)), y)
    return (x3, y3)


def ec_add(p1, p2, F: _FieldOps):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            return ec_double(p1, F)
        return None  # p2 == -p1
    lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
    x3 = F.sub(F.sub(F.sqr(lam), x1), x2)
    y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
    return (x3, y3)


def ec_mul_affine(pt, k: int, F: _FieldOps):
    """Plain affine double-and-add — the slow, obviously-correct ladder
    the Jacobian fast path is differential-tested against."""
    if k < 0:
        return ec_mul_affine(ec_neg(pt, F), -k, F)
    acc = None
    while k:
        if k & 1:
            acc = ec_add(acc, pt, F)
        pt = ec_double(pt, F)
        k >>= 1
    return acc


def _jac_double(X, Y, Z, F: _FieldOps):
    """dbl-2009-l (a = 0): 2M + 5S, inversion-free."""
    A = F.sqr(X)
    B = F.sqr(Y)
    C = F.sqr(B)
    D = F.muli(F.sub(F.sub(F.sqr(F.add(X, B)), A), C), 2)
    E = F.muli(A, 3)
    X3 = F.sub(F.sqr(E), F.muli(D, 2))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), F.muli(C, 8))
    Z3 = F.muli(F.mul(Y, Z), 2)
    return X3, Y3, Z3


def _jac_add_affine(X, Y, Z, x2, y2, F: _FieldOps):
    """madd-2007-bl mixed addition; falls back to doubling / infinity on
    the equal-x edge cases."""
    zero = F.sub(X, X)
    Z1Z1 = F.sqr(Z)
    U2 = F.mul(x2, Z1Z1)
    S2 = F.mul(F.mul(y2, Z), Z1Z1)
    H = F.sub(U2, X)
    r = F.muli(F.sub(S2, Y), 2)
    if H == zero:
        if r == zero:
            return _jac_double(X, Y, Z, F)
        return X, Y, zero  # P + (-P) = infinity
    HH = F.sqr(H)
    I = F.muli(HH, 4)
    J = F.mul(H, I)
    V = F.mul(X, I)
    X3 = F.sub(F.sub(F.sqr(r), J), F.muli(V, 2))
    Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.muli(F.mul(Y, J), 2))
    Z3 = F.sub(F.sub(F.sqr(F.add(Z, H)), Z1Z1), HH)
    return X3, Y3, Z3


def ec_mul(pt, k: int, F: _FieldOps):
    """Scalar multiplication via Jacobian double-and-add (one inversion at
    the end) — bit-identical in result to :func:`ec_mul_affine`, which
    tests pin."""
    if pt is None or k == 0:
        return None
    if k < 0:
        return ec_mul(ec_neg(pt, F), -k, F)
    x2, y2 = pt
    one = 1 if isinstance(x2, int) else F2_ONE
    zero = F.sub(x2, x2)
    X = Y = Z = None
    for bit in bin(k)[2:]:
        if X is not None:
            X, Y, Z = _jac_double(X, Y, Z, F)
        if bit == "1":
            if X is None:
                X, Y, Z = x2, y2, one  # affine seed, Z = 1
            elif Z == zero:
                X, Y, Z = x2, y2, one  # re-seed after P + (-P)
            else:
                X, Y, Z = _jac_add_affine(X, Y, Z, x2, y2, F)
    if Z == zero:
        return None
    zi = F.inv(Z)
    zi2 = F.sqr(zi)
    return F.mul(X, zi2), F.mul(Y, F.mul(zi, zi2))


def ec_on_curve(pt, F: _FieldOps) -> bool:
    if pt is None:
        return True
    x, y = pt
    if isinstance(F.b, int):  # Fp
        return y * y % P == (x * x % P * x + F.b) % P
    return F.sqr(y) == F.add(F.mul(F.sqr(x), x), F.b)


G1 = (G1_X, G1_Y)
G2 = (G2_X, G2_Y)
assert ec_on_curve(G1, FP_OPS), "G1 generator not on E"
assert ec_on_curve(G2, FP2_OPS), "G2 generator not on E'"


# ---------------------------------------------------------------------------
# Group orders / cofactors — derived, then functionally asserted
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def g1_cofactor() -> int:
    """h1 = (x-1)^2 / 3 (standard BLS12 fact), asserted against the curve:
    the full order h1*r must annihilate the generator."""
    h1, rem = divmod((X_PARAM - 1) ** 2, 3)
    assert rem == 0
    assert ec_mul(G1, h1 * R_ORDER, FP_OPS) is None, "G1 order formula wrong"
    return h1


@lru_cache(maxsize=None)
def g2_cofactor() -> int:
    """#E'(Fp2) / r, found by testing the six possible sextic-twist orders
    against sample twist points (exact arithmetic — no transcribed 500-bit
    constant to get wrong)."""
    import math

    n1 = g1_cofactor() * R_ORDER  # #E(Fp)
    t = P + 1 - n1  # Frobenius trace over Fp
    t2 = t * t - 2 * P  # trace over Fp2
    v2sq, rem = divmod(4 * P * P - t2 * t2, 3)
    assert rem == 0
    v2 = math.isqrt(v2sq)
    assert v2 * v2 == v2sq, "twist discriminant is not a perfect square"
    candidates = [P * P + 1 - t2, P * P + 1 + t2]
    for s_num in (t2 + 3 * v2, t2 - 3 * v2):
        if s_num % 2 == 0:  # only integral traces are candidates
            candidates += [P * P + 1 - s_num // 2, P * P + 1 + s_num // 2]
    samples = [_curve_point_g2(b"fisco-bls-order-probe-%d" % i) for i in (0, 1)]
    for n in candidates:
        if all(ec_mul(q, n, FP2_OPS) is None for q in samples):
            h2, rem = divmod(n, R_ORDER)
            assert rem == 0, "twist order not divisible by r"
            assert ec_mul(G2, n, FP2_OPS) is None
            return h2
    raise AssertionError("no candidate twist order annihilates E'(Fp2)")


def _expand(tag: bytes, msg: bytes, ctr: int) -> tuple[int, int]:
    """Deterministic (c0, c1) Fp2 x-candidate from SHA-256 counter blocks."""
    digs = [
        hashlib.sha256(tag + bytes([ctr, j]) + msg).digest() for j in range(4)
    ]
    c0 = int.from_bytes(digs[0] + digs[1], "big") % P
    c1 = int.from_bytes(digs[2] + digs[3], "big") % P
    return (c0, c1)


def _curve_point_g2(msg: bytes, tag: bytes = b"FISCO-BLS12381-G2-TAI:"):
    """Deterministic point on E'(Fp2) (NOT cofactor-cleared): smallest
    counter whose x-candidate lands on the curve."""
    for ctr in range(256):
        x = _expand(tag, msg, ctr)
        rhs = f2_add(f2_mul(f2_sqr(x), x), XI_B)
        y = f2_sqrt(rhs)
        if y is None:
            continue
        # canonical root: sign bit 0 (deterministic across implementations)
        if f2_sign(y):
            y = f2_neg(y)
        return (x, y)
    raise AssertionError("no curve point within 256 counters")  # p(fail)≈2^-256


XI_B = (4, 4)  # b' = 4 * (1 + u)


@lru_cache(maxsize=4096)
def hash_to_g2(msg: bytes):
    """Deterministic hash-to-G2: try-and-increment onto E'(Fp2), then
    cofactor clearing into the r-torsion. Cached: consensus signs/verifies
    the same header hash from every committee member."""
    pt = _curve_point_g2(msg)
    out = ec_mul(pt, g2_cofactor(), FP2_OPS)
    assert out is not None  # a curve point of full cofactor order would be
    return out


def subgroup_check_g1(pt) -> bool:
    return ec_on_curve(pt, FP_OPS) and ec_mul(pt, R_ORDER, FP_OPS) is None


def subgroup_check_g2(pt) -> bool:
    return ec_on_curve(pt, FP2_OPS) and ec_mul(pt, R_ORDER, FP2_OPS) is None


# ---------------------------------------------------------------------------
# Fp12 = Fp[w]/(w^12 - 2 w^6 + 2) — coefficient lists of 12 ints
# ---------------------------------------------------------------------------

F12_ONE = (1,) + (0,) * 11
F12_ZERO = (0,) * 12


def f12_from_fp2(c, k: int = 0):
    """Embed c = c0 + c1*u at basis position w^k: u = w^6 - 1, so the
    element is (c0 - c1)*w^k + c1*w^(k+6)."""
    out = [0] * 12
    out[k] = (c[0] - c[1]) % P
    out[k + 6] = c[1] % P
    return tuple(out)


def f12_mul(a, b):
    t = [0] * 23
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                t[i + j] += ai * bj
    # w^12 = 2 w^6 - 2
    for k in range(22, 11, -1):
        c = t[k]
        if c:
            t[k - 6] += 2 * c
            t[k - 12] -= 2 * c
    return tuple(v % P for v in t[:12])


def f12_sqr(a):
    return f12_mul(a, a)


def f12_neg(a):
    return tuple(-v % P for v in a)


def f12_muli(a, k: int):
    return tuple(v * k % P for v in a)


def f12_pow(a, e: int):
    if e < 0:
        return f12_pow(f12_inv(a), -e)
    out = F12_ONE
    while e:
        if e & 1:
            out = f12_mul(out, a)
        a = f12_sqr(a)
        e >>= 1
    return out


_W_POLY = (2, 0, 0, 0, 0, 0, -2, 0, 0, 0, 0, 0, 1)  # w^12 - 2w^6 + 2 (low→high)


def f12_inv(a):
    """Extended Euclid over Fp[w] modulo the defining polynomial — generic
    algebra, no tower inversion formulas to mistranscribe."""

    def pdiv(num, den):
        num = list(num)
        deg_d = max(i for i, v in enumerate(den) if v)
        inv_lead = fp_inv(den[deg_d])
        q = [0] * (len(num))
        for k in range(len(num) - 1, deg_d - 1, -1):
            if num[k] % P == 0:
                continue
            f = num[k] * inv_lead % P
            q[k - deg_d] = f
            for i, dv in enumerate(den[: deg_d + 1]):
                num[k - deg_d + i] = (num[k - deg_d + i] - f * dv) % P
        return q, [v % P for v in num[: deg_d if deg_d else 1]]

    # gcd(a, W) with Bezout tracking: s*a ≡ gcd (mod W)
    r0 = [v % P for v in _W_POLY]
    r1 = list(a) + [0]
    s0, s1 = [0], [1]
    while any(v % P for v in r1):
        q, rem = pdiv(r0, r1)
        r0, r1 = r1, rem + [0] * (len(r1) - len(rem))
        # s0 - q*s1
        prod = [0] * (len(q) + len(s1))
        for i, qv in enumerate(q):
            if qv:
                for j, sv in enumerate(s1):
                    prod[i + j] = (prod[i + j] + qv * sv) % P
        ns = [
            ((s0[i] if i < len(s0) else 0) - prod[i]) % P
            for i in range(max(len(s0), len(prod)))
        ]
        s0, s1 = s1, ns
    deg = max(i for i, v in enumerate(r0) if v % P)
    assert deg == 0, "input not invertible"
    scale = fp_inv(r0[0])
    out = [v * scale % P for v in s0[:12]] + [0] * max(0, 12 - len(s0))
    # s0 may exceed degree 11 before reduction: fold through the modulus
    extra = [v * scale % P for v in s0[12:]]
    full = list(out[:12]) + extra
    for k in range(len(full) - 1, 11, -1):
        c = full[k]
        if c:
            full[k - 6] = (full[k - 6] + 2 * c) % P
            full[k - 12] = (full[k - 12] - 2 * c) % P
    return tuple(v % P for v in full[:12])


@lru_cache(maxsize=None)
def frob_table(k: int):
    """(w^i)^(p^k) for i = 0..11, each as an Fp12 element — the Frobenius
    is Fp-linear (coefficients are Frobenius-fixed), so applying it is one
    constant matrix-vector product."""
    wp = f12_pow(tuple([0, 1] + [0] * 10), pow(P, k))
    out = [F12_ONE]
    for _ in range(11):
        out.append(f12_mul(out[-1], wp))
    return tuple(out)


def f12_frob(a, k: int):
    tab = frob_table(k)
    acc = F12_ZERO
    for i, ci in enumerate(a):
        if ci:
            acc = tuple(
                (av + ci * tv) % P for av, tv in zip(acc, tab[i])
            )
    return acc


# ---------------------------------------------------------------------------
# Optimal-ate pairing
# ---------------------------------------------------------------------------


def _line_sparse(lam, xt, yt, px: int, py: int):
    """The line through (un)twisted points, normalized by w^3: with the
    slope lam computed ON THE TWIST (Fp2), the line evaluated at the
    G1 point (px, py) is

        l * w^3 = (lam*xt - yt)  +  (-lam*px) w^2  +  py w^3

    (all normalization factors lie in killed subfields). Returned dense in
    the w-basis."""
    c0 = f2_sub(f2_mul(lam, xt), yt)  # Fp2 at w^0
    c2 = f2_muli(lam, -px % P)  # Fp2 * px at w^2
    out = [0] * 12
    out[0] = (c0[0] - c0[1]) % P
    out[6] = c0[1]
    out[2] = (c2[0] - c2[1]) % P
    out[8] = c2[1]
    out[3] = py % P
    return tuple(out)


def miller_loop(pairs) -> tuple:
    """Product of Miller loops f_{|x|, Qi}(Pi) for [(P_g1, Q_g2twist)]
    pairs, conjugated for the negative parameter. Accumulators stay in
    affine Fp2 on the twist; slopes cost one Fp2 inversion per step."""
    bits = bin(-X_PARAM)[2:]
    f = F12_ONE
    ts = [q for _, q in pairs]
    for bit in bits[1:]:
        f = f12_sqr(f)
        for i, (p1, _q) in enumerate(pairs):
            t = ts[i]
            lam = f2_mul(
                f2_muli(f2_sqr(t[0]), 3), f2_inv(f2_muli(t[1], 2))
            )
            f = f12_mul(f, _line_sparse(lam, t[0], t[1], p1[0], p1[1]))
            ts[i] = ec_double(t, FP2_OPS)
        if bit == "1":
            for i, (p1, q) in enumerate(pairs):
                t = ts[i]
                lam = f2_mul(
                    f2_sub(q[1], t[1]), f2_inv(f2_sub(q[0], t[0]))
                )
                f = f12_mul(f, _line_sparse(lam, t[0], t[1], p1[0], p1[1]))
                ts[i] = ec_add(t, q, FP2_OPS)
    return f12_frob(f, 6)  # x < 0: f ← f^(p^6) = conjugation


def _cyclo_pow_abs_x(a):
    """a^|x| for the cyclotomic-subgroup element a (plain square-multiply
    over the 64 static bits of |x|)."""
    out = None
    for bit in bin(-X_PARAM)[2:]:
        out = f12_sqr(out) if out is not None else None
        if out is None:
            out = a
            continue
        if bit == "1":
            out = f12_mul(out, a)
    return out


def final_exponentiation(f):
    """f^((p^12-1)/r) up to a fixed cube (see module docstring): easy part
    (p^6-1)(p^2+1), then the chain for 3(p^4-p^2+1)/r."""
    # easy part — after this, m is in the cyclotomic subgroup where
    # inversion is the p^6-Frobenius (conjugation)
    m = f12_mul(f12_frob(f, 6), f12_inv(f))
    m = f12_mul(f12_frob(m, 2), m)
    conj = lambda z: f12_frob(z, 6)  # noqa: E731 — cyclotomic inverse
    a1 = _cyclo_pow_abs_x(m)  # m^|x|
    mx2 = _cyclo_pow_abs_x(a1)  # m^(x^2)
    g = f12_mul(f12_mul(mx2, f12_sqr(a1)), m)  # m^((x-1)^2) (x<0: -2x=2|x|)
    h = f12_mul(conj(_cyclo_pow_abs_x(g)), f12_frob(g, 1))  # g^(x+p)
    hx2 = _cyclo_pow_abs_x(_cyclo_pow_abs_x(h))  # h^(x^2)
    k = f12_mul(f12_mul(hx2, f12_frob(h, 2)), conj(h))  # h^(x^2+p^2-1)
    return f12_mul(k, f12_mul(f12_sqr(m), m))  # k * m^3


def pairing_check(pairs) -> bool:
    """True iff Π e(Pi, Qi) == 1 for affine pairs (P in E(Fp), Q on the
    twist E'(Fp2)); infinity entries contribute the identity."""
    live = [(p, q) for p, q in pairs if p is not None and q is not None]
    if not live:
        return True
    return final_exponentiation(miller_loop(live)) == F12_ONE


def pairing(p1, q2):
    """e(P, Q) up to the fixed final-exponentiation cube — consistent for
    equality comparisons, which is all consensus needs."""
    if p1 is None or q2 is None:
        return F12_ONE
    return final_exponentiation(miller_loop([(p1, q2)]))


# ---------------------------------------------------------------------------
# Point compression (48-byte G1 / 96-byte G2, zcash-style header bits)
# ---------------------------------------------------------------------------

_FLAG_COMPRESSED = 0x80
_FLAG_INFINITY = 0x40
_FLAG_SIGN = 0x20


def compress_g1(pt) -> bytes:
    if pt is None:
        return bytes([_FLAG_COMPRESSED | _FLAG_INFINITY]) + b"\x00" * 47
    x, y = pt
    flags = _FLAG_COMPRESSED | (_FLAG_SIGN if y > (P - 1) // 2 else 0)
    raw = bytearray(x.to_bytes(48, "big"))
    raw[0] |= flags
    return bytes(raw)


def decompress_g1(buf: bytes):
    """48 bytes -> point; raises ValueError on malformed/off-curve/out-of-
    subgroup input (deserialization is the trust boundary)."""
    if len(buf) != 48 or not buf[0] & _FLAG_COMPRESSED:
        raise ValueError("bad G1 encoding")
    if buf[0] & _FLAG_INFINITY:
        if any(buf[1:]) or buf[0] & ~(_FLAG_COMPRESSED | _FLAG_INFINITY):
            raise ValueError("bad G1 infinity encoding")
        return None
    x = int.from_bytes(bytes([buf[0] & 0x1F]) + buf[1:], "big")
    if x >= P:
        raise ValueError("G1 x out of range")
    y = fp_sqrt((x * x % P * x + B_G1) % P)
    if y is None:
        raise ValueError("G1 x not on curve")
    if bool(buf[0] & _FLAG_SIGN) != (y > (P - 1) // 2):
        y = -y % P
    pt = (x, y)
    if not subgroup_check_g1(pt):
        raise ValueError("G1 point not in the r-torsion subgroup")
    return pt


def compress_g2(pt) -> bytes:
    if pt is None:
        return bytes([_FLAG_COMPRESSED | _FLAG_INFINITY]) + b"\x00" * 95
    (x0, x1), y = pt
    flags = _FLAG_COMPRESSED | (_FLAG_SIGN if f2_sign(y) else 0)
    raw = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    raw[0] |= flags
    return bytes(raw)


def decompress_g2(buf: bytes):
    if len(buf) != 96 or not buf[0] & _FLAG_COMPRESSED:
        raise ValueError("bad G2 encoding")
    if buf[0] & _FLAG_INFINITY:
        if any(buf[1:]) or buf[0] & ~(_FLAG_COMPRESSED | _FLAG_INFINITY):
            raise ValueError("bad G2 infinity encoding")
        return None
    x1 = int.from_bytes(bytes([buf[0] & 0x1F]) + buf[1:48], "big")
    x0 = int.from_bytes(buf[48:], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("G2 x out of range")
    x = (x0, x1)
    y = f2_sqrt(f2_add(f2_mul(f2_sqr(x), x), XI_B))
    if y is None:
        raise ValueError("G2 x not on twist")
    if bool(buf[0] & _FLAG_SIGN) != bool(f2_sign(y)):
        y = f2_neg(y)
    pt = (x, y)
    if not subgroup_check_g2(pt):
        raise ValueError("G2 point not in the r-torsion subgroup")
    return pt


# ---------------------------------------------------------------------------
# The signature scheme (min-pubkey-size, same-message aggregation)
# ---------------------------------------------------------------------------


def keygen(secret: int):
    """secret int -> (sk, 48-byte compressed pubkey). sk = secret mod r,
    clamped away from 0."""
    sk = secret % R_ORDER or 1
    return sk, compress_g1(ec_mul(G1, sk, FP_OPS))


def sign(sk: int, msg: bytes) -> bytes:
    return compress_g2(ec_mul(hash_to_g2(msg), sk, FP2_OPS))


def verify(pub48: bytes, msg: bytes, sig96: bytes) -> bool:
    try:
        pk = decompress_g1(pub48)
        s = decompress_g2(sig96)
    except ValueError:
        return False
    if pk is None or s is None:
        return False  # infinity pubkey/signature is degenerate, reject
    # e(g1, sig) == e(pk, H(m))  <=>  e(-g1, sig) * e(pk, H(m)) == 1
    return pairing_check(
        [(ec_neg(G1, FP_OPS), s), (pk, hash_to_g2(msg))]
    )


def aggregate_signatures(sigs: list[bytes]) -> bytes:
    acc = None
    for s in sigs:
        acc = ec_add(acc, decompress_g2(s), FP2_OPS)
    return compress_g2(acc)


def aggregate_pubkeys(pubs: list[bytes]) -> bytes:
    acc = None
    for p in pubs:
        acc = ec_add(acc, decompress_g1(p), FP_OPS)
    return compress_g1(acc)


def aggregate_verify(pubs: list[bytes], msg: bytes, agg_sig96: bytes) -> bool:
    """Same-message aggregate verification: one pairing check for the whole
    signer set. Rogue-key safety comes from the committee registration
    model (qc pubkeys are registered with the consensus committee =
    proof-of-possession trust), not from message separation."""
    if not pubs:
        return False
    try:
        apk = decompress_g1(aggregate_pubkeys(pubs))
        s = decompress_g2(agg_sig96)
    except ValueError:
        return False
    if apk is None or s is None:
        return False
    return pairing_check([(ec_neg(G1, FP_OPS), s), (apk, hash_to_g2(msg))])
