"""Ed25519 (RFC 8032) — pure-Python reference implementation, the port's
own copy (hashlib only).

Reference role: bcos-crypto/signature/ed25519/Ed25519Crypto.cpp (wedpr FFI).
In the port it is the oracle that the batch verification of
``ops/ed25519.py`` (the plain PyTorch version and the CUDA kernel) is held
against, and the single-item leg of the suite's ``Ed25519Crypto``:
``seed_to_pubkey``, ``sign`` and ``verify``.

Textbook RFC 8032 math: edwards25519 in extended homogeneous coordinates,
SHA-512 from hashlib, little-endian point compression with the x-parity bit.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, -1, P)) % P

_BY = 4 * pow(5, -1, P) % P
_BX = None  # derived below


def _sha512(data: bytes) -> bytes:
    return hashlib.sha512(data).digest()


def _inv(x: int) -> int:
    return pow(x, P - 2, P)


def _recover_x(y: int, sign: int) -> int | None:
    """x from y via the curve equation; None if y is off-curve."""
    x2 = (y * y - 1) * _inv(D * y * y + 1) % P
    if x2 == 0:
        return 0 if sign == 0 else None
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * pow(2, (P - 1) // 4, P) % P
    if (x * x - x2) % P != 0:
        return None
    if x & 1 != sign:
        x = P - x
    return x


_BX = _recover_x(_BY, 0)
BASE = (_BX, _BY, 1, _BX * _BY % P)  # extended (X, Y, Z, T)
IDENT = (0, 1, 1, 0)


def _add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    dd = 2 * z1 * z2 % P
    e, f, g, h = b - a, dd - c, dd + c, b + a
    return e * f % P, g * h % P, f * g % P, e * h % P


def _mul(s: int, p):
    q = IDENT
    while s > 0:
        if s & 1:
            q = _add(q, p)
        p = _add(p, p)
        s >>= 1
    return q


def _compress(p) -> bytes:
    x, y, z, _ = p
    zi = _inv(z)
    x, y = x * zi % P, y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _decompress(data: bytes):
    if len(data) != 32:
        return None
    yv = int.from_bytes(data, "little")
    sign = yv >> 255
    yv &= (1 << 255) - 1
    if yv >= P:
        return None
    x = _recover_x(yv, sign)
    if x is None:
        return None
    return (x, yv, 1, x * yv % P)


def _eq_points(p, q) -> bool:
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


def _clamp(h: bytes) -> int:
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def seed_to_pubkey(seed: bytes) -> bytes:
    """32-byte seed -> 32-byte compressed public key."""
    a = _clamp(_sha512(seed))
    return _compress(_mul(a, BASE))


def sign(seed: bytes, msg: bytes) -> bytes:
    h = _sha512(seed)
    a = _clamp(h)
    prefix = h[32:]
    apub = _compress(_mul(a, BASE))
    r = int.from_bytes(_sha512(prefix + msg), "little") % L
    rpt = _compress(_mul(r, BASE))
    k = int.from_bytes(_sha512(rpt + apub + msg), "little") % L
    s = (r + k * a) % L
    return rpt + s.to_bytes(32, "little")


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    if len(sig) != 64:
        return False
    a_pt = _decompress(pub)
    r_pt = _decompress(sig[:32])
    if a_pt is None or r_pt is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False  # malleability guard (RFC 8032 §5.1.7)
    k = int.from_bytes(_sha512(sig[:32] + pub + msg), "little") % L
    # 8*S*B == 8*R + 8*k*A (cofactored verification)
    lhs = _mul(8 * s, BASE)
    rhs = _add(_mul(8, r_pt), _mul(8 * k % (8 * L), a_pt))
    return _eq_points(lhs, rhs)
