"""Pure-Python secp256k1 ECDSA reference (sign / recover), the port's copy.

Mirrors the reference semantics:
- 65-byte signature r‖s‖v with recovery id v
  (bcos-crypto signature/secp256k1/Secp256k1Crypto.cpp:106-108 accepts
  v∈{27,28} or {0,1}); recover returns the uncompressed public key; address
  = rightmost 160 bits of hash(pubkey) (CryptoSuite.h:56-59).

This is the golden-vector source for the port's batch recover, and the host
oracle that ``chip_smoke.py`` checks the card against. SM2 stays with the
SM-suite slice.
"""

from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass


@dataclass(frozen=True)
class Curve:
    name: str
    p: int
    a: int
    b: int
    gx: int
    gy: int
    n: int


SECP256K1 = Curve(
    name="secp256k1",
    p=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
    a=0,
    b=7,
    gx=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    gy=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
    n=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
)

# Affine points are (x, y) int tuples; None is the point at infinity.


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)


def point_add(c: Curve, P, Q):
    if P is None:
        return Q
    if Q is None:
        return P
    x1, y1 = P
    x2, y2 = Q
    if x1 == x2:
        if (y1 + y2) % c.p == 0:
            return None
        lam = (3 * x1 * x1 + c.a) * _inv(2 * y1, c.p) % c.p
    else:
        lam = (y2 - y1) * _inv(x2 - x1, c.p) % c.p
    x3 = (lam * lam - x1 - x2) % c.p
    y3 = (lam * (x1 - x3) - y1) % c.p
    return (x3, y3)


def point_mul(c: Curve, k: int, P):
    k %= c.n
    R = None
    A = P
    while k:
        if k & 1:
            R = point_add(c, R, A)
        A = point_add(c, A, A)
        k >>= 1
    return R


def on_curve(c: Curve, P) -> bool:
    """On-curve check for CANONICAL affine coordinates: 0 <= x, y < p."""
    if P is None:
        return True
    x, y = P
    if not (0 <= x < c.p and 0 <= y < c.p):
        return False
    return (y * y - (x * x * x + c.a * x + c.b)) % c.p == 0


def privkey_to_pubkey(c: Curve, d: int):
    """Returns affine (x, y)."""
    return point_mul(c, d, (c.gx, c.gy))


def _rfc6979_k(c: Curve, d: int, z: int, retry: int = 0) -> int:
    """Deterministic nonce (RFC 6979, HMAC-SHA256) — reproducible test vectors.

    ``retry`` perturbs the derivation (extra entropy octet) so r==0/s==0 retry
    loops get a fresh nonce for the SAME message."""
    holen = 32
    x = d.to_bytes(32, "big")
    h1 = (z % c.n).to_bytes(32, "big")
    if retry:
        h1 += retry.to_bytes(4, "big")
    v = b"\x01" * holen
    k = b"\x00" * holen
    k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < c.n:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def ecdsa_sign(msg_hash: bytes, d: int, c: Curve = SECP256K1):
    """Returns (r, s, v) with low-s normalization; v ∈ {0,1,2,3} is the
    recovery id (bit 1 set only in the ~2^-128 case rx ≥ n)."""
    z = int.from_bytes(msg_hash, "big")
    for retry in range(64):
        k = _rfc6979_k(c, d, z, retry)
        R = point_mul(c, k, (c.gx, c.gy))
        assert R is not None
        rx, ry = R
        r = rx % c.n
        if r == 0:
            continue  # fresh k via retry counter; astronomically unlikely
        s = _inv(k, c.n) * (z + r * d) % c.n
        if s == 0:
            continue
        v = (ry & 1) | (2 if rx >= c.n else 0)
        if s > c.n // 2:
            s = c.n - s
            v ^= 1
        return (r, s, v)
    raise RuntimeError("ecdsa_sign: could not produce a signature")


def ecdsa_recover(msg_hash: bytes, r: int, s: int, v: int, c: Curve = SECP256K1):
    """Recover the public key; v may be 0-3 or 27/28-style. Returns (x, y) or None."""
    if v >= 27:
        v -= 27
    if not (0 <= v <= 3 and 1 <= r < c.n and 1 <= s < c.n):
        return None
    x = r + (c.n if v & 2 else 0)
    if x >= c.p:
        return None
    y_sq = (pow(x, 3, c.p) + c.a * x + c.b) % c.p
    y = pow(y_sq, (c.p + 1) // 4, c.p)  # p ≡ 3 (mod 4)
    if y * y % c.p != y_sq:
        return None
    if (y & 1) != (v & 1):
        y = c.p - y
    z = int.from_bytes(msg_hash, "big")
    rinv = _inv(r, c.n)
    # Q = r^-1 (s·R − z·G)
    Q = point_add(
        c,
        point_mul(c, s * rinv % c.n, (x, y)),
        point_mul(c, (-z) * rinv % c.n, (c.gx, c.gy)),
    )
    if Q is None or not on_curve(c, Q):
        return None
    return Q
