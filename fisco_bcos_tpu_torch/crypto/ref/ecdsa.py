"""Pure-Python elliptic-curve reference, the port's copy: secp256k1 ECDSA
(sign / verify / recover) and SM2 (GB/T 32918) sign / verify.

Mirrors the reference semantics:
- secp256k1: 65-byte signature r‖s‖v with recovery id v
  (bcos-crypto signature/secp256k1/Secp256k1Crypto.cpp:106-108 accepts
  v∈{27,28} or {0,1}); recover returns the uncompressed public key; address
  = rightmost 160 bits of hash(pubkey) (CryptoSuite.h:56-59).
- SM2: 64-byte signature r‖s with the public key appended for "recover"
  (bcos-crypto signature/sm2/SM2Crypto.cpp:58-62, :81-91 — recover =
  parse-pubkey-then-verify). e = SM3(ZA ‖ M) with the default user id.

This is the golden-vector source for the port's batch kernels, and the host
oracle that ``chip_smoke.py`` checks the card against.
"""

from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass

from .sm3 import sm3


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

SM2_CURVE = Curve(
    name="sm2p256v1",
    p=0xFFFFFFFEFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF00000000FFFFFFFFFFFFFFFF,
    a=0xFFFFFFFEFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF00000000FFFFFFFFFFFFFFFC,
    b=0x28E9FA9E9D9F5E344D5A9E4BCF6509A7F39789F515AB8F92DDBCBD414D940E93,
    gx=0x32C4AE2C1F1981195F9904466A39C9948FE30BBFF2660BE1715A4589334C74C7,
    gy=0xBC3736A2F4F6779C59BDCEE36B692153D0A9877CC62A474002DF32E52139F0A0,
    n=0xFFFFFFFEFFFFFFFFFFFFFFFFFFFFFFFF7203DF6B21C6052B53BBF40939D54123,
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


def ecdsa_verify(msg_hash: bytes, r: int, s: int, pub, c: Curve = SECP256K1) -> bool:
    if not (1 <= r < c.n and 1 <= s < c.n):
        return False
    if pub is None or not on_curve(c, pub):
        return False
    z = int.from_bytes(msg_hash, "big")
    w = _inv(s, c.n)
    u1 = z * w % c.n
    u2 = r * w % c.n
    R = point_add(c, point_mul(c, u1, (c.gx, c.gy)), point_mul(c, u2, pub))
    if R is None:
        return False
    return R[0] % c.n == r


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
    y = pow(y_sq, (c.p + 1) // 4, c.p)  # p ≡ 3 (mod 4) for both curves
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


# ---------------------------------------------------------------------------
# SM2 (GB/T 32918.2-2016 digital signatures)
# ---------------------------------------------------------------------------

SM2_DEFAULT_ID = b"1234567812345678"


def sm2_za_bytes(
    pub_xy: bytes,
    user_id: bytes = SM2_DEFAULT_ID,
    c: Curve = SM2_CURVE,
    sm3_fn=sm3,
) -> bytes:
    """ZA = SM3(ENTL ‖ ID ‖ a ‖ b ‖ Gx ‖ Gy ‖ Px ‖ Py); ``pub_xy`` is the
    64-byte x‖y encoding."""
    entl = (len(user_id) * 8).to_bytes(2, "big")
    data = (
        entl
        + user_id
        + c.a.to_bytes(32, "big")
        + c.b.to_bytes(32, "big")
        + c.gx.to_bytes(32, "big")
        + c.gy.to_bytes(32, "big")
        + pub_xy
    )
    return sm3_fn(data)


def sm2_e_bytes(
    pub_xy: bytes,
    msg_hash: bytes,
    user_id: bytes = SM2_DEFAULT_ID,
    sm3_fn=sm3,
) -> bytes:
    """e = SM3(ZA ‖ M) as 32 bytes; M is the 32-byte tx hash being signed."""
    return sm3_fn(sm2_za_bytes(pub_xy, user_id, sm3_fn=sm3_fn) + msg_hash)


def sm2_e(msg_hash: bytes, pub, user_id: bytes = SM2_DEFAULT_ID) -> int:
    px, py = pub
    return int.from_bytes(
        sm2_e_bytes(px.to_bytes(32, "big") + py.to_bytes(32, "big"), msg_hash, user_id),
        "big",
    )


def sm2_sign_e(e: int, d: int, k: int) -> tuple[int, int]:
    """The SM2 signature (r, s) of the digest integer e (any 256-bit value)
    under secret d with nonce k, not checked for a degenerate r or s."""
    c = SM2_CURVE
    r = (e + point_mul(c, k, (c.gx, c.gy))[0]) % c.n
    return r, _inv(1 + d, c.n) * (k - r * d) % c.n


def sm2_sign(msg_hash: bytes, d: int, user_id: bytes = SM2_DEFAULT_ID):
    c = SM2_CURVE
    pub = privkey_to_pubkey(c, d)
    e = sm2_e(msg_hash, pub, user_id)
    for retry in range(64):
        k = _rfc6979_k(c, d, e, retry)
        r, s = sm2_sign_e(e, d, k)
        if r == 0 or r + k == c.n or s == 0:
            continue  # fresh k via retry counter
        return (r, s)
    raise RuntimeError("sm2_sign: could not produce a signature")


def sm2_verify_e(e: int, r: int, s: int, pub) -> bool:
    """SM2 verification with the digest e = SM3(ZA ‖ M) given as an
    integer (any 256-bit value)."""
    c = SM2_CURVE
    if not (1 <= r < c.n and 1 <= s < c.n):
        return False
    if pub is None or not on_curve(c, pub):
        return False
    t = (r + s) % c.n
    if t == 0:
        return False
    P1 = point_add(c, point_mul(c, s, (c.gx, c.gy)), point_mul(c, t, pub))
    if P1 is None:
        return False
    return (e + P1[0]) % c.n == r


def sm2_verify(msg_hash: bytes, r: int, s: int, pub, user_id: bytes = SM2_DEFAULT_ID) -> bool:
    if pub is None or not on_curve(SM2_CURVE, pub):
        return False
    return sm2_verify_e(sm2_e(msg_hash, pub, user_id), r, s, pub)


def sm2_edge_e_rows(digests, n_rows: int, rng) -> list:
    """(e, r, s, pub) test rows for digest integers that no SM3 output
    reaches on purpose (e = 0, 2^256 - 1, n, ...): row j takes digest
    j mod len(digests) and, in turn for each pass over the digests, a valid
    signature of it, the same with s + 1, and the same with e flipped in
    bit 0. Keys and nonces come from ``rng`` (a ``random.Random``)."""
    c = SM2_CURVE
    rows = []
    for j in range(n_rows):
        e = digests[j % len(digests)]
        d, k = rng.randrange(1, c.n - 1), rng.randrange(1, c.n)
        pub = privkey_to_pubkey(c, d)
        r, s = sm2_sign_e(e, d, k)
        variant = (j // len(digests)) % 3
        if variant == 1:
            s = (s + 1) % c.n
        rows.append(((e ^ 1) if variant == 2 else e, r, s, pub))
    return rows
