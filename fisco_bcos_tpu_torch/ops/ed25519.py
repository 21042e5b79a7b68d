"""Batch Ed25519 verification (RFC 8032, cofactored), the port of the JAX
package's ``ops/ed25519.py``.

The device does the whole check: each lane's SHA-512 challenge
k = H(R ‖ A ‖ M) mod L, negated, then every elliptic step, the two
decompressions, the dual ladder s·B + (L − k)·A, the R subtraction, the
cofactor 8 and the identity test, and returns one verdict bit a lane:

    ok = s < L and A, R decompress and 8·(s·B + (L − k)·A − R) == O.

(The JAX package hashes the challenges on the host, one hashlib call a
lane; :func:`challenges` keeps that as the oracle.)

The device input is one ``[B, 128]`` uint8 row a lane (:data:`ROW_BYTES`):
R ‖ S ‖ A ‖ k_neg, 32 little-endian bytes each, R and S as they come in the
signature and A as the key; the sign bits stay in the top bytes of R and A.
The host joins R ‖ S ‖ A (:func:`signature_rows`, k_neg zero) and packs the
messages (``hash_common.pack_messages``); :func:`challenge_device` writes
k_neg into the rows in place and :func:`verify_device` reads them. A CUDA
tensor goes to the hand-written kernels ``csrc/ed25519_challenge.cu`` and
``csrc/ed25519_verify.cu`` (which replaces the JAX program ``_verify_xla``),
a CPU tensor to :func:`challenge_plain` and :func:`verify_plain`, the plain
PyTorch versions below.

The plain version mirrors the JAX ``verify_core`` step for step on the
port's limb plane: 16-bit limbs in int64, the ring Z/2p (2p = 2^256 − 38, a
:class:`~.limb.FoldField` with c = 38) reduced to canonical mod p only where
values are compared or their parity is read, decompression by an inversion
and the p ≡ 5 (mod 8) square root, extended twisted-Edwards points (a = −1)
under the complete add-2008-hwcd-3 law, 64 unsigned 4-bit windows with a
15-entry runtime table of A and the host comb of B (:func:`b_comb_table`,
the JAX package's table). The kernel computes the same verdict by its own
method (one exponentiation a decompression, signed windows); a verdict is
one bit, so the two agree on every lane. Invalid lanes lower their bit and
never raise.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache

import numpy as np
import torch

from . import _kernels, limb
from .ec import WINDOW, _select15, scalar_windows
from .hash_common import bucket_batch, gather_padded, upload_packed
from .limb import FoldField, const_col, cond_sub, eq, int_to_rows, is_zero, lt, select
from .. import params
from ..crypto.ref import ed25519 as ref
from ..device import resolve_device
from ..observability.device import device_span

P = ref.P  # 2^255 - 19
L = ref.L
D = ref.D
TWO_P = 2 * P  # 2^256 - 38: the folding modulus
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1) mod p
ROW_BYTES = 128  # R ‖ S ‖ A ‖ k_neg, 32 little-endian bytes each


class EdOps:
    """The ring Z/2p and the constant columns of Ed25519 on one device."""

    def __init__(self, device):
        self.F = FoldField(TWO_P, device)
        self.p_col = const_col(int_to_rows(P), device)
        self.l_col = const_col(int_to_rows(L), device)
        self.d_col = const_col(int_to_rows(D), device)
        self.d2_col = const_col(int_to_rows(2 * D % P), device)
        self.sqrt_m1_col = const_col(int_to_rows(SQRT_M1), device)


@lru_cache(maxsize=None)
def ed_ops(device) -> EdOps:
    return EdOps(torch.device(device))


# ---------------------------------------------------------------------------
# Field helpers over Z/2p (the JAX :69-93)
# ---------------------------------------------------------------------------


def _canon(x: torch.Tensor, E: EdOps) -> torch.Tensor:
    """Z/2p residue (< 2p) -> canonical mod-p limbs (one conditional
    subtract)."""
    return cond_sub(x, E.p_col)


def eq_p(a: torch.Tensor, b: torch.Tensor, E: EdOps) -> torch.Tensor:
    return eq(_canon(a, E), _canon(b, E))


def _inv(a: torch.Tensor, E: EdOps) -> torch.Tensor:
    """a^-1 mod p (Fermat; 0 -> 0). The exponent is the mod-p one: the
    quotient map Z/2p -> Z/p makes the fold-domain powering valid."""
    return limb.pow_static(E.F, a, P - 2)


def _sqrt_p58(a: torch.Tensor, E: EdOps) -> tuple[torch.Tensor, torch.Tensor]:
    """Square root mod p for p ≡ 5 (mod 8): candidate c = a^((p+3)/8),
    times sqrt(-1) when c² == -a. Returns (root, is_square)."""
    F = E.F
    c = limb.pow_static(F, a, (P + 3) // 8)
    flip = eq_p(F.sqr(c), F.neg(a), E)
    c = select(flip, F.mul(c, E.sqrt_m1_col.expand_as(a)), c)
    return c, eq_p(F.sqr(c), a, E)


# ---------------------------------------------------------------------------
# Extended twisted-Edwards group law (a = -1), complete (the JAX :101-162)
# ---------------------------------------------------------------------------


def ed_identity(like: torch.Tensor, E: EdOps):
    z = torch.zeros_like(like)
    one = E.F.one(like)
    return z, one, one, z  # (0, 1, 1, 0)


def ed_add(p1, p2, E: EdOps):
    """add-2008-hwcd-3: 8M + 1 constant mul (2d). Unified: doubling and
    identity operands need no select."""
    F = E.F
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2 = p2
    a0 = F.mul(F.sub(y1, x1), F.sub(y2, x2))
    b0 = F.mul(F.add(y1, x1), F.add(y2, x2))
    c0 = F.mul(F.mul(t1, E.d2_col.expand_as(x1)), t2)
    d0 = F.mul(z1, z2)
    d0 = F.add(d0, d0)
    e, f, g, h = F.sub(b0, a0), F.sub(d0, c0), F.add(d0, c0), F.add(b0, a0)
    return F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h)


def ed_madd(p1, pre, E: EdOps):
    """Mixed addition with an affine entry (Y+X, Y-X, 2dT) of the host comb:
    7M."""
    F = E.F
    x1, y1, z1, t1 = p1
    yx2, ymx2, dt2 = pre
    a0 = F.mul(F.sub(y1, x1), ymx2)
    b0 = F.mul(F.add(y1, x1), yx2)
    c0 = F.mul(t1, dt2)
    d0 = F.add(z1, z1)
    e, f, g, h = F.sub(b0, a0), F.sub(d0, c0), F.add(d0, c0), F.add(b0, a0)
    return F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h)


def ed_double(p1, E: EdOps):
    """dbl-2008-hwcd (a = -1): 4M + 4S."""
    F = E.F
    x1, y1, z1, _ = p1
    a0, b0 = F.sqr(x1), F.sqr(y1)
    zz = F.sqr(z1)
    c0 = F.add(zz, zz)
    h = F.add(a0, b0)
    e = F.sub(h, F.sqr(F.add(x1, y1)))
    g = F.sub(a0, b0)
    f = F.add(c0, g)
    return F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h)


def ed_neg(p1, E: EdOps):
    x, y, z, t = p1
    return E.F.neg(x), y, z, E.F.neg(t)


def is_identity(p1, E: EdOps) -> torch.Tensor:
    x, y, z, _ = p1
    return eq_p(x, torch.zeros_like(x), E) & eq_p(y, z, E)


# ---------------------------------------------------------------------------
# Decompression (the JAX :170-189)
# ---------------------------------------------------------------------------


def decompress(y: torch.Tensor, sign: torch.Tensor, E: EdOps):
    """[16, T] y (little-endian limbs, sign bit stripped) + [T] sign ->
    ((X, Y, Z, T) extended, valid bool[T])."""
    F = E.F
    valid = lt(y, E.p_col)
    yy = F.sqr(y)
    one = F.one(y)
    u = F.sub(yy, one)  # y^2 - 1
    v = F.add(F.mul(E.d_col.expand_as(y), yy), one)  # d·y^2 + 1, never 0
    x2 = F.mul(u, _inv(v, E))
    x, is_sq = _sqrt_p58(x2, E)
    x_zero = is_zero(_canon(x2, E))
    valid &= is_sq | x_zero
    valid &= ~(x_zero & (sign != 0))  # x = 0 with sign 1 (RFC 8032 §5.1.3 step 4)
    x = select(x_zero, torch.zeros_like(x), x)
    flip = (_canon(x, E)[0] & 1) != sign
    x = select(flip, F.neg(x), x)
    return (x, y, one, F.mul(x, y)), valid


# ---------------------------------------------------------------------------
# Fixed-base comb table for B (the JAX :197-222)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def b_comb_table() -> np.ndarray:
    """[45, 16] uint32: rows 3c-3..3c-1 hold (y+x, y-x, 2dxy) mod p of c·B
    for c in 1..15, built from Python integers."""
    tab = np.zeros((45, limb.LIMBS), dtype=np.uint32)
    zi = pow(ref.BASE[2], -1, P)
    base = ref.BASE[0] * zi % P, ref.BASE[1] * zi % P
    acc = None
    for c in range(1, 16):
        acc = base if acc is None else _affine_add(acc, base)
        x, y = acc
        tab[3 * (c - 1) + 0] = int_to_rows((y + x) % P)
        tab[3 * (c - 1) + 1] = int_to_rows((y - x) % P)
        tab[3 * (c - 1) + 2] = int_to_rows(2 * D * x % P * y % P)
    return tab


def _affine_add(p1, p2):
    """Host affine Edwards addition (twisted, a = -1)."""
    x1, y1 = p1
    x2, y2 = p2
    dxy = D * x1 % P * x2 % P * y1 % P * y2 % P
    x3 = (x1 * y2 + y1 * x2) * pow(1 + dxy, -1, P) % P
    y3 = (y1 * y2 + x1 * x2) * pow(1 - dxy, -1, P) % P
    return x3, y3


# ---------------------------------------------------------------------------
# The verification core (the JAX :230-282)
# ---------------------------------------------------------------------------


def verify_core(s, k_neg, a_y, a_sign, r_y, r_sign, b_table, E: EdOps) -> torch.Tensor:
    """Limb inputs [16, T] int64, signs [T]; b_table the [45, 16] comb on the
    device. ok = 8·(s·B + (L-k)·A − R) == O, with the range and decoding
    checks folded in."""
    A, ok_a = decompress(a_y, a_sign, E)
    R, ok_r = decompress(r_y, r_sign, E)
    valid = ok_a & ok_r & lt(s, E.l_col)  # s < L: the malleability guard

    # the 15-entry runtime table of A by unified additions, [15, 16, T] a coordinate
    ta = [A]
    for _ in range(14):
        ta.append(ed_add(ta[-1], A, E))
    ta = [torch.stack([t[i] for t in ta]) for i in range(4)]
    tb = [b_table[i::3] for i in range(3)]  # (y+x, y-x, 2dxy) of c·B, [15, 16] each

    w_s, w_k = scalar_windows(s), scalar_windows(k_neg)  # [64, T], LSB first
    acc = ed_identity(s, E)
    for i in reversed(range(w_s.shape[0])):
        for _ in range(WINDOW):
            acc = ed_double(acc, E)
        w = w_k[i]  # the A term: runtime table, unified addition
        added = ed_add(acc, tuple(_select15(t, w) for t in ta), E)
        acc = select(w == 0, acc, added)
        w = w_s[i]  # the B term: fixed comb, mixed addition
        madded = ed_madd(acc, tuple(_select15(t, w) for t in tb), E)
        acc = select(w == 0, acc, madded)

    acc = ed_add(acc, ed_neg(R, E), E)
    for _ in range(3):  # the cofactor 8
        acc = ed_double(acc, E)
    return valid & is_identity(acc, E)


def rows_to_limbs(rows: torch.Tensor):
    """[B, 128] uint8 rows -> (s, k_neg, a_y, r_y [16, B] int64 limb-major
    little-endian limbs, a_sign, r_sign [B] int64), the sign bits taken off
    the top of A and R."""
    le = rows.reshape(rows.shape[0], 4, 16, 2).to(torch.int64)
    limbs = (le[..., 0] | le[..., 1] << 8).permute(1, 2, 0)  # [4, 16, B]: R, S, A, k_neg
    r_y, s, a_y, k_neg = limbs.clone().unbind(0)
    r_sign, a_sign = r_y[15] >> 15, a_y[15] >> 15
    r_y[15] &= 0x7FFF
    a_y[15] &= 0x7FFF
    return s, k_neg, a_y, r_y, a_sign, r_sign


def verify_plain(rows: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel, in its public layout:
    [B, 128] uint8 rows -> ok bool[B], on the rows' device."""
    E = ed_ops(rows.device)
    s, k_neg, a_y, r_y, a_sign, r_sign = rows_to_limbs(rows)
    table = torch.from_numpy(b_comb_table().astype(np.int64)).to(rows.device)
    return verify_core(s, k_neg, a_y, a_sign, r_y, r_sign, table, E)


# ---------------------------------------------------------------------------
# Device entry point
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def comb_words(device: torch.device) -> torch.Tensor:
    """The kernel's comb, [24, 8] int32 (uint32 words of (y+x, y-x, 2dxy)
    of c·B, c = 1..8), uploaded once per device."""
    return torch.from_numpy(params.ed25519_comb_words().view(np.int32)).to(device)


def verify_device(rows: torch.Tensor) -> torch.Tensor:
    """Batch Ed25519 verify. rows: [B, 128] uint8, R ‖ S ‖ A ‖ k_neg
    little-endian (:func:`device_inputs`); returns ok bool[B].

    CUDA tensors go to the CUDA kernel (or an exception); CPU tensors to the
    plain version."""
    if rows.device.type == "cuda":
        return _kernels.ed25519_verify(rows, comb_words(rows.device))
    if rows.device.type == "cpu":
        return verify_plain(rows)
    raise ValueError(f"verify_device: unsupported device {rows.device}")


# ---------------------------------------------------------------------------
# The challenges: SHA-512 of R ‖ A ‖ M, reduced mod L, negated
# ---------------------------------------------------------------------------

# SHA-512's round constants and initial value (FIPS 180-4 §4.2.3, §5.3.5)
_SHA512_K = [
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F, 0xE9B5DBA58189DBBC,
    0x3956C25BF348B538, 0x59F111F1B605D019, 0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118,
    0xD807AA98A3030242, 0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235, 0xC19BF174CF692694,
    0xE49B69C19EF14AD2, 0xEFBE4786384F25E3, 0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65,
    0x2DE92C6F592B0275, 0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F, 0xBF597FC7BEEF0EE4,
    0xC6E00BF33DA88FC2, 0xD5A79147930AA725, 0x06CA6351E003826F, 0x142929670A0E6E70,
    0x27B70A8546D22FFC, 0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6, 0x92722C851482353B,
    0xA2BFE8A14CF10364, 0xA81A664BBC423001, 0xC24B8B70D0F89791, 0xC76C51A30654BE30,
    0xD192E819D6EF5218, 0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99, 0x34B0BCB5E19B48A8,
    0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB, 0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3,
    0x748F82EE5DEFB2FC, 0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915, 0xC67178F2E372532B,
    0xCA273ECEEA26619C, 0xD186B8C721C0C207, 0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178,
    0x06F067AA72176FBA, 0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC, 0x431D67C49C100D4C,
    0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A, 0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817,
]
_SHA512_IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]
SHA512_BLOCK = 128  # bytes


def _i64(v: int) -> int:
    """A 64-bit word as the int64 with its bit pattern."""
    return v - (1 << 64) if v >> 63 else v


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (>> is arithmetic)."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return _shr(x, n) | (x << (64 - n))


def sha512_words(words: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """SHA-512 over pre-padded blocks: words [B, M, 16] int64 (big-endian
    64-bit words as bit patterns), nblocks [B] -> the digests as [B, 8]
    int64 words. Sums wrap mod 2^64, as int64 addition does."""
    bsz, m_max, _ = words.shape
    state = torch.tensor([_i64(v) for v in _SHA512_IV], device=words.device)[:, None].expand(8, bsz)
    for m in range(m_max):
        w = list(words[:, m, :].T)
        a, b, c, d, e, f, g, h = state
        for t in range(80):
            if t >= 16:
                w15, w2 = w[t - 15], w[t - 2]
                s0 = _rotr(w15, 1) ^ _rotr(w15, 8) ^ _shr(w15, 7)
                s1 = _rotr(w2, 19) ^ _rotr(w2, 61) ^ _shr(w2, 6)
                w.append(s1 + w[t - 7] + s0 + w[t - 16])
            t1 = h + (_rotr(e, 14) ^ _rotr(e, 18) ^ _rotr(e, 41)) + ((e & f) ^ (~e & g)) + _i64(_SHA512_K[t]) + w[t]
            t2 = (_rotr(a, 28) ^ _rotr(a, 34) ^ _rotr(a, 39)) + ((a & b) ^ (a & c) ^ (b & c))
            h, g, f, e, d, c, b, a = g, f, e, d + t1, c, b, a, t1 + t2
        state = torch.where(m < nblocks.to(words.device), state + torch.stack([a, b, c, d, e, f, g, h]), state)
    return state.T


def challenge_plain(rows, data, starts, lengths) -> torch.Tensor:
    """The plain PyTorch version of the challenge kernel: for message i of
    the packed batch (data uint8 [N], starts int64 [B], lengths int32 [B]),
    k = SHA-512(R ‖ A ‖ M) mod L from row i's R (bytes 0..31) and A (64..95);
    k_neg = (L - k) mod L goes into bytes 96..127 of rows[i] ([>= B, 128]
    uint8), in place. Returns rows. SHA-512 runs on int64 tensors on the
    rows' device, the reduction on Python integers."""
    bsz = starts.shape[0]
    if not bsz:
        return rows
    dev = rows.device
    lengths = lengths.to(torch.int64)
    total = lengths + 64  # bytes hashed
    nblocks = (total + 16) // SHA512_BLOCK + 1  # room for 0x80 and the 16-byte length
    width = SHA512_BLOCK * int(nblocks.max())
    buf = torch.zeros((bsz, width), dtype=torch.int64, device=dev)
    buf[:, :32] = rows[:bsz, :32]
    buf[:, 32:64] = rows[:bsz, 64:96]
    buf[:, 64:] = gather_padded(data, starts, lengths, SHA512_BLOCK, nblocks)[:, : width - 64]
    pos = torch.arange(width, device=dev)
    buf |= (pos == total[:, None]) * 0x80
    end = nblocks[:, None] * SHA512_BLOCK  # the bit length, big-endian, ends the last block
    for k in range(8):
        buf |= (pos == end - 1 - k) * ((total[:, None] * 8 >> (8 * k)) & 0xFF)
    shifts = torch.arange(56, -8, -8, device=dev)
    words = (buf.view(bsz, -1, 16, 8) << shifts).sum(-1)  # big-endian words, the top byte in the sign bit
    digests = sha512_words(words, nblocks).cpu().numpy().astype(">i8").tobytes()
    k_neg = b"".join(
        ((L - int.from_bytes(digests[64 * i : 64 * i + 64], "little") % L) % L).to_bytes(32, "little")
        for i in range(bsz)
    )
    rows[:bsz, 96:] = torch.frombuffer(bytearray(k_neg), dtype=torch.uint8).view(bsz, 32).to(dev)
    return rows


def challenge_device(rows, data, starts, lengths) -> torch.Tensor:
    """Each message's k_neg into its row (bytes 96..127 of rows[:B]), in
    place; returns rows. CUDA tensors go to the challenge kernel (or an
    exception); CPU tensors to the plain version."""
    if rows.device.type == "cuda":
        return _kernels.ed25519_challenge(rows, data, starts, lengths)
    if rows.device.type == "cpu":
        return challenge_plain(rows, data, starts, lengths)
    raise ValueError(f"challenge_device: unsupported device {rows.device}")


# ---------------------------------------------------------------------------
# Host half: the rows, and the JAX package's host challenges (the JAX :306-364)
# ---------------------------------------------------------------------------


def challenges(msgs, pubs, sigs) -> bytes:
    """Each lane's k_neg = (L - k) mod L, k = SHA-512(R ‖ A ‖ M) mod L, as
    32 little-endian bytes, joined: one hashlib call a lane (R the first 32
    bytes of the signature, A the 32-byte key)."""
    return b"".join(
        ((L - int.from_bytes(hashlib.sha512(s[:32] + p + bytes(m)).digest(), "little") % L) % L)
        .to_bytes(32, "little")
        for m, p, s in zip(msgs, pubs, sigs)
    )


def _column(items, width: int, what: str) -> np.ndarray:
    """The first `width` bytes of each bytes-like item (at least `width`
    each) as a [B, width] uint8 array: one join, and a loop in Python over
    the items only where one is longer than `width`."""
    joined = b"".join(items)
    if len(joined) != width * len(items) or max(map(len, items), default=width) != width:
        if min(map(len, items)) < width:
            raise ValueError(f"ed25519: {what} must hold {width} bytes")
        joined = b"".join(bytes(x[:width]) for x in items)
    return np.frombuffer(joined, dtype=np.uint8).reshape(len(items), width)


def signature_rows(pubs, sigs, pad_to: int | None = None) -> np.ndarray:
    """Keys and signatures -> the kernels' [pad_to, 128] uint8 rows
    (default: the batch's bucket) with k_neg zero: each lane's R ‖ S (the
    signature's first 64 bytes) and A (the key's first 32); zero rows pad
    the bucket. A key shorter than 32 bytes or a signature shorter than 64
    raises."""
    if len(pubs) != len(sigs):
        raise ValueError(f"ed25519: {len(pubs)} keys, {len(sigs)} signatures")
    bsz = len(sigs)
    rows = np.zeros((bucket_batch(bsz) if pad_to is None else pad_to, ROW_BYTES), dtype=np.uint8)
    rows[:bsz, :64] = _column(sigs, 64, "signatures")
    rows[:bsz, 64:96] = _column(pubs, 32, "keys")
    return rows


def device_inputs(msgs, pubs, sigs, pad_to: int | None = None) -> np.ndarray:
    """The host's rows, as the JAX package makes its inputs: the
    :func:`signature_rows` with each lane's :func:`challenges` k_neg (one
    hashlib call a lane). The oracle of the challenge kernel's rows."""
    if len(msgs) != len(sigs):
        raise ValueError(f"ed25519: {len(msgs)} messages, {len(sigs)} signatures")
    rows = signature_rows(pubs, sigs, pad_to)
    bsz = len(msgs)
    keys, rs = rows[:bsz, 64:96], rows[:bsz, :32]
    k_neg = challenges(msgs, [k.tobytes() for k in keys], [r.tobytes() for r in rs])
    rows[:bsz, 96:] = np.frombuffer(k_neg, dtype=np.uint8).reshape(bsz, 32)
    return rows


def challenge_rows(msgs, pubs, sigs, device=None) -> torch.Tensor:
    """Host API: the kernels' [bucket, 128] uint8 rows with each lane's
    challenge written in, on the CUDA card unless ``device`` names another:
    one upload of the :func:`signature_rows` and of the packed messages,
    then the challenge kernel (its plain version on the CPU). Byte for byte
    :func:`device_inputs`."""
    dev = resolve_device(device)
    if len(msgs) != len(sigs):
        raise ValueError(f"ed25519: {len(msgs)} messages, {len(sigs)} signatures")
    rows = torch.from_numpy(signature_rows(pubs, sigs)).to(dev)
    return challenge_device(rows, *upload_packed(msgs, dev))


def verify_batch(msgs, pubs, sigs, device=None) -> np.ndarray:
    """Host API: per-lane bytes (message, 32-byte key, 64-byte R ‖ S) ->
    bool[B]. Runs on the CUDA card unless ``device`` names another:
    :func:`challenge_rows` (one upload, the challenge kernel), the verify
    kernel, one download of the verdicts, under one ``ed25519_verify`` span
    (the JAX span covers its one device program; the challenges it hashes
    on the host before the span are here a kernel, inside it)."""
    with device_span("ed25519_verify", len(msgs)):
        ok = verify_device(challenge_rows(msgs, pubs, sigs, device))
        return ok.cpu().numpy()[: len(msgs)]
