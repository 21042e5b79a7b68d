"""Batch Ed25519 verification (RFC 8032, cofactored), the port of the JAX
package's ``ops/ed25519.py``.

The split of labour is the JAX package's: the host hashes each lane's
SHA-512 challenge k = H(R ‖ A ‖ M) mod L and negates it (:func:`challenges`,
one hashlib call a lane); the device does every elliptic step, the two
decompressions, the dual ladder s·B + (L − k)·A, the R subtraction, the
cofactor 8 and the identity test, and returns one verdict bit a lane:

    ok = s < L and A, R decompress and 8·(s·B + (L − k)·A − R) == O.

The device input is one ``[B, 128]`` uint8 row a lane (:data:`ROW_BYTES`):
R ‖ S ‖ A ‖ k_neg, 32 little-endian bytes each, R and S as they come in the
signature and A as the key; the sign bits stay in the top bytes of R and A.
:func:`verify_device` sends a CUDA tensor of rows to the hand-written kernel
``csrc/ed25519_verify.cu`` (which replaces the JAX program ``_verify_xla``)
and a CPU tensor to :func:`verify_plain`, the plain PyTorch version below.

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
from .hash_common import bucket_batch
from .limb import FoldField, const_col, cond_sub, eq, int_to_rows, is_zero, lt, select
from .. import params
from ..crypto.ref import ed25519 as ref
from ..device import resolve_device

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
# Host half (the JAX :306-364)
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


def device_inputs(msgs, pubs, sigs, pad_to: int | None = None) -> np.ndarray:
    """Host bytes -> the kernel's [pad_to, 128] uint8 rows (default: the
    batch's bucket): each lane's R ‖ S (the signature's first 64 bytes), A
    (the key's first 32) and its :func:`challenges` k_neg; zero rows pad the
    bucket. A key shorter than 32 bytes or a signature shorter than 64
    raises."""
    bsz = len(msgs)
    if not len(pubs) == len(sigs) == bsz:
        raise ValueError(f"ed25519: {bsz} messages, {len(pubs)} keys, {len(sigs)} signatures")
    pubs = [bytes(p[:32]) for p in pubs]
    sigs = [bytes(s[:64]) for s in sigs]
    if any(len(p) != 32 for p in pubs) or any(len(s) != 64 for s in sigs):
        raise ValueError("ed25519: keys must hold 32 bytes and signatures 64")
    parts = [
        np.frombuffer(b"".join(sigs), dtype=np.uint8).reshape(bsz, 64),
        np.frombuffer(b"".join(pubs), dtype=np.uint8).reshape(bsz, 32),
        np.frombuffer(challenges(msgs, pubs, sigs), dtype=np.uint8).reshape(bsz, 32),
    ]
    rows = np.zeros((bucket_batch(bsz) if pad_to is None else pad_to, ROW_BYTES), dtype=np.uint8)
    np.concatenate(parts, axis=1, out=rows[:bsz])
    return rows


def verify_batch(msgs, pubs, sigs, device=None) -> np.ndarray:
    """Host API: per-lane bytes (message, 32-byte key, 64-byte R ‖ S) ->
    bool[B]. Runs on the CUDA card unless ``device`` names another: the
    challenges hashed on the host, one upload of the rows, one launch, one
    download of the verdicts."""
    dev = resolve_device(device)
    rows = device_inputs(msgs, pubs, sigs)
    ok = verify_device(torch.from_numpy(rows).to(dev))
    return ok.cpu().numpy()[: len(msgs)]
