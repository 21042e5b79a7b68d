"""Batch secp256k1 ECDSA public-key recovery and signature verification.

``recover_device`` keeps the JAX package's public layout: ``[B, 16]`` limbs
in, ``(qx, qy [B, 16], ok [B])`` out. ``verify_device`` takes one ``[B, 160]``
uint8 row a signature, z ‖ r ‖ s ‖ qx ‖ qy big-endian as they come off the
wire (:func:`verify_rows`), and returns ``ok [B]``. On a CUDA tensor each
launches its hand-written kernel
(``csrc/secp256k1_recover.cu`` replaces the Pallas ``_recover_kernel``,
``csrc/secp256k1_verify.cu`` the ``_verify_kernel``, each together with the
inversions the TPU ran outside it); on a CPU tensor each runs the plain
PyTorch version below, a port of the JAX ``recover_core`` / ``verify_core``.
Kernel and plain version give the same bytes on every lane: the affine
result of a valid recovery is unique, a not-ok lane is all zeros, and a
verdict is one bit.

Recover semantics (the reference's, Secp256k1Crypto.cpp:106-108): v ∈
{0..3, 27, 28} — 29 and 30 must NOT alias to 2 and 3; x = r + (v&2 ? n : 0)
< p; y = √(x³+7) must exist, its parity flipped by v&1; Q = r⁻¹(s·R − z·G).
Verify: r, s ∈ [1, n); qx, qy < p; Q on the curve; R = u1·G + u2·Q with
u1 = (z mod n)·s⁻¹, u2 = (r mod n)·s⁻¹; x(R) ≡ r (mod n), compared
projectively. Invalid lanes never raise: they come back not-ok.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import _kernels
from .bigint import limb_rows, limbs_to_bytes_be
from .ec import (
    CurveOps,
    glv_decompose,
    lane_inv,
    on_curve,
    pt_to_affine_batch,
    quad_mul_windowed,
    reduce_mod_n,
    valid_scalar,
)
from .hash_common import bucket_batch, pad_rows
from .limb import add_widen, eq, is_zero, lt, select
from ..device import resolve_device
from ..observability.device import device_span
from .. import params
from ..params import default_tables

# ---------------------------------------------------------------------------
# Plain version (limb-major [16, T] int64), a port of the JAX recover_core
# ---------------------------------------------------------------------------


def inv_mod_n(x: torch.Tensor, C: CurveOps) -> torch.Tensor:
    """Batch x^-1 mod n with one Fermat exponentiation for the lane axis.
    Canonicalizes first so an x ≡ 0 (mod n) with nonzero limbs cannot
    poison the shared product tree."""
    return lane_inv(C.Fn, reduce_mod_n(x, C))


def recover_project_core(z, r, s, v, rinv, g_table, C: CurveOps):
    """Projective part of recovery. z, r, s: [16, T] plain limbs; v: [T]
    recovery id; rinv = :func:`inv_mod_n`(r). Returns (X, Y, Z [16, T]
    projective Q, valid bool[T])."""
    F, Fn = C.F, C.Fn
    valid = ((v >= 0) & (v <= 3)) | ((v >= 27) & (v <= 28))
    v = torch.where(v >= 27, v - 27, v)
    valid &= valid_scalar(r, C) & valid_scalar(s, C)
    # x = r + (v & 2 ? n : 0); reject overflow past 2^256 or x >= p
    n_or_0 = select((v & 2) != 0, C.n_col.expand_as(r), torch.zeros_like(r))
    x17 = add_widen(r, n_or_0)
    x = x17[:16]
    valid &= (x17[16] == 0) & lt(x, C.p_col)
    # y from y^2 = x^3 + 7; p ≡ 3 (mod 4)
    y2 = F.add(F.mul(F.sqr(x), x), C.b_enc.expand_as(x))
    y = F.sqrt(y2)
    valid &= eq(F.sqr(y), y2)  # x^3 + 7 must be a quadratic residue
    flip = (y[0] & 1) != (v & 1)  # parity of the plain y
    y = select(flip, F.neg(y), y)
    # Q = r^-1 * (s*R - z*G)
    u1 = Fn.neg(Fn.mul(reduce_mod_n(z, C), rinv))
    u2 = Fn.mul(s, rinv)
    ka, sa, kb, sb = glv_decompose(u2, C)
    X, Y, Z = quad_mul_windowed(u1, ka, sa, kb, sb, (x, y), C, g_table)
    return X, Y, Z, valid


def recover_finish(X, Y, Z, valid, C: CurveOps):
    """Projective Q -> plain affine (qx, qy, ok); not-ok lanes are zeroed."""
    qx, qy, inf = pt_to_affine_batch((X, Y, Z), C)
    valid = valid & ~inf
    zero = torch.zeros_like(X)
    return select(valid, qx, zero), select(valid, qy, zero), valid


def recover_core(z, r, s, v, g_table, C: CurveOps):
    """Whole recovery on limb-major tensors: r⁻¹, the projective core, and
    the batched affine conversion."""
    rinv = inv_mod_n(r, C)
    X, Y, Z, valid = recover_project_core(z, r, s, v, rinv, g_table, C)
    return recover_finish(X, Y, Z, valid, C)


def verify_core(z, r, s, qx, qy, sinv, g_table, C: CurveOps):
    """Batch ECDSA verify on limb-major [16, T] plain tensors; sinv =
    :func:`inv_mod_n`(s) (garbage on s ≡ 0 lanes, which `valid` masks).
    Returns bool[T].

    x(R) ≡ r (mod n) is compared projectively: X = r·Z, or X = (r+n)·Z when
    r + n < p, so no per-lane inversion remains."""
    F, Fn = C.F, C.Fn
    valid = valid_scalar(r, C) & valid_scalar(s, C)
    valid &= lt(qx, C.p_col) & lt(qy, C.p_col)
    valid &= on_curve(qx, qy, C)
    u1 = Fn.mul(reduce_mod_n(z, C), sinv)
    u2 = Fn.mul(reduce_mod_n(r, C), sinv)
    ka, sa, kb, sb = glv_decompose(u2, C)
    X, _Y, Z = quad_mul_windowed(u1, ka, sa, kb, sb, (qx, qy), C, g_table)
    # r < n < p: r is already a canonical field element
    ok = eq(X, F.mul(r, Z))
    rn17 = add_widen(r, C.n_col.expand_as(r))  # [17, T]
    rn_fits = (rn17[16] == 0) & lt(rn17[:16], C.p_col)
    ok |= rn_fits & eq(X, F.mul(rn17[:16], Z))
    return valid & ~is_zero(Z) & ok


def _g_table(device) -> torch.Tensor:
    return torch.from_numpy(default_tables().comb_limbs().astype(np.int64)).to(device)


VERIFY_ROW_BYTES = 160  # z ‖ r ‖ s ‖ qx ‖ qy, 32 big-endian bytes each


def rows_to_limbs(rows: torch.Tensor) -> torch.Tensor:
    """[B, 160] uint8 verify rows -> [5, 16, B] int64 limb-major plain limbs
    (z, r, s, qx, qy), on the rows' device."""
    be = rows.reshape(rows.shape[0], 5, 16, 2).to(torch.int64)
    limbs = (be[..., 0] << 8 | be[..., 1]).flip(-1)  # [B, 5, 16], little-endian limbs
    return limbs.permute(1, 2, 0)


def verify_plain(rows):
    """The plain PyTorch version of the verify kernel, in its public layout:
    [B, 160] uint8 rows -> ok bool[B], on the rows' device."""
    C = CurveOps(rows.device)
    zT, rT, sT, qxT, qyT = rows_to_limbs(rows)
    return verify_core(zT, rT, sT, qxT, qyT, inv_mod_n(sT, C), _g_table(rows.device), C)


def recover_plain(z, r, s, v):
    """The plain PyTorch version of the kernel, in its public layout:
    z, r, s [B, 16] int32 limbs, v [B] int32 -> (qx, qy [B, 16] int32,
    ok bool[B]), on the inputs' device."""
    C = CurveOps(z.device)
    qx, qy, ok = recover_core(
        z.T.to(torch.int64),
        r.T.to(torch.int64),
        s.T.to(torch.int64),
        v.to(torch.int64),
        _g_table(z.device),
        C,
    )
    return qx.T.to(torch.int32).contiguous(), qy.T.to(torch.int32).contiguous(), ok


# ---------------------------------------------------------------------------
# Device entry point ([B, 16] batch-major public API)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def comb_words(device: torch.device) -> torch.Tensor:
    """The kernel's [60, 8] int32 comb table (uint32 words of the affine
    c·G and c·2^128·G, c = 1..15), uploaded once per device."""
    return torch.from_numpy(default_tables().comb_words.view(np.int32)).to(device)


@lru_cache(maxsize=None)
def verify_comb_words(device: torch.device) -> torch.Tensor:
    """The verify kernel's [64, 8] int32 comb (uint32 words of the affine
    c·G and c·2^128·G, c = 1..16), uploaded once per device."""
    return torch.from_numpy(params.verify_comb_words().view(np.int32)).to(device)


def recover_device(z, r, s, v):
    """Batch ECDSA recover. z/r/s: [B, 16] int32 limbs; v: [B] int32.
    Returns (qx, qy [B, 16] int32 plain limbs, ok bool[B]).

    CUDA tensors go to the CUDA kernel (or an exception); CPU tensors to the
    plain version."""
    if z.device.type == "cuda":
        return _kernels.secp256k1_recover(z, r, s, v, comb_words(z.device))
    if z.device.type == "cpu":
        return recover_plain(z, r, s, v)
    raise ValueError(f"recover_device: unsupported device {z.device}")


def verify_device(rows):
    """Batch ECDSA verify. rows: [B, 160] uint8, z ‖ r ‖ s ‖ qx ‖ qy
    big-endian (:func:`verify_rows`); returns ok bool[B].

    CUDA tensors go to the CUDA kernel (or an exception); CPU tensors to the
    plain version."""
    if rows.device.type == "cuda":
        return _kernels.secp256k1_verify(rows, verify_comb_words(rows.device))
    if rows.device.type == "cpu":
        return verify_plain(rows)
    raise ValueError(f"verify_device: unsupported device {rows.device}")


# ---------------------------------------------------------------------------
# Host wrapper (bytes in / bytes out, batch padded per hash_common._bucket)
# ---------------------------------------------------------------------------


def verify_rows(
    msg_hashes: np.ndarray, rs: np.ndarray, ss: np.ndarray, pubkeys: np.ndarray, rows: int
) -> np.ndarray:
    """[B,32] hash, r, s and [B,64] pubkey (uint8 big-endian) -> the
    kernel's [rows, 160] uint8 input, one concatenate into zero rows that
    pad the batch to its bucket."""
    parts = [
        np.asarray(a, dtype=np.uint8).reshape(-1, w)
        for a, w in ((msg_hashes, 32), (rs, 32), (ss, 32), (pubkeys, 64))
    ]
    out = np.zeros((rows, VERIFY_ROW_BYTES), dtype=np.uint8)
    np.concatenate(parts, axis=1, out=out[: len(parts[0])])
    return out


def verify_batch(
    msg_hashes: np.ndarray, rs: np.ndarray, ss: np.ndarray, pubkeys: np.ndarray, device=None
) -> np.ndarray:
    """Host API: [B,32] hash, [B,32] r, [B,32] s, [B,64] uncompressed pubkey
    (all uint8 big-endian) -> bool[B]. Runs on the CUDA card unless
    ``device`` names another: one upload of the padded rows, one download
    of the verdicts, under one ``secp256k1_verify`` span."""
    dev = resolve_device(device)
    bsz = len(msg_hashes)
    bb = bucket_batch(bsz)
    with device_span("secp256k1_verify", bsz, shape_key=bb) as sp:
        rows = verify_rows(msg_hashes, rs, ss, pubkeys, bb)
        with sp.phase("transfer"):  # host->card copy of the operands
            rows_t = torch.from_numpy(rows).to(dev)
        ok = verify_device(rows_t)
        return ok.cpu().numpy()[:bsz]


def recover_batch(
    msg_hashes: np.ndarray, sigs65: np.ndarray, device=None
) -> tuple[np.ndarray, np.ndarray]:
    """Host API: [B,32] hash + [B,65] r‖s‖v signatures (uint8) ->
    (pubkeys [B,64] uint8, ok bool[B]), under one ``secp256k1_recover``
    span."""
    dev = resolve_device(device)
    bsz = len(msg_hashes)
    bb = bucket_batch(bsz)
    with device_span("secp256k1_recover", bsz, shape_key=bb) as sp:
        sigs65 = np.asarray(sigs65, dtype=np.uint8).reshape(-1, 65)
        host = (
            limb_rows(msg_hashes, bb), limb_rows(sigs65[:, :32], bb), limb_rows(sigs65[:, 32:64], bb),
            pad_rows(sigs65[:, 64].astype(np.int32), bb),
        )
        with sp.phase("transfer"):  # host->card copies of the operands
            z, r, s, v = (torch.from_numpy(a).to(dev) for a in host)
        qx, qy, ok = recover_device(z, r, s, v)
        pubs = np.concatenate(
            [limbs_to_bytes_be(qx.cpu().numpy()), limbs_to_bytes_be(qy.cpu().numpy())],
            axis=-1,
        )
        return pubs[:bsz], ok.cpu().numpy()[:bsz]
