"""Batch SM2 (GB/T 32918.2) signature verification — the 国密 suite.

Reference counterpart: bcos-crypto signature/sm2/SM2Crypto.cpp:29-91. The
signature is 64-byte r‖s with the 64-byte uncompressed public key appended,
and "recover" = parse the pubkey, then verify (SM2Crypto.cpp:81-91). The
digest is e = SM3(ZA ‖ M), ZA = SM3(ENTL ‖ ID ‖ a ‖ b ‖ Gx ‖ Gy ‖ Px ‖ Py)
with the default user id "1234567812345678"; on the card both SM3 passes
are one launch of the SM3 kernel's e form, continued from a per-ID
midstate of ZA's shared blocks (:func:`e_device`). Verification: t = (r + s) mod n ≠ 0; (x1, y1) = s·G +
t·Q; valid iff (e + x1) mod n == r.

``verify_device`` keeps the JAX package's public layout (``[B, 16]`` limbs
in, ``ok [B]`` out). On a CUDA tensor it launches the hand-written kernel
(``csrc/sm2_verify.cu``, which replaces the Pallas ``_sm2_verify_kernel``
and the ``verify_finish`` the TPU ran after it); on a CPU tensor it runs
the plain PyTorch version below, a port of the JAX ``verify_core`` over the
Montgomery field (``limb.MontField``) and the 64-window dual ladder. Both
give the same bit on every lane. Invalid lanes never raise.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import _kernels
from .bigint import bytes_be_to_limbs_device, limb_rows, limb_tensor, limbs_to_bytes_device
from .ec import (
    CurveOps,
    add_mod_n,
    dual_mul_windowed,
    lane_inv,
    on_curve,
    reduce_mod_n,
    valid_scalar,
)
from .hash_common import bucket_batch, pad_rows, rows_as_packed
from .limb import eq, is_zero, lt
from .address import pubkey_rows
from .sm3 import sm3_packed_plain
from ..crypto.ref.ecdsa import SM2_CURVE, SM2_DEFAULT_ID
from ..crypto.ref.sm3 import _IV as _SM3_IV
from ..crypto.ref.sm3 import _compress as sm3_compress
from ..device import resolve_device
from ..observability.device import device_span
from ..params import default_sm2_tables

# ---------------------------------------------------------------------------
# Plain version (limb-major [16, T] int64), a port of the JAX verify_core
# ---------------------------------------------------------------------------


def verify_project_core(e, r, s, qx, qy, g_table, C: CurveOps):
    """Projective part: e, r, s, qx, qy [16, T] plain limbs (e the digest
    as an integer, (qx, qy) the affine public key). Returns (X, Z [16, T]
    Montgomery-domain coordinates of s·G + t·Q, valid bool[T])."""
    F = C.F
    valid = valid_scalar(r, C) & valid_scalar(s, C)
    valid &= lt(qx, C.p_col) & lt(qy, C.p_col)
    qx_e = F.from_plain(qx)
    qy_e = F.from_plain(qy)
    valid &= on_curve(qx_e, qy_e, C)
    t = add_mod_n(reduce_mod_n(r, C), s, C)
    valid &= ~is_zero(t)
    X, _Y, Z = dual_mul_windowed(s, t, (qx_e, qy_e), C, g_table)
    return X, Z, valid


def verify_finish(e, r, X, Z, valid, C: CurveOps):
    """(e + x1) mod n == r, x1 = X/Z with the Z inversion batched across
    lanes."""
    F = C.F
    x1_e = F.mul(X, lane_inv(F, Z))
    x1 = reduce_mod_n(F.to_plain(x1_e), C)
    R = add_mod_n(reduce_mod_n(e, C), x1, C)
    return valid & ~is_zero(Z) & eq(R, r)


def verify_core(e, r, s, qx, qy, g_table, C: CurveOps):
    """Whole SM2 verify on limb-major tensors -> bool[T]."""
    X, Z, valid = verify_project_core(e, r, s, qx, qy, g_table, C)
    return verify_finish(e, r, X, Z, valid, C)


def verify_plain(e, r, s, qx, qy):
    """The plain PyTorch version of the kernel, in its public layout:
    e, r, s, qx, qy [B, 16] int32 limbs -> ok bool[B], on the inputs'
    device."""
    C = CurveOps(e.device, "sm2")
    g_table = torch.from_numpy(default_sm2_tables().comb_limbs().astype(np.int64)).to(e.device)
    return verify_core(*(a.T.to(torch.int64) for a in (e, r, s, qx, qy)), g_table, C)


# ---------------------------------------------------------------------------
# Device entry point ([B, 16] batch-major public API)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def comb_words(device: torch.device) -> torch.Tensor:
    """The kernel's [30, 8] int32 comb (uint32 words of the Montgomery-domain
    affine c·G, c = 1..15), uploaded once per device."""
    return torch.from_numpy(default_sm2_tables().comb_words.view(np.int32)).to(device)


def verify_device(e, r, s, qx, qy):
    """Batch SM2 verify. All inputs [B, 16] int32 plain-domain limbs (batch
    major); returns ok bool[B].

    CUDA tensors go to the CUDA kernel (or an exception); CPU tensors to the
    plain version."""
    if e.device.type == "cuda":
        return _kernels.sm2_verify(e, r, s, qx, qy, comb_words(e.device))
    if e.device.type == "cpu":
        return verify_plain(e, r, s, qx, qy)
    raise ValueError(f"verify_device: unsupported device {e.device}")


# ---------------------------------------------------------------------------
# e = SM3(ZA ‖ M) on the device
# ---------------------------------------------------------------------------


def za_prefix(user_id: bytes = SM2_DEFAULT_ID) -> bytes:
    """ENTL ‖ ID ‖ a ‖ b ‖ Gx ‖ Gy: the part of ZA's message that every
    signer shares."""
    c = SM2_CURVE
    return (
        (len(user_id) * 8).to_bytes(2, "big")
        + user_id
        + b"".join(v.to_bytes(32, "big") for v in (c.a, c.b, c.gx, c.gy))
    )


@lru_cache(maxsize=None)
def za_midstate(user_id: bytes = SM2_DEFAULT_ID) -> np.ndarray:
    """The e form's per-ID table, int32 [32] (layout in csrc/sm3.cuh): the
    SM3 chain after ZA's whole 64-byte blocks of :func:`za_prefix`, computed
    once on the host with the port's reference compression, then the count
    t of the prefix's bytes after those blocks, ZA's whole length (prefix
    and the 64-byte key), and those t bytes at the end of 64."""
    prefix = za_prefix(user_id)
    whole = len(prefix) // 64 * 64
    v = list(_SM3_IV)
    for off in range(0, whole, 64):
        v = sm3_compress(v, prefix[off : off + 64])
    tail = prefix[whole:]
    table = np.zeros(32, dtype=np.uint32)
    table[:8] = v
    table[8] = len(tail)
    table[9] = len(prefix) + 64
    table[16:] = np.frombuffer(bytes(64 - len(tail)) + tail, dtype="<u4")
    table = table.view(np.int32)
    table.setflags(write=False)  # one cached array for every caller
    return table


@lru_cache(maxsize=None)
def za_state(user_id: bytes, device: torch.device) -> torch.Tensor:
    """:func:`za_midstate` uploaded once per (user ID, device)."""
    return torch.tensor(za_midstate(user_id), device=device)


def e_plain(hash_bytes, qx, qy, user_id: bytes = SM2_DEFAULT_ID) -> torch.Tensor:
    """The plain version of the e form, both SM3 passes whole (no
    midstate): e = SM3(SM3(prefix ‖ key) ‖ h) for digests h [B, 32] uint8
    and keys qx, qy [B, 16] int32 limbs -> e as [B, 16] int32 limbs."""
    pub = pubkey_rows(qx, qy)
    prefix = torch.tensor(list(za_prefix(user_id)), dtype=torch.uint8, device=pub.device)
    za = sm3_packed_plain(*rows_as_packed(torch.cat([prefix.expand(pub.shape[0], -1), pub], dim=1)))
    e = sm3_packed_plain(*rows_as_packed(torch.cat([za, hash_bytes], dim=1)))
    return bytes_be_to_limbs_device(e)


def e_device(hash_bytes, qx, qy, user_id: bytes = SM2_DEFAULT_ID) -> torch.Tensor:
    """e = SM3(ZA ‖ h), ZA = SM3(ENTL ‖ ID ‖ a ‖ b ‖ Gx ‖ Gy ‖ x ‖ y), for
    digests h [B, 32] uint8 and keys qx, qy [B, 16] int32 limbs -> e as
    [B, 16] int32 limbs, the SM2 kernel's input. CUDA tensors go to the SM3
    kernel's e form, one launch continued from the ID's midstate (or an
    exception); CPU tensors to :func:`e_plain`. The JAX counterpart is
    ``sm2_e_batch``'s two SM3 passes."""
    if hash_bytes.device.type == "cuda":
        return _kernels.sm3_e(hash_bytes, qx, qy, za_state(user_id, hash_bytes.device))
    if hash_bytes.device.type == "cpu":
        return e_plain(hash_bytes, qx, qy, user_id)
    raise ValueError(f"e_device: unsupported device {hash_bytes.device}")


# ---------------------------------------------------------------------------
# Host wrappers (bytes in / bytes out, batch padded per hash_common._bucket)
# ---------------------------------------------------------------------------


def _hash_tensor(msg_hashes: np.ndarray, rows: int, dev) -> torch.Tensor:
    """[B, 32] digests zero-padded to [rows, 32] uint8 on ``dev``."""
    return torch.from_numpy(pad_rows(np.asarray(msg_hashes, dtype=np.uint8).reshape(-1, 32), rows)).to(dev)


def sm2_e_batch(
    msg_hashes: np.ndarray, pubkeys: np.ndarray, user_id: bytes = SM2_DEFAULT_ID, device=None
) -> np.ndarray:
    """e = SM3(ZA ‖ M) for a batch: [B,32] hashes + [B,64] pubkeys ->
    [B,32] uint8. Runs on the CUDA card unless ``device`` names another."""
    dev = resolve_device(device)
    pubs = np.asarray(pubkeys, dtype=np.uint8).reshape(-1, 64)
    bsz = len(pubs)
    qx, qy = limb_tensor(pubs[:, :32], bsz, dev), limb_tensor(pubs[:, 32:], bsz, dev)
    e = e_device(_hash_tensor(msg_hashes, bsz, dev), qx, qy, user_id)
    return limbs_to_bytes_device(e).to(torch.uint8).cpu().numpy()


def verify_batch(
    msg_hashes: np.ndarray,
    rs: np.ndarray,
    ss: np.ndarray,
    pubkeys: np.ndarray,
    user_id: bytes = SM2_DEFAULT_ID,
    device=None,
) -> np.ndarray:
    """Host API: [B,32] tx hash, [B,32] r, [B,32] s, [B,64] pubkey -> bool[B].
    Runs on the CUDA card unless ``device`` names another; e stays on it
    between the SM3 passes and the kernel. One ``sm2_verify`` span, with no
    ``sm3`` span inside (the JAX wrapper's e derivation has none)."""
    dev = resolve_device(device)
    bsz = len(msg_hashes)
    bb = bucket_batch(bsz)
    with device_span("sm2_verify", bsz, shape_key=bb) as sp:
        pubkeys = np.asarray(pubkeys, dtype=np.uint8).reshape(-1, 64)
        host = (
            pad_rows(np.asarray(msg_hashes, dtype=np.uint8).reshape(-1, 32), bb),
            limb_rows(rs, bb), limb_rows(ss, bb), limb_rows(pubkeys[:, :32], bb), limb_rows(pubkeys[:, 32:], bb),
        )
        with sp.phase("transfer"):  # host->card copies of the operands
            h, r, s, qx, qy = (torch.from_numpy(a).to(dev) for a in host)
        ok = verify_device(e_device(h, qx, qy, user_id), r, s, qx, qy)
        return ok.cpu().numpy()[:bsz]


def recover_batch(
    msg_hashes: np.ndarray, sigs_with_pub: np.ndarray, device=None
) -> tuple[np.ndarray, np.ndarray]:
    """Reference-style SM2 "recover": the signature is r‖s‖pubkey (128
    bytes); parse the pubkey and verify (SM2Crypto.cpp:81-91). Returns
    (pubkeys [B,64], ok bool[B]); a not-ok lane's pubkey is zeroed."""
    sigs_with_pub = np.asarray(sigs_with_pub, dtype=np.uint8).reshape(-1, 128)
    pubs = sigs_with_pub[:, 64:128]
    ok = verify_batch(
        msg_hashes, sigs_with_pub[:, :32], sigs_with_pub[:, 32:64], pubs, device=device
    )
    return np.where(ok[:, None], pubs, np.zeros_like(pubs)), ok
