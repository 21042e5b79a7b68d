"""Fused tx-admission crypto step — the port's main path.

One device program performs, for a whole block of transactions, what the
reference does one tx at a time (``TxValidator::verify``,
bcos-txpool/txpool/validator/TxValidator.cpp:27-69). For the default suite
(:func:`admit_batch`):

    tx hash (keccak256)  →  ECDSA recover  →  sender = right160(keccak(pub))

and for an ``sm_crypto`` chain (:func:`admit_batch_sm`):

    tx hash (SM3)  →  SM2 "recover" (parse pub, verify)  →  right160(SM3(pub))

The batch enters as pre-padded hash block tensors plus signature limb
tensors and leaves as one packed ``[B, 117]`` uint8 tensor, copied to the
host once. On the card the path is this program or an exception: there is
no host fallback. Invalid lanes never raise — they lower a validity bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops import keccak, secp256k1, sm2, sm3
from ..ops.address import sender_address_device, sm3_sender_address_device
from ..ops.bigint import (
    bytes_be_to_limbs,
    digest_words_le_to_limbs,
    limbs_to_bytes_device,
    words_be_to_limbs,
)
from ..ops.hash_common import pad_keccak, pad_md64, pad_rows


def admission_core(blocks, nblocks, r, s, v):
    """The fused admission body. blocks [B, M, 17, 2] + nblocks [B] are the
    pre-padded keccak form of each tx's signed payload; (r, s) [B, 16] int32
    limbs and v [B] int32 are the 65-byte signature split.

    Returns (addr [B, 20] byte values, ok bool[B], qx, qy, z [B, 16] limbs);
    z is the tx hash as limbs."""
    words = keccak.keccak256_blocks(blocks, nblocks)
    z = digest_words_le_to_limbs(words)
    qx, qy, ok = secp256k1.recover_device(z, r, s, v)
    addr = sender_address_device(qx, qy)
    return addr, ok, qx, qy, z


def pack_admission_device(addr, ok, qx, qy, z) -> torch.Tensor:
    """[B, 117] uint8 = addr(20) ‖ ok(1) ‖ pubkey(64) ‖ tx_hash(32)."""
    u8 = torch.uint8
    return torch.cat(
        [
            addr.to(u8),
            ok.to(u8)[:, None],
            limbs_to_bytes_device(qx).to(u8),
            limbs_to_bytes_device(qy).to(u8),
            limbs_to_bytes_device(z).to(u8),
        ],
        dim=1,
    )


def _admission_packed(blocks, nblocks, r, s, v) -> torch.Tensor:
    return pack_admission_device(*admission_core(blocks, nblocks, r, s, v))


def admit_batch(
    payloads, sigs65, device=None
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host API: list[bytes] signed payloads + [B, 65] r‖s‖v signatures ->
    (senders [B, 20] uint8, ok bool[B], pubkeys [B, 64] uint8,
    tx hashes [B, 32] uint8).

    Runs on the CUDA card unless ``device`` names another; with no device
    and no CUDA it raises. A not-ok lane carries a zero pubkey and the
    sender of the zero key, right160(keccak(0^64)), as the JAX device
    program does."""
    dev = resolve_device(device)
    host = host_inputs(payloads, sigs65)
    packed = _admission_packed(*(torch.from_numpy(a).to(dev) for a in host))
    out = packed[: len(payloads)].cpu().numpy()
    return out[:, :20], out[:, 20] != 0, out[:, 21:85], out[:, 85:117]


def host_inputs(payloads, sigs65) -> tuple[np.ndarray, ...]:
    """The host half of admission: (blocks [B', M, 17, 2] int64, nblocks
    [B'] int32, r, s [B', 16] int32 limbs, v [B'] int32), B' the bucketed
    batch. pad_keccak buckets the batch (empty-message pad rows); r/s/v
    follow its bucket with zero rows."""
    blocks, nblocks = pad_keccak(list(payloads))
    bb = blocks.shape[0]
    sigs65 = np.asarray(sigs65, dtype=np.uint8).reshape(-1, 65)

    def limbs(a):
        return pad_rows(bytes_be_to_limbs(a), bb).astype(np.int32)

    return (
        blocks.astype(np.int64),
        nblocks,
        limbs(sigs65[:, :32]),
        limbs(sigs65[:, 32:64]),
        pad_rows(sigs65[:, 64].astype(np.int32), bb),
    )


# ---------------------------------------------------------------------------
# SM suite (sm_crypto chains): SM3 + SM2
# ---------------------------------------------------------------------------


def admission_sm_core(blocks, nblocks, za_blk, za_nblocks, r, s, qx, qy):
    """The SM admission body. blocks [B, M, 16] + nblocks [B]: the MD-padded
    payloads; za_blk [B, 4, 16] + za_nblocks [B]: the padded ZA messages of
    the carried pubkeys; r, s, qx, qy [B, 16] int32 limbs of r‖s‖pub.

    Returns (addr [B, 20] byte values, ok bool[B], qx, qy [B, 16] limbs
    zeroed on not-ok lanes, z [B, 16] the tx hash as limbs)."""
    h = sm3.sm3_blocks(blocks, nblocks)
    e = sm2.e_device(h, za_blk, za_nblocks)
    ok = sm2.verify_device(e, r, s, qx, qy)
    qx = torch.where(ok[:, None], qx, torch.zeros_like(qx))
    qy = torch.where(ok[:, None], qy, torch.zeros_like(qy))
    return sm3_sender_address_device(qx, qy), ok, qx, qy, words_be_to_limbs(h)


def admit_batch_sm(
    payloads, sigs128, device=None
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host API of the SM suite: list[bytes] signed payloads + [B, 128]
    r‖s‖pubkey signatures -> (senders [B, 20] uint8, ok bool[B], pubkeys
    [B, 64] uint8, tx hashes [B, 32] uint8).

    One call for the three steps that the JAX package's ``batch_admit``
    takes on a non-default suite (txpool/validator.py:143-149):
    ``sm3_batch(payloads)`` → ``sm2.recover_batch(hashes, sigs128)`` (parse
    the pubkey, verify, zero the pubkey of a not-ok lane) →
    ``sm3_batch(pubs)[:, 12:]`` (crypto/suite.py:940). A not-ok lane
    therefore carries the zero key and its sender right160(SM3(0^64)).

    Runs on the CUDA card unless ``device`` names another; with no device
    and no CUDA it raises. An empty batch returns before any device work,
    as ``batch_admit`` does."""
    dev = resolve_device(device)
    if not len(payloads):
        empty = np.zeros((0, 117), dtype=np.uint8)
        return empty[:, :20], empty[:, 20] != 0, empty[:, 21:85], empty[:, 85:117]
    host = host_inputs_sm(payloads, sigs128)
    packed = pack_admission_device(
        *admission_sm_core(*(torch.from_numpy(a).to(dev) for a in host))
    )
    out = packed[: len(payloads)].cpu().numpy()
    return out[:, :20], out[:, 20] != 0, out[:, 21:85], out[:, 85:117]


def host_inputs_sm(payloads, sigs128) -> tuple[np.ndarray, ...]:
    """The host half of SM admission: (blocks [B', M, 16] int64, nblocks
    [B'] int32, ZA blocks [B', 4, 16] int64, ZA nblocks [B'] int32, r, s,
    qx, qy [B', 16] int32 limbs), B' the bucketed batch. pad_md64 buckets
    the batch (empty-message pad rows); the signature rows follow its bucket
    with zero rows."""
    blocks, nblocks = pad_md64(list(payloads))
    bb = blocks.shape[0]
    sigs128 = pad_rows(np.asarray(sigs128, dtype=np.uint8).reshape(-1, 128), bb)
    za_blk, za_nblocks = sm2.za_blocks(sigs128[:, 64:])

    def limbs(a):
        return bytes_be_to_limbs(a).astype(np.int32)

    return (
        blocks.astype(np.int64),
        nblocks,
        za_blk.astype(np.int64),
        za_nblocks,
        limbs(sigs128[:, :32]),
        limbs(sigs128[:, 32:64]),
        limbs(sigs128[:, 64:96]),
        limbs(sigs128[:, 96:128]),
    )
