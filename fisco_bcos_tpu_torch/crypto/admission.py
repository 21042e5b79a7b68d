"""Fused tx-admission crypto step — the port's main path.

One device program performs, for a whole block of transactions, what the
reference does one tx at a time (``TxValidator::verify``,
bcos-txpool/txpool/validator/TxValidator.cpp:27-69):

    tx hash (keccak256)  →  ECDSA recover  →  sender = right160(keccak(pub))

The batch enters as pre-padded keccak block tensors plus signature limb
tensors and leaves as one packed ``[B, 117]`` uint8 tensor, copied to the
host once. On the card the path is this program or an exception: there is
no host fallback. Invalid lanes never raise — they lower a validity bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops import keccak, secp256k1
from ..ops.address import sender_address_device
from ..ops.bigint import bytes_be_to_limbs, digest_words_le_to_limbs, limbs_to_bytes_device
from ..ops.hash_common import pad_keccak, pad_rows


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
