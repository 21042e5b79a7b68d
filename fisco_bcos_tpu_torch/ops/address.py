"""Device-side sender-address derivation.

The reference computes the tx sender as right160(hash(uncompressed pubkey))
(CryptoSuite.h:56-59), with keccak256 on the default suite and SM3 on the
SM suite. Here the whole batch of pubkeys is hashed at once: a 64-byte
message plus padding is one keccak rate block, or two SM3 blocks. Every lane
is hashed, a not-ok lane's zero key included, exactly as the JAX package
does.
"""

from __future__ import annotations

import torch

from .bigint import limbs_to_bytes_device, limbs_to_words_be
from .keccak import RATE_LANES, keccak256_lanes
from .sm3 import md64_pad_512bit, sm3_blocks, words_be_to_bytes_device

_RATE_BYTES = 136


def sender_address_device(qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    """Affine pubkey limbs ([B, 16] each, plain domain) -> [B, 20] int64
    address byte values.

    address = keccak256(qx_be32 ‖ qy_be32)[12:32]; multi-rate padding
    (0x01 at byte 64, 0x80 at byte 135) is applied inline."""
    bsz = qx.shape[0]
    msg = torch.zeros((bsz, _RATE_BYTES), dtype=torch.int64, device=qx.device)
    msg[:, 0:32] = limbs_to_bytes_device(qx.to(torch.int64))
    msg[:, 32:64] = limbs_to_bytes_device(qy.to(torch.int64))
    msg[:, 64] = 0x01
    msg[:, 135] = 0x80
    # little-endian bytes -> 64-bit lanes (the top byte lands in the sign bit)
    shifts = torch.arange(0, 64, 8, device=qx.device)
    lanes = (msg.view(bsz, RATE_LANES, 8) << shifts).sum(-1)
    ones = torch.ones((bsz,), dtype=torch.int64, device=qx.device)
    words = keccak256_lanes(lanes[:, None, :], ones)  # [B, 8] LE digest words
    idx = torch.arange(12, 32, device=qx.device)
    return (words[:, idx // 4] >> (8 * (idx % 4))) & 0xFF


def sm3_sender_address_device(qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    """right160(SM3(qx_be32 ‖ qy_be32)) for [B, 16] limb pubkeys -> [B, 20]
    int64 byte values (the SM suite's calculate_address_batch,
    crypto/suite.py:940)."""
    words = torch.cat([limbs_to_words_be(qx), limbs_to_words_be(qy)], dim=1)
    nblocks = torch.full((words.shape[0],), 2, dtype=torch.int32, device=words.device)
    return words_be_to_bytes_device(sm3_blocks(md64_pad_512bit(words), nblocks))[:, 12:]
