"""Device-side sender-address derivation.

The reference computes the tx sender as right160(keccak256(uncompressed
pubkey)) (CryptoSuite.h:56-59). Here the whole batch of recovered pubkeys is
hashed at once: a 64-byte message plus keccak padding fits one rate block.
Every lane is hashed, a not-ok lane's zero key included, exactly as the JAX
device program does.
"""

from __future__ import annotations

import torch

from .bigint import limbs_to_bytes_device
from .keccak import RATE_LANES, keccak256_lanes

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
