"""Device-side sender-address derivation.

The reference computes the tx sender as right160(hash(uncompressed pubkey))
(CryptoSuite.h:56-59), with keccak256 on the default suite and SM3 on the
SM suite. Here the whole batch of pubkeys is hashed at once, as ``[B, 64]``
byte rows through the packed hash entry (the kernel on the card). Every
lane is hashed, a not-ok lane's zero key included, exactly as the JAX
package does.
"""

from __future__ import annotations

import torch

from .bigint import limbs_to_bytes_device
from .hash_common import rows_as_packed
from .keccak import keccak256_packed
from .sm3 import sm3_packed


def pubkey_rows(qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    """Affine pubkey limbs ([B, 16] each, plain domain) -> [B, 64] uint8
    qx_be32 ‖ qy_be32."""
    return torch.cat([limbs_to_bytes_device(qx), limbs_to_bytes_device(qy)], dim=1).to(torch.uint8)


def sender_address_device(qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    """keccak256(qx_be32 ‖ qy_be32)[12:32] for [B, 16] limb pubkeys -> [B, 20]
    uint8."""
    return keccak256_packed(*rows_as_packed(pubkey_rows(qx, qy)))[:, 12:]


def sm3_sender_address_device(qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    """right160(SM3(qx_be32 ‖ qy_be32)) for [B, 16] limb pubkeys -> [B, 20]
    uint8 (the SM suite's calculate_address_batch, crypto/suite.py:940)."""
    return sm3_packed(*rows_as_packed(pubkey_rows(qx, qy)))[:, 12:]
