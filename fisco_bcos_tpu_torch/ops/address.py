"""Device-side sender-address derivation: the hash kernels' sender forms
and their plain versions.

The reference computes the tx sender as right160(hash(uncompressed pubkey))
(CryptoSuite.h:56-59), with keccak256 on the default suite and SM3 on the
SM suite. Here the whole batch of keys is hashed at once, from the ``[B,
16]`` int32 limbs the EC kernels hold: on the card one launch of a sender
form (``csrc/keccak256.cu``, ``csrc/sm3.cu``), which builds each 64-byte
message from the limbs in registers, as the JAX package's
``sender_address_device`` pads inline from limbs; on the CPU the plain
versions below. Both return the keys' bytes beside the addresses, which the
admission result carries. Every lane is hashed, a not-ok lane's zero key
included, exactly as the JAX package does.
"""

from __future__ import annotations

import torch

from . import _kernels
from .bigint import limbs_to_bytes_device
from .hash_common import rows_as_packed
from .keccak import keccak256_packed_plain
from .sm3 import sm3_packed_plain


def pubkey_rows(qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    """Affine pubkey limbs ([B, 16] each, plain domain) -> [B, 64] uint8
    qx_be32 ‖ qy_be32."""
    return torch.cat([limbs_to_bytes_device(qx), limbs_to_bytes_device(qy)], dim=1).to(torch.uint8)


def sender_address_plain(qx, qy, ok=None, packed_plain=keccak256_packed_plain):
    """The plain version of the sender forms: (right160(H(key)) [B, 20]
    uint8, key [B, 64] uint8), key = qx_be32 ‖ qy_be32, zeroed where `ok`
    (bool [B], if given) is false; H keccak-256 unless `packed_plain` names
    another plain packed hash."""
    rows = pubkey_rows(qx, qy)
    if ok is not None:
        rows = torch.where(ok[:, None], rows, torch.zeros_like(rows))
    return packed_plain(*rows_as_packed(rows))[:, 12:], rows


def sm3_sender_address_plain(qx, qy, ok):
    """The plain version of the SM3 sender form."""
    return sender_address_plain(qx, qy, ok, sm3_packed_plain)


def sender_address_device(qx: torch.Tensor, qy: torch.Tensor):
    """keccak256(qx_be32 ‖ qy_be32)[12:32] for [B, 16] limb pubkeys ->
    (addresses [B, 20] uint8, the keys' bytes [B, 64] uint8). CUDA tensors
    go to the keccak kernel's sender form (or an exception), CPU tensors to
    the plain version."""
    if qx.device.type == "cuda":
        return _kernels.keccak256_sender(qx, qy)
    if qx.device.type == "cpu":
        return sender_address_plain(qx, qy)
    raise ValueError(f"sender_address_device: unsupported device {qx.device}")


def sm3_sender_address_device(qx: torch.Tensor, qy: torch.Tensor, ok: torch.Tensor):
    """right160(SM3(key)) for [B, 16] limb pubkeys, the key zeroed where
    ok (bool [B]) is false -> (addresses [B, 20] uint8, the zeroed keys'
    bytes [B, 64] uint8): what the SM suite's calculate_address_batch
    (crypto/suite.py:940) gives after sm2.recover_batch. CUDA tensors go to
    the SM3 kernel's sender form (or an exception), CPU tensors to the plain
    version."""
    if qx.device.type == "cuda":
        return _kernels.sm3_sender(qx, qy, ok)
    if qx.device.type == "cpu":
        return sm3_sender_address_plain(qx, qy, ok)
    raise ValueError(f"sm3_sender_address_device: unsupported device {qx.device}")
