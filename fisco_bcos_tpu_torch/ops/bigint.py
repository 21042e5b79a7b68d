"""256-bit limb/byte conversions: host (numpy) and tensor forms.

A 256-bit value is 16 little-endian 16-bit limbs. Batch tensors at the
port's public functions are batch-major ``[B, 16]`` int32, the JAX
package's public layout (its limbs are uint32; every limb is < 2^16, so the
values are equal). The plain field code in :mod:`.limb` works limb-major in
int64 internally.
"""

from __future__ import annotations

import numpy as np
import torch

LIMBS = 16  # 16 x 16-bit limbs = 256 bits
_R = 1 << 256


# ---------------------------------------------------------------------------
# Host-side conversions (numpy, exact Python ints)
# ---------------------------------------------------------------------------


def int_to_limbs(x: int) -> np.ndarray:
    """Python int -> [16] uint32 little-endian 16-bit limbs."""
    if not 0 <= x < _R:
        raise ValueError("int_to_limbs: out of range")
    return np.array([(x >> (16 * i)) & 0xFFFF for i in range(LIMBS)], dtype=np.uint32)


def limbs_to_int(a) -> int:
    a = np.asarray(a, dtype=np.uint64)
    return sum(int(a[..., i]) << (16 * i) for i in range(a.shape[-1]))


def ints_to_limbs(xs) -> np.ndarray:
    """Iterable of ints -> [B, 16] uint32."""
    return np.stack([int_to_limbs(int(x)) for x in xs])


def limbs_to_ints(arr) -> list[int]:
    arr = np.asarray(arr)
    flat = arr.reshape(-1, arr.shape[-1])
    return [sum(int(row[i]) << (16 * i) for i in range(arr.shape[-1])) for row in flat]


def bytes_be_to_limbs(data: np.ndarray) -> np.ndarray:
    """[B, 32] uint8 big-endian byte rows -> [B, 16] uint32 limbs (vectorized)."""
    data = np.asarray(data, dtype=np.uint8)
    pairs = data.reshape(*data.shape[:-1], 16, 2).astype(np.uint32)
    be16 = pairs[..., 0] * 256 + pairs[..., 1]
    return be16[..., ::-1].copy()


def limb_tensor(data: np.ndarray, rows: int, device) -> torch.Tensor:
    """[B, 32] big-endian byte rows -> [rows, 16] int32 limb tensor on
    `device`, zero rows padding the batch to its bucket."""
    limbs = bytes_be_to_limbs(np.asarray(data, dtype=np.uint8).reshape(-1, 32))
    padded = np.zeros((rows, LIMBS), dtype=np.int32)
    padded[: len(limbs)] = limbs
    return torch.from_numpy(padded).to(device)


def limbs_to_bytes_be(limbs: np.ndarray) -> np.ndarray:
    """[B, 16] uint32 limbs -> [B, 32] uint8 big-endian byte rows."""
    limbs = np.asarray(limbs, dtype=np.uint32)[..., ::-1]
    hi = (limbs >> 8).astype(np.uint8)
    lo = (limbs & 0xFF).astype(np.uint8)
    return np.stack([hi, lo], axis=-1).reshape(*limbs.shape[:-1], 32)


# ---------------------------------------------------------------------------
# Tensor forms (keep hash -> EC pipelines on the device)
# ---------------------------------------------------------------------------


def _bswap32(w: torch.Tensor) -> torch.Tensor:
    """Byte-swap 32-bit words held in int64 (values < 2^32)."""
    return (
        ((w & 0xFF) << 24)
        | ((w & 0xFF00) << 8)
        | ((w >> 8) & 0xFF00)
        | ((w >> 24) & 0xFF)
    )


def digest_words_le_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """Keccak digest words ([..., 8] little-endian byte order, values
    < 2^32, digest read as a big-endian 256-bit integer) -> [..., 16] int32
    limbs."""
    rc = _bswap32(words.to(torch.int64)).flip(-1)  # word 7 = least significant
    lo = rc & 0xFFFF
    hi = (rc >> 16) & 0xFFFF
    return torch.stack([lo, hi], dim=-1).reshape(*words.shape[:-1], LIMBS).to(torch.int32)


def limbs_to_bytes_device(limbs: torch.Tensor) -> torch.Tensor:
    """[..., 16] limbs -> [..., 32] big-endian byte values (input dtype)."""
    rev = limbs.flip(-1)
    return torch.stack([rev >> 8, rev & 0xFF], dim=-1).reshape(*limbs.shape[:-1], 32)


def words_be_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """SM3 digest words ([..., 8] big-endian order, values < 2^32, digest
    read as a big-endian 256-bit integer) -> [..., 16] int32 limbs."""
    rc = words.to(torch.int64).flip(-1)  # word 7 = least significant
    lo = rc & 0xFFFF
    hi = (rc >> 16) & 0xFFFF
    return torch.stack([lo, hi], dim=-1).reshape(*words.shape[:-1], LIMBS).to(torch.int32)


def limbs_to_words_be(limbs: torch.Tensor) -> torch.Tensor:
    """[..., 16] limbs -> [..., 8] int64 big-endian 32-bit words (the
    inverse of :func:`words_be_to_limbs`)."""
    l64 = limbs.to(torch.int64)
    return (l64[..., 0::2] | (l64[..., 1::2] << 16)).flip(-1)
