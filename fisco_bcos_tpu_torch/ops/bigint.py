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


def limb_rows(data: np.ndarray, rows: int) -> np.ndarray:
    """[B, 32] big-endian byte rows -> [rows, 16] int32 limbs, zero rows
    padding the batch to its bucket."""
    limbs = bytes_be_to_limbs(np.asarray(data, dtype=np.uint8).reshape(-1, 32))
    padded = np.zeros((rows, LIMBS), dtype=np.int32)
    padded[: len(limbs)] = limbs
    return padded


def limb_tensor(data: np.ndarray, rows: int, device) -> torch.Tensor:
    """:func:`limb_rows` as a tensor on `device`."""
    return torch.from_numpy(limb_rows(data, rows)).to(device)


def limbs_to_bytes_be(limbs: np.ndarray) -> np.ndarray:
    """[B, 16] uint32 limbs -> [B, 32] uint8 big-endian byte rows."""
    limbs = np.asarray(limbs, dtype=np.uint32)[..., ::-1]
    hi = (limbs >> 8).astype(np.uint8)
    lo = (limbs & 0xFF).astype(np.uint8)
    return np.stack([hi, lo], axis=-1).reshape(*limbs.shape[:-1], 32)


# ---------------------------------------------------------------------------
# Tensor forms (keep hash -> EC pipelines on the device)
# ---------------------------------------------------------------------------


def bytes_be_to_limbs_device(data: torch.Tensor) -> torch.Tensor:
    """[..., 32] big-endian byte values (a digest read as a 256-bit integer)
    -> [..., 16] int32 limbs."""
    pairs = data.to(torch.int32).reshape(*data.shape[:-1], 16, 2)
    return (pairs[..., 0] * 256 + pairs[..., 1]).flip(-1)


def limbs_to_bytes_device(limbs: torch.Tensor) -> torch.Tensor:
    """[..., 16] limbs -> [..., 32] big-endian byte values (input dtype)."""
    rev = limbs.flip(-1)
    return torch.stack([rev >> 8, rev & 0xFF], dim=-1).reshape(*limbs.shape[:-1], 32)
