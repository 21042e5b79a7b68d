"""Batch Keccak-256: the hand-written CUDA kernel and its plain PyTorch
version.

:func:`keccak256_packed` hashes a packed batch (one byte buffer, per-message
starts and lengths; ``hash_common.pack_messages``): on a CUDA tensor it
launches ``csrc/keccak256.cu``, which pads each message itself; on a CPU
tensor it runs :func:`keccak256_packed_plain`, which gathers and pads on the
tensor's device and runs the sponge below.

:func:`keccak256_tx_hash` is the kernel's tx-hash form: the same hash,
giving each digest also as the recover kernel's ``[B, 16]`` int32 limbs
(z), with no torch op between the two kernels. The sender form sits in
``ops/address.py``, beside its JAX counterpart.

The sponge is the port of the JAX package's ``keccak256_blocks``: a
lane-parallel sponge over pre-padded blocks with per-lane multi-block
masking. A 64-bit keccak lane is one int64 (the JAX lo/hi uint32 split is a
TPU artifact); the state is a ``[25, B]`` tensor and each round is a
handful of whole-state ops. Right shifts of int64 are arithmetic, so every
rotation masks the bits it brings down.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels
from ..device import resolve_device
from ..observability.device import device_span
from .bigint import bytes_be_to_limbs_device
from .hash_common import bucket_batch, digest_bytes, download_later, gather_padded, upload_packed

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# as signed int64 bit patterns
_RC_I64 = [rc - (1 << 64) if rc >> 63 else rc for rc in _RC]

# rho rotation offsets r[x][y]; the pi permutation as, for each destination
# lane (index x + 5y), its source lane and rotation
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_PI_SRC = [0] * 25
_PI_ROT = [0] * 25
for _x in range(5):
    for _y in range(5):
        _dst = _y + 5 * ((2 * _x + 3 * _y) % 5)
        _PI_SRC[_dst] = _x + 5 * _y
        _PI_ROT[_dst] = _ROT[_x][_y]

RATE_LANES = 17
RATE_BYTES = 8 * RATE_LANES
_LO32 = 0xFFFFFFFF


def keccak_f1600(a: torch.Tensor) -> torch.Tensor:
    """24-round Keccak-f[1600] over a [25, B] int64 state (lane x + 5y)."""
    dev = a.device
    src = torch.tensor(_PI_SRC, device=dev)
    rot = torch.tensor(_PI_ROT, device=dev)[:, None]
    low_mask = (1 << rot) - 1  # the bits a right shift by 64 - rot brings down
    bsz = a.shape[1]
    for rc in _RC_I64:
        a5 = a.view(5, 5, bsz)  # [y, x, B]
        # theta: C[x] = xor over y; D[x] = C[x-1] ^ rotl(C[x+1], 1)
        c = a5[0] ^ a5[1] ^ a5[2] ^ a5[3] ^ a5[4]
        c1 = c.roll(-1, 0)
        d = c.roll(1, 0) ^ ((c1 << 1) | ((c1 >> 63) & 1))
        a = (a5 ^ d[None]).reshape(25, bsz)
        # rho + pi: B[dst] = rotl(A[src], rot)
        b = a[src]
        b = (b << rot) | ((b >> (64 - rot)) & low_mask)
        # chi within each row y, then iota
        b5 = b.view(5, 5, bsz)
        a = (b5 ^ (~b5.roll(-1, 1) & b5.roll(-2, 1))).reshape(25, bsz)
        a[0] ^= rc
    return a


def keccak256_lanes(lanes: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Sponge over pre-padded blocks of 64-bit lanes.

    lanes: [B, M, 17] int64 rate lanes; nblocks: [B]. Returns digests as
    [B, 8] int64 little-endian 32-bit words (values < 2^32)."""
    bsz, m_max, _ = lanes.shape
    state = torch.zeros((25, bsz), dtype=torch.int64, device=lanes.device)
    nblocks = nblocks.to(lanes.device)
    for m in range(m_max):
        absorbed = state.clone()
        absorbed[:RATE_LANES] ^= lanes[:, m, :].T
        state = torch.where(m < nblocks, keccak_f1600(absorbed), state)
    sq = state[:4]  # 32 bytes = lanes 0..3 -> words [lo0, hi0, lo1, hi1, ...]
    return torch.stack([sq & _LO32, (sq >> 32) & _LO32], dim=1).reshape(8, bsz).T


def keccak256_blocks(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """blocks: [B, M, 17, 2] rate lanes as (lo, hi) 32-bit halves (the JAX
    layout, any integer dtype holding the uint32 values); nblocks: [B].
    Returns digests as [B, 8] int64 little-endian words (values < 2^32)."""
    b = blocks.to(torch.int64)
    lanes = (b[..., 0] & _LO32) | (b[..., 1] << 32)
    return keccak256_lanes(lanes, nblocks)


def keccak256_packed_plain(data, starts, lengths) -> torch.Tensor:
    """The plain PyTorch version of the kernel: keccak-256 of each message
    of a packed batch (data uint8 [N], starts int64 [B], lengths int32 [B])
    -> [B, 32] uint8, on the inputs' device."""
    bsz = starts.shape[0]
    if bsz == 0:
        return torch.empty((0, 32), dtype=torch.uint8, device=data.device)
    lengths = lengths.to(torch.int64)
    nblocks = lengths // RATE_BYTES + 1
    buf = gather_padded(data, starts, lengths, RATE_BYTES, nblocks)
    pos = torch.arange(buf.shape[1], device=data.device)
    buf ^= (pos == lengths[:, None]) * 0x01  # multi-rate padding, 0x81 where both meet
    buf ^= (pos == nblocks[:, None] * RATE_BYTES - 1) * 0x80
    # little-endian bytes -> 64-bit lanes (the top byte lands in the sign bit)
    shifts = torch.arange(0, 64, 8, device=data.device)
    lanes = (buf.view(bsz, -1, RATE_LANES, 8) << shifts).sum(-1)
    return digest_bytes(keccak256_lanes(lanes, nblocks), (0, 8, 16, 24))


def keccak256_packed(data, starts, lengths) -> torch.Tensor:
    """keccak-256 of each message of a packed batch -> [B, 32] uint8. CUDA
    tensors go to the kernel (or an exception); CPU tensors to the plain
    version."""
    if data.device.type == "cuda":
        return _kernels.keccak256_packed(data, starts, lengths)
    if data.device.type == "cpu":
        return keccak256_packed_plain(data, starts, lengths)
    raise ValueError(f"keccak256_packed: unsupported device {data.device}")


def keccak256_tx_hash_plain(data, starts, lengths) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the tx-hash form: (digests [B, 32] uint8, the
    digests read as big-endian integers, [B, 16] int32 limbs)."""
    digests = keccak256_packed_plain(data, starts, lengths)
    return digests, bytes_be_to_limbs_device(digests)


def keccak256_tx_hash(data, starts, lengths) -> tuple[torch.Tensor, torch.Tensor]:
    """keccak-256 of each message of a packed batch -> (digests [B, 32]
    uint8, z [B, 16] int32 limbs). CUDA tensors go to the kernel's tx-hash
    form (or an exception); CPU tensors to the plain version. The JAX
    counterpart: ``keccak256_blocks`` then ``digest_words_le_to_limbs`` in
    ``admission_core``."""
    if data.device.type == "cuda":
        return _kernels.keccak256_tx_hash(data, starts, lengths)
    if data.device.type == "cpu":
        return keccak256_tx_hash_plain(data, starts, lengths)
    raise ValueError(f"keccak256_tx_hash: unsupported device {data.device}")


def keccak256_batch(msgs, device=None) -> np.ndarray:
    """Host convenience: list of bytes -> [B, 32] uint8 digests. Runs on the
    CUDA card unless ``device`` names another; one ``keccak256`` span."""
    n = len(msgs)
    with device_span("keccak256", n, shape_key=bucket_batch(n)):
        return keccak256_batch_async(msgs, device)()


def keccak256_batch_async(msgs, device=None):
    """Dispatch the batch and defer the copy to the host: returns a resolver
    () -> [B, 32] uint8."""
    return download_later(keccak256_packed(*upload_packed(msgs, resolve_device(device))))
