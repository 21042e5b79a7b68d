"""Batch SM3 (GB/T 32905) — the 国密 hash of sm_crypto chains (reference:
bcos-crypto hash/SM3.h, OpenSSL-tassl EVP): the hand-written CUDA kernel and
its plain PyTorch version.

:func:`sm3_packed` hashes a packed batch (one byte buffer, per-message
starts and lengths; ``hash_common.pack_messages``): on a CUDA tensor it
launches ``csrc/sm3.cu``, which pads each message itself; on a CPU tensor
it runs :func:`sm3_packed_plain`, which gathers and pads on the tensor's
device and runs the chain below. The kernel's other forms sit beside their
JAX counterparts, each with its plain version: the sender in
``ops/address.py``, SM2's e in ``ops/sm2.py``.

The chain is the port of the JAX package's ``sm3_blocks``: a lane-parallel
Merkle–Damgård chain over pre-padded blocks with per-lane multi-block
masking. A 32-bit word rides an int64 (PyTorch on the CPU has no uint32
arithmetic); every sum and left shift is masked back to 32 bits. The state
is ``[8, B]`` and each round a handful of whole-batch ops.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels
from ..device import resolve_device
from ..observability.device import device_span
from .hash_common import digest_bytes, download_later, md64_words, upload_packed

_IV = [
    0x7380166F, 0x4914B2B9, 0x172442D7, 0xDA8A0600,
    0xA96F30BC, 0x163138AA, 0xE38DEE4D, 0xB0FB0E4E,
]
_M32 = 0xFFFFFFFF


def _rotl_int(v: int, n: int) -> int:
    n %= 32
    return ((v << n) | (v >> (32 - n))) & _M32


# Tj <<< j for the 64 rounds
_TJ = [_rotl_int(0x79CC4519 if j < 16 else 0x7A879D8A, j) for j in range(64)]


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    n %= 32
    if n == 0:
        return x
    return ((x << n) & _M32) | (x >> (32 - n))


def _p0(x: torch.Tensor) -> torch.Tensor:
    return x ^ _rotl(x, 9) ^ _rotl(x, 17)


def _p1(x: torch.Tensor) -> torch.Tensor:
    return x ^ _rotl(x, 15) ^ _rotl(x, 23)


def _compress(v: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """v [8, B] chaining state, block [16, B] big-endian words -> [8, B]."""
    w = list(block.unbind(0))
    for j in range(16, 68):
        w.append(_p1(w[j - 16] ^ w[j - 9] ^ _rotl(w[j - 3], 15)) ^ _rotl(w[j - 13], 7) ^ w[j - 6])
    a, b, c, d, e, f, g, h = v.unbind(0)
    for j in range(64):
        a12 = _rotl(a, 12)
        ss1 = _rotl((a12 + e + _TJ[j]) & _M32, 7)
        ss2 = ss1 ^ a12
        if j < 16:
            ff = a ^ b ^ c
            gg = e ^ f ^ g
        else:
            ff = (a & b) | (a & c) | (b & c)
            gg = (e & f) | (~e & g)
        tt1 = (ff + d + ss2 + (w[j] ^ w[j + 4])) & _M32
        tt2 = (gg + h + ss1 + w[j]) & _M32
        a, b, c, d, e, f, g, h = tt1, a, _rotl(b, 9), c, _p0(tt2), e, _rotl(f, 19), g
    return v ^ torch.stack([a, b, c, d, e, f, g, h])


def sm3_blocks(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """blocks [B, M, 16] big-endian words (any integer dtype holding the
    uint32 values), nblocks [B] -> digests [B, 8] int64 big-endian words
    (values < 2^32).

    Only block slots below the batch's largest ``nblocks`` are compressed:
    the slots above it are masked on every lane, so the digests are the
    JAX program's, which runs all M."""
    b = blocks.to(torch.int64)
    nblocks = nblocks.to(b.device)
    bsz = b.shape[0]
    state = torch.tensor(_IV, dtype=torch.int64, device=b.device)[:, None].expand(8, bsz)
    m_used = int(nblocks.max()) if bsz else 0
    for m in range(min(m_used, b.shape[1])):
        state = torch.where(m < nblocks, _compress(state, b[:, m, :].T), state)
    return state.T.contiguous()


def sm3_packed_plain(data, starts, lengths) -> torch.Tensor:
    """The plain PyTorch version of the kernel: SM3 of each message of a
    packed batch (data uint8 [N], starts int64 [B], lengths int32 [B]) ->
    [B, 32] uint8, on the inputs' device."""
    if starts.shape[0] == 0:
        return torch.empty((0, 32), dtype=torch.uint8, device=data.device)
    return digest_bytes(sm3_blocks(*md64_words(data, starts, lengths)), (24, 16, 8, 0))


def sm3_packed(data, starts, lengths) -> torch.Tensor:
    """SM3 of each message of a packed batch -> [B, 32] uint8. CUDA tensors
    go to the kernel (or an exception); CPU tensors to the plain version."""
    if data.device.type == "cuda":
        return _kernels.sm3_packed(data, starts, lengths)
    if data.device.type == "cpu":
        return sm3_packed_plain(data, starts, lengths)
    raise ValueError(f"sm3_packed: unsupported device {data.device}")


def sm3_batch(msgs, device=None) -> np.ndarray:
    """Host convenience: list of bytes -> [B, 32] uint8 digests. Runs on the
    CUDA card unless ``device`` names another; one ``sm3`` span."""
    with device_span("sm3", len(msgs)):
        return sm3_batch_async(msgs, device)()


def sm3_batch_async(msgs, device=None):
    """Dispatch the batch and defer the copy to the host: returns a resolver
    () -> [B, 32] uint8."""
    return download_later(sm3_packed(*upload_packed(msgs, resolve_device(device))))
