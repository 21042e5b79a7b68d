"""Batch SHA-256 (FIPS 180-4; reference: bcos-crypto hash/Sha256.h and the
sha256 EVM precompile): the hand-written CUDA kernel and its plain PyTorch
version.

:func:`sha256_packed` hashes a packed batch (one byte buffer, per-message
starts and lengths; ``hash_common.pack_messages``): on a CUDA tensor it
launches ``csrc/sha256.cu``, which pads each message itself; on a CPU tensor
it runs :func:`sha256_packed_plain`, which pads on the tensor's device
(``hash_common.md64_words``, SM3's padding) and runs the chain below.

The chain is the port of the JAX package's ``sha256_blocks``: a
lane-parallel Merkle–Damgård chain over pre-padded blocks with per-lane
multi-block masking. A 32-bit word rides an int64 (PyTorch on the CPU has
no uint32 arithmetic); every sum and left shift is masked back to 32 bits.
The state is ``[8, B]`` and each round a handful of whole-batch ops.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels
from ..device import resolve_device
from ..observability.device import device_span
from .hash_common import digest_bytes, download_later, md64_words, upload_packed

_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
_IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]
_M32 = 0xFFFFFFFF


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x >> n) | ((x << (32 - n)) & _M32)


def _schedule(block: torch.Tensor) -> list[torch.Tensor]:
    """The message schedule: block [16, B] -> the 64 words W[t], each [B]."""
    w = list(block.unbind(0))
    for t in range(48):
        w15, w2 = w[t + 1], w[t + 14]
        s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
        s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
        w.append((w[t] + s0 + w[t + 9] + s1) & _M32)
    return w


def _compress(v: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """v [8, B] chaining state, block [16, B] big-endian words -> [8, B]."""
    w = _schedule(block)
    a, b, c, d, e, f, g, h = v.unbind(0)
    for j in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + s1 + ch + _K[j] + w[j]) & _M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = (t1 + s0 + maj) & _M32, a, b, c, (d + t1) & _M32, e, f, g
    return (v + torch.stack([a, b, c, d, e, f, g, h])) & _M32


def sha256_blocks(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
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


def sha256_packed_plain(data, starts, lengths) -> torch.Tensor:
    """The plain PyTorch version of the kernel: SHA-256 of each message of a
    packed batch (data uint8 [N], starts int64 [B], lengths int32 [B]) ->
    [B, 32] uint8, on the inputs' device."""
    if starts.shape[0] == 0:
        return torch.empty((0, 32), dtype=torch.uint8, device=data.device)
    return digest_bytes(sha256_blocks(*md64_words(data, starts, lengths)), (24, 16, 8, 0))


def sha256_packed(data, starts, lengths) -> torch.Tensor:
    """SHA-256 of each message of a packed batch -> [B, 32] uint8. CUDA
    tensors go to the kernel (or an exception); CPU tensors to the plain
    version."""
    if data.device.type == "cuda":
        return _kernels.sha256_packed(data, starts, lengths)
    if data.device.type == "cpu":
        return sha256_packed_plain(data, starts, lengths)
    raise ValueError(f"sha256_packed: unsupported device {data.device}")


def sha256_batch(msgs, device=None) -> np.ndarray:
    """Host convenience: list of bytes -> [B, 32] uint8 digests. Runs on the
    CUDA card unless ``device`` names another; one ``sha256`` span."""
    with device_span("sha256", len(msgs)):
        return sha256_batch_async(msgs, device)()


def sha256_batch_async(msgs, device=None):
    """Dispatch the batch and defer the copy to the host: returns a resolver
    () -> [B, 32] uint8."""
    return download_later(sha256_packed(*upload_packed(msgs, resolve_device(device))))
