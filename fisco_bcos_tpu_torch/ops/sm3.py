"""Batch SM3 (GB/T 32905) in plain PyTorch — the 国密 hash of sm_crypto
chains (reference: bcos-crypto hash/SM3.h, OpenSSL-tassl EVP).

The port of the JAX package's ``sm3_blocks``: a lane-parallel
Merkle–Damgård chain over pre-padded blocks with per-lane multi-block
masking. A 32-bit word rides an int64 (PyTorch on the CPU has no uint32
arithmetic); every sum and left shift is masked back to 32 bits. The state
is ``[8, B]`` and each round a handful of whole-batch ops.

This runs as plain PyTorch on the card too — the JAX package computes SM3
outside any Pallas kernel. Its hand-written CUDA kernel is queued in
ROADMAP.md.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .hash_common import digest_words_to_bytes_be, pad_md64

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


def sm3_batch(msgs, device=None) -> np.ndarray:
    """Host convenience: list of bytes -> [B, 32] uint8 digests. Runs on the
    CUDA card unless ``device`` names another."""
    return sm3_batch_async(msgs, device)()


def sm3_batch_async(msgs, device=None):
    """Dispatch the batch and defer the copy to the host: returns a resolver
    () -> [B, 32] uint8."""
    dev = resolve_device(device)
    n = len(msgs)
    blocks, nblocks = pad_md64(msgs)  # batch dim bucketed; sliced below
    words = sm3_blocks(torch.from_numpy(blocks.astype(np.int64)).to(dev), torch.from_numpy(nblocks).to(dev))
    return lambda: digest_words_to_bytes_be(words.cpu().numpy())[:n]


def words_be_to_bytes_device(words: torch.Tensor) -> torch.Tensor:
    """[..., 8] big-endian 32-bit words (int64) -> [..., 32] byte values."""
    shifts = torch.tensor([24, 16, 8, 0], device=words.device)
    return ((words[..., None] >> shifts) & 0xFF).reshape(*words.shape[:-1], 32)


def md64_pad_512bit(words16: torch.Tensor) -> torch.Tensor:
    """[B, 16] big-endian words of a 64-byte message -> its SM3 blocks
    [B, 2, 16]: the message, then 0x80‖0…‖bitlen 512."""
    tail = torch.zeros_like(words16)
    tail[:, 0] = 0x80000000
    tail[:, 15] = 512
    return torch.stack([words16, tail], dim=1)
