"""Host-side batch padding for the device hash programs (the port's copy).

A whole batch is padded into a dense ``[B, M, words]`` block tensor plus a
per-lane block count; the device program runs over the M block slots and
masks inactive lanes. B and M follow a bounded bucket ladder, the same as
the JAX package's, so the two packages pad every batch identically.
"""

from __future__ import annotations

import os
from collections.abc import Sequence

import numpy as np


def _bucket(n: int) -> int:
    """Round up to a bounded set of batch shapes: powers of two up to 2048,
    then multiples of 2048 (a 10k-tx block pads to 10240 lanes, not 16384 —
    padding waste stays under 2%).

    FISCO_TEST_BUCKET=<q> quantizes every batch to multiples of q instead,
    exactly as in the JAX package (its test suite sets it)."""
    q = int(os.environ.get("FISCO_TEST_BUCKET", "0"))
    if q:
        return max(q, -(-n // q) * q)
    if n <= 2048:
        m = 1
        while m < n:
            m *= 2
        return m
    return -(-n // 2048) * 2048


bucket_batch = _bucket  # shared by the EC host wrappers


def pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    """Zero-pad a batch array along axis 0 to `rows` (bucketed batch sizes)."""
    if a.shape[0] == rows:
        return a
    pad = np.zeros((rows - a.shape[0],) + a.shape[1:], dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def pad_keccak(
    msgs: Sequence[bytes], rate: int = 136
) -> tuple[np.ndarray, np.ndarray]:
    """Keccak multi-rate padding (0x01 … 0x80 legacy domain).

    Returns (blocks [B', M, rate//8, 2] uint32 little-endian lo/hi lane
    halves, nblocks [B'] int32), where B' = _bucket(len(msgs)) and M is the
    bucketed largest block count. Padding rows are empty messages; callers
    that need exactly len(msgs) digests slice the result.
    """
    b_pad = _bucket(max(len(msgs), 1))
    nblocks = np.array(
        [len(m) // rate + 1 for m in msgs] + [1] * (b_pad - len(msgs)),
        dtype=np.int32,
    )
    m_max = _bucket(int(nblocks.max()))
    lanes = rate // 8
    buf = np.zeros((b_pad, m_max * rate), dtype=np.uint8)
    for i, m in enumerate(msgs):
        buf[i, : len(m)] = np.frombuffer(m, dtype=np.uint8)
        end = nblocks[i] * rate
        buf[i, len(m)] ^= 0x01
        buf[i, end - 1] ^= 0x80
    if b_pad > len(msgs):  # all pad rows are the padded empty message
        buf[len(msgs):, 0] = 0x01
        buf[len(msgs):, rate - 1] = 0x80
    words = buf.view("<u4").reshape(b_pad, m_max, lanes, 2)
    return words.astype(np.uint32), nblocks


def pad_md64(
    msgs: Sequence[bytes],
) -> tuple[np.ndarray, np.ndarray]:
    """Merkle–Damgård padding with 64-bit big-endian length (SHA-256 and SM3
    share it): 0x80, zeros, bitlen. Returns (blocks [B', M, 16] uint32
    big-endian words, nblocks [B'] int32); B' = _bucket(len(msgs)) with
    empty-message padding rows, exactly like :func:`pad_keccak`."""
    b_pad = _bucket(max(len(msgs), 1))
    nblocks = np.array(
        [(len(m) + 8) // 64 + 1 for m in msgs] + [1] * (b_pad - len(msgs)),
        dtype=np.int32,
    )
    m_max = _bucket(int(nblocks.max()))
    buf = np.zeros((b_pad, m_max * 64), dtype=np.uint8)
    for i, m in enumerate(msgs):
        buf[i, : len(m)] = np.frombuffer(m, dtype=np.uint8)
        buf[i, len(m)] = 0x80
        end = nblocks[i] * 64
        buf[i, end - 8 : end] = np.frombuffer(
            (len(m) * 8).to_bytes(8, "big"), dtype=np.uint8
        )
    if b_pad > len(msgs):  # pad rows: empty message = 0x80 + zero bitlen
        buf[len(msgs):, 0] = 0x80
    words = buf.view(">u4").reshape(b_pad, m_max, 16)
    return words.astype(np.uint32), nblocks


def pad_md64_rows(data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """:func:`pad_md64` for a [B, L] uint8 batch of equal-length messages,
    vectorised and unbucketed: (blocks [B, M, 16] uint32 big-endian words,
    nblocks [B] int32), M = (L + 8) // 64 + 1 exactly. The blocks a message
    uses are the ones pad_md64 gives it; pad_md64's extra masked block slots
    and pad rows change no digest."""
    data = np.asarray(data, dtype=np.uint8)
    bsz, length = data.shape
    m = (length + 8) // 64 + 1
    buf = np.zeros((bsz, m * 64), dtype=np.uint8)
    buf[:, :length] = data
    buf[:, length] = 0x80
    buf[:, -8:] = np.frombuffer((length * 8).to_bytes(8, "big"), dtype=np.uint8)
    words = buf.view(">u4").reshape(bsz, m, 16).astype(np.uint32)
    return words, np.full(bsz, m, dtype=np.int32)


def digest_words_to_bytes_le(words: np.ndarray) -> np.ndarray:
    """[B, 8] uint32 little-endian words -> [B, 32] uint8 (keccak digests)."""
    return np.ascontiguousarray(np.asarray(words, dtype="<u4")).view(np.uint8).reshape(
        *words.shape[:-1], 32
    )


def digest_words_to_bytes_be(words: np.ndarray) -> np.ndarray:
    """[B, 8] uint32 big-endian words -> [B, 32] uint8 (sha256/sm3 digests)."""
    return (
        np.ascontiguousarray(np.asarray(words, dtype=np.uint32).astype(">u4"))
        .view(np.uint8)
        .reshape(*words.shape[:-1], 32)
    )
