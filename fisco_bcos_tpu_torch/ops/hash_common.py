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


def digest_words_to_bytes_le(words: np.ndarray) -> np.ndarray:
    """[B, 8] uint32 little-endian words -> [B, 32] uint8 (keccak digests)."""
    return np.ascontiguousarray(np.asarray(words, dtype="<u4")).view(np.uint8).reshape(
        *words.shape[:-1], 32
    )
