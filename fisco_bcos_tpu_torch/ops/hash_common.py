"""Batch layouts of the hash functions (the port's copy of the JAX
package's host padding, and the packed form the port's kernels take).

The packed form: one byte buffer plus per-message starts and lengths; the
hash kernels pad each message themselves (:func:`pack_messages`,
:func:`rows_as_packed`).

The JAX padding: a whole batch padded into a dense ``[B, M, words]`` block
tensor plus a per-lane block count; the device program runs over the M
block slots and masks inactive lanes. B and M follow a bounded bucket
ladder, the same as the JAX package's, so the two packages pad every batch
identically. The tests hold the port's blocks-form functions against the
JAX ones through it.
"""

from __future__ import annotations

import os
from collections.abc import Sequence

import numpy as np
import torch


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


def bucket_ladder(max_n: int) -> list[int]:
    """Every bucket :func:`_bucket` can produce for batches up to ``max_n``:
    the most distinct batch shapes a flood of sizes ≤ max_n can launch per
    op, which the device observatory's storm bound counts. Honors
    FISCO_TEST_BUCKET quantization like _bucket itself."""
    max_n = max(int(max_n), 1)
    ladder: list[int] = []
    n = 1
    while True:
        b = _bucket(n)
        if not ladder or b != ladder[-1]:
            ladder.append(b)
        if b >= max_n:
            return ladder
        n = b + 1


def pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    """Zero-pad a batch array along axis 0 to `rows` (bucketed batch sizes)."""
    if a.shape[0] == rows:
        return a
    pad = np.zeros((rows - a.shape[0],) + a.shape[1:], dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def pack_messages(msgs: Sequence[bytes]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Messages (bytes-like) -> (data uint8 [N], starts int64 [B], lengths
    int32 [B]): message i is data[starts[i] : starts[i] + lengths[i]]. One
    join, no loop over the messages in Python."""
    data = np.frombuffer(bytearray().join(msgs), dtype=np.uint8)
    lengths = np.fromiter(map(len, msgs), dtype=np.int32, count=len(msgs))
    starts = np.zeros(len(msgs), dtype=np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    return data, starts, lengths


def rows_as_packed(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A [B, L] uint8 tensor of equal-length messages as a packed batch on
    its device: (data [B·L], starts = arange(B)·L int64, lengths = L int32)."""
    rows = rows.contiguous()
    bsz, length = rows.shape
    starts = torch.arange(bsz, dtype=torch.int64, device=rows.device) * length
    lengths = torch.full((bsz,), length, dtype=torch.int32, device=rows.device)
    return rows.reshape(-1), starts, lengths


def gather_padded(data, starts, lengths, block_bytes: int, nblocks) -> torch.Tensor:
    """The messages of a packed batch as zero-filled rows of
    nblocks.max() blocks: [B, M·block_bytes] int64 byte values."""
    width = block_bytes * int(nblocks.max())
    pos = torch.arange(width, device=data.device)
    inside = pos < lengths[:, None]
    idx = torch.where(inside, starts[:, None] + pos, data.numel())  # past the end: the zero
    return torch.nn.functional.pad(data, (0, 1))[idx].to(torch.int64)


def md64_words(data, starts, lengths) -> tuple[torch.Tensor, torch.Tensor]:
    """The Merkle–Damgård padding SHA-256 and SM3 share, of each message of
    a packed batch (data uint8 [N], starts int64 [B], lengths int32 [B]), on
    the inputs' device: 0x80, zeros, the 64-bit big-endian bit length.
    Returns (blocks [B, M, 16] int64 big-endian words, nblocks [B] int64),
    M the largest block count."""
    bsz = starts.shape[0]
    lengths = lengths.to(torch.int64)
    nblocks = (lengths + 8) // 64 + 1
    buf = gather_padded(data, starts, lengths, 64, nblocks)
    pos = torch.arange(buf.shape[1], device=data.device)
    buf |= (pos == lengths[:, None]) * 0x80
    # the 64-bit big-endian bit length in the last block's last 8 bytes
    from_end = nblocks[:, None] * 64 - 1 - pos
    in_len = (from_end >= 0) & (from_end < 8)
    buf |= torch.where(in_len, ((lengths * 8)[:, None] >> (8 * from_end.clamp(0, 7))) & 0xFF, 0)
    shifts = torch.tensor([24, 16, 8, 0], device=data.device)
    return (buf.view(bsz, -1, 16, 4) << shifts).sum(-1), nblocks


def digest_bytes(words: torch.Tensor, shifts) -> torch.Tensor:
    """[B, 8] 32-bit digest words -> [B, 32] uint8, each word's bytes taken
    at `shifts`."""
    shifts = torch.tensor(shifts, device=words.device)
    return ((words[..., None] >> shifts) & 0xFF).reshape(words.shape[0], 32).to(torch.uint8)


def upload_packed(msgs, dev) -> tuple[torch.Tensor, ...]:
    """pack_messages(msgs) as tensors on `dev`."""
    return tuple(torch.from_numpy(a).to(dev) for a in pack_messages(msgs))


def download_later(t: torch.Tensor):
    """A resolver () -> `t` as a numpy array, for a tensor that a kernel
    launched on this thread's current stream writes. On the card the copy
    waits on an event recorded here, after the launch, so it follows the
    kernel on whatever thread and stream resolve it: the DevicePlane's
    worker launches, the caller resolves, and a caller inside
    ``torch.cuda.stream(s)`` copies on s."""
    if t.device.type != "cuda":
        return lambda: t.numpy()
    launched = torch.cuda.Event()
    launched.record(torch.cuda.current_stream(t.device))

    def resolve():
        torch.cuda.current_stream(t.device).wait_event(launched)
        return t.cpu().numpy()

    return resolve


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
