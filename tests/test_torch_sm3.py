"""Port SM3 (plain PyTorch) against the JAX package's sm3_batch and the
reference SM3, at one 32-lane bucket, plus the port's copies of the
Merkle–Damgård padding."""

import numpy as np
import pytest
import torch

from fisco_bcos_tpu.ops import hash_common as jhash_common
from fisco_bcos_tpu.ops import sm3 as jsm3
from fisco_bcos_tpu_torch.crypto.ref.sm3 import sm3 as ref_sm3
from fisco_bcos_tpu_torch.ops import hash_common, sm3

# lengths around every padding edge (55/56: the length field spills into a
# second block; 64: a whole block of message) and a few multi-block ones
LENGTHS = [0, 1, 3, 31, 32, 55, 56, 57, 63, 64, 65, 97, 119, 120, 128, 210, 300, 1000]


def _messages():
    rng = np.random.default_rng(41)
    msgs = [rng.bytes(n) for n in LENGTHS]
    msgs += [b"abc", b"abcd" * 16, bytes(64), b"\xff" * 64]
    return msgs


@pytest.fixture(scope="module")
def digests():
    msgs = _messages()
    assert len(msgs) <= 32  # one JAX bucket
    return msgs, sm3.sm3_batch(msgs, device="cpu"), np.asarray(jsm3.sm3_batch(msgs))


def test_sm3_matches_jax_bytewise(digests):
    _, port, jax_out = digests
    assert port.dtype == np.uint8 and port.shape == jax_out.shape
    np.testing.assert_array_equal(port, jax_out)


def test_sm3_matches_reference(digests):
    msgs, port, _ = digests
    for i, m in enumerate(msgs):
        assert bytes(port[i]) == ref_sm3(m), len(m)
    # GB/T 32905 appendix A, example 1
    assert ref_sm3(b"abc").hex().startswith("66c7f0f462eeedd9d1f2d46bdc10e4e2")


def test_sm3_blocks_stops_at_the_largest_block_count():
    """The block slots beyond the batch's largest nblocks are masked on
    every lane, so garbage there changes no digest."""
    blocks, nblocks = hash_common.pad_md64([b"a" * 70, b"b" * 3])
    m = int(nblocks.max())
    rng = np.random.default_rng(7)
    junk = rng.integers(0, 1 << 32, size=(blocks.shape[0], 3, 16), dtype=np.int64)
    longer = np.concatenate([blocks[:, :m].astype(np.int64), junk], axis=1)
    got = sm3.sm3_blocks(torch.from_numpy(longer), torch.from_numpy(nblocks))
    want = sm3.sm3_blocks(torch.from_numpy(blocks[:, :m].astype(np.int64)), torch.from_numpy(nblocks))
    assert torch.equal(got, want)
    assert bytes(hash_common.digest_words_to_bytes_be(got[0].numpy())) == ref_sm3(b"a" * 70)


def test_pad_md64_matches_jax():
    msgs = _messages()
    for part in (msgs[:1], msgs[:5], msgs):
        got, got_n = hash_common.pad_md64(part)
        want, want_n = jhash_common.pad_md64(part)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_n, want_n)
    words = np.arange(16, dtype=np.uint32).reshape(2, 8) * 0x01020305
    np.testing.assert_array_equal(
        hash_common.digest_words_to_bytes_be(words), jhash_common.digest_words_to_bytes_be(words)
    )
