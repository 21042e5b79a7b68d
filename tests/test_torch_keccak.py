"""Port keccak256_blocks (plain PyTorch, int64 lanes) against the JAX
keccak256_blocks and the pure-Python oracle, plus the port's copies of the
host padding and the digest/limb adapters."""

import jax.numpy as jnp
import numpy as np
import torch

from fisco_bcos_tpu.ops import bigint as jbigint
from fisco_bcos_tpu.ops import hash_common as jhash
from fisco_bcos_tpu.ops import keccak as jkeccak
from fisco_bcos_tpu_torch.crypto.ref.keccak import keccak256
from fisco_bcos_tpu_torch.ops import bigint, hash_common, keccak


def _messages():
    rng = np.random.default_rng(11)
    msgs = [b"", b"a" * 135, b"b" * 136, b"c" * 137, b"d" * 271, b"e" * 272, b"f" * 300]
    msgs += [bytes(rng.integers(0, 256, int(n), dtype=np.uint8)) for n in rng.integers(0, 420, 9)]
    return msgs


def test_pad_keccak_is_the_jax_padding():
    msgs = _messages()
    blocks, nblocks = hash_common.pad_keccak(msgs)
    jblocks, jnblocks = jhash.pad_keccak(msgs)
    np.testing.assert_array_equal(blocks, jblocks)
    np.testing.assert_array_equal(nblocks, jnblocks)
    assert nblocks[: len(msgs)].max() >= 3  # multi-block messages are covered
    for n in (1, 31, 32, 33, 2047, 2049, 10_000):
        assert hash_common.bucket_batch(n) == jhash.bucket_batch(n)


def test_keccak256_blocks_matches_jax_and_oracle():
    msgs = _messages()
    blocks, nblocks = hash_common.pad_keccak(msgs)
    got = keccak.keccak256_blocks(
        torch.from_numpy(blocks.astype(np.int64)), torch.from_numpy(nblocks)
    )
    ref = np.asarray(jkeccak.keccak256_blocks(jnp.asarray(blocks), jnp.asarray(nblocks)))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    digests = hash_common.digest_words_to_bytes_le(got.numpy().astype(np.uint32))
    for i, m in enumerate(msgs):
        assert bytes(digests[i]) == keccak256(m), i
    for row in digests[len(msgs):]:  # bucket padding rows hash the empty message
        assert bytes(row) == keccak256(b"")


def test_digest_limb_adapters_match_jax():
    rng = np.random.default_rng(7)
    digests = rng.integers(0, 256, size=(9, 32), dtype=np.uint8)
    words = np.ascontiguousarray(digests).view("<u4").astype(np.uint32)
    got = bigint.bytes_be_to_limbs_device(torch.from_numpy(digests))
    ref = np.asarray(jbigint.digest_words_le_to_limbs(jnp.asarray(words)))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int32))
    np.testing.assert_array_equal(got.numpy(), bigint.bytes_be_to_limbs(digests).astype(np.int32))
    back = bigint.limbs_to_bytes_device(got)
    np.testing.assert_array_equal(back.numpy(), digests.astype(np.int32))
    jback = np.asarray(jbigint.limbs_to_bytes_device(jnp.asarray(ref)))
    np.testing.assert_array_equal(back.numpy(), jback.astype(np.int32))
