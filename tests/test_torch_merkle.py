"""The port's wide merkle tree and hash plane (plain path, device="cpu")
against the JAX package's MerkleTree, merkle_root, verify_proof and hash
impls. On the CPU the JAX tree takes its native host route, which
tests/test_merkle.py pins equal to its fused device program."""

import hashlib

import numpy as np
import pytest
import torch

from fisco_bcos_tpu.crypto import suite as jsuite
from fisco_bcos_tpu.ops import merkle as jmerkle
from fisco_bcos_tpu_torch.crypto import suite
from fisco_bcos_tpu_torch.crypto.ref.poseidon import poseidon_hash
from fisco_bcos_tpu_torch.ops import _kernels, merkle

HASHERS = ("keccak256", "sm3")
LEAF_COUNTS = (1, 2, 15, 16, 17, 255, 256, 257, 4097)


def _leaves(n: int) -> np.ndarray:
    return np.random.default_rng(n).integers(0, 256, (n, 32), dtype=np.uint8)


@pytest.fixture(autouse=True)
def no_kernel_loader(monkeypatch):
    monkeypatch.setattr(_kernels, "_library", lambda name: pytest.fail("kernel loader called on CPU"))


@pytest.mark.parametrize("hasher", HASHERS)
@pytest.mark.parametrize("n", LEAF_COUNTS)
def test_tree_matches_jax(hasher, n):
    leaves = _leaves(n)
    tree = merkle.MerkleTree(leaves, hasher=hasher, device="cpu")
    ref = jmerkle.MerkleTree(leaves, hasher=hasher)
    assert len(tree.levels) == len(ref.levels)
    for got, want in zip(tree.levels, ref.levels):
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, np.asarray(want))
    assert tree.padded_root == ref.padded_root
    assert tree.root == ref.root
    assert merkle.merkle_root(leaves, hasher=hasher, device="cpu") == jmerkle.merkle_root(leaves, hasher=hasher)
    for i in {0, n // 2, n - 1}:
        proof = tree.proof(i)
        assert [(p.group, p.index) for p in proof] == [(p.group, p.index) for p in ref.proof(i)]
        assert merkle.MerkleTree.verify_proof(bytes(leaves[i]), i, n, proof, tree.root, hasher=hasher)


@pytest.mark.parametrize("hasher", HASHERS)
@pytest.mark.parametrize("width", [2, 3, 5])
def test_other_widths_match_jax(hasher, width):
    leaves = _leaves(41)
    tree = merkle.MerkleTree(leaves, width=width, hasher=hasher, device="cpu")
    ref = jmerkle.MerkleTree(leaves, width=width, hasher=hasher)
    assert tree.root == ref.root
    assert merkle.merkle_root(leaves, width, hasher, device="cpu") == ref.root
    proof = tree.proof(40)
    assert merkle.MerkleTree.verify_proof(bytes(leaves[40]), 40, 41, proof, ref.root, width, hasher)


@pytest.mark.parametrize("hasher", HASHERS)
def test_verify_proof_rejects_forgeries(hasher):
    n = 257
    leaves = _leaves(n)
    tree = merkle.MerkleTree(leaves, hasher=hasher, device="cpu")
    root, leaf, i = tree.root, bytes(leaves[200]), 200
    proof = tree.proof(i)
    verify = merkle.MerkleTree.verify_proof
    ok = lambda *a: verify(*a, hasher=hasher)  # noqa: E731
    assert ok(leaf, i, n, proof, root)
    assert jmerkle.MerkleTree.verify_proof(leaf, i, n, proof, root, hasher=hasher)
    assert not ok(leaf, i + 1, n, proof, root)  # another position
    assert not ok(leaf, i, n + 1, proof, root)  # another size
    assert not ok(leaf, n, n, proof, root) and not ok(leaf, -1, n, proof, root)
    assert not ok(leaf, i, n, proof[:-1], root)  # truncated
    assert not ok(leaf, i, n, proof + proof[-1:], root)  # too deep
    assert not ok(bytes(leaves[201]), i, n, proof, root)  # another leaf
    assert not ok(leaf[:31], i, n, proof, root)
    # an inner digest presented as a leaf, with the proof's upper levels
    inner = bytes(tree.levels[1][i // 16])
    assert not ok(inner, i // 16, n, proof[1:], root)
    # the same bytes regrouped: a 31-byte entry in the first group
    first = proof[0]
    joined = b"".join(first.group)
    regrouped = (joined[:31], joined[31:63]) + first.group[2:]
    forged = [merkle.MerkleProofItem(group=regrouped, index=first.index)] + proof[1:]
    assert not ok(leaf, i, n, forged, root)
    short = [merkle.MerkleProofItem(group=first.group[:-1], index=first.index)] + proof[1:]
    assert not ok(leaf, i, n, short, root)
    assert not ok(leaf, i, n, proof, root[::-1])


def test_bucket_leaves_and_bind_root_match_jax():
    for n in list(range(1, 600)) + [4095, 4096, 4097, 10_000, 10_240, 10_241, 65_537]:
        assert merkle.bucket_leaves(n) == jmerkle.bucket_leaves(n), n
    assert merkle.bucket_leaves(10_000) == 10_240
    for hasher in HASHERS:
        assert merkle.bind_root(bytes(32), 7, hasher) == jmerkle.bind_root(bytes(32), 7, hasher)


def test_tensor_leaves_and_async_root():
    leaves = _leaves(300)
    resolve = merkle.merkle_root_async(torch.from_numpy(leaves), hasher="sm3", device="cpu")
    assert resolve() == jmerkle.merkle_root(leaves, hasher="sm3")
    tree = merkle.MerkleTree(torch.from_numpy(leaves), device="cpu")
    assert tree.root == jmerkle.merkle_root(leaves)


def test_validation_errors():
    for bad in (np.zeros((3, 31), np.uint8), np.zeros((0, 32), np.uint8), np.zeros(32, np.uint8)):
        with pytest.raises(ValueError):
            merkle.merkle_root(bad, device="cpu")
        with pytest.raises(ValueError):
            merkle.MerkleTree(bad, device="cpu")
    with pytest.raises(ValueError):
        merkle.merkle_root(_leaves(4), width=1, device="cpu")
    with pytest.raises(KeyError, match="unknown hasher 'md5'"):
        merkle.merkle_root(_leaves(4), hasher="md5", device="cpu")
    with pytest.raises(KeyError, match="unknown hasher 'md5'"):
        suite.hash_impl_by_name("md5")
    # Poseidon is carried: one leaf is its own padded root, bound to its count
    assert suite.hash_impl_by_name("poseidon").name == "poseidon"
    assert merkle.merkle_root(_leaves(1), hasher="poseidon", device="cpu") == poseidon_hash(
        _leaves(1).tobytes() + (1).to_bytes(8, "big")
    )
    # SHA-256 is carried: 4 leaves are one group, bound to their count
    assert suite.hash_impl_by_name("sha256").name == "sha256"
    top = hashlib.sha256(_leaves(4).tobytes()).digest()
    assert merkle.merkle_root(_leaves(4), hasher="sha256", device="cpu") == hashlib.sha256(
        top + (4).to_bytes(8, "big")
    ).digest()
    with pytest.raises(IndexError):
        merkle.MerkleTree(_leaves(4), device="cpu").proof(4)


@pytest.mark.parametrize("hasher", HASHERS)
def test_hash_plane_matches_jax_hash(hasher):
    rng = np.random.default_rng(99)
    msgs = [rng.bytes(int(n)) for n in [0, 1, 64, 97, 135, 136, 210, 700] + rng.integers(0, 400, 8).tolist()]
    impl = suite.hash_impl_by_name(hasher)
    ref = {"keccak256": jsuite.Keccak256, "sm3": jsuite.SM3}[hasher]()
    assert impl.name == ref.name == hasher
    got = impl.hash_batch(msgs, device="cpu")
    got_async = impl.hash_batch_async(iter(msgs), device="cpu")()
    assert got.shape == (len(msgs), 32) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, got_async)
    for i, m in enumerate(msgs):
        assert bytes(got[i]) == ref.hash(m) == impl.hash(m), len(m)
    assert impl.hash_batch([], device="cpu").shape == (0, 32)
