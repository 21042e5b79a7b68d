"""Wide merkle trees on the packed hash kernels (the port of the JAX
package's ``ops/merkle.py``).

Reference counterpart: bcos-crypto/bcos-crypto/merkle/Merkle.h:35-230
(templated on hasher and width, default width 16). A level with L nodes is
one launch of the packed hash over the level's own ``[L, 32]`` buffer:
group g is the bytes of nodes g·width … g·width + width − 1, so its start is
g·32·width and its length min(width, L − g·width)·32 — the short last
group keeps its true length, as in the reference. The whole tree stays on
the device, with no host copy between levels; a tree is built over the
bucket-padded leaf set (:func:`bucket_leaves`) and its root bound to the
real leaf count (:func:`bind_root`).

Unlike the reference, nothing here picks the host: the levels run on the
CUDA card unless the caller passes ``device="cpu"`` (the plain path). The
single-message hashes (the root binding, a proof's levels) run on the host
through the port's ``crypto/ref`` hashes, which give the kernels' bytes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..crypto.ref.keccak import keccak256 as ref_keccak256
from ..crypto.ref.poseidon import poseidon_hash as ref_poseidon
from ..crypto.ref.sha2 import sha256 as ref_sha256
from ..crypto.ref.sm3 import sm3 as ref_sm3
from ..device import resolve_device
from ..observability.device import device_span
from .keccak import keccak256_packed
from .poseidon import poseidon_packed
from .sha256 import sha256_packed
from .sm3 import sm3_packed

# hasher name -> (the packed batch hash, the host hash of one message)
_HASHERS = {
    "keccak256": (keccak256_packed, ref_keccak256),
    "sm3": (sm3_packed, ref_sm3),
    "sha256": (sha256_packed, ref_sha256),
    "poseidon": (poseidon_packed, ref_poseidon),
}


def hasher_fns(name: str):
    """(packed batch hash, host hash) of a hasher the port carries. Any
    other name raises: one node hashing with another function than its
    peers would fork the chain."""
    try:
        return _HASHERS[name]
    except KeyError:
        raise KeyError(
            f"unknown hasher {name!r}: the port carries keccak256, sm3, sha256 and "
            "poseidon, every hasher of the JAX package"
        ) from None


def bucket_leaves(n: int) -> int:
    """Leaf-count bucket (the reference's): the smallest m·2^j ≥ n with
    16 ≤ m ≤ 32; up to 16 leaves keep their exact size."""
    if n <= 16:
        return n
    j = n.bit_length() - 5
    return -(-n // (1 << j)) << j


def bind_root(padded_root: bytes, n: int, hasher: str = "keccak256") -> bytes:
    """Final root = H(padded_root ‖ u64be(n)): binding the real leaf count
    keeps trees of different n in one bucket apart."""
    return hasher_fns(hasher)[1](bytes(padded_root) + int(n).to_bytes(8, "big"))


@dataclass(frozen=True)
class MerkleProofItem:
    """One level of a wide merkle proof: the child group containing the
    target, plus the target's index within the group."""

    group: tuple[bytes, ...]
    index: int


def _level(cur: torch.Tensor, width: int, packed_hash) -> torch.Tensor:
    """One level: [L, 32] uint8 -> [ceil(L / width), 32], one launch."""
    n = cur.shape[0]
    first = torch.arange(0, n, width, device=cur.device)  # each group's first node
    starts = first * 32
    lengths = ((n - first).clamp(max=width) * 32).to(torch.int32)
    return packed_hash(cur.reshape(-1), starts, lengths)


def _padded_leaves(leaves, width: int, device) -> tuple[torch.Tensor, int]:
    """Checked leaves, zero-filled to their bucket, on the resolved device:
    ([bucket_leaves(n), 32] uint8, n)."""
    if width < 2:
        raise ValueError("width must be >= 2")
    dev = resolve_device(device)
    if isinstance(leaves, torch.Tensor):
        leaves = leaves.to(dev, torch.uint8)
    else:
        leaves = torch.tensor(np.asarray(leaves, dtype=np.uint8), device=dev)
    if leaves.dim() != 2 or leaves.shape[1] != 32:
        raise ValueError("leaves must be [N, 32] uint8")
    n = leaves.shape[0]
    if n == 0:
        raise ValueError("merkle tree needs at least one leaf")
    filler = torch.zeros((bucket_leaves(n) - n, 32), dtype=torch.uint8, device=dev)
    return torch.cat([leaves, filler]), n


def _device_levels(leaves: torch.Tensor, width: int, hasher: str) -> list[torch.Tensor]:
    """All levels bottom-up on the leaves' device; the last is the [1, 32]
    padded root."""
    packed_hash = hasher_fns(hasher)[0]
    levels = [leaves]
    while levels[-1].shape[0] > 1:
        levels.append(_level(levels[-1], width, packed_hash))
    return levels


class MerkleTree:
    """Wide merkle tree over 32-byte leaf hashes.

    `leaves` is an [N, 32] uint8 array or tensor (already-hashed items, e.g.
    tx hashes). Every level is kept, as [L, 32] uint8 numpy arrays, for
    proofs. Built on the CUDA card unless ``device`` names another; the
    levels come to the host in one copy."""

    def __init__(self, leaves, width: int = 16, hasher: str = "keccak256", device=None):
        padded, self.n = _padded_leaves(leaves, width, device)
        self.width = width
        self.hasher = hasher
        levels = _device_levels(padded, width, hasher)
        flat = torch.cat(levels).cpu().numpy()
        bounds = np.cumsum([0] + [lv.shape[0] for lv in levels])
        self.levels = [flat[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]

    @property
    def padded_root(self) -> bytes:
        """Root of the bucket-padded tree."""
        return bytes(self.levels[-1][0])

    @property
    def root(self) -> bytes:
        return bind_root(self.padded_root, self.n, self.hasher)

    def proof(self, leaf_index: int) -> list[MerkleProofItem]:
        """Proof for leaf `leaf_index`: one child group per level below root."""
        if not 0 <= leaf_index < self.n:
            raise IndexError("leaf index out of range")
        items: list[MerkleProofItem] = []
        idx = leaf_index
        for level in self.levels[:-1]:
            g0 = (idx // self.width) * self.width
            group = tuple(bytes(h) for h in level[g0 : g0 + self.width])
            items.append(MerkleProofItem(group=group, index=idx - g0))
            idx //= self.width
        return items

    @staticmethod
    def verify_proof(
        leaf: bytes,
        leaf_index: int,
        n_leaves: int,
        proof: list[MerkleProofItem],
        root: bytes,
        width: int = 16,
        hasher: str = "keccak256",
    ) -> bool:
        """Recompute the path from a positioned leaf up to `root`, on the
        host. (leaf_index, n_leaves) pin the proof's depth and every group's
        size and offset, so a truncated proof cannot certify an inner digest
        as a leaf, and every group entry must be a 32-byte digest, so a
        regrouping of the same bytes cannot forge a member."""
        host_hash = hasher_fns(hasher)[1]
        if not 0 <= leaf_index < n_leaves:
            return False
        if len(leaf) != 32:
            return False
        cur = leaf
        # group sizes and depth follow the padded size; bind_root pins the real n
        idx, size = leaf_index, bucket_leaves(n_leaves)
        for item in proof:
            if size <= 1:
                return False  # proof longer than the tree is deep
            g0 = (idx // width) * width
            if item.index != idx - g0:
                return False
            if len(item.group) != min(width, size - g0):
                return False
            if any(len(h) != 32 for h in item.group):
                return False
            if item.group[item.index] != cur:
                return False
            cur = host_hash(b"".join(item.group))
            idx //= width
            size = -(-size // width)
        if size != 1:
            return False  # proof shorter than the tree is deep
        return bind_root(cur, n_leaves, hasher) == root


def merkle_root_async(leaves, width: int = 16, hasher: str = "keccak256", device=None):
    """Dispatch every level of the tree, defer the sync: returns a resolver
    () -> root bytes, which copies the 32-byte padded root to the host once.
    `leaves` may already lie on the card (the tx hashes from the hash
    kernel, say). Runs on the CUDA card unless ``device`` names another.
    One ``merkle_root`` span covers the dispatch (the JAX span's place,
    so ``merkle_root`` and the suites' sealing calls are both counted); the
    resolver's copy is the caller's wait."""
    n = len(leaves)
    with device_span("merkle_root", n, shape_key=(hasher, width, bucket_leaves(max(n, 1)))):
        padded, n = _padded_leaves(leaves, width, device)
        top = _device_levels(padded, width, hasher)[-1]
    return lambda: bind_root(bytes(top[0].cpu().numpy()), n, hasher)


def merkle_root(leaves, width: int = 16, hasher: str = "keccak256", device=None) -> bytes:
    """Root only (the block-sealing hot path: tx and receipt roots)."""
    return merkle_root_async(leaves, width, hasher, device)()
