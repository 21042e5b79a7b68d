"""The hash plane of the crypto suite (the hash half of the JAX package's
``crypto/suite.py``; reference: bcos-crypto Hash.h:37-60).

A single message hashes on the host through the port's ``crypto/ref``
hashes; a batch goes to the packed hash kernel, on the CUDA card unless the
caller passes ``device="cpu"``. Both give the same bytes. ``CryptoSuite``,
the signature implementations and the DevicePlane routing are not ported
yet (ROADMAP A2, A4).
"""

from __future__ import annotations

import numpy as np

from ..ops import keccak as keccak_ops
from ..ops import sm3 as sm3_ops
from ..ops.merkle import hasher_fns


class HashImpl:
    """A hash function with a single-message host call and a batch call."""

    name: str = ""

    def hash(self, data: bytes) -> bytes:
        return hasher_fns(self.name)[1](data)

    def hash_batch(self, msgs, device=None) -> np.ndarray:
        """list[bytes] -> [B, 32] uint8 digests, one kernel launch."""
        return self.hash_batch_async(msgs, device)()

    def hash_batch_async(self, msgs, device=None):
        """Dispatch the batch, defer the sync: () -> [B, 32] uint8."""
        raise NotImplementedError


class Keccak256(HashImpl):
    name = "keccak256"

    def hash_batch_async(self, msgs, device=None):
        return keccak_ops.keccak256_batch_async(list(msgs), device)


class SM3(HashImpl):
    name = "sm3"

    def hash_batch_async(self, msgs, device=None):
        return sm3_ops.sm3_batch_async(list(msgs), device)


_HASH_IMPLS: dict[str, type[HashImpl]] = {"keccak256": Keccak256, "sm3": SM3}


def hash_impl_by_name(name: str) -> HashImpl:
    """Hash impl registry lookup. An unknown name raises, naming what is
    not ported yet: one node silently hashing with another function than
    its peers would fork the state commitment."""
    hasher_fns(name)  # raises for a hasher the port does not carry
    return _HASH_IMPLS[name]()
