"""SHA-256 reference (hashlib; the port's copy of the JAX package's
``crypto/ref/sha2.py``): the host oracle of the port's batch SHA-256 and its
single-message hash."""

from __future__ import annotations

import hashlib


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()
