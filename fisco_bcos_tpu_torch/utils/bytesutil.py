"""Fixed-bytes helpers (reference: bcos-utilities/FixedBytes.h h160/h256;
the port's copy of the JAX package's ``utils/bytesutil.py``)."""

from __future__ import annotations


def h256(data: bytes) -> bytes:
    """Normalize to exactly 32 bytes (left-pad with zeros, error on overflow)."""
    if len(data) > 32:
        raise ValueError(f"h256 overflow: {len(data)} bytes")
    return data.rjust(32, b"\x00")


def to_hex(data: bytes, prefix: bool = True) -> str:
    return ("0x" if prefix else "") + data.hex()


def from_hex(s: str) -> bytes:
    if s.startswith(("0x", "0X")):
        s = s[2:]
    if len(s) % 2:
        s = "0" + s
    return bytes.fromhex(s)


def int_to_bytes32(v: int) -> bytes:
    return int(v).to_bytes(32, "big")


def bytes32_to_int(b: bytes) -> int:
    return int.from_bytes(b, "big")


def right160(b: bytes) -> bytes:
    """Rightmost 160 bits of a 32-byte hash — address derivation
    (reference: bcos-crypto CryptoSuite.h:56-59 calculateAddress)."""
    return b[-20:]
