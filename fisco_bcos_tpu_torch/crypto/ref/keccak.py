"""Pure-Python Keccak-256 (legacy 0x01 padding, as used for Ethereum-style tx
hashing in the reference's Keccak256 hasher — bcos-crypto hash/Keccak256.h).

NIST SHA3-256 differs only in the domain-separation padding byte (0x06)."""

from __future__ import annotations

from struct import unpack_from

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_MASK = (1 << 64) - 1


def keccak_f1600(state: list[int]) -> list[int]:
    """24-round Keccak-f[1600] permutation over 25 lanes (index = x + 5y),
    each round written out over local lanes: theta's column parities c and
    their mixes d; rho + pi into b, B[y, 2x+3y] = rot(A[x, y] ^ d[x],
    r[x][y]) with the rotation offsets of FIPS 202 Table 2; chi back into
    a (~b & c stays within 64 bits for a non-negative c); iota."""
    (a0, a1, a2, a3, a4, a5, a6, a7, a8, a9, a10, a11, a12,
     a13, a14, a15, a16, a17, a18, a19, a20, a21, a22, a23, a24) = state
    M = _MASK
    for rc in _RC:
        c0 = a0 ^ a5 ^ a10 ^ a15 ^ a20
        c1 = a1 ^ a6 ^ a11 ^ a16 ^ a21
        c2 = a2 ^ a7 ^ a12 ^ a17 ^ a22
        c3 = a3 ^ a8 ^ a13 ^ a18 ^ a23
        c4 = a4 ^ a9 ^ a14 ^ a19 ^ a24
        d0 = c4 ^ (((c1 << 1) | (c1 >> 63)) & M)
        d1 = c0 ^ (((c2 << 1) | (c2 >> 63)) & M)
        d2 = c1 ^ (((c3 << 1) | (c3 >> 63)) & M)
        d3 = c2 ^ (((c4 << 1) | (c4 >> 63)) & M)
        d4 = c3 ^ (((c0 << 1) | (c0 >> 63)) & M)
        b0 = a0 ^ d0
        v = a6 ^ d1
        b1 = ((v << 44) | (v >> 20)) & M
        v = a12 ^ d2
        b2 = ((v << 43) | (v >> 21)) & M
        v = a18 ^ d3
        b3 = ((v << 21) | (v >> 43)) & M
        v = a24 ^ d4
        b4 = ((v << 14) | (v >> 50)) & M
        v = a3 ^ d3
        b5 = ((v << 28) | (v >> 36)) & M
        v = a9 ^ d4
        b6 = ((v << 20) | (v >> 44)) & M
        v = a10 ^ d0
        b7 = ((v << 3) | (v >> 61)) & M
        v = a16 ^ d1
        b8 = ((v << 45) | (v >> 19)) & M
        v = a22 ^ d2
        b9 = ((v << 61) | (v >> 3)) & M
        v = a1 ^ d1
        b10 = ((v << 1) | (v >> 63)) & M
        v = a7 ^ d2
        b11 = ((v << 6) | (v >> 58)) & M
        v = a13 ^ d3
        b12 = ((v << 25) | (v >> 39)) & M
        v = a19 ^ d4
        b13 = ((v << 8) | (v >> 56)) & M
        v = a20 ^ d0
        b14 = ((v << 18) | (v >> 46)) & M
        v = a4 ^ d4
        b15 = ((v << 27) | (v >> 37)) & M
        v = a5 ^ d0
        b16 = ((v << 36) | (v >> 28)) & M
        v = a11 ^ d1
        b17 = ((v << 10) | (v >> 54)) & M
        v = a17 ^ d2
        b18 = ((v << 15) | (v >> 49)) & M
        v = a23 ^ d3
        b19 = ((v << 56) | (v >> 8)) & M
        v = a2 ^ d2
        b20 = ((v << 62) | (v >> 2)) & M
        v = a8 ^ d3
        b21 = ((v << 55) | (v >> 9)) & M
        v = a14 ^ d4
        b22 = ((v << 39) | (v >> 25)) & M
        v = a15 ^ d0
        b23 = ((v << 41) | (v >> 23)) & M
        v = a21 ^ d1
        b24 = ((v << 2) | (v >> 62)) & M
        a0 = b0 ^ (~b1 & b2)
        a1 = b1 ^ (~b2 & b3)
        a2 = b2 ^ (~b3 & b4)
        a3 = b3 ^ (~b4 & b0)
        a4 = b4 ^ (~b0 & b1)
        a5 = b5 ^ (~b6 & b7)
        a6 = b6 ^ (~b7 & b8)
        a7 = b7 ^ (~b8 & b9)
        a8 = b8 ^ (~b9 & b5)
        a9 = b9 ^ (~b5 & b6)
        a10 = b10 ^ (~b11 & b12)
        a11 = b11 ^ (~b12 & b13)
        a12 = b12 ^ (~b13 & b14)
        a13 = b13 ^ (~b14 & b10)
        a14 = b14 ^ (~b10 & b11)
        a15 = b15 ^ (~b16 & b17)
        a16 = b16 ^ (~b17 & b18)
        a17 = b17 ^ (~b18 & b19)
        a18 = b18 ^ (~b19 & b15)
        a19 = b19 ^ (~b15 & b16)
        a20 = b20 ^ (~b21 & b22)
        a21 = b21 ^ (~b22 & b23)
        a22 = b22 ^ (~b23 & b24)
        a23 = b23 ^ (~b24 & b20)
        a24 = b24 ^ (~b20 & b21)
        a0 ^= rc
    return [a0, a1, a2, a3, a4, a5, a6, a7, a8, a9, a10, a11, a12,
            a13, a14, a15, a16, a17, a18, a19, a20, a21, a22, a23, a24]


def _keccak(data: bytes, rate: int, out_len: int, pad_byte: int) -> bytes:
    state = [0] * 25
    words = f"<{rate // 8}Q"
    # multi-rate padding
    padded = bytearray(data)
    padded.append(pad_byte)
    padded += bytes(-len(padded) % rate)
    padded[-1] |= 0x80
    for off in range(0, len(padded), rate):
        for i, w in enumerate(unpack_from(words, padded, off)):
            state[i] ^= w
        state = keccak_f1600(state)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(out_len // 8))
    return out[:out_len]


def keccak256(data: bytes) -> bytes:
    return _keccak(data, rate=136, out_len=32, pad_byte=0x01)


def sha3_256(data: bytes) -> bytes:
    return _keccak(data, rate=136, out_len=32, pad_byte=0x06)
