"""Pure-Python Keccak-256 (legacy 0x01 padding, as used for Ethereum-style tx
hashing in the reference's Keccak256 hasher — bcos-crypto hash/Keccak256.h).

NIST SHA3-256 differs only in the domain-separation padding byte (0x06)."""

from __future__ import annotations

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# Rotation offsets r[x][y] (x = column, y = row), lane index = x + 5*y.
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK = (1 << 64) - 1


# rho + pi as (source lane, destination lane, rotation): B[y, 2x+3y] = rot(A[x, y])
_RHO_PI = [(x + 5 * y, y + 5 * ((2 * x + 3 * y) % 5), _ROT[x][y]) for x in range(5) for y in range(5)]


def keccak_f1600(state: list[int]) -> list[int]:
    """24-round Keccak-f[1600] permutation over 25 lanes (index = x + 5y)."""
    A = list(state)
    B = [0] * 25
    M = _MASK
    for rc in _RC:
        # theta
        c0 = A[0] ^ A[5] ^ A[10] ^ A[15] ^ A[20]
        c1 = A[1] ^ A[6] ^ A[11] ^ A[16] ^ A[21]
        c2 = A[2] ^ A[7] ^ A[12] ^ A[17] ^ A[22]
        c3 = A[3] ^ A[8] ^ A[13] ^ A[18] ^ A[23]
        c4 = A[4] ^ A[9] ^ A[14] ^ A[19] ^ A[24]
        D = (
            c4 ^ (((c1 << 1) | (c1 >> 63)) & M),
            c0 ^ (((c2 << 1) | (c2 >> 63)) & M),
            c1 ^ (((c3 << 1) | (c3 >> 63)) & M),
            c2 ^ (((c4 << 1) | (c4 >> 63)) & M),
            c3 ^ (((c0 << 1) | (c0 >> 63)) & M),
        )
        # theta's column parity applied, then rho + pi
        for src, dst, r in _RHO_PI:
            v = A[src] ^ D[src % 5]
            B[dst] = ((v << r) | (v >> (64 - r))) & M if r else v
        # chi (~b & c stays within 64 bits for a non-negative c)
        for y in (0, 5, 10, 15, 20):
            b0, b1, b2, b3, b4 = B[y : y + 5]
            A[y] = b0 ^ (~b1 & b2)
            A[y + 1] = b1 ^ (~b2 & b3)
            A[y + 2] = b2 ^ (~b3 & b4)
            A[y + 3] = b3 ^ (~b4 & b0)
            A[y + 4] = b4 ^ (~b0 & b1)
        # iota
        A[0] ^= rc
    return A


def _keccak(data: bytes, rate: int, out_len: int, pad_byte: int) -> bytes:
    state = [0] * 25
    # multi-rate padding
    padded = bytearray(data)
    padded.append(pad_byte)
    while len(padded) % rate:
        padded.append(0)
    padded[-1] |= 0x80
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        state = keccak_f1600(state)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(out_len // 8))
    return out[:out_len]


def keccak256(data: bytes) -> bytes:
    return _keccak(data, rate=136, out_len=32, pad_byte=0x01)


def sha3_256(data: bytes) -> bytes:
    return _keccak(data, rate=136, out_len=32, pad_byte=0x06)
