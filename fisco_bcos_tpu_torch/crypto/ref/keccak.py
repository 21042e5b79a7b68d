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


def _rotl(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _MASK


def keccak_f1600(state: list[int]) -> list[int]:
    """24-round Keccak-f[1600] permutation over 25 lanes (index = x + 5y)."""
    A = list(state)
    for rc in _RC:
        # theta
        C = [A[x] ^ A[x + 5] ^ A[x + 10] ^ A[x + 15] ^ A[x + 20] for x in range(5)]
        D = [C[(x - 1) % 5] ^ _rotl(C[(x + 1) % 5], 1) for x in range(5)]
        A = [A[i] ^ D[i % 5] for i in range(25)]
        # rho + pi: B[y, 2x+3y] = rot(A[x, y])
        B = [0] * 25
        for x in range(5):
            for y in range(5):
                B[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(A[x + 5 * y], _ROT[x][y])
        # chi
        A = [
            B[x + 5 * y] ^ ((~B[(x + 1) % 5 + 5 * y]) & _MASK & B[(x + 2) % 5 + 5 * y])
            for y in range(5)
            for x in range(5)
        ]
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
