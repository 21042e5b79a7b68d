"""Pure-Python SM3 (GB/T 32905-2016) — the 国密 hash used when sm_crypto is on
(reference: bcos-crypto hash/SM3.h via OpenSSL-tassl EVP). The port's copy:
the host oracle of its batch SM3."""

from __future__ import annotations

import struct

_IV = [
    0x7380166F, 0x4914B2B9, 0x172442D7, 0xDA8A0600,
    0xA96F30BC, 0x163138AA, 0xE38DEE4D, 0xB0FB0E4E,
]

_M32 = 0xFFFFFFFF


def _rotl(v: int, n: int) -> int:
    n %= 32
    return ((v << n) | (v >> (32 - n))) & _M32


def _p0(x: int) -> int:
    return x ^ _rotl(x, 9) ^ _rotl(x, 17)


def _p1(x: int) -> int:
    return x ^ _rotl(x, 15) ^ _rotl(x, 23)


def _compress(v: list[int], block: bytes) -> list[int]:
    w = list(struct.unpack(">16I", block))
    for j in range(16, 68):
        w.append(
            _p1(w[j - 16] ^ w[j - 9] ^ _rotl(w[j - 3], 15))
            ^ _rotl(w[j - 13], 7)
            ^ w[j - 6]
        )
    w1 = [w[j] ^ w[j + 4] for j in range(64)]
    a, b, c, d, e, f, g, h = v
    for j in range(64):
        t = 0x79CC4519 if j < 16 else 0x7A879D8A
        ss1 = _rotl((_rotl(a, 12) + e + _rotl(t, j)) & _M32, 7)
        ss2 = ss1 ^ _rotl(a, 12)
        if j < 16:
            ff = a ^ b ^ c
            gg = e ^ f ^ g
        else:
            ff = (a & b) | (a & c) | (b & c)
            gg = (e & f) | ((~e) & _M32 & g)
        tt1 = (ff + d + ss2 + w1[j]) & _M32
        tt2 = (gg + h + ss1 + w[j]) & _M32
        d = c
        c = _rotl(b, 9)
        b = a
        a = tt1
        h = g
        g = _rotl(f, 19)
        f = e
        e = _p0(tt2)
    return [x ^ y for x, y in zip(v, [a, b, c, d, e, f, g, h])]


def sm3(data: bytes) -> bytes:
    bitlen = len(data) * 8
    padded = bytearray(data)
    padded.append(0x80)
    while len(padded) % 64 != 56:
        padded.append(0)
    padded += struct.pack(">Q", bitlen)
    v = list(_IV)
    for off in range(0, len(padded), 64):
        v = _compress(v, bytes(padded[off : off + 64]))
    return struct.pack(">8I", *v)
