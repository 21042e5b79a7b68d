// SM3 (GB/T 32905) of one message, padded in registers: the arithmetic of
// sm3.cu, host compilable.
//
// The chaining state is 8 32-bit words in registers. The message schedule
// runs over a rolling window of 16 words: at round j the window holds
// W[j-12 .. j+3], and W[j+4] replaces W[j-12] in its slot. The 64 rounds
// unroll, so every slot index and every T_j <<< j is a constant.

#ifndef FISCO_SM3_CUH
#define FISCO_SM3_CUH

#include "hash_kernel.cuh"

HCONST uint32_t SM3_IV[8] = {
    0x7380166Fu, 0x4914B2B9u, 0x172442D7u, 0xDA8A0600u,
    0xA96F30BCu, 0x163138AAu, 0xE38DEE4Du, 0xB0FB0E4Eu,
};

HDEV uint32_t rotl32(uint32_t x, int n) {
  n &= 31;
  return n ? (x << n) | (x >> (32 - n)) : x;
}

HDEV uint32_t sm3_p0(uint32_t x) { return x ^ rotl32(x, 9) ^ rotl32(x, 17); }

HDEV uint32_t sm3_p1(uint32_t x) { return x ^ rotl32(x, 15) ^ rotl32(x, 23); }

// One compression: v ^= CF(v, block); w holds the block's 16 big-endian words
// and is used as the schedule's window.
HDEV void sm3_compress(uint32_t* v, uint32_t* w) {
  uint32_t a = v[0], b = v[1], c = v[2], d = v[3], e = v[4], f = v[5], g = v[6], h = v[7];
#pragma unroll
  for (int j = 0; j < 64; j++) {
    if (j >= 12) {  // W[j+4] = P1(W[j-12] ^ W[j-5] ^ (W[j+1] <<< 15)) ^ (W[j-9] <<< 7) ^ W[j-2]
      w[(j + 4) & 15] = sm3_p1(w[(j + 4) & 15] ^ w[(j + 11) & 15] ^ rotl32(w[(j + 1) & 15], 15)) ^
                        rotl32(w[(j + 7) & 15], 7) ^ w[(j + 14) & 15];
    }
    const uint32_t wj = w[j & 15];
    const uint32_t a12 = rotl32(a, 12);
    const uint32_t ss1 = rotl32(a12 + e + rotl32(j < 16 ? 0x79CC4519u : 0x7A879D8Au, j), 7);
    const uint32_t ss2 = ss1 ^ a12;
    const uint32_t ff = j < 16 ? a ^ b ^ c : (a & b) | (a & c) | (b & c);
    const uint32_t gg = j < 16 ? e ^ f ^ g : (e & f) | (~e & g);
    const uint32_t tt1 = ff + d + ss2 + (wj ^ w[(j + 4) & 15]);
    const uint32_t tt2 = gg + h + ss1 + wj;
    d = c;
    c = rotl32(b, 9);
    b = a;
    a = tt1;
    h = g;
    g = rotl32(f, 19);
    f = e;
    e = sm3_p0(tt2);
  }
  v[0] ^= a; v[1] ^= b; v[2] ^= c; v[3] ^= d;
  v[4] ^= e; v[5] ^= f; v[6] ^= g; v[7] ^= h;
}

// sm3(msg[0..len)) -> out[0..32), big-endian. Merkle–Damgård padding over
// (len + 8) / 64 + 1 blocks: 0x80 after the message, zeros, and the 64-bit
// big-endian bit length in the last block's last 8 bytes.
HDEV void sm3_message(const uint8_t* msg, int64_t len, uint8_t* out) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; i++) v[i] = SM3_IV[i];
  const int64_t nblocks = (len + 8) / 64 + 1;
  const uint64_t bits = (uint64_t)len * 8;
  for (int64_t blk = 0; blk < nblocks; blk++) {
    const int64_t off = blk * 64;
    const int64_t rem = len - off;  // message bytes from this block's start on
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; i++) {
      const int64_t k = rem - 4 * i;  // message bytes from this word's start on
      uint32_t word = load_bytes<uint32_t, 4, true>(msg + off + 4 * i, bytes_in_word(k, 4));
      if (k >= 0 && k < 4) word |= 0x80u << (24 - 8 * k);
      w[i] = word;
    }
    if (blk == nblocks - 1) {
      w[14] |= (uint32_t)(bits >> 32);
      w[15] |= (uint32_t)bits;
    }
    sm3_compress(v, w);
  }
#pragma unroll
  for (int i = 0; i < 32; i++) out[i] = (uint8_t)(v[i >> 2] >> (24 - 8 * (i & 3)));
}

#endif  // FISCO_SM3_CUH
