// SM3 (GB/T 32905) of one message, padded in registers: the arithmetic of
// sm3.cu, host compilable. A message comes through a reader
// (hash_kernel.cuh), as 64 bytes of big-endian words, or, for SM2's e, as a
// key after a per-ID midstate.
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

// Continue the chain v over msg[0..len) (a ByteReader or a WordReader) and
// pad: 0x80 after the message, zeros, and `bits` (the bit length of the
// whole message, bytes compressed into v before included) as a 64-bit
// big-endian value in the last block's last 8 bytes; (len + 8) / 64 + 1
// blocks. From the IV with bits = 8 len, this is SM3 of the message; from a
// midstate over whole 64-byte blocks, SM3 of those blocks and the message.
template <class R>
HDEV void sm3_absorb(uint32_t* v, const R& msg, int64_t len, uint64_t bits) {
  const int64_t nblocks = (len + 8) / 64 + 1;
  for (int64_t blk = 0; blk < nblocks; blk++) {
    const int64_t off = blk * 64;
    const int64_t rem = len - off;  // message bytes from this block's start on
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; i++) {
      const int64_t k = rem - 4 * i;  // message bytes from this word's start on
      uint32_t word = msg.be32(off + 4 * i, k);
      if (k >= 0 && k < 4) word |= 0x80u << (24 - 8 * k);
      w[i] = word;
    }
    if (blk == nblocks - 1) {
      w[14] |= (uint32_t)(bits >> 32);
      w[15] |= (uint32_t)bits;
    }
    sm3_compress(v, w);
  }
}

// sm3(msg[0..len)) -> out[0..32), big-endian, the bytes read where they lie.
HDEV void sm3_message(const uint8_t* msg, int64_t len, uint8_t* out) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; i++) v[i] = SM3_IV[i];
  sm3_absorb(v, ByteReader{msg}, len, (uint64_t)len * 8);
#pragma unroll
  for (int i = 0; i < 32; i++) out[i] = (uint8_t)(v[i >> 2] >> (24 - 8 * (i & 3)));
}

// SM3 of 64 bytes given as 16 big-endian words -> v, 8 big-endian words: the
// words' block, then the padding block of a 512-bit message.
HDEV void sm3_64(const uint32_t* be, uint32_t* v) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 8; i++) v[i] = SM3_IV[i];
#pragma unroll
  for (int i = 0; i < 16; i++) w[i] = be[i];
  sm3_compress(v, w);
#pragma unroll
  for (int i = 0; i < 16; i++) w[i] = 0;
  w[0] = 0x80000000u;
  w[15] = 512;
  sm3_compress(v, w);
}

// SM2's ZA midstate for one user ID, as ops/sm2.py za_state lays it out in
// 32 words: [0, 8) the chain after ZA's whole shared 64-byte blocks (ENTL ‖
// ID ‖ a ‖ b ‖ Gx ‖ Gy, cut at a multiple of 64), [8] the count t < 64 of
// that prefix's bytes after them, [9] ZA's whole length in bytes (prefix
// and key), [16, 32) 64 bytes in memory order whose last t are those bytes.
#define SM3_ZA_WORDS 32
// A lane's scratch row: the prefix's tail and the key (32 words), one more
// word that a reader may load, and rows 33 words apart, so that the lanes'
// same words fall in distinct banks.
#define SM3_E_ROW_WORDS 33

// e = SM3(ZA ‖ H), ZA = SM3(prefix ‖ key), continued from the midstate:
// za as above, `row` SM3_E_ROW_WORDS words of scratch, the key as 16
// big-endian words (x ‖ y), H as 8 -> e as 8 big-endian words. ZA never
// leaves registers; a lane compresses (t + 72) / 64 + 1 blocks for ZA and 2
// for e, 4 for the default ID.
HDEV void sm3_e_lane(const uint32_t* za, uint32_t* row, const uint32_t* key, const uint32_t* h,
                     uint32_t* e) {
  const uint32_t t = za[8];
#pragma unroll
  for (int i = 0; i < 16; i++) row[i] = za[16 + i];
#pragma unroll
  for (int i = 0; i < 16; i++) row[16 + i] = bswap32(key[i]);
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; i++) v[i] = za[i];
  sm3_absorb(v, WordReader{row, 64 - t}, t + 64, (uint64_t)za[9] * 8);
  uint32_t m[16];
#pragma unroll
  for (int i = 0; i < 8; i++) m[i] = v[i], m[8 + i] = h[i];
  sm3_64(m, e);
}

// The kernel bodies' hash policy (hash_kernel.cuh): digests leave as memory
// order words (d[j] = bytes 4j..4j+3, little-endian).
struct Sm3 {
  template <class R>
  HDEV void message(const R& msg, int64_t len, uint32_t* d) {
    uint32_t v[8];
#pragma unroll
    for (int i = 0; i < 8; i++) v[i] = SM3_IV[i];
    sm3_absorb(v, msg, len, (uint64_t)len * 8);
#pragma unroll
    for (int i = 0; i < 8; i++) d[i] = bswap32(v[i]);
  }
  HDEV void key(const uint32_t* be, uint32_t* d) {
    uint32_t v[8];
    sm3_64(be, v);
#pragma unroll
    for (int i = 0; i < 8; i++) d[i] = bswap32(v[i]);
  }
};

#endif  // FISCO_SM3_CUH
