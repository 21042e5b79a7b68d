// SHA-256 (FIPS 180-4) of one message, padded in registers: the arithmetic
// of sha256.cu, host compilable. A message comes through a MsgReader
// (hash_kernel.cuh: staged words or its bytes where they lie, chosen at run
// time, so the compression below is compiled once) as 64-byte blocks of
// big-endian words; the padding is SM3's (sm3.cuh): 0x80, zeros, the 64-bit
// big-endian bit length.
//
// A block wholly inside the message loads as 16 plain words; only the last
// one or two blocks form the padding, in 32-bit arithmetic.
//
// The chaining state is 8 32-bit words in registers; a round writes only d
// and h, and the next round renames the eight (round j names s[(k - j) & 7]
// the k-th of a..h), so after 8 rounds the names are back where they began.
// The message schedule runs over a rolling window of 16 words: at round
// t >= 16 the slot t & 15 holds W[t-16] and receives W[t]. All 64 rounds
// are unrolled, about 1.4 k instructions: on chip_smoke.py's field bench
// the fastest form a block on the H100 (no constant loads of K, no renaming
// at a pass's end; the bench keeps passes of 8 and 16 rounds to time
// against it), and its one copy stays far inside the instruction cache.

#ifndef FISCO_SHA256_CUH
#define FISCO_SHA256_CUH

#include "hash_kernel.cuh"

HCONST uint32_t SHA256_K[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u, 0x923F82A4u,
    0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u, 0x72BE5D74u, 0x80DEB1FEu,
    0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u, 0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu,
    0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu, 0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u,
    0xC6E00BF3u, 0xD5A79147u, 0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu,
    0x53380D13u, 0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u, 0x19A4C116u,
    0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au, 0x5B9CCA4Fu, 0x682E6FF3u,
    0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u, 0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u,
    0xC67178F2u,
};

HCONST uint32_t SHA256_IV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};

// x >>> n for n in 1..31
HDEV uint32_t rotr32(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

// Round j (j mod 8 names the registers of s) with kw = K[t] + W[t]
HDEV void sha256_round(uint32_t* s, int j, uint32_t kw) {
  const uint32_t a = s[(8 - j) & 7], b = s[(9 - j) & 7], c = s[(10 - j) & 7];
  const uint32_t e = s[(12 - j) & 7], f = s[(13 - j) & 7], g = s[(14 - j) & 7];
  uint32_t& d = s[(11 - j) & 7];
  uint32_t& h = s[(15 - j) & 7];
  const uint32_t t1 = h + (rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25)) + ((e & f) ^ (~e & g)) + kw;
  d += t1;
  h = t1 + (rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22)) + ((a & b) ^ (a & c) ^ (b & c));
}

// W[t] into slot j & 15 of the window, over W[t - 16] (t = j mod 16)
HDEV void sha256_expand(uint32_t* w, int j) {
  const uint32_t w15 = w[(j + 1) & 15], w2 = w[(j + 14) & 15];
  w[j & 15] += (rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3)) + w[(j + 9) & 15] +
               (rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10));
}

// One compression: v += CF(v, block); w holds the block's 16 big-endian
// words and is used as the schedule's window.
HDEV void sha256_compress(uint32_t* v, uint32_t* w) {
  uint32_t s[8];
#pragma unroll
  for (int k = 0; k < 8; k++) s[k] = v[k];
#pragma unroll
  for (int j = 0; j < 16; j++) sha256_round(s, j, SHA256_K[j] + w[j]);
#pragma unroll
  for (int j = 16; j < 64; j++) {
    sha256_expand(w, j);
    sha256_round(s, j, SHA256_K[j] + w[j & 15]);
  }
#pragma unroll
  for (int k = 0; k < 8; k++) v[k] += s[k];
}

// Blocks of a message of len bytes: room for 0x80 and the 8-byte length
HDEV uint32_t sha256_blocks_of(uint32_t len) { return (len + 8) / 64 + 1; }

// Block blk of the padded message as 16 big-endian words. A block wholly
// inside the message is 16 plain reads; a tail block (the last one or two)
// reads the message bytes it holds, puts 0x80 after them and, if it is the
// last, the bit length in its last two words.
HDEV void sha256_block(const MsgReader& msg, uint32_t len, uint32_t blk, uint32_t* w) {
  const uint32_t off = 64 * blk;
  if (off + 64 <= len) {
    msg.be32s<16>(off, w);
    return;
  }
  const int rem = (int)(len - off);  // message bytes from the block's start on: below 64, maybe below 0
  msg.be32s_head<16>(off, rem, w);
#pragma unroll
  for (int i = 0; i < 16; i++) {
    const int k = rem - 4 * i;  // message bytes from this word's start on
    w[i] |= k >= 0 && k < 4 ? 0x80u << (24 - 8 * k) : 0u;
  }
  if (rem < 56) {  // the last block: words 14 and 15 hold no message byte
    w[14] = len >> 29;
    w[15] = len << 3;
  }
}

// SHA-256 of the len bytes through `msg`, one lane: the chaining value
// (big-endian words) into v. The lane runs wb blocks, as many as the
// longest message of its warp (at least its own): past its own last block
// it compresses zeros and keeps its chaining value, so every block of the
// warp is one pass of all its lanes. After a block's words are formed,
// the warp meets: its lanes that loaded a full block and those that padded
// a tail run the one copy of the compression together.
HDEV void sha256_lane(const MsgReader& msg, uint32_t len, uint32_t wb, uint32_t* v) {
#pragma unroll
  for (int k = 0; k < 8; k++) v[k] = SHA256_IV[k];
  const uint32_t nb = sha256_blocks_of(len);
#pragma unroll 1
  for (uint32_t blk = 0; blk < wb; blk++) {
    uint32_t w[16], u[8];
    if (blk < nb) {
      sha256_block(msg, len, blk, w);
    } else {
#pragma unroll
      for (int i = 0; i < 16; i++) w[i] = 0;
    }
    warp_meet();
#pragma unroll
    for (int k = 0; k < 8; k++) u[k] = v[k];
    sha256_compress(u, w);
#pragma unroll
    for (int k = 0; k < 8; k++) v[k] = blk < nb ? u[k] : v[k];
  }
}

// sha256(msg[0..len)) -> out[0..32), big-endian, the bytes read where they lie.
HDEV void sha256_message(const uint8_t* msg, int64_t len, uint8_t* out) {
  uint32_t v[8];
  sha256_lane(MsgReader::direct(msg), (uint32_t)len, sha256_blocks_of((uint32_t)len), v);
#pragma unroll
  for (int i = 0; i < 32; i++) out[i] = (uint8_t)(v[i >> 2] >> (24 - 8 * (i & 3)));
}

#endif  // FISCO_SHA256_CUH
