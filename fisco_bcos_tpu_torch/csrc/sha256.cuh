// SHA-256 (FIPS 180-4) of one message, padded in registers: the arithmetic
// of sha256.cu, host compilable. A message comes through a reader
// (hash_kernel.cuh) as 64-byte blocks of big-endian words; the padding is
// SM3's (sm3.cuh): 0x80, zeros, the 64-bit big-endian bit length.
//
// The chaining state is 8 32-bit words in registers. The message schedule
// runs over a rolling window of 16 words: at round j >= 16 the slot j & 15
// holds W[j-16] and receives W[j]. The 64 rounds unroll, so every slot index
// and every K[j] is a constant.

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

// One compression: v += CF(v, block); w holds the block's 16 big-endian
// words and is used as the schedule's window.
HDEV void sha256_compress(uint32_t* v, uint32_t* w) {
  uint32_t a = v[0], b = v[1], c = v[2], d = v[3], e = v[4], f = v[5], g = v[6], h = v[7];
#pragma unroll
  for (int j = 0; j < 64; j++) {
    if (j >= 16) {  // W[j] = s1(W[j-2]) + W[j-7] + s0(W[j-15]) + W[j-16]
      const uint32_t w15 = w[(j + 1) & 15], w2 = w[(j + 14) & 15];
      const uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
      w[j & 15] += s0 + w[(j + 9) & 15] + s1;
    }
    const uint32_t big_s1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + big_s1 + ch + SHA256_K[j] + w[j & 15];
    const uint32_t big_s0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + big_s0 + maj;
  }
  v[0] += a; v[1] += b; v[2] += c; v[3] += d;
  v[4] += e; v[5] += f; v[6] += g; v[7] += h;
}

// SHA-256 of msg[0..len) (a ByteReader or a WordReader) from the IV into v:
// (len + 8) / 64 + 1 blocks, the padding formed word by word as they load.
template <class R>
HDEV void sha256_absorb(uint32_t* v, const R& msg, int64_t len) {
  const int64_t nblocks = (len + 8) / 64 + 1;
  const uint64_t bits = (uint64_t)len * 8;
#pragma unroll
  for (int i = 0; i < 8; i++) v[i] = SHA256_IV[i];
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
    sha256_compress(v, w);
  }
}

// sha256(msg[0..len)) -> out[0..32), big-endian, the bytes read where they lie.
HDEV void sha256_message(const uint8_t* msg, int64_t len, uint8_t* out) {
  uint32_t v[8];
  sha256_absorb(v, ByteReader{msg}, len);
#pragma unroll
  for (int i = 0; i < 32; i++) out[i] = (uint8_t)(v[i >> 2] >> (24 - 8 * (i & 3)));
}

// The kernel body's hash policy (hash_kernel.cuh): digests leave as memory
// order words (d[j] = bytes 4j..4j+3, little-endian).
struct Sha256 {
  template <class R>
  HDEV void message(const R& msg, int64_t len, uint32_t* d) {
    uint32_t v[8];
    sha256_absorb(v, msg, len);
#pragma unroll
    for (int i = 0; i < 8; i++) d[i] = bswap32(v[i]);
  }
};

#endif  // FISCO_SHA256_CUH
