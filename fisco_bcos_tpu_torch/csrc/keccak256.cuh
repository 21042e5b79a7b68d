// Keccak-256 (legacy 0x01 padding, the reference's Keccak256 hasher) of one
// message, padded in registers: the arithmetic of keccak256.cu, host
// compilable. A message comes through a reader (hash_kernel.cuh), or as a
// public key's 16 big-endian words.
//
// The state is 25 64-bit lanes in registers (lane x + 5y). A round is
// theta, rho and pi together (each lane of b is a rotated lane of a, with
// the column parity folded in), chi and iota; a rotation by a constant is two
// funnel shifts. The round constants sit in __constant__ memory: every
// thread reads the same one.

#ifndef FISCO_KECCAK256_CUH
#define FISCO_KECCAK256_CUH

#include "hash_kernel.cuh"

#define KECCAK_RATE 136  // bytes: 17 lanes

HCONST uint64_t KECCAK_RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull, 0x8000000080008000ull,
    0x000000000000808Bull, 0x0000000080000001ull, 0x8000000080008081ull, 0x8000000000008009ull,
    0x000000000000008Aull, 0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull, 0x8000000000008003ull,
    0x8000000000008002ull, 0x8000000000000080ull, 0x000000000000800Aull, 0x800000008000000Aull,
    0x8000000080008081ull, 0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

// n in [1, 63]
HDEV uint64_t rotl64(uint64_t x, int n) { return (x << n) | (x >> (64 - n)); }

// The 24-round Keccak-f[1600] permutation, in place.
HDEV void keccak_f1600(uint64_t* a) {
#pragma unroll 1
  for (int round = 0; round < 24; round++) {
    // theta: lane (x, y) takes c[x-1] ^ rotl(c[x+1], 1), c the column parities
    const uint64_t c0 = a[0] ^ a[5] ^ a[10] ^ a[15] ^ a[20];
    const uint64_t c1 = a[1] ^ a[6] ^ a[11] ^ a[16] ^ a[21];
    const uint64_t c2 = a[2] ^ a[7] ^ a[12] ^ a[17] ^ a[22];
    const uint64_t c3 = a[3] ^ a[8] ^ a[13] ^ a[18] ^ a[23];
    const uint64_t c4 = a[4] ^ a[9] ^ a[14] ^ a[19] ^ a[24];
    const uint64_t d0 = c4 ^ rotl64(c1, 1);
    const uint64_t d1 = c0 ^ rotl64(c2, 1);
    const uint64_t d2 = c1 ^ rotl64(c3, 1);
    const uint64_t d3 = c2 ^ rotl64(c4, 1);
    const uint64_t d4 = c3 ^ rotl64(c0, 1);
    // rho and pi: b[y + 5((2x + 3y) mod 5)] = rotl(a[x + 5y], r[x][y])
    uint64_t b[25];
    b[0] = a[0] ^ d0;
    b[1] = rotl64(a[6] ^ d1, 44);
    b[2] = rotl64(a[12] ^ d2, 43);
    b[3] = rotl64(a[18] ^ d3, 21);
    b[4] = rotl64(a[24] ^ d4, 14);
    b[5] = rotl64(a[3] ^ d3, 28);
    b[6] = rotl64(a[9] ^ d4, 20);
    b[7] = rotl64(a[10] ^ d0, 3);
    b[8] = rotl64(a[16] ^ d1, 45);
    b[9] = rotl64(a[22] ^ d2, 61);
    b[10] = rotl64(a[1] ^ d1, 1);
    b[11] = rotl64(a[7] ^ d2, 6);
    b[12] = rotl64(a[13] ^ d3, 25);
    b[13] = rotl64(a[19] ^ d4, 8);
    b[14] = rotl64(a[20] ^ d0, 18);
    b[15] = rotl64(a[4] ^ d4, 27);
    b[16] = rotl64(a[5] ^ d0, 36);
    b[17] = rotl64(a[11] ^ d1, 10);
    b[18] = rotl64(a[17] ^ d2, 15);
    b[19] = rotl64(a[23] ^ d3, 56);
    b[20] = rotl64(a[2] ^ d2, 62);
    b[21] = rotl64(a[8] ^ d3, 55);
    b[22] = rotl64(a[14] ^ d4, 39);
    b[23] = rotl64(a[15] ^ d0, 41);
    b[24] = rotl64(a[21] ^ d1, 2);
    // chi within each row, then iota
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
#pragma unroll
      for (int x = 0; x < 5; x++) {
        a[y + x] = b[y + x] ^ (~b[y + (x + 1) % 5] & b[y + (x + 2) % 5]);
      }
    }
    a[0] ^= KECCAK_RC[round];
  }
}

// The sponge over msg[0..len) (a ByteReader or a WordReader) -> the digest's
// 32 bytes as 8 little-endian words (d[j] = bytes 4j..4j+3). The sponge
// absorbs len / 136 + 1 blocks; the last one carries 0x01 after the message
// and 0x80 in its byte 135 (0x81 where the two coincide).
template <class R>
HDEV void keccak256_absorb(const R& msg, int64_t len, uint32_t* d) {
  uint64_t a[25];
#pragma unroll
  for (int i = 0; i < 25; i++) a[i] = 0;
  const int64_t nblocks = len / KECCAK_RATE + 1;
  for (int64_t blk = 0; blk < nblocks; blk++) {
    const int64_t off = blk * KECCAK_RATE;
    const int64_t rem = len - off;  // message bytes from this block's start on
    const bool last = blk == nblocks - 1;
#pragma unroll
    for (int w = 0; w < 17; w++) {
      const int64_t k = rem - 8 * w;  // message bytes from this lane's start on
      uint64_t lane = msg.le64(off + 8 * w, k);
      if (last && k >= 0 && k < 8) lane ^= (uint64_t)0x01 << (8 * k);
      a[w] ^= lane;
    }
    if (last) a[16] ^= 0x8000000000000000ull;
    keccak_f1600(a);
  }
#pragma unroll
  for (int j = 0; j < 4; j++) {
    d[2 * j] = (uint32_t)a[j];
    d[2 * j + 1] = (uint32_t)(a[j] >> 32);
  }
}

// keccak256(msg[0..len)) -> out[0..32), the bytes read where they lie.
HDEV void keccak256_message(const uint8_t* msg, int64_t len, uint8_t* out) {
  uint32_t d[8];
  keccak256_absorb(ByteReader{msg}, len, d);
#pragma unroll
  for (int i = 0; i < 32; i++) out[i] = (uint8_t)(d[i >> 2] >> (8 * (i & 3)));
}

// keccak-256 of a public key's 64 bytes, given as 16 big-endian words (x ‖
// y): one block, its padding constant -> the digest words as above.
HDEV void keccak256_key(const uint32_t* be, uint32_t* d) {
  uint64_t a[25];
#pragma unroll
  for (int i = 0; i < 25; i++) a[i] = 0;
#pragma unroll
  for (int w = 0; w < 8; w++) a[w] = bswap32(be[2 * w]) | ((uint64_t)bswap32(be[2 * w + 1]) << 32);
  a[8] = 0x01;
  a[16] = 0x8000000000000000ull;
  keccak_f1600(a);
#pragma unroll
  for (int j = 0; j < 4; j++) {
    d[2 * j] = (uint32_t)a[j];
    d[2 * j + 1] = (uint32_t)(a[j] >> 32);
  }
}

// The kernel bodies' hash policy (hash_kernel.cuh).
struct Keccak256 {
  template <class R>
  HDEV void message(const R& msg, int64_t len, uint32_t* d) { keccak256_absorb(msg, len, d); }
  HDEV void key(const uint32_t* be, uint32_t* d) { keccak256_key(be, d); }
};

#endif  // FISCO_KECCAK256_CUH
