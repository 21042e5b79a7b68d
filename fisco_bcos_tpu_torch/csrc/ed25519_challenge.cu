// Ed25519's challenges on the H100: for each signature, k = SHA-512(R ‖ A ‖
// M) mod L (RFC 8032 §5.1.7, the digest read little-endian), written as
// k_neg = (L − k) mod L, 32 little-endian bytes, into bytes 96..127 of its
// row, in place. The rows are csrc/ed25519_verify.cu's input (R ‖ S ‖ A ‖
// k_neg); the messages come packed (data uint8, int64 starts, int32
// lengths: hash_common.pack_messages), as the hash kernels take them.
//
// Replaces the host half of the JAX package's ops/ed25519.py (:306-347, one
// hashlib SHA-512 and a Python reduction a lane, at :328), which the port
// first kept on the host (ops/ed25519.py `challenges`, still the oracle).
// The rows and the verdicts are byte for byte what the host made. The plain
// PyTorch version is ops/ed25519.py `challenge_plain`.
//
// One thread a message, one warp a block, in the packed hash kernels' style
// (hash_kernel.cuh): the warp stages its messages through shared memory
// when their span fits (stage_warp); the 64-byte prefix R ‖ A comes from
// the row (four 16-byte loads). SHA-512's 64-bit words are pairs of 32-bit
// registers on this card: a rotation by a constant is two funnel shifts, an
// add a carry chain of two. A message of up to 47 bytes (a QC vote's 32) is
// one 128-byte block after the prefix.
//
// What bounds it: 32-bit integer instructions, about 3,700 a block
// (chip_smoke.py counts them, SHA512_BLOCK_OPS); the bytes (the row's 64
// bytes of prefix and 32 of output, the message, 12 of start and length)
// are a few percent of that time. A QC check is 4 or 7 messages, one warp,
// and 10,240 messages are 320 warps, one a scheduler at most, so the kernel
// runs at one warp's pace, and the design cuts that warp's stream as
// sha256.cu's does:
//   - one copy of the message's code: both routes (staged words, or the
//     bytes where they lie) feed it through one MsgReader chosen at run
//     time, and rounds 16-79 are a rolled loop over passes of 16 unrolled
//     rounds (SHA512_PASS);
//   - a block wholly inside the message loads without the padding logic;
//     only the last one or two blocks form 0x80 and the 128-bit bit length;
//   - the block loop is the warp's (its longest message's blocks), and the
//     warp meets after a block's words are formed, so one copy of the
//     compression runs for lanes that loaded a full block and lanes that
//     padded a tail alike (sha512_prefixed);
//   - R and A are loaded before the staging, their latency under its;
//   - the reduction mod L (Barrett, HAC 14.42, base 2^32, k = 8: q = ⌊⌊x /
//     2^224⌋·μ / 2^288⌋ with μ = ⌊2^512 / L⌋, r = x − q·L mod 2^288, then at
//     most two subtractions of L) runs its word products as rows of PTX
//     carry chains (mad_row9), as poseidon.cu's REDC does.
// Two lanes a message (a schedule lane writing W[16..79] + K while the
// round lane runs rounds 0-15) measured slower on the field bench, as
// sha256.cu's did (PERF.md §6).
//
// The message and lane functions compile as host C++ too (no __CUDACC__):
// the tier-1 tests build them with g++ and hold them against hashlib.

#include "hash_kernel.cuh"

#define ED25519_ROW_BYTES 128

// rounds a pass among rounds 16-79: passes of 16 were the fastest on the
// field bench, which times passes of 8 and all 64 unrolled against them
#define SHA512_PASS 16

HCONST uint64_t SHA512_K[80] = {
    0x428A2F98D728AE22ull, 0x7137449123EF65CDull, 0xB5C0FBCFEC4D3B2Full, 0xE9B5DBA58189DBBCull,
    0x3956C25BF348B538ull, 0x59F111F1B605D019ull, 0x923F82A4AF194F9Bull, 0xAB1C5ED5DA6D8118ull,
    0xD807AA98A3030242ull, 0x12835B0145706FBEull, 0x243185BE4EE4B28Cull, 0x550C7DC3D5FFB4E2ull,
    0x72BE5D74F27B896Full, 0x80DEB1FE3B1696B1ull, 0x9BDC06A725C71235ull, 0xC19BF174CF692694ull,
    0xE49B69C19EF14AD2ull, 0xEFBE4786384F25E3ull, 0x0FC19DC68B8CD5B5ull, 0x240CA1CC77AC9C65ull,
    0x2DE92C6F592B0275ull, 0x4A7484AA6EA6E483ull, 0x5CB0A9DCBD41FBD4ull, 0x76F988DA831153B5ull,
    0x983E5152EE66DFABull, 0xA831C66D2DB43210ull, 0xB00327C898FB213Full, 0xBF597FC7BEEF0EE4ull,
    0xC6E00BF33DA88FC2ull, 0xD5A79147930AA725ull, 0x06CA6351E003826Full, 0x142929670A0E6E70ull,
    0x27B70A8546D22FFCull, 0x2E1B21385C26C926ull, 0x4D2C6DFC5AC42AEDull, 0x53380D139D95B3DFull,
    0x650A73548BAF63DEull, 0x766A0ABB3C77B2A8ull, 0x81C2C92E47EDAEE6ull, 0x92722C851482353Bull,
    0xA2BFE8A14CF10364ull, 0xA81A664BBC423001ull, 0xC24B8B70D0F89791ull, 0xC76C51A30654BE30ull,
    0xD192E819D6EF5218ull, 0xD69906245565A910ull, 0xF40E35855771202Aull, 0x106AA07032BBD1B8ull,
    0x19A4C116B8D2D0C8ull, 0x1E376C085141AB53ull, 0x2748774CDF8EEB99ull, 0x34B0BCB5E19B48A8ull,
    0x391C0CB3C5C95A63ull, 0x4ED8AA4AE3418ACBull, 0x5B9CCA4F7763E373ull, 0x682E6FF3D6B2B8A3ull,
    0x748F82EE5DEFB2FCull, 0x78A5636F43172F60ull, 0x84C87814A1F0AB72ull, 0x8CC702081A6439ECull,
    0x90BEFFFA23631E28ull, 0xA4506CEBDE82BDE9ull, 0xBEF9A3F7B2C67915ull, 0xC67178F2E372532Bull,
    0xCA273ECEEA26619Cull, 0xD186B8C721C0C207ull, 0xEADA7DD6CDE0EB1Eull, 0xF57D4F7FEE6ED178ull,
    0x06F067AA72176FBAull, 0x0A637DC5A2C898A6ull, 0x113F9804BEF90DAEull, 0x1B710B35131C471Bull,
    0x28DB77F523047D84ull, 0x32CAAB7B40C72493ull, 0x3C9EBE0A15C9BEBCull, 0x431D67C49C100D4Cull,
    0x4CC5D4BECB3E42B6ull, 0x597F299CFC657E2Aull, 0x5FCB6FAB3AD6FAECull, 0x6C44198C4A475817ull,
};

HCONST uint64_t SHA512_IV[8] = {
    0x6A09E667F3BCC908ull, 0xBB67AE8584CAA73Bull, 0x3C6EF372FE94F82Bull, 0xA54FF53A5F1D36F1ull,
    0x510E527FADE682D1ull, 0x9B05688C2B3E6C1Full, 0x1F83D9ABFB41BD6Bull, 0x5BE0CD19137E2179ull,
};

// L = 2^252 + 27742317777372353535851937790883648493, and μ = ⌊2^512 / L⌋
// (260 bits), little-endian 32-bit words
HCONST uint32_t ED_L_WORDS[8] = {0x5CF5D3EDu, 0x5812631Au, 0xA2F79CD6u, 0x14DEF9DEu,
                                 0x00000000u, 0x00000000u, 0x00000000u, 0x10000000u};
HCONST uint32_t ED_L_MU[9] = {0x0A2C131Bu, 0xED9CE5A3u, 0x086329A7u, 0x2106215Du, 0xFFFFFFEBu,
                              0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x0000000Fu};

// x >>> n for n in [1, 63]; on the card two funnel shifts
HDEV uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

// Round j (j mod 8 names the registers of s, as sha256_round) with kw = K[t] + W[t]
HDEV void sha512_round(uint64_t* s, int j, uint64_t kw) {
  const uint64_t a = s[(8 - j) & 7], b = s[(9 - j) & 7], c = s[(10 - j) & 7];
  const uint64_t e = s[(12 - j) & 7], f = s[(13 - j) & 7], g = s[(14 - j) & 7];
  uint64_t& d = s[(11 - j) & 7];
  uint64_t& h = s[(15 - j) & 7];
  const uint64_t t1 = h + (rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41)) + ((e & f) ^ (~e & g)) + kw;
  d += t1;
  h = t1 + (rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39)) + ((a & b) ^ (a & c) ^ (b & c));
}

// W[t] into slot j & 15 of the window, over W[t - 16] (t = j mod 16)
HDEV void sha512_expand(uint64_t* w, int j) {
  const uint64_t w15 = w[(j + 1) & 15], w2 = w[(j + 14) & 15];
  w[j & 15] += (rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6)) + w[(j + 9) & 15] +
               (rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7));
}

// One block (w: its 16 big-endian words, used as the schedule's window)
// into the chaining value h: rounds 0-15, then rounds 16-79 as a rolled loop
// over passes of SHA512_PASS unrolled rounds.
HDEV void sha512_compress(uint64_t* h, uint64_t* w) {
  uint64_t s[8];
#pragma unroll
  for (int k = 0; k < 8; k++) s[k] = h[k];
#pragma unroll
  for (int j = 0; j < 16; j++) sha512_round(s, j, SHA512_K[j] + w[j]);
#pragma unroll 1
  for (int t0 = 16; t0 < 80; t0 += SHA512_PASS) {
#pragma unroll
    for (int j = 0; j < SHA512_PASS; j++) {
      sha512_expand(w, j);
      sha512_round(s, j, SHA512_K[t0 + j] + w[j]);
    }
  }
#pragma unroll
  for (int k = 0; k < 8; k++) h[k] += s[k];
}

// Blocks of R ‖ A ‖ M for a message of len bytes: the 64-byte prefix, and
// room for 0x80 and the 16-byte length
HDEV uint32_t sha512_blocks_of(uint32_t len) { return (len + 80) / 128 + 1; }

// 64 bytes of the message from byte i (base + 64 h of a block), of which
// the first `rem` are the message's, as 8 big-endian words into w: plain
// reads where all 64 lie inside the message, else the bytes it holds and
// 0x80 after them.
HDEV void sha512_half(const MsgReader& msg, int i, int rem, uint64_t* w) {
  uint32_t x[16];
  if (rem >= 64) {
    msg.be32s<16>((uint32_t)i, x);
  } else {
    msg.be32s_head<16>((uint32_t)i, rem, x);
  }
#pragma unroll
  for (int t = 0; t < 8; t++) {
    const int k = rem - 8 * t;  // message bytes from this word's start on
    w[t] = (uint64_t)x[2 * t] << 32 | x[2 * t + 1];
    w[t] |= k >= 0 && k < 8 ? 0x80ull << (56 - 8 * k) : 0ull;
  }
}

// Block blk of prefix (8 big-endian words: R ‖ A) ‖ the message (len bytes
// through msg), padded, as 16 big-endian words: its two halves of 64 bytes
// (block 0's first, the prefix), each plain reads where it lies wholly
// inside the message; the last block holds the bit length in its last two
// words.
HDEV void sha512_block(const uint64_t* prefix, const MsgReader& msg, uint32_t len, uint32_t blk, uint64_t* w) {
  const int base = 128 * (int)blk - 64;  // the message byte at the block's start (block 0 starts with the prefix)
  if (blk == 0) {
#pragma unroll
    for (int t = 0; t < 8; t++) w[t] = prefix[t];
  } else {
    sha512_half(msg, base, (int)len - base, w);
  }
  sha512_half(msg, base + 64, (int)len - base - 64, w + 8);
  if ((int)len - base < 112) {  // the last block: the 128-bit bit length, its high half 0
    w[14] = 0;
    w[15] = (uint64_t)(64 + len) << 3;
  }
}

// SHA-512 of prefix ‖ the message, one lane -> h, the digest's 8 big-endian
// words. The lane runs wb blocks, its warp's longest message's (at least its
// own), and the warp meets after each block's words are formed, as
// sha256_lane does.
HDEV void sha512_prefixed(const uint64_t* prefix, const MsgReader& msg, uint32_t len, uint32_t wb, uint64_t* h) {
#pragma unroll
  for (int k = 0; k < 8; k++) h[k] = SHA512_IV[k];
  const uint32_t nb = sha512_blocks_of(len);
#pragma unroll 1
  for (uint32_t blk = 0; blk < wb; blk++) {
    uint64_t w[16], u[8];
    if (blk < nb) {
      sha512_block(prefix, msg, len, blk, w);
    } else {
#pragma unroll
      for (int t = 0; t < 16; t++) w[t] = 0;
    }
    warp_meet();
#pragma unroll
    for (int k = 0; k < 8; k++) u[k] = h[k];
    sha512_compress(u, w);
#pragma unroll
    for (int k = 0; k < 8; k++) h[k] = blk < nb ? u[k] : h[k];
  }
}

// t[0..10) += m·q[0..9), with cin added to t[9]; returns the carry out of
// t[9] (0-2), owed to t[10]. On the card two chains of PTX carries, the low
// halves of the word products into t[0..9), the high halves into t[1..10);
// on the host in u64.
HDEV uint32_t mad_row9(uint32_t* t, uint32_t m, const uint32_t* q, uint32_t cin) {
#ifdef __CUDA_ARCH__
  uint32_t c;
  asm("mad.lo.cc.u32 %0, %11, %12, %0;\n\t"
      "madc.lo.cc.u32 %1, %11, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %14, %2;\n\t"
      "madc.lo.cc.u32 %3, %11, %15, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %16, %4;\n\t"
      "madc.lo.cc.u32 %5, %11, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %11, %18, %6;\n\t"
      "madc.lo.cc.u32 %7, %11, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %11, %20, %8;\n\t"
      "addc.cc.u32 %9, %9, %21;\n\t"
      "addc.u32 %10, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %11, %12, %1;\n\t"
      "madc.hi.cc.u32 %2, %11, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %14, %3;\n\t"
      "madc.hi.cc.u32 %4, %11, %15, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %16, %5;\n\t"
      "madc.hi.cc.u32 %6, %11, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %11, %18, %7;\n\t"
      "madc.hi.cc.u32 %8, %11, %19, %8;\n\t"
      "madc.hi.cc.u32 %9, %11, %20, %9;\n\t"
      "addc.u32 %10, %10, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "=&r"(c)
      : "r"(m), "r"(q[0]), "r"(q[1]), "r"(q[2]), "r"(q[3]), "r"(q[4]), "r"(q[5]), "r"(q[6]),
        "r"(q[7]), "r"(q[8]), "r"(cin));
  return c;
#else
  uint64_t c = 0;
  for (int j = 0; j < 9; j++) {
    c += (uint64_t)m * q[j] + t[j];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  c += (uint64_t)t[9] + cin;
  t[9] = (uint32_t)c;
  return (uint32_t)(c >> 32);
#endif
}

// x (16 little-endian words, any 512-bit value) mod L -> r (8 words).
HDEV void mod_l(const uint32_t* x, uint32_t* r) {
  // q2 = ⌊x / 2^224⌋·μ, rows of x's words 7..15 by μ; q3 = its words 9..17
  uint32_t t[19];
#pragma unroll
  for (int i = 0; i < 19; i++) t[i] = 0;
  uint32_t owed = 0;
#pragma unroll
  for (int i = 0; i < 9; i++) owed = mad_row9(t + i, x[7 + i], ED_L_MU, owed);
  const uint32_t* q3 = t + 9;
  // q3·L mod 2^288: rows of L's words 0-3 by q3 (its words 4-6 are 0), and
  // q3·2^252 (word 7 is 2^28)
  uint32_t u[14];
#pragma unroll
  for (int i = 0; i < 14; i++) u[i] = 0;
  owed = 0;
#pragma unroll
  for (int j = 0; j < 4; j++) owed = mad_row9(u + j, ED_L_WORDS[j], q3, owed);
  const uint64_t s7 = (uint64_t)u[7] + (q3[0] << 28);
  u[7] = (uint32_t)s7;
  u[8] += (q3[0] >> 4 | q3[1] << 28) + (uint32_t)(s7 >> 32);
  // r = x - q3·L mod 2^288, below 3L
  uint32_t d[9];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    const uint64_t dlt = (uint64_t)x[i] - u[i] - borrow;
    d[i] = (uint32_t)dlt;
    borrow = (uint32_t)(dlt >> 63);
  }
  // subtract L while it fits
#pragma unroll
  for (int k = 0; k < 2; k++) {
    uint32_t s[9];
    borrow = 0;
#pragma unroll
    for (int i = 0; i < 9; i++) {
      const uint64_t dlt = (uint64_t)d[i] - (i < 8 ? ED_L_WORDS[i] : 0u) - borrow;
      s[i] = (uint32_t)dlt;
      borrow = (uint32_t)(dlt >> 63);
    }
#pragma unroll
    for (int i = 0; i < 9; i++) d[i] = borrow ? d[i] : s[i];
  }
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = d[i];
}

// R (row bytes 0..31) and A (64..95) as 16 little-endian words -> the
// prefix's 8 big-endian 64-bit words
HDEV void ra_prefix(const uint32_t* ra, uint64_t* prefix) {
#pragma unroll
  for (int i = 0; i < 8; i++) prefix[i] = (uint64_t)bswap32(ra[2 * i]) << 32 | bswap32(ra[2 * i + 1]);
}

// The digest (8 big-endian words) -> k_neg = (L - digest mod L) mod L as 8
// little-endian words (k = 0: k_neg = 0, not L)
HDEV void challenge_finish(const uint64_t* h, uint32_t* k_neg) {
  uint32_t x[16], k[8];
#pragma unroll
  for (int i = 0; i < 8; i++) {  // the digest's bytes, read as a little-endian integer
    x[2 * i] = bswap32((uint32_t)(h[i] >> 32));
    x[2 * i + 1] = bswap32((uint32_t)h[i]);
  }
  mod_l(x, k);
  uint32_t borrow = 0, nz = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint64_t dlt = (uint64_t)ED_L_WORDS[i] - k[i] - borrow;
    k_neg[i] = (uint32_t)dlt;
    borrow = (uint32_t)(dlt >> 63);
    nz |= k[i];
  }
#pragma unroll
  for (int i = 0; i < 8; i++) k_neg[i] = nz ? k_neg[i] : 0u;
}

// One lane: the row's R and A as 16 little-endian words, the message
// through `msg` -> k_neg = (L - SHA-512(R ‖ A ‖ M) mod L) mod L as 8
// little-endian words; wb as sha512_prefixed.
HDEV void challenge_lane(const uint32_t* ra, const MsgReader& msg, uint32_t len, uint32_t wb, uint32_t* k_neg) {
  uint64_t prefix[8], h[8];
  ra_prefix(ra, prefix);
  sha512_prefixed(prefix, msg, len, wb, h);
  challenge_finish(h, k_neg);
}

#ifdef __CUDACC__

// Message i is data[starts[i] .. starts[i] + lengths[i]); its k_neg goes to
// rows[128 i + 96 ..] (rows 16-byte aligned). A range outside the n_data
// bytes of `data` is read from no memory: its lane writes k_neg = 0 (the
// wrappers' callers make no such range).
__global__ void __launch_bounds__(HASH_THREADS)
ed25519_challenge_kernel(uint8_t* __restrict__ rows, const uint8_t* __restrict__ data,
                         const int64_t* __restrict__ starts, const int32_t* __restrict__ lengths,
                         int n, int64_t n_data) {
  extern __shared__ uint4 hash_smem[];
  uint8_t* smem = (uint8_t*)hash_smem;
  const int lane = threadIdx.x;
  const int i = blockIdx.x * HASH_THREADS + lane;
  uint4* row = reinterpret_cast<uint4*>(rows + (int64_t)ED25519_ROW_BYTES * (i < n ? i : 0));
  // R and A first: their loads overlap the staging's
  uint32_t ra[16] = {0};
  if (i < n) {
#pragma unroll
    for (int q = 0; q < 4; q++) {  // R: quads 0, 1; A: quads 4, 5
      const uint4 v = row[q < 2 ? q : q + 2];
      ra[4 * q] = v.x, ra[4 * q + 1] = v.y, ra[4 * q + 2] = v.z, ra[4 * q + 3] = v.w;
    }
  }
  int64_t start = 0, len = 0;
  bool valid = false;
  if (i < n) {
    start = starts[i];
    len = lengths[i];
    valid = start >= 0 && len >= 0 && start <= n_data - len;
  }
  int64_t lo;
  const bool staged = stage_warp(smem, data, start, len, valid, lane, &lo);
  const MsgReader msg = staged ? MsgReader::staged((const uint32_t*)smem, stage_offset(data, lo, start))
                               : MsgReader::direct(data + start);
  uint32_t k_neg[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const uint32_t nb = valid ? sha512_blocks_of((uint32_t)len) : 0;
  const uint32_t wb = __reduce_max_sync(0xFFFFFFFFu, nb);  // the warp's longest message's blocks
  challenge_lane(ra, msg, valid ? (uint32_t)len : 0u, wb, k_neg);
  if (!valid) {
#pragma unroll
    for (int k = 0; k < 8; k++) k_neg[k] = 0;
  }
  if (i < n) {
    row[6] = make_uint4(k_neg[0], k_neg[1], k_neg[2], k_neg[3]);
    row[7] = make_uint4(k_neg[4], k_neg[5], k_neg[6], k_neg[7]);
  }
}

// Launch geometry for n messages: threads a block, blocks, dynamic shared bytes.
extern "C" void ed25519_challenge_geometry(int n, int* out) {
  out[0] = HASH_THREADS;
  out[1] = (n + HASH_THREADS - 1) / HASH_THREADS;
  out[2] = HASH_PACKED_SMEM;
}

// C entry point for ctypes, all pointers on `device`: rows uint8 [>= n, 128]
// (written in place), data uint8 [n_data], starts int64 [n], lengths int32
// [n]. Launches on `stream`, does not synchronise; returns the first CUDA
// error (0 on success).
extern "C" int ed25519_challenge_launch(void* rows, const void* data, const void* starts,
                                        const void* lengths, int n, long long n_data, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  int geo[3];
  ed25519_challenge_geometry(n, geo);
  ed25519_challenge_kernel<<<geo[1], geo[0], geo[2], (cudaStream_t)stream>>>(
      (uint8_t*)rows, (const uint8_t*)data, (const int64_t*)starts, (const int32_t*)lengths, n,
      (int64_t)n_data);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
