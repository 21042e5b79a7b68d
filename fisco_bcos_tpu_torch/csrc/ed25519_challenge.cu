// Ed25519's challenges on the H100: for each signature, k = SHA-512(R ‖ A ‖
// M) mod L (RFC 8032 §5.1.7, the digest read little-endian), written as
// k_neg = (L − k) mod L, 32 little-endian bytes, into bytes 96..127 of its
// row, in place. The rows are csrc/ed25519_verify.cu's input (R ‖ S ‖ A ‖
// k_neg); the messages come packed (data uint8, int64 starts, int32
// lengths: hash_common.pack_messages), as the hash kernels take them.
//
// Replaces the host half of the JAX package's ops/ed25519.py (:306-347, one
// hashlib SHA-512 and a Python reduction a lane, at :328), which the port
// kept on the host until now (ops/ed25519.py `challenges`, still the
// oracle). The rows and the verdicts are byte for byte what the host made.
// The plain PyTorch version is ops/ed25519.py `challenge_plain`.
//
// One thread a message, one warp a block, in the packed hash kernels' style
// (hash_kernel.cuh): the warp stages its messages through shared memory
// when their span fits (stage_warp) and each lane reads its message as
// words; the 64-byte prefix R ‖ A comes from the row (four 16-byte loads);
// the padding (0x80, zeros, the 128-bit big-endian bit length) is made in
// registers. SHA-512's 64-bit words are pairs of 32-bit registers on this
// card: a rotation by a constant is two funnel shifts, an add a carry chain
// of two. A message of up to 47 bytes (a QC vote's 32) is one 128-byte
// block after the prefix.
//
// The 512-bit digest is reduced by Barrett (HAC 14.42, base 2^32, k = 8):
// q = ⌊⌊x / 2^224⌋·μ / 2^288⌋ with μ = ⌊2^512 / L⌋, r = x − q·L mod 2^288,
// then at most two subtractions of L.
//
// What bounds it: 32-bit integer instructions, about 3,700 a block
// (chip_smoke.py counts them, SHA512_BLOCK_OPS); the bytes (the row's 64
// bytes of prefix and 32 of output, the message, 12 of start and length)
// are a few percent of that time. 10,240 messages are 320 warps, one a
// scheduler at most: the kernel runs at one warp's pace.
//
// The message and lane functions compile as host C++ too (no __CUDACC__):
// the tier-1 tests build them with g++ and hold them against hashlib.

#include "hash_kernel.cuh"

#define ED25519_ROW_BYTES 128

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

// n in [1, 63]; on the card two funnel shifts
HDEV uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

HDEV uint64_t bswap64(uint64_t x) {
  return (uint64_t)bswap32((uint32_t)x) << 32 | bswap32((uint32_t)(x >> 32));
}

// One block (w: its 16 big-endian words, used as the schedule's ring) into
// the chaining value h. 80 rounds as 5 passes of 16, each unrolled, so a
// round's word and the ring's slots are registers.
HDEV void sha512_compress(uint64_t* h, uint64_t* w) {
  uint64_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll 1
  for (int t0 = 0; t0 < 80; t0 += 16) {
#pragma unroll
    for (int j = 0; j < 16; j++) {
      if (t0) {  // the schedule: w[t] = σ1(w[t-2]) + w[t-7] + σ0(w[t-15]) + w[t-16]
        const uint64_t w2 = w[(j + 14) & 15], w15 = w[(j + 1) & 15];
        const uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
        const uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
        w[j] += s1 + w[(j + 9) & 15] + s0;
      }
      const uint64_t t1 = hh + (rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41)) +
                          ((e & f) ^ (~e & g)) + SHA512_K[t0 + j] + w[j];
      const uint64_t t2 = (rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39)) +
                          ((a & b) ^ (a & c) ^ (b & c));
      hh = g, g = f, f = e, e = d + t1, d = c, c = b, b = a, a = t1 + t2;
    }
  }
  h[0] += a, h[1] += b, h[2] += c, h[3] += d, h[4] += e, h[5] += f, h[6] += g, h[7] += hh;
}

// SHA-512 of prefix (8 big-endian words: R ‖ A) ‖ the message (len bytes
// through reader `msg`) -> h, the digest's 8 big-endian words.
template <class Rd>
HDEV void sha512_prefixed(const uint64_t* prefix, const Rd& msg, int64_t len, uint64_t* h) {
#pragma unroll
  for (int i = 0; i < 8; i++) h[i] = SHA512_IV[i];
  const int64_t total = 64 + len;  // bytes hashed
  const int64_t blocks = (total + 16) / 128 + 1;  // room for 0x80 and the 16-byte length
#pragma unroll 1
  for (int64_t blk = 0; blk < blocks; blk++) {
    uint64_t w[16];
#pragma unroll
    for (int t = 0; t < 16; t++) {
      if (blk == 0 && t < 8) {
        w[t] = prefix[t];
      } else {
        const int64_t i = 128 * blk + 8 * t - 64;  // the word's first message byte
        const int64_t rem = len - i;
        uint64_t v = bswap64(msg.le64(i, rem));
        if (rem >= 0 && rem < 8) v |= 0x80ull << (56 - 8 * rem);
        w[t] = v;
      }
    }
    if (blk == blocks - 1) w[15] = (uint64_t)total << 3;  // w[14], the length's high half, is 0
    sha512_compress(h, w);
  }
}

// x (16 little-endian words, any 512-bit value) mod L -> r (8 words).
HDEV void mod_l(const uint32_t* x, uint32_t* r) {
  // q2 = ⌊x / 2^224⌋·μ: 9 x 9 words; only its words 9..17 are kept
  uint32_t q2[18];
#pragma unroll
  for (int i = 0; i < 18; i++) q2[i] = 0;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 9; j++) {
      c += (uint64_t)x[7 + i] * ED_L_MU[j] + q2[i + j];
      q2[i + j] = (uint32_t)c;
      c >>= 32;
    }
    q2[i + 9] = (uint32_t)c;
  }
  // r = x - q3·L mod 2^288, q3 = q2 / 2^288 (words 9..17)
  uint32_t ql[9];
#pragma unroll
  for (int i = 0; i < 9; i++) ql[i] = 0;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8 && i + j < 9; j++) {
      c += (uint64_t)q2[9 + i] * ED_L_WORDS[j] + ql[i + j];
      ql[i + j] = (uint32_t)c;
      c >>= 32;
    }
    if (i == 0) ql[8] = (uint32_t)c;  // the other rows' carries leave the 288 bits
  }
  uint32_t t[9];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    const uint64_t dlt = (uint64_t)x[i] - ql[i] - borrow;
    t[i] = (uint32_t)dlt;
    borrow = (uint32_t)(dlt >> 63);
  }
  // t < 3L: subtract L while it fits
#pragma unroll
  for (int k = 0; k < 2; k++) {
    uint32_t s[9];
    borrow = 0;
#pragma unroll
    for (int i = 0; i < 9; i++) {
      const uint64_t dlt = (uint64_t)t[i] - (i < 8 ? ED_L_WORDS[i] : 0u) - borrow;
      s[i] = (uint32_t)dlt;
      borrow = (uint32_t)(dlt >> 63);
    }
#pragma unroll
    for (int i = 0; i < 9; i++) t[i] = borrow ? t[i] : s[i];
  }
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = t[i];
}

// One lane: the row's R (bytes 0..31) and A (64..95) as 16 little-endian
// words, the message through `msg` -> k_neg = (L - SHA-512(R ‖ A ‖ M) mod
// L) mod L as 8 little-endian words.
template <class Rd>
HDEV void challenge_lane(const uint32_t* ra, const Rd& msg, int64_t len, uint32_t* k_neg) {
  uint64_t prefix[8], h[8];
#pragma unroll
  for (int i = 0; i < 8; i++) prefix[i] = (uint64_t)bswap32(ra[2 * i]) << 32 | bswap32(ra[2 * i + 1]);
  sha512_prefixed(prefix, msg, len, h);
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
  for (int i = 0; i < 8; i++) k_neg[i] = nz ? k_neg[i] : 0u;  // k = 0: k_neg = 0, not L
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
  int64_t start = 0, len = 0;
  bool valid = false;
  if (i < n) {
    start = starts[i];
    len = lengths[i];
    valid = start >= 0 && len >= 0 && start <= n_data - len;
  }
  int64_t lo;
  const bool staged = stage_warp(smem, data, start, len, valid, lane, &lo);
  if (i >= n) return;
  uint4* row = reinterpret_cast<uint4*>(rows + (int64_t)ED25519_ROW_BYTES * i);
  uint32_t k_neg[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (valid) {
    uint32_t ra[16];
#pragma unroll
    for (int q = 0; q < 4; q++) {  // R: quads 0, 1; A: quads 4, 5
      const uint4 v = row[q < 2 ? q : q + 2];
      ra[4 * q] = v.x, ra[4 * q + 1] = v.y, ra[4 * q + 2] = v.z, ra[4 * q + 3] = v.w;
    }
    if (staged) {
      challenge_lane(ra, WordReader{(const uint32_t*)smem, stage_offset(data, lo, start)}, len, k_neg);
    } else {
      challenge_lane(ra, ByteReader{data + start}, len, k_neg);
    }
  }
  row[6] = make_uint4(k_neg[0], k_neg[1], k_neg[2], k_neg[3]);
  row[7] = make_uint4(k_neg[4], k_neg[5], k_neg[6], k_neg[7]);
}

extern "C" void ed25519_challenge_geometry(int n, int* out) { hash_geometry(n, HASH_PACKED_SMEM, out); }

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
  hash_geometry(n, HASH_PACKED_SMEM, geo);
  ed25519_challenge_kernel<<<geo[1], geo[0], geo[2], (cudaStream_t)stream>>>(
      (uint8_t*)rows, (const uint8_t*)data, (const int64_t*)starts, (const int32_t*)lengths, n,
      (int64_t)n_data);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
