// What the port's two hash kernels (keccak256.cu, sm3.cu) share: one thread
// hashes one message; a warp stages its 32 messages through shared memory
// and its 32 results leave through shared memory as contiguous rows.
//
// Each kernel is one body with an input and an output policy, one C entry
// point per form:
//   packed    bytes, int64 starts, int32 lengths -> digests [B, 32] uint8
//   tx hash   the same input -> digests and the digest as [B, 16] int32
//             16-bit limbs (the EC kernels' input)
//   sender    a public key as [B, 16] int32 limbs x, y (the EC kernels'
//             output), optionally zeroed where ok[i] is false -> the
//             address [B, 20] and the key's bytes [B, 64]
//   e (SM3)   digests [B, 32], key limbs and a per-ID ZA midstate -> SM2's
//             e as [B, 16] int32 limbs
//
// Staging (packed and tx-hash forms). The warp finds the span [lo, hi) of
// its lanes' messages with shuffles. Every packed caller lays a warp's
// messages out back to back (pack_messages, rows_as_packed, a merkle
// level), so the span is the messages themselves. If it fits
// HASH_STAGE_BYTES, the warp copies it with cp.async, 16 bytes a lane where
// the source is aligned and byte copies at the two ragged ends, into shared
// memory at the same offset mod 16; each lane then reads its message as
// aligned 32-bit words and funnel shifts (WordReader). Where the span does
// not fit (long messages, or starts scattered through the buffer) the warp
// reads as before, each lane its own bytes from global memory (ByteReader).
// Any start, length and order stays allowed; only the route changes. Empty
// messages read nothing and do not widen the span.
//
// Geometry: one warp a block, as the EC kernels: 10,240 messages make 320
// blocks over the 132 SMs, at most one warp a scheduler, so nothing is
// gained by larger blocks. HASH_STAGE_BYTES = 16 KiB: 32 merkle groups of
// width 16 (512 bytes each), or 32 messages of 512 bytes, stage whole;
// three such blocks take 48 KiB of an SM's 228 KiB.
//
// Outputs: each lane writes its row to shared memory, and the warp stores
// the warp's rows as one contiguous span, 16 bytes a lane (1 KiB of digests
// a warp). The wrappers allocate every output, so it is 16-byte aligned.
//
// The message and lane functions compile as host C++ too (no __CUDACC__):
// the tier-1 tests build them with g++ and hold them against the reference
// hashes.

#ifndef FISCO_HASH_KERNEL_CUH
#define FISCO_HASH_KERNEL_CUH

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HINL __device__ __forceinline__
#define HCONST __constant__
#else
#define HINL inline
#define HCONST static const
#endif
#define HDEV static HINL

#ifndef HASH_STAGE_BYTES
#define HASH_STAGE_BYTES 16384
#endif

HDEV uint32_t bswap32(uint32_t x) {
  return (x >> 24) | ((x >> 8) & 0xFF00u) | ((x << 8) & 0xFF0000u) | (x << 24);
}

// Bytes p[0..k) as a little-endian (keccak lanes) or big-endian (SM3 words)
// value of `W` bytes, k in [0, W]; the bytes past k read as zero and are not
// loaded.
template <typename T, int W, bool BE>
HDEV T load_bytes(const uint8_t* p, int k) {
  T v = 0;
  if (k >= W) {
#pragma unroll
    for (int i = 0; i < W; i++) v |= (T)p[i] << (8 * (BE ? W - 1 - i : i));
  } else {
    for (int i = 0; i < k; i++) v |= (T)p[i] << (8 * (BE ? W - 1 - i : i));
  }
  return v;
}

// The message bytes from `rem` bytes before a word's first byte on: the count
// to load into a word of W bytes.
HDEV int bytes_in_word(int64_t rem, int w) {
  return rem <= 0 ? 0 : (rem >= w ? w : (int)rem);
}

// A message read byte by byte where it lies (global memory): any start, any
// alignment, and no byte outside the message is loaded. `rem` is the count
// of message bytes from byte i on; the bytes past the message read as zero.
struct ByteReader {
  const uint8_t* p;
  HINL uint64_t le64(int64_t i, int64_t rem) const {
    return load_bytes<uint64_t, 8, false>(p + i, bytes_in_word(rem, 8));
  }
  HINL uint32_t be32(int64_t i, int64_t rem) const {
    return load_bytes<uint32_t, 4, true>(p + i, bytes_in_word(rem, 4));
  }
};

// A message at byte `off` of 4-byte aligned words (shared memory on the
// card): a value is one or two funnel shifts of aligned 32-bit loads, and a
// value wholly past the message loads nothing. A value that ends the message
// may load up to three words past its last byte, so the words must run 12
// bytes beyond it.
struct WordReader {
  const uint32_t* w;
  uint32_t off;
  HINL uint32_t le32(uint32_t b) const {  // bytes b..b+3, little-endian
    const uint32_t q = b >> 2;
    return (uint32_t)((((uint64_t)w[q + 1] << 32) | w[q]) >> (8 * (b & 3)));
  }
  HINL uint64_t le64(int64_t i, int64_t rem) const {
    if (rem <= 0) return 0;
    const uint32_t b = off + (uint32_t)i;
    const uint64_t v = le32(b) | ((uint64_t)le32(b + 4) << 32);
    return rem >= 8 ? v : v & ((1ull << (8 * rem)) - 1);
  }
  HINL uint32_t be32(int64_t i, int64_t rem) const {
    if (rem <= 0) return 0;
    uint32_t v = le32(off + (uint32_t)i);
    if (rem < 4) v &= (1u << (8 * rem)) - 1;
    return bswap32(v);
  }
};

// Bytes of the 8-byte value hi:lo picked by a selector's nibbles: byte k of
// the result is byte (sel >> 4k) & 7 of it. One PRMT on the card.
HDEV uint32_t byte_perm(uint32_t lo, uint32_t hi, uint32_t sel) {
#ifdef __CUDA_ARCH__
  return __byte_perm(lo, hi, sel);
#else
  const uint64_t x = (uint64_t)hi << 32 | lo;
  uint32_t r = 0;
  for (int k = 0; k < 4; k++) r |= (uint32_t)(x >> (8 * ((sel >> (4 * k)) & 7)) & 0xFF) << (8 * k);
  return r;
#endif
}

// A message through either route, the route chosen at run time, so that the
// code that consumes its words is compiled once (sha256.cuh,
// ed25519_challenge.cu): its bytes as 4-byte aligned words (staged, in shared
// memory on the card: `words` not null, the message from byte `off` on; the
// words must run 4 bytes past the last one read) or where they lie (`bytes`,
// global memory; no byte outside the message is loaded). It reads N
// big-endian 32-bit words at a time, from a multiple of 4 bytes into the
// message, with one test of the route for all N: a staged word is one
// byte_perm of two aligned words, its selector fixed by off mod 4.
struct MsgReader {
  const uint32_t* words;
  uint32_t off;
  const uint8_t* bytes;
  uint32_t sel;

  static HINL MsgReader staged(const uint32_t* w, uint32_t off) {
    const uint32_t r = off & 3;
    return MsgReader{w, off, nullptr, r << 12 | (r + 1) << 8 | (r + 2) << 4 | (r + 3)};
  }
  static HINL MsgReader direct(const uint8_t* p) { return MsgReader{nullptr, 0, p, 0}; }

  // message bytes [i, i + 4N), all inside the message
  template <int N>
  HINL void be32s(uint32_t i, uint32_t* out) const {
    if (words) {
      const uint32_t q = (off + i) >> 2;
      uint32_t lo = words[q];
#pragma unroll
      for (int k = 0; k < N; k++) {
        const uint32_t hi = words[q + k + 1];
        out[k] = byte_perm(lo, hi, sel);
        lo = hi;
      }
    } else {
#pragma unroll
      for (int k = 0; k < N; k++) out[k] = load_bytes<uint32_t, 4, true>(bytes + i + 4 * k, 4);
    }
  }

  // bytes [i, i + 4N) of which the first `rem` (any value) are the
  // message's and the rest read as zero; a staged word wholly past the
  // message is read from word 0 and masked, a direct one not loaded
  template <int N>
  HINL void be32s_head(uint32_t i, int rem, uint32_t* out) const {
    if (words) {
      const uint32_t q = (off + i) >> 2;
#pragma unroll
      for (int k = 0; k < N; k++) {
        const int b = rem - 4 * k;  // message bytes from this word's start on
        const uint32_t qk = b > 0 ? q + k : 0;
        const uint32_t v = byte_perm(words[qk], words[qk + 1], sel);
        out[k] = b >= 4 ? v : b > 0 ? v & ~(0xFFFFFFFFu >> (8 * b)) : 0u;
      }
    } else {
#pragma unroll
      for (int k = 0; k < N; k++) {
        const int b = rem - 4 * k;
        out[k] = load_bytes<uint32_t, 4, true>(bytes + i + 4 * k, b <= 0 ? 0 : b >= 4 ? 4 : b);
      }
    }
  }
};

// The warp meets (__syncwarp on the card; nothing in a host build, which
// runs one lane at a time): lanes that took different branches run what
// follows together, as one copy of it.
HDEV void warp_meet() {
#ifdef __CUDA_ARCH__
  __syncwarp();
#endif
}

// [16] int32 16-bit limbs (little-endian, as the EC kernels keep a 256-bit
// value) -> [8] big-endian 32-bit words: the value's 32 bytes, big-endian.
// Only each limb's low 16 bits count, as in limbs_to_bytes_device.
HDEV void limbs_to_be_words(const int32_t* limbs, uint32_t* be) {
#pragma unroll
  for (int i = 0; i < 8; i++) {
    be[i] = ((uint32_t)limbs[15 - 2 * i] << 16) | ((uint32_t)limbs[14 - 2 * i] & 0xFFFFu);
  }
}

// [8] big-endian words -> [16] 16-bit limbs (the inverse).
HDEV void be_words_to_limbs(const uint32_t* be, uint32_t* limbs) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    limbs[2 * k] = be[7 - k] & 0xFFFFu;
    limbs[2 * k + 1] = be[7 - k] >> 16;
  }
}

// The tx-hash form's second output: a digest (8 words in memory order)
// read as a big-endian integer -> its 16 limbs.
HDEV void digest_limbs(const uint32_t* digest, uint32_t* limbs) {
  uint32_t be[8];
#pragma unroll
  for (int j = 0; j < 8; j++) be[j] = bswap32(digest[j]);
  be_words_to_limbs(be, limbs);
}

// The sender form's lane: a key's 16 big-endian words (x ‖ y) -> its 64
// bytes and right160(H(key)), both as words in memory order.
template <class H>
HDEV void sender_lane(const uint32_t* key, uint32_t* bytes, uint32_t* addr) {
  uint32_t digest[8];
  H::key(key, digest);
#pragma unroll
  for (int j = 0; j < 16; j++) bytes[j] = bswap32(key[j]);
#pragma unroll
  for (int j = 0; j < 5; j++) addr[j] = digest[3 + j];
}

#ifdef __CUDACC__

#define HASH_THREADS 32
// Dynamic shared bytes a block: the packed and tx-hash forms stage a span of
// up to HASH_STAGE_BYTES at its address mod 16, plus the words a reader may
// load past it; the sender and e forms need their rows only.
#define HASH_PACKED_SMEM (HASH_STAGE_BYTES + 32)
#define HASH_ROW_SMEM (HASH_THREADS * 64)

HDEV void cp_async16(void* smem_dst, const void* gsrc) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(smem_dst)),
               "l"(gsrc)
               : "memory");
}

// src[0 .. span) -> smem + (src mod 16) on, by the whole warp: 16-byte
// cp.async copies of the aligned middle, byte copies of the ragged ends.
HDEV void stage_span(uint8_t* smem, const uint8_t* src, int64_t span, int lane) {
  const uintptr_t a0 = (uintptr_t)src, a1 = a0 + span;
  const uintptr_t q0 = (a0 + 15) & ~(uintptr_t)15, q1 = a1 & ~(uintptr_t)15;
  uint8_t* dst = smem + (a0 & 15);  // dst - src = 0 mod 16
  if (q0 < q1) {
    for (uintptr_t q = q0 + 16 * lane; q < q1; q += 16 * HASH_THREADS) {
      cp_async16(dst + (q - a0), (const void*)q);
    }
    for (int64_t k = lane; k < (int64_t)(q0 - a0); k += HASH_THREADS) dst[k] = src[k];
    for (int64_t k = (int64_t)(q1 - a0) + lane; k < span; k += HASH_THREADS) dst[k] = src[k];
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    for (int64_t k = lane; k < span; k += HASH_THREADS) dst[k] = src[k];
  }
  __syncwarp();
}

// The staging of a packed batch (above): the span [lo, hi) of the warp's
// valid, non-empty messages, copied into smem by the whole warp when it
// fits HASH_STAGE_BYTES. Returns whether the warp staged; *lo_out is the
// span's start, so a staged lane reads its message from byte
// (data + lo) mod 16 + start - lo of smem on (stage_offset).
HDEV bool stage_warp(uint8_t* smem, const uint8_t* data, int64_t start, int64_t len, bool valid,
                     int lane, int64_t* lo_out) {
  int64_t lo = valid && len > 0 ? start : INT64_MAX;
  int64_t hi = valid && len > 0 ? start + len : 0;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int64_t lo_d = __shfl_xor_sync(0xFFFFFFFFu, (long long)lo, d);
    const int64_t hi_d = __shfl_xor_sync(0xFFFFFFFFu, (long long)hi, d);
    lo = lo_d < lo ? lo_d : lo;
    hi = hi_d > hi ? hi_d : hi;
  }
  const bool staged = hi - lo <= HASH_STAGE_BYTES;  // no bytes at all: hi - lo < 0
  if (staged && hi > lo) stage_span(smem, data + lo, hi - lo, lane);
  *lo_out = lo;
  return staged;
}

HDEV uint32_t stage_offset(const uint8_t* data, int64_t lo, int64_t start) {
  return (uint32_t)(((uintptr_t)(data + lo) & 15) + (start - lo));
}

// This lane's row of N words into shared memory at lane·4N bytes, with
// 16-byte stores where N allows.
template <int N>
HDEV void put_row(uint8_t* smem, int lane, const uint32_t* words) {
  if constexpr (N % 4 == 0) {
    uint4* row = (uint4*)smem + lane * (N / 4);
#pragma unroll
    for (int j = 0; j < N / 4; j++) {
      row[j] = make_uint4(words[4 * j], words[4 * j + 1], words[4 * j + 2], words[4 * j + 3]);
    }
  } else {
    uint32_t* row = (uint32_t*)smem + lane * N;
#pragma unroll
    for (int j = 0; j < N; j++) row[j] = words[j];
  }
}

// The warp's rows (smem[0 .. bytes)) -> out[0 .. bytes), 16 bytes a lane
// (out is 16-byte aligned), the last bytes of a short warp one at a time.
HDEV void warp_store(const uint8_t* smem, uint8_t* out, int bytes, int lane) {
  for (int k = 16 * lane; k + 16 <= bytes; k += 16 * HASH_THREADS) {
    *(uint4*)(out + k) = *(const uint4*)(smem + k);
  }
  for (int k = (bytes & ~15) + lane; k < bytes; k += HASH_THREADS) out[k] = smem[k];
}

// Rows of N words from every lane < n_lanes -> out (one contiguous span).
template <int N>
HDEV void store_rows(uint8_t* smem, uint8_t* out, int n_lanes, int lane, const uint32_t* words) {
  __syncwarp();  // every lane is done with what smem held before
  if (lane < n_lanes) put_row<N>(smem, lane, words);
  __syncwarp();
  warp_store(smem, out, 4 * N * n_lanes, lane);
}

// A [16] int32 limb row (64 bytes, 16-byte aligned) -> [8] big-endian words.
HDEV void load_limb_row(const int32_t* row, uint32_t* be) {
  int32_t limbs[16];
#pragma unroll
  for (int j = 0; j < 4; j++) {
    const int4 q = __ldg((const int4*)row + j);
    limbs[4 * j] = q.x, limbs[4 * j + 1] = q.y, limbs[4 * j + 2] = q.z, limbs[4 * j + 3] = q.w;
  }
  limbs_to_be_words(limbs, be);
}

// The packed and tx-hash forms. Message i is data[starts[i] .. starts[i] +
// lengths[i]); its digest goes to out[32 i ..], and with LIMBS its value as
// 16 limbs to limbs_out[16 i ..]. A range outside the n_data bytes of
// `data` is read from no memory: its lane writes a zero digest (the
// wrappers' callers make no such range). routes, where not null, counts the
// warps that staged (routes[0]) and that read directly (routes[1]).
template <class H, bool LIMBS>
__global__ void __launch_bounds__(HASH_THREADS)
packed_hash_kernel(const uint8_t* __restrict__ data, const int64_t* __restrict__ starts,
                   const int32_t* __restrict__ lengths, uint8_t* __restrict__ out,
                   int32_t* __restrict__ limbs_out, int n, int64_t n_data, int* routes) {
  extern __shared__ uint4 hash_smem[];
  uint8_t* smem = (uint8_t*)hash_smem;
  const int lane = threadIdx.x;
  const int first = blockIdx.x * HASH_THREADS;
  const int n_lanes = min(HASH_THREADS, n - first);
  int64_t start = 0, len = 0;
  bool valid = false;
  if (lane < n_lanes) {
    start = starts[first + lane];
    len = lengths[first + lane];
    valid = start >= 0 && len >= 0 && start <= n_data - len;
  }
  int64_t lo;
  const bool staged = stage_warp(smem, data, start, len, valid, lane, &lo);
  if (routes != nullptr && lane == 0) atomicAdd(routes + (staged ? 0 : 1), 1);

  uint32_t digest[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (valid) {
    if (staged) {
      H::message(WordReader{(const uint32_t*)smem, stage_offset(data, lo, start)}, len, digest);
    } else {
      H::message(ByteReader{data + start}, len, digest);
    }
  }
  store_rows<8>(smem, out + 32 * (int64_t)first, n_lanes, lane, digest);
  if constexpr (LIMBS) {
    uint32_t limbs[16];
    digest_limbs(digest, limbs);
    store_rows<16>(smem, (uint8_t*)(limbs_out + 16 * (int64_t)first), n_lanes, lane, limbs);
  }
}

// The sender form: the key x ‖ y from limbs (zero where ok is given and
// false) -> right160(H(key)) to addr[20 i ..] and the key's bytes to
// pub[64 i ..].
template <class H>
__global__ void __launch_bounds__(HASH_THREADS)
sender_kernel(const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
              const uint8_t* __restrict__ ok, uint8_t* __restrict__ addr,
              uint8_t* __restrict__ pub, int n) {
  extern __shared__ uint4 hash_smem[];
  uint8_t* smem = (uint8_t*)hash_smem;
  const int lane = threadIdx.x;
  const int first = blockIdx.x * HASH_THREADS;
  const int n_lanes = min(HASH_THREADS, n - first);
  const int64_t i = (int64_t)first + lane;
  uint32_t key[16] = {0};
  if (lane < n_lanes && (ok == nullptr || ok[i])) {
    load_limb_row(qx + 16 * i, key);
    load_limb_row(qy + 16 * i, key + 8);
  }
  uint32_t bytes[16], address[5];
  sender_lane<H>(key, bytes, address);
  store_rows<16>(smem, pub + 64 * (int64_t)first, n_lanes, lane, bytes);
  store_rows<5>(smem, addr + 20 * (int64_t)first, n_lanes, lane, address);
}

// Launch geometry for n lanes: threads a block, blocks, dynamic shared bytes.
static void hash_geometry(int n, int smem, int* out) {
  out[0] = HASH_THREADS;
  out[1] = (n + HASH_THREADS - 1) / HASH_THREADS;
  out[2] = smem;
}

// The launches, on `stream` of `device`; they do not synchronise, and return
// the first CUDA error (0 on success).
template <class H, bool LIMBS>
static int packed_hash_launch(const void* data, const void* starts, const void* lengths,
                              void* out, void* limbs_out, void* routes, int n, long long n_data,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  int geo[3];
  hash_geometry(n, HASH_PACKED_SMEM, geo);
  packed_hash_kernel<H, LIMBS><<<geo[1], geo[0], geo[2], (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int64_t*)starts, (const int32_t*)lengths, (uint8_t*)out,
      (int32_t*)limbs_out, n, (int64_t)n_data, (int*)routes);
  return (int)cudaGetLastError();
}

template <class H>
static int sender_launch(const void* qx, const void* qy, const void* ok, void* addr, void* pub,
                         int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  int geo[3];
  hash_geometry(n, HASH_ROW_SMEM, geo);
  sender_kernel<H><<<geo[1], geo[0], geo[2], (cudaStream_t)stream>>>(
      (const int32_t*)qx, (const int32_t*)qy, (const uint8_t*)ok, (uint8_t*)addr, (uint8_t*)pub, n);
  return (int)cudaGetLastError();
}

extern "C" const char* fisco_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

#endif  // __CUDACC__

#endif  // FISCO_HASH_KERNEL_CUH
