// Batch SM3 on the H100: one thread a message, 32 digest bytes a message
// out. Three forms of one body (hash_kernel.cuh):
//   packed  (sm3_launch)         any packed batch: the SM tx hash,
//           hash_batch, merkle levels
//   sender  (sm3_sender_launch)  the SM2 path's qx, qy limbs and ok bits ->
//           right160(SM3(ok ? x ‖ y : 0^64)) and the (zeroed) key's bytes
//   e       (sm3_e_launch)       tx-hash digests, qx, qy limbs and a per-ID
//           ZA midstate -> SM2's e = SM3(ZA ‖ H) as the SM2 kernel's [B, 16]
//           limbs, ZA = SM3(ENTL ‖ ID ‖ a ‖ b ‖ Gx ‖ Gy ‖ x ‖ y) kept in
//           registers
//
// Replaces the JAX package's sm3_blocks (fisco_bcos_tpu/ops/sm3.py), and
// with it the SM3 passes of sm2_e_batch (fisco_bcos_tpu/ops/sm2.py) and of
// the SM suite's calculate_address_batch (fisco_bcos_tpu/crypto/suite.py),
// jitted Merkle–Damgård chains over blocks padded on the host, which the
// TPU ran outside any Pallas kernel; the port's plain versions are
// sm3_packed_plain (ops/sm3.py), sm3_sender_address_plain (ops/address.py)
// and e_plain (ops/sm2.py).
//
// What bounds it: integer instructions. A compression takes about 1.4 k
// 32-bit instructions counted as one each (a 3-input logic op or add, a
// funnel shift): chip_smoke.py's SM3_COMPRESS_OPS. The bytes are a small
// share of that. A 10,240-message batch is 320 warps for 528 schedulers, so
// the kernel runs at one warp's pace: the design cuts the warp's stream
// (staged messages read as words, coalesced result rows), and the e form
// cuts the work itself: the first two of ZA's four blocks are the same for
// every signer of one ID, so the host compresses them once (the midstate)
// and a lane compresses 4 blocks for e, not 6.

#include "sm3.cuh"

#ifdef __CUDACC__

#define SM3_E_SMEM (HASH_THREADS * SM3_E_ROW_WORDS * 4)

// The e form: h uint8 [n, 32] digests, qx, qy int32 [n, 16], za int32
// [SM3_ZA_WORDS] (sm3.cuh) -> e int32 [n, 16] limbs.
__global__ void __launch_bounds__(HASH_THREADS)
sm3_e_kernel(const uint8_t* __restrict__ h, const int32_t* __restrict__ qx,
             const int32_t* __restrict__ qy, const uint32_t* __restrict__ za,
             int32_t* __restrict__ e_out, int n) {
  extern __shared__ uint4 hash_smem[];
  uint8_t* smem = (uint8_t*)hash_smem;
  const int lane = threadIdx.x;
  const int first = blockIdx.x * HASH_THREADS;
  const int n_lanes = min(HASH_THREADS, n - first);
  const int64_t i = (int64_t)first + lane;
  uint32_t limbs[16];
  if (lane < n_lanes) {
    uint32_t key[16], hw[8], e[8];
    load_limb_row(qx + 16 * i, key);
    load_limb_row(qy + 16 * i, key + 8);
#pragma unroll
    for (int j = 0; j < 2; j++) {
      const uint4 q = __ldg((const uint4*)(h + 32 * i) + j);
      hw[4 * j] = bswap32(q.x), hw[4 * j + 1] = bswap32(q.y);
      hw[4 * j + 2] = bswap32(q.z), hw[4 * j + 3] = bswap32(q.w);
    }
    sm3_e_lane(za, (uint32_t*)smem + lane * SM3_E_ROW_WORDS, key, hw, e);
    be_words_to_limbs(e, limbs);
  }
  store_rows<16>(smem, (uint8_t*)(e_out + 16 * (int64_t)first), n_lanes, lane, limbs);
}

extern "C" void sm3_geometry(int n, int* out) { hash_geometry(n, HASH_PACKED_SMEM, out); }

// C entry points for ctypes, all pointers on `device`. data uint8, starts
// int64 [n], lengths int32 [n], out uint8 [n, 32]; n_data the bytes of
// data; routes int32 [2] or null.
extern "C" int sm3_launch(const void* data, const void* starts, const void* lengths, void* out,
                          void* routes, int n, long long n_data, int device, void* stream) {
  return packed_hash_launch<Sm3, false>(data, starts, lengths, out, nullptr, routes, n, n_data,
                                        device, stream);
}

// qx, qy int32 [n, 16]; ok bool [n] or null; addr uint8 [n, 20]; pub uint8
// [n, 64].
extern "C" int sm3_sender_launch(const void* qx, const void* qy, const void* ok, void* addr,
                                 void* pub, int n, int device, void* stream) {
  return sender_launch<Sm3>(qx, qy, ok, addr, pub, n, device, stream);
}

// h uint8 [n, 32]; qx, qy int32 [n, 16]; za int32 [SM3_ZA_WORDS]; e int32
// [n, 16].
extern "C" int sm3_e_launch(const void* h, const void* qx, const void* qy, const void* za, void* e,
                            int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  int geo[3];
  hash_geometry(n, SM3_E_SMEM, geo);
  sm3_e_kernel<<<geo[1], geo[0], geo[2], (cudaStream_t)stream>>>(
      (const uint8_t*)h, (const int32_t*)qx, (const int32_t*)qy, (const uint32_t*)za, (int32_t*)e,
      n);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
