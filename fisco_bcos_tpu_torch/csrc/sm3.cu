// Batch SM3 on the H100: one thread a message of a packed batch (bytes,
// per-message starts and lengths), padded inside the kernel, 32 digest bytes
// a message out.
//
// Replaces the JAX package's sm3_blocks (fisco_bcos_tpu/ops/sm3.py), a jitted
// Merkle–Damgård chain over blocks padded on the host, which the TPU ran
// outside any Pallas kernel; the port's plain version, sm3_packed_plain
// (ops/sm3.py), gathers, pads and runs 64 rounds of whole-batch tensor ops a
// block. One kernel serves every SM3 of the port: the SM tx hash, SM2's ZA
// and e, the SM sender address, hash_batch and each SM merkle level.
//
// What bounds it: integer instructions. A compression takes about 1.4 k
// 32-bit instructions counted as one each (a 3-input logic op or add, a
// funnel shift): chip_smoke.py's SM3_COMPRESS_OPS. The bytes (each message
// read once, 32 bytes written) are a small share of that. A 10,240-message
// batch is 320 warps for 528 schedulers, so the kernel runs at one warp's
// pace, and at that size its launch may well cost more than its work.
//
// The byte loads are uncoalesced (hash_kernel.cuh); a warp-staged copy
// through shared memory is left for a later change.

#include "sm3.cuh"

#ifdef __CUDACC__

struct Sm3 {
  static __device__ __forceinline__ void message(const uint8_t* msg, int64_t len, uint8_t* out) {
    sm3_message(msg, len, out);
  }
};

extern "C" void sm3_geometry(int n, int* out) { hash_geometry(n, out); }

// C entry point for ctypes: data uint8, starts int64 [n], lengths int32 [n],
// out uint8 [n, 32], all on `device`; n_data the bytes of data.
extern "C" int sm3_launch(const void* data, const void* starts, const void* lengths, void* out,
                          int n, long long n_data, int device, void* stream) {
  return packed_hash_launch<Sm3>(data, starts, lengths, out, n, n_data, device, stream);
}

#endif  // __CUDACC__
