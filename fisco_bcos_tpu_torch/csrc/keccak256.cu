// Batch keccak-256 on the H100: one thread a message of a packed batch
// (bytes, per-message starts and lengths), padded inside the kernel, 32
// digest bytes a message out.
//
// Replaces the JAX package's keccak256_blocks (fisco_bcos_tpu/ops/keccak.py),
// a jitted sponge over blocks padded on the host, which the TPU ran outside
// any Pallas kernel; the port's plain version, keccak256_packed_plain
// (ops/keccak.py), gathers, pads and runs 24 rounds of whole-state tensor
// ops. One kernel serves every keccak of the port: the tx hash, the sender
// address, hash_batch and each merkle level.
//
// What bounds it: integer instructions. A permutation takes about 4.3 k
// 32-bit instructions counted as one each (a 3-input logic op, a funnel
// shift): chip_smoke.py's KECCAK_F_OPS. The bytes (each message read once,
// 32 bytes written) are under a tenth of that at the main path's 97-byte
// payloads. A 10,240-message batch is 320 warps for 528 schedulers, so the
// kernel runs at one warp's pace, and at that size its launch may well cost
// more than its work.
//
// The byte loads are uncoalesced (hash_kernel.cuh); a warp-staged copy
// through shared memory is left for a later change.

#include "keccak256.cuh"

#ifdef __CUDACC__

struct Keccak256 {
  static __device__ __forceinline__ void message(const uint8_t* msg, int64_t len, uint8_t* out) {
    keccak256_message(msg, len, out);
  }
};

extern "C" void keccak256_geometry(int n, int* out) { hash_geometry(n, out); }

// C entry point for ctypes: data uint8, starts int64 [n], lengths int32 [n],
// out uint8 [n, 32], all on `device`; n_data the bytes of data.
extern "C" int keccak256_launch(const void* data, const void* starts, const void* lengths,
                                void* out, int n, long long n_data, int device, void* stream) {
  return packed_hash_launch<Keccak256>(data, starts, lengths, out, n, n_data, device, stream);
}

#endif  // __CUDACC__
