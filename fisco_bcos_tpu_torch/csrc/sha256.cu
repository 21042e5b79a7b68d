// Batch SHA-256 on the H100: one thread a message, 32 digest bytes a message
// out, in the packed form of sm3.cu (hash_kernel.cuh's packed_hash_kernel):
// a packed batch (one byte buffer, int64 starts, int32 lengths) in, each
// message padded in registers, a warp's messages staged through shared
// memory (stage_warp) when their span fits HASH_STAGE_BYTES, [B, 32]
// big-endian digests written as the warp's contiguous rows.
//
// Replaces the JAX package's sha256_blocks (fisco_bcos_tpu/ops/sha256.py),
// a jitted Merkle–Damgård chain over blocks padded on the host, which the
// TPU ran outside any Pallas kernel; the port's plain version is
// sha256_packed_plain (ops/sha256.py). Callers: the Sha256 HashImpl's batch
// calls and merkle levels with hasher "sha256".
//
// What bounds it: integer instructions, as SM3 (sm3.cu). A compression takes
// about 1.4 k 32-bit instructions counted as one each (a 3-input logic op or
// add, a funnel shift, a plain shift): chip_smoke.py's SHA256_COMPRESS_OPS.
// The bytes are a small share of that. A 10,240-message
// batch is 320 warps for 528 schedulers, so the kernel runs at one warp's
// pace, and the design cuts that warp's stream as SM3's does: staged
// messages read as aligned words, coalesced result rows.

#include "sha256.cuh"

#ifdef __CUDACC__

extern "C" void sha256_geometry(int n, int* out) { hash_geometry(n, HASH_PACKED_SMEM, out); }

// C entry point for ctypes, all pointers on `device`. data uint8, starts
// int64 [n], lengths int32 [n], out uint8 [n, 32]; n_data the bytes of data;
// routes int32 [2] or null.
extern "C" int sha256_launch(const void* data, const void* starts, const void* lengths, void* out,
                             void* routes, int n, long long n_data, int device, void* stream) {
  return packed_hash_launch<Sha256, false>(data, starts, lengths, out, nullptr, routes, n, n_data,
                                           device, stream);
}

#endif  // __CUDACC__
