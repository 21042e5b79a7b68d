// Batch SHA-256 on the H100, in the packed form of the hash kernels: a
// packed batch (one byte buffer, int64 starts, int32 lengths) in, each
// message padded in registers, a warp's messages staged through shared
// memory (stage_warp, hash_kernel.cuh) when their span fits
// HASH_STAGE_BYTES, [B, 32] big-endian digests written as the warp's
// contiguous rows.
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
// The bytes are a small share of that. A 10,240-message batch is 320 warps
// for 528 schedulers and a merkle level above it far fewer, so a launch
// takes about as long as one warp's stream of its longest message, and the
// design cuts that stream (sha256.cuh):
//   - one copy of the compression: both routes (staged words, or the bytes
//     where they lie) feed it through one MsgReader chosen at run time; its
//     64 rounds unrolled, the fastest form on the field bench (sha256.cuh);
//   - a block wholly inside the message loads without the padding logic
//     (staged: a byte_perm of two aligned words a word); only the last one
//     or two blocks form the padding, in 32-bit arithmetic;
//   - the block loop is the warp's (its longest message's blocks), and the
//     warp meets after a block's words are formed: without that meeting
//     point the compiler put the compression in both arms of the
//     full-block / tail test, and a warp whose lanes stood at different
//     blocks ran it twice (sha256_lane).
// Two lanes a message (a round lane beside a schedule lane) measured slower
// on the field bench: the warp issues the two lanes' diverged streams one
// after the other (PERF.md §6).
//
// The arithmetic compiles as host C++ too (no __CUDACC__): the tier-1 tests
// build it with g++.

#include "sha256.cuh"

#ifdef __CUDACC__

// Message i is data[starts[i] .. starts[i] + lengths[i]); its digest goes to
// out[32 i ..]. A range outside the n_data bytes of `data` is read from no
// memory: its digest is zero (the wrappers' callers make no such range).
// routes, where not null, counts the warps that staged (routes[0]) and that
// read directly (routes[1]).
__global__ void __launch_bounds__(HASH_THREADS)
sha256_kernel(const uint8_t* __restrict__ data, const int64_t* __restrict__ starts,
              const int32_t* __restrict__ lengths, uint8_t* __restrict__ out, int n, int64_t n_data,
              int* routes) {
  extern __shared__ uint4 hash_smem[];
  uint8_t* smem = (uint8_t*)hash_smem;
  const int lane = threadIdx.x;
  const int first = blockIdx.x * HASH_THREADS;
  const int n_msgs = min(HASH_THREADS, n - first);
  int64_t start = 0, len = 0;
  bool valid = false;
  if (lane < n_msgs) {
    start = starts[first + lane];
    len = lengths[first + lane];
    valid = start >= 0 && len >= 0 && start <= n_data - len;
  }
  int64_t lo;
  const bool staged = stage_warp(smem, data, start, len, valid, lane, &lo);
  if (routes != nullptr && lane == 0) atomicAdd(routes + (staged ? 0 : 1), 1);
  const MsgReader msg = staged ? MsgReader::staged((const uint32_t*)smem, stage_offset(data, lo, start))
                               : MsgReader::direct(data + start);

  uint32_t v[8];
  const uint32_t nb = valid ? sha256_blocks_of((uint32_t)len) : 0;
  const uint32_t wb = __reduce_max_sync(0xFFFFFFFFu, nb);  // the warp's longest message's blocks
  sha256_lane(msg, valid ? (uint32_t)len : 0u, wb, v);
  uint32_t digest[8];
#pragma unroll
  for (int k = 0; k < 8; k++) digest[k] = valid ? bswap32(v[k]) : 0u;
  store_rows<8>(smem, out + 32 * (int64_t)first, n_msgs, lane, digest);
}

// Launch geometry for n messages: threads a block, blocks, dynamic shared bytes.
extern "C" void sha256_geometry(int n, int* out) {
  out[0] = HASH_THREADS;
  out[1] = (n + HASH_THREADS - 1) / HASH_THREADS;
  out[2] = HASH_PACKED_SMEM;
}

// C entry point for ctypes, all pointers on `device`. data uint8, starts
// int64 [n], lengths int32 [n], out uint8 [n, 32]; n_data the bytes of data;
// routes int32 [2] or null. Launches on `stream`, does not synchronise;
// returns the first CUDA error (0 on success).
extern "C" int sha256_launch(const void* data, const void* starts, const void* lengths, void* out,
                             void* routes, int n, long long n_data, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  int geo[3];
  sha256_geometry(n, geo);
  sha256_kernel<<<geo[1], geo[0], geo[2], (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int64_t*)starts, (const int32_t*)lengths, (uint8_t*)out, n,
      (int64_t)n_data, (int*)routes);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
