// What the port's two hash kernels (keccak256.cu, sm3.cu) share: one thread
// hashes one message of a packed batch, read from one byte buffer at its
// own start and length, and pads it in registers; 32 digest bytes a message
// out.
//
// The byte loads are uncoalesced: each thread walks its own message, and
// neighbouring threads read addresses a message apart. A warp-staged copy
// of the messages through shared memory is left for a later change.
//
// The message functions compile as host C++ too (no __CUDACC__): the tier-1
// tests build them with g++ and hold them against the reference hashes.

#ifndef FISCO_HASH_KERNEL_CUH
#define FISCO_HASH_KERNEL_CUH

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HDEV __device__ __forceinline__
#define HCONST __constant__
#else
#define HDEV static inline
#define HCONST static const
#endif

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

#ifdef __CUDACC__

// One warp a block, as the EC kernels: 10,240 messages make 320 blocks,
// spread over all 132 SMs.
#define HASH_THREADS 32

// Message i is data[starts[i] .. starts[i] + lengths[i]); its digest goes to
// out[32 i .. 32 i + 32). A range outside the n_data bytes of `data` is read
// from no memory: its lane writes a zero digest (the wrappers' callers make
// no such range).
template <class H>
__global__ void __launch_bounds__(HASH_THREADS)
packed_hash_kernel(const uint8_t* __restrict__ data, const int64_t* __restrict__ starts,
                   const int32_t* __restrict__ lengths, uint8_t* __restrict__ out, int n,
                   int64_t n_data) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int64_t start = starts[i];
  int64_t len = lengths[i];
  uint8_t* digest = out + 32 * (int64_t)i;
  if (start < 0 || len < 0 || start > n_data - len) {
#pragma unroll
    for (int k = 0; k < 32; k++) digest[k] = 0;
    return;
  }
  H::message(data + start, len, digest);
}

// Launch geometry for n messages: threads a block, blocks, dynamic shared bytes.
static void hash_geometry(int n, int* out) {
  out[0] = HASH_THREADS;
  out[1] = (n + HASH_THREADS - 1) / HASH_THREADS;
  out[2] = 0;
}

// Launches on `stream` of `device`, does not synchronise; returns the first
// CUDA error (0 on success).
template <class H>
static int packed_hash_launch(const void* data, const void* starts, const void* lengths,
                              void* out, int n, long long n_data, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  int geo[3];
  hash_geometry(n, geo);
  packed_hash_kernel<H><<<geo[1], geo[0], geo[2], (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int64_t*)starts, (const int32_t*)lengths, (uint8_t*)out, n,
      (int64_t)n_data);
  return (int)cudaGetLastError();
}

extern "C" const char* fisco_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

#endif  // __CUDACC__

#endif  // FISCO_HASH_KERNEL_CUH
