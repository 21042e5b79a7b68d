// Multi-word integer helpers shared by the port's EC kernels: 256-bit values
// as 8 little-endian 32-bit words, one thread per signature.
//
// Everything here compiles as host C++ too (no __CUDACC__): the tier-1 tests
// build the kernels' arithmetic with g++. Only the error-string entry point
// is CUDA-specific.

#ifndef FISCO_WIDE_INT_CUH
#define FISCO_WIDE_INT_CUH

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DEV __device__ __forceinline__
#define DEV_NOINLINE __device__ __noinline__
#define CONSTMEM __constant__
#else
#define DEV static inline
#define DEV_NOINLINE static
#define CONSTMEM static const
#endif

typedef uint32_t u32;
typedef uint64_t u64;

template <int N>
DEV u32 add_w(u32* r, const u32* a, const u32* b) {
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    c += (u64)a[i] + b[i];
    r[i] = (u32)c;
    c >>= 32;
  }
  return (u32)c;
}

// r[0..N) += a[0..M), carry rippling to the top; returns the carry out.
template <int N, int M>
DEV u32 add_into(u32* r, const u32* a) {
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    c += (u64)r[i] + (i < M ? a[i] : 0u);
    r[i] = (u32)c;
    c >>= 32;
  }
  return (u32)c;
}

template <int N>
DEV u32 sub_w(u32* r, const u32* a, const u32* b) {  // returns the borrow
  u32 borrow = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    u64 d = (u64)a[i] - b[i] - borrow;
    r[i] = (u32)d;
    borrow = (u32)(d >> 63);
  }
  return borrow;
}

// r[NA+NB] = a[NA] * b[NB] (schoolbook; r must not alias a or b)
template <int NA, int NB>
DEV void mul_w(u32* r, const u32* a, const u32* b) {
#pragma unroll
  for (int i = 0; i < NA + NB; i++) r[i] = 0;
#pragma unroll
  for (int i = 0; i < NA; i++) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < NB; j++) {
      c += (u64)a[i] * b[j] + r[i + j];
      r[i + j] = (u32)c;
      c >>= 32;
    }
    r[i + NB] = (u32)c;
  }
}

template <int N>
DEV void copy_w(u32* r, const u32* a) {
#pragma unroll
  for (int i = 0; i < N; i++) r[i] = a[i];
}

DEV void select8(u32* r, bool take_a, const u32* a, const u32* b) {
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = take_a ? a[i] : b[i];
}

DEV bool is_zero8(const u32* a) {
  u32 acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a[i];
  return acc == 0;
}

DEV bool eq8(const u32* a, const u32* b) {
  u32 acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a[i] ^ b[i];
  return acc == 0;
}

DEV bool lt8(const u32* a, const u32* b) {
  u32 t[8];
  return sub_w<8>(t, a, b) != 0;
}

// r = a - m if a >= m else a, for a < 2m (an m above 2^255 takes any a).
DEV void cond_sub8(u32* r, const u32* a, const u32* m) {
  u32 t[8];
  u32 borrow = sub_w<8>(t, a, m);
  select8(r, borrow != 0, a, t);
}

// (a + b) mod m for canonical a, b < m
DEV void add_mod(u32* r, const u32* a, const u32* b, const u32* m) {
  u32 t[8], s[8];
  u32 carry = add_w<8>(t, a, b);
  u32 borrow = sub_w<8>(s, t, m);
  select8(r, carry || !borrow, s, t);
}

// (a - b) mod m for canonical a, b < m
DEV void sub_mod(u32* r, const u32* a, const u32* b, const u32* m) {
  u32 t[8], s[8];
  u32 borrow = sub_w<8>(t, a, b);
  add_w<8>(s, t, m);
  select8(r, borrow != 0, s, t);
}

// A projective point (X : Y : Z), each coordinate in its field's domain.
struct Pt {
  u32 X[8], Y[8], Z[8];
};

// 4-bit window i (0 = LSB) of a little-endian word array.
DEV u32 window_at(const u32* k, int i) { return (k[i >> 3] >> ((i & 7) * 4)) & 15u; }

// 16 little-endian 16-bit limbs (the port's [B, 16] int32 layout) <-> words
DEV void load_limbs(u32* w, const int32_t* limbs) {
#pragma unroll
  for (int i = 0; i < 8; i++) w[i] = ((u32)limbs[2 * i] & 0xFFFFu) | ((u32)limbs[2 * i + 1] << 16);
}

DEV void store_limbs(int32_t* limbs, const u32* w) {
#pragma unroll
  for (int i = 0; i < 8; i++) {
    limbs[2 * i] = (int32_t)(w[i] & 0xFFFFu);
    limbs[2 * i + 1] = (int32_t)(w[i] >> 16);
  }
}

#ifdef __CUDACC__
extern "C" const char* fisco_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
#endif  // __CUDACC__

#endif  // FISCO_WIDE_INT_CUH
