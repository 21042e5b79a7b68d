// secp256k1 ECDSA signature verification, one thread per signature, for
// sm_90a.
//
// Replaces the Pallas TPU kernel `_verify_kernel`
// (fisco_bcos_tpu/ops/pallas_ec.py:78, launched from `_verify_call`)
// together with the step the TPU ran outside it because Mosaic cannot slice
// lanes: `inv_mod_n(s)` before the kernel. Here each lane inverts s by
// Fermat; the inverse is unique, so the verdict equals the plain PyTorch
// version (fisco_bcos_tpu_torch/ops/secp256k1.py verify_core) on every lane.
//
// Per lane (z, r, s, qx, qy) -> ok, exactly as verify_core:
//   valid = 1 <= r, s < n and qx, qy < p and qy^2 = qx^3 + 7;
//   u1 = (z mod n)·s^-1, u2 = (r mod n)·s^-1 (s^-1 of s mod n; z = 0 or n
//   leaves every G window empty, z > n is reduced once first);
//   R = u1·G + u2·Q by the GLV ladder of secp256k1_common.cuh;
//   ok = valid and Z != 0 and (X = r·Z or (r + n < p and X = (r+n)·Z)),
//   the projective form of x(R) ≡ r (mod n): no inversion of Z.
// Every lane runs the whole ladder: an invalid lane (a Q off the curve or
// with a coordinate >= p, s = 0, ...) computes on garbage without a fault
// and its valid bit masks the verdict, as in verify_core.
//
// What bounds it on an H100: 32-bit integer multiply issue (IMAD, 64 per
// clock per SM, half the fp32 FMA rate); the bytes (5 x 64 B in, 1 B out a
// lane) are negligible. A valid lane needs about 3.3k field multiplications
// (the Fermat s^-1 ~330 mod n, the 14-add table and 15 β products ~200, the
// ladder 33 x (4 doublings + up to 4 additions) ~2.6k, the compare 2).
// chip_smoke.py counts them per lane from the run's own windows. Like the
// recover kernel this first version is plain: 128 threads a block, the
// combs in shared memory, the 15-entry tables in local memory. Occupancy,
// a batched inversion and register pressure are later work.
//
// The arithmetic compiles as host C++ too (no __CUDACC__): only the kernel
// and its C entry point are CUDA-specific.

#include "secp256k1_common.cuh"

// One signature. comb: [60][8] words, as glv_dual_mul reads it.
DEV_NOINLINE void verify_lane(const int32_t* zl, const int32_t* rl, const int32_t* sl,
                              const int32_t* qxl, const int32_t* qyl,
                              const u32 (*comb)[8], uint8_t* ok) {
  const u32 P[8] = SECP_P, N[8] = SECP_N;
  const u32 SEVEN[8] = {7, 0, 0, 0, 0, 0, 0, 0};
  u32 z[8], r[8], s[8], qx[8], qy[8];
  load_limbs(z, zl);
  load_limbs(r, rl);
  load_limbs(s, sl);
  load_limbs(qx, qxl);
  load_limbs(qy, qyl);

  bool valid = !is_zero8(r) && lt8(r, N) && !is_zero8(s) && lt8(s, N);
  valid = valid && lt8(qx, P) && lt8(qy, P);
  u32 lhs[8], rhs[8];
  fp_sqr(lhs, qy);
  fp_sqr(rhs, qx);
  fp_mul(rhs, rhs, qx);
  fp_add(rhs, rhs, SEVEN);
  valid = valid && eq8(lhs, rhs);

  // u1 = (z mod n)·s^-1, u2 = (r mod n)·s^-1
  u32 zn[8], rn[8], sn[8], sinv[8], u1[8], u2[8];
  cond_sub8(zn, z, N);
  cond_sub8(rn, r, N);
  cond_sub8(sn, s, N);
  f_pow<true, EXP_N_INV_ID>(sinv, sn);
  fn_mul(u1, zn, sinv);
  fn_mul(u2, rn, sinv);
  Pt acc;
  glv_dual_mul(acc, qx, qy, u1, u2, comb);

  // x(R) ≡ r (mod n) with x(R) < p < 2n: X = r·Z, or X = (r+n)·Z if r+n < p
  u32 t[8], rpn[8];
  fp_mul(t, r, acc.Z);
  bool hit = eq8(acc.X, t);
  u32 carry = add_w<8>(rpn, r, N);
  bool rpn_fits = carry == 0 && lt8(rpn, P);
  fp_mul(t, rpn, acc.Z);
  hit = hit || (rpn_fits && eq8(acc.X, t));
  *ok = valid && !is_zero8(acc.Z) && hit;
}

#ifdef __CUDACC__

#define VERIFY_THREADS 128

__global__ void __launch_bounds__(VERIFY_THREADS)
secp256k1_verify_kernel(const int32_t* __restrict__ z, const int32_t* __restrict__ r,
                        const int32_t* __restrict__ s, const int32_t* __restrict__ qx,
                        const int32_t* __restrict__ qy, const u32* __restrict__ comb,
                        uint8_t* __restrict__ ok, int n) {
  // every thread reads a different comb row: shared memory, not __constant__
  __shared__ u32 s_comb[60][8];
  for (int i = threadIdx.x; i < 60 * 8; i += blockDim.x) s_comb[i >> 3][i & 7] = comb[i];
  __syncthreads();
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  verify_lane(z + 16 * lane, r + 16 * lane, s + 16 * lane, qx + 16 * lane, qy + 16 * lane,
              s_comb, ok + lane);
}

// C entry point for ctypes: launches on `stream` of `device`, does not
// synchronise; returns cudaGetLastError() (0 on success).
extern "C" int secp256k1_verify_launch(const void* z, const void* r, const void* s,
                                       const void* qx, const void* qy, const void* comb,
                                       void* ok, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  int blocks = (n + VERIFY_THREADS - 1) / VERIFY_THREADS;
  secp256k1_verify_kernel<<<blocks, VERIFY_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)z, (const int32_t*)r, (const int32_t*)s, (const int32_t*)qx,
      (const int32_t*)qy, (const u32*)comb, (uint8_t*)ok, n);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
