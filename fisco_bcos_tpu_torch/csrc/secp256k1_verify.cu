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
// What bounds it on an H100: the bound counts 32-bit integer multiply
// issue (IMAD, 64 per clock per SM, half the fp32 FMA rate); the bytes (5 x
// 64 B in, 1 B out a lane) are negligible. A valid lane needs about 3.3k
// field products (the Fermat s^-1 ~330 mod n, the 14-add table ~160, the
// ladder 33 x (4 doublings + up to 4 additions) ~2.6k, the compare 2);
// chip_smoke.py counts them per lane from the run's own windows. Like the
// recover kernel, what one warp issues sets its time, and it takes the
// recover kernel's design through secp256k1_common.cuh: leaner field ops
// with 36-product squarings, the group law as field-op programs over
// per-lane slots in dynamic shared memory (the ladder's code inside the
// instruction cache), and 32 threads a block (320 blocks on 132 SMs,
// 67,584 + 1,920 B of shared memory a block). Its own front end, the
// per-lane s^-1 and the projective compare, is as before.
//
// The arithmetic compiles as host C++ too (no __CUDACC__): only the kernel
// and its C entry point are CUDA-specific.

#include "secp256k1_common.cuh"

// One signature. comb: [60][8] words, as glv_dual_mul reads it; `slots` is
// the lane's slot memory (SLOT_WORDS words at stride `stride`).
DEV void verify_lane(const int32_t* zl, const int32_t* rl, const int32_t* sl,
                     const int32_t* qxl, const int32_t* qyl, const u32 (*comb)[8], u32* slots,
                     int stride, uint8_t* ok) {
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
  f_pow<true, EXP_N_INV_ID>(sinv, sn, slots, stride);
  fn_mul(u1, zn, sinv);
  fn_mul(u2, rn, sinv);
  Pt acc;
  glv_dual_mul(acc, qx, qy, u1, u2, comb, slots, stride);

  // x(R) ≡ r (mod n) with x(R) < p < 2n: X = r·Z, or X = (r+n)·Z if r+n < p
  u32 rz[8], rpnz[8], rpn[8];
  u32 carry = add_w<8>(rpn, r, N);
  bool rpn_fits = carry == 0 && lt8(rpn, P);
  fp_mul(rz, r, acc.Z);
  fp_mul(rpnz, rpn, acc.Z);
  bool hit = eq8(acc.X, rz) || (rpn_fits && eq8(acc.X, rpnz));
  *ok = valid && !is_zero8(acc.Z) && hit;
}

#ifdef __CUDACC__

// One warp a block: 10,240 lanes make 320 blocks, which reach all 132 SMs.
#define VERIFY_THREADS 32
#define VERIFY_SMEM_BYTES (SLOT_WORDS * 4 * VERIFY_THREADS)

__global__ void __launch_bounds__(VERIFY_THREADS, 1)
secp256k1_verify_kernel(const int32_t* __restrict__ z, const int32_t* __restrict__ r,
                        const int32_t* __restrict__ s, const int32_t* __restrict__ qx,
                        const int32_t* __restrict__ qy, const u32* __restrict__ comb,
                        uint8_t* __restrict__ ok, int n) {
  // every thread reads a different comb row: shared memory, not __constant__
  __shared__ u32 s_comb[60][8];
  extern __shared__ uint4 s_slots[];  // the lanes' slots, lane-minor quads
  for (int i = threadIdx.x; i < 60 * 8; i += blockDim.x) s_comb[i >> 3][i & 7] = comb[i];
  __syncthreads();
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  verify_lane(z + 16 * lane, r + 16 * lane, s + 16 * lane, qx + 16 * lane, qy + 16 * lane,
              s_comb, reinterpret_cast<u32*>(s_slots + threadIdx.x), VERIFY_THREADS, ok + lane);
}

// Launch geometry for n lanes: threads a block, blocks, dynamic shared bytes.
extern "C" void secp256k1_verify_geometry(int n, int* out) {
  out[0] = VERIFY_THREADS;
  out[1] = (n + VERIFY_THREADS - 1) / VERIFY_THREADS;
  out[2] = VERIFY_SMEM_BYTES;
}

// C entry point for ctypes: launches on `stream` of `device`, does not
// synchronise; returns the first CUDA error (0 on success).
extern "C" int secp256k1_verify_launch(const void* z, const void* r, const void* s,
                                       const void* qx, const void* qy, const void* comb,
                                       void* ok, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  err = cudaFuncSetAttribute(secp256k1_verify_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, VERIFY_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(secp256k1_verify_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  int geo[3];
  secp256k1_verify_geometry(n, geo);
  secp256k1_verify_kernel<<<geo[1], geo[0], geo[2], (cudaStream_t)stream>>>(
      (const int32_t*)z, (const int32_t*)r, (const int32_t*)s, (const int32_t*)qx,
      (const int32_t*)qy, (const u32*)comb, (uint8_t*)ok, n);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
