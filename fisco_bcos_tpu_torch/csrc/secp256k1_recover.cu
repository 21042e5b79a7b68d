// secp256k1 ECDSA public-key recovery, one thread per signature, for sm_90a.
//
// Replaces the Pallas TPU kernel `_recover_kernel`
// (fisco_bcos_tpu/ops/pallas_ec.py:63, launched from `_recover_call`) together
// with the two steps the TPU ran outside it because Mosaic cannot slice
// lanes: `inv_mod_n(r)` before the kernel and `recover_finish` (batched
// Z^-1, affine conversion, not-ok lanes zeroed) after it. Here both
// inversions run per lane by Fermat inside the kernel; the inverse is unique,
// so the output equals the plain PyTorch version
// (fisco_bcos_tpu_torch/ops/secp256k1.py recover_core) byte for byte.
//
// Per lane (z, r, s, v) -> (qx, qy, ok):
//   v in {0..3, 27, 28} (29 and 30 do NOT alias to 2 and 3); 1 <= r, s < n;
//   x = r + (v&2 ? n : 0) with no carry past 2^256 and x < p;
//   y = (x^3+7)^((p+1)/4) must square back to x^3+7; flip y to the parity v&1;
//   u1 = -(z mod n)·r^-1, u2 = s·r^-1 (mod n); GLV split u2 = ±ka ± kb·λ;
//   Q = u1·G + u2·R by a 33-window 4-bit ladder over the runtime 15-entry
//   R / λR table and the G / 2^128·G affine combs (shared memory);
//   ok = valid and Z != 0; a not-ok lane writes qx = qy = 0.
// Field elements are 8 little-endian 32-bit words; mod p is reduced with the
// 2^256 = 0x1000003D1 fold, mod n with the ~2^129 complement fold.
//
// What bounds it on an H100: 32-bit integer multiply issue (IMAD, 64 per
// clock per SM, half the fp32 FMA rate). One field multiplication mod p is
// 73 32x32->64 products; a valid lane needs about 3.6k of them (sqrt and the
// two Fermat inversions ~330 each, the 14-add table and 15 β products ~200,
// the ladder 33 x (4 doublings + up to 4 additions) ~2.6k). The script
// chip_smoke.py recounts the multiplies per lane from the run's own windows.
// This first version is plain: at 10,240 lanes and 128 threads a block it
// fills 80 blocks, fewer than the card's 132 SMs, and the 15-entry tables
// live in local memory. Occupancy, a block-level batched inversion and
// register pressure are later work.
//
// The field ops, the group law, the GLV split and the ladder live in
// secp256k1_common.cuh, shared with the verify kernel. The arithmetic
// compiles as host C++ too (no __CUDACC__): only the kernel and its C entry
// point are CUDA-specific.

#include "secp256k1_common.cuh"

DEV void store_not_ok(int32_t* qx, int32_t* qy, uint8_t* ok) {
#pragma unroll
  for (int i = 0; i < 16; i++) qx[i] = qy[i] = 0;
  *ok = 0;
}

// One signature. comb: [60][8] words — x then y of c·G (rows 0..29) and of
// c·2^128·G (rows 30..59), c = 1..15, affine.
DEV_NOINLINE void recover_lane(const int32_t* zl, const int32_t* rl, const int32_t* sl,
                               int32_t v, const u32 (*comb)[8], int32_t* qx,
                               int32_t* qy, uint8_t* ok) {
  const u32 P[8] = SECP_P, N[8] = SECP_N;
  const u32 SEVEN[8] = {7, 0, 0, 0, 0, 0, 0, 0};
  const u32 ZERO[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  u32 z[8], r[8], s[8];
  load_limbs(z, zl);
  load_limbs(r, rl);
  load_limbs(s, sl);

  bool valid = (v >= 0 && v <= 3) || (v >= 27 && v <= 28);
  if (v >= 27) v -= 27;
  valid = valid && !is_zero8(r) && lt8(r, N) && !is_zero8(s) && lt8(s, N);
  u32 x[8], addend[8];
  select8(addend, (v & 2) != 0, N, ZERO);
  u32 carry = add_w<8>(x, r, addend);
  valid = valid && carry == 0 && lt8(x, P);
  if (!valid) {
    store_not_ok(qx, qy, ok);
    return;
  }
  // y^2 = x^3 + 7 must be a residue; p ≡ 3 (mod 4)
  u32 y2[8], y[8], t[8];
  fp_sqr(t, x);
  fp_mul(t, t, x);
  fp_add(y2, t, SEVEN);
  f_pow<false, EXP_P_SQRT_ID>(y, y2);
  fp_sqr(t, y);
  if (!eq8(t, y2)) {
    store_not_ok(qx, qy, ok);
    return;
  }
  if ((y[0] & 1u) != ((u32)v & 1u)) fp_neg(y, y);

  // u1 = -(z mod n)·r^-1, u2 = s·r^-1
  u32 zn[8], rinv[8], u1[8], u2[8];
  copy_w<8>(zn, z);
  fn_cond_sub(zn);
  f_pow<true, EXP_N_INV_ID>(rinv, r);
  fn_mul(u1, zn, rinv);
  fn_neg(u1, u1);
  fn_mul(u2, s, rinv);
  Pt acc;
  glv_dual_mul(acc, x, y, u1, u2, comb);

  if (is_zero8(acc.Z)) {
    store_not_ok(qx, qy, ok);
    return;
  }
  u32 zinv[8], ax[8], ay[8];
  f_pow<false, EXP_P_INV_ID>(zinv, acc.Z);
  fp_mul(ax, acc.X, zinv);
  fp_mul(ay, acc.Y, zinv);
  store_limbs(qx, ax);
  store_limbs(qy, ay);
  *ok = 1;
}

#ifdef __CUDACC__

#define RECOVER_THREADS 128

__global__ void __launch_bounds__(RECOVER_THREADS)
secp256k1_recover_kernel(const int32_t* __restrict__ z, const int32_t* __restrict__ r,
                         const int32_t* __restrict__ s, const int32_t* __restrict__ v,
                         const u32* __restrict__ comb, int32_t* __restrict__ qx,
                         int32_t* __restrict__ qy, uint8_t* __restrict__ ok, int n) {
  // every thread reads a different comb row: shared memory, not __constant__
  __shared__ u32 s_comb[60][8];
  for (int i = threadIdx.x; i < 60 * 8; i += blockDim.x) s_comb[i >> 3][i & 7] = comb[i];
  __syncthreads();
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  recover_lane(z + 16 * lane, r + 16 * lane, s + 16 * lane, v[lane], s_comb,
               qx + 16 * lane, qy + 16 * lane, ok + lane);
}

// C entry point for ctypes: launches on `stream` of `device`, does not
// synchronise; returns cudaGetLastError() (0 on success).
extern "C" int secp256k1_recover_launch(const void* z, const void* r, const void* s,
                                        const void* v, const void* comb, void* qx,
                                        void* qy, void* ok, int n, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  int blocks = (n + RECOVER_THREADS - 1) / RECOVER_THREADS;
  secp256k1_recover_kernel<<<blocks, RECOVER_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)z, (const int32_t*)r, (const int32_t*)s, (const int32_t*)v,
      (const u32*)comb, (int32_t*)qx, (int32_t*)qy, (uint8_t*)ok, n);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
