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
// What bounds it on an H100: the bound counts 32-bit integer multiply
// issue (IMAD, 64 per clock per SM, half the fp32 FMA rate). A valid lane
// needs about 3.6k field products (sqrt and the two Fermat inversions ~330
// each, the 14-add table ~160, the ladder 33 x (4 doublings + up to 4
// additions) ~2.6k); chip_smoke.py recounts the multiplies per lane from
// the run's own windows. With one thread a signature, 10,240 lanes make
// 320 warps for the card's 528 schedulers, so what one warp issues sets
// the time: measured, a warp pays for every integer instruction it
// issues, and over twice as much once its loop body outgrows the
// instruction cache (wide_int.cuh; PERF.md §6), as the previous version's
// ladder, with every product inlined into its group-law functions, did.
// The design here (secp256k1_common.cuh, wide_int.cuh):
//   - fewer instructions per field op: the product's rows with a 64-bit
//     carry, a 36-product squaring (the square root, the Fermat chains and
//     the doublings square ~1,000 times a lane), add/sub chains with the
//     carry in a predicate;
//   - the group law (RCB algorithms 7, 8, 9) as constant programs of field
//     ops over per-lane slots in shared memory, run by one loop holding one
//     copy of each op, so a ladder window's code stays inside the cache;
//     the λ view βX of a table entry is one more op, when kb needs it;
//   - the slots (the point, its addend, β, 14 temporaries and the c·Q table,
//     which the Fermat chains reuse for their 15 powers: 2,112 B a lane) in
//     dynamic shared memory, lane-minor 16-byte quads; 32 threads a block
//     make 320 blocks on 132 SMs (67,584 + 1,920 B of shared memory a
//     block, three a SM).
// The scalars' windows come from shift registers, so no array is indexed
// at run time and the kernel needs no stack.
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
// c·2^128·G (rows 30..59), c = 1..15, affine. `slots` is the lane's slot
// memory (SLOT_WORDS words at stride `stride`, wide_int.cuh).
DEV void recover_lane(const int32_t* zl, const int32_t* rl, const int32_t* sl, int32_t v,
                      const u32 (*comb)[8], u32* slots, int stride, int32_t* qx, int32_t* qy,
                      uint8_t* ok) {
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
  f_pow<false, EXP_P_SQRT_ID>(y, y2, slots, stride);
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
  f_pow<true, EXP_N_INV_ID>(rinv, r, slots, stride);
  fn_mul(u1, zn, rinv);
  fn_neg(u1, u1);
  fn_mul(u2, s, rinv);
  Pt acc;
  glv_dual_mul(acc, x, y, u1, u2, comb, slots, stride);

  if (is_zero8(acc.Z)) {
    store_not_ok(qx, qy, ok);
    return;
  }
  u32 zinv[8], ax[8], ay[8];
  f_pow<false, EXP_P_INV_ID>(zinv, acc.Z, slots, stride);
  fp_mul(ax, acc.X, zinv);
  fp_mul(ay, acc.Y, zinv);
  store_limbs(qx, ax);
  store_limbs(qy, ay);
  *ok = 1;
}

#ifdef __CUDACC__

// One warp a block: 10,240 lanes make 320 blocks, which reach all 132 SMs.
#define RECOVER_THREADS 32
#define RECOVER_SMEM_BYTES (SLOT_WORDS * 4 * RECOVER_THREADS)

__global__ void __launch_bounds__(RECOVER_THREADS, 1)
secp256k1_recover_kernel(const int32_t* __restrict__ z, const int32_t* __restrict__ r,
                         const int32_t* __restrict__ s, const int32_t* __restrict__ v,
                         const u32* __restrict__ comb, int32_t* __restrict__ qx,
                         int32_t* __restrict__ qy, uint8_t* __restrict__ ok, int n) {
  // every thread reads a different comb row: shared memory, not __constant__
  __shared__ u32 s_comb[60][8];
  extern __shared__ uint4 s_slots[];  // the lanes' slots, lane-minor quads
  for (int i = threadIdx.x; i < 60 * 8; i += blockDim.x) s_comb[i >> 3][i & 7] = comb[i];
  __syncthreads();
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  recover_lane(z + 16 * lane, r + 16 * lane, s + 16 * lane, v[lane], s_comb,
               reinterpret_cast<u32*>(s_slots + threadIdx.x), RECOVER_THREADS, qx + 16 * lane, qy + 16 * lane, ok + lane);
}

// Launch geometry for n lanes: threads a block, blocks, dynamic shared bytes.
extern "C" void secp256k1_recover_geometry(int n, int* out) {
  out[0] = RECOVER_THREADS;
  out[1] = (n + RECOVER_THREADS - 1) / RECOVER_THREADS;
  out[2] = RECOVER_SMEM_BYTES;
}

// C entry point for ctypes: launches on `stream` of `device`, does not
// synchronise; returns the first CUDA error (0 on success).
extern "C" int secp256k1_recover_launch(const void* z, const void* r, const void* s,
                                        const void* v, const void* comb, void* qx,
                                        void* qy, void* ok, int n, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  err = cudaFuncSetAttribute(secp256k1_recover_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, RECOVER_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(secp256k1_recover_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  int geo[3];
  secp256k1_recover_geometry(n, geo);
  secp256k1_recover_kernel<<<geo[1], geo[0], geo[2], (cudaStream_t)stream>>>(
      (const int32_t*)z, (const int32_t*)r, (const int32_t*)s, (const int32_t*)v,
      (const u32*)comb, (int32_t*)qx, (int32_t*)qy, (uint8_t*)ok, n);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
