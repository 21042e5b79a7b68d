// secp256k1 ECDSA signature verification, one thread per signature, for
// sm_90a.
//
// Replaces the Pallas TPU kernel `_verify_kernel`
// (fisco_bcos_tpu/ops/pallas_ec.py:78, launched from `_verify_call`)
// together with the step the TPU ran outside it because Mosaic cannot slice
// lanes: `inv_mod_n(s)` before the kernel. Here each lane inverts s itself;
// the inverse is unique, so the verdict equals the plain PyTorch version
// (fisco_bcos_tpu_torch/ops/secp256k1.py verify_core) on every lane.
//
// Per lane, one 160-byte row z ‖ r ‖ s ‖ qx ‖ qy (big-endian, as on the
// wire) -> ok, exactly as verify_core:
//   valid = 1 <= r, s < n and qx, qy < p and qy^2 = qx^3 + 7;
//   u1 = (z mod n)·s^-1, u2 = (r mod n)·s^-1 (s^-1 of s mod n; z = 0 or n
//   leaves every G window empty, z > n is reduced once first);
//   R = u1·G + u2·Q by a GLV ladder of 27 signed 5-bit windows;
//   ok = valid and Z != 0 and (X = r·Z or (r + n < p and X = (r+n)·Z)),
//   the projective form of x(R) ≡ r (mod n): no inversion of Z.
// Every lane runs the whole ladder: an invalid lane (a Q off the curve or
// with a coordinate >= p, s = 0, ...) computes on garbage without a fault
// and its valid bit masks the verdict, as in verify_core.
//
// What bounds it on an H100: the bound counts 32-bit integer multiply
// issue (IMAD, 64 per clock per SM, half the fp32 FMA rate); the bytes (160
// B in, 1 B out a lane) are negligible. What one warp issues sets the time
// (10,240 lanes are 320 warps for 528 schedulers), so the design cuts what
// a lane issues and keeps the shared layer (secp256k1_common.cuh: field
// ops, the group law as field-op programs over per-lane slots in dynamic
// shared memory, 32 threads a block) as it is:
// - s^-1 by safegcd divsteps (secp256k1_modinv.cuh): 42 k cycles a warp on
//   an H100 where the Fermat chain mod n took 390 k (chip_smoke.py's field
//   bench);
// - 27 windows of 5 doublings with signed digits in [-15, 16] instead of
//   33 windows of 4: a warp adds whenever any of its lanes' digits is
//   nonzero, so fewer windows are fewer additions; 16 table entries of c·Q
//   (48 slots of verify's own, 2,208 B a lane) and a 64-row G comb;
// - the inputs as one byte row a lane, read in 16-byte quads.
//
// The arithmetic compiles as host C++ too (no __CUDACC__): only the kernel
// and its C entry point are CUDA-specific.

#include "secp256k1_common.cuh"
#include "secp256k1_modinv.cuh"

// Verify's slots: the shared layout up to S_TAB, then 16 table entries of
// three slots (X, Y, Z). Recover and SM2 keep S_COUNT.
#define VERIFY_TAB 16
#define VERIFY_SLOTS (S_TAB + 3 * VERIFY_TAB)
#define VERIFY_SLOT_WORDS (VERIFY_SLOTS * 8)
// comb rows: x of c·G, y of c·G, x of c·2^128·G, y of c·2^128·G, c = 1..16
#define VERIFY_COMB_ROWS (4 * VERIFY_TAB)
#define VERIFY_WINDOWS 27
#define VERIFY_ROW_BYTES 160

// Signed 5-bit digits d_i in [-15, 16] with sum d_i·32^i = k, read MSB
// first: K = k + Y, Y = 15·(32^27 - 1)/31 (01111 in every window), and
// d_i = window i of K less 15. The add's carries are the recoding's carries
// (window i carries out iff its bits plus the carry in exceed 16).
// 5-word shift register as win_init: K << 25, so the next window is always
// the top five bits. k < 2^130 (the GLV halves, u1's 128-bit halves).
DEV void win5_init(u32* w, const u32* k) {
  const u32 Y[5] = {0xDEF7BDEFu, 0xF7BDEF7Bu, 0xBDEF7BDEu, 0xEF7BDEF7u, 0x3Du};
  u32 s[5];
  add_w<5>(s, k, Y);
#pragma unroll
  for (int i = 4; i >= 0; i--) w[i] = s[i] << 25 | (i > 0 ? s[i - 1] >> 7 : 0u);
}

// the next digit, MSB first
DEV int win5_next(u32* w) {
  u32 top = w[4] >> 27;
#pragma unroll
  for (int i = 4; i > 0; i--) w[i] = w[i] << 5 | w[i - 1] >> 27;
  w[0] <<= 5;
  return (int)top - 15;
}

// acc = u1·G + u2·Q for affine Q = (qx, qy) and scalars u1, u2 < n. comb:
// VERIFY_COMB_ROWS x 8 words, affine. The runtime table c·Q, c = 1..16,
// goes to the slots from S_TAB on; each entry is the one before plus the
// affine Q (a mixed addition). u2 is split by GLV; the ladder runs 27
// windows MSB first of 5 doublings (none in the first, where the
// accumulator is still the identity), then up to two complete additions from
// the table ((X : ±Y : Z) for ka, (βX : ±Y : Z) for kb; the digit's sign
// XORs into the split's) and two mixed additions from the combs (u1's low
// and high 128 bits, y negated for a negative digit). A lane whose digit
// is 0 skips that addition. Any Q is safe: an off-curve or out-of-range Q
// gives garbage, never a fault.
DEV void glv_dual_mul5(Pt& acc, const u32* qx, const u32* qy, const u32* u1, const u32* u2,
                       const u32 (*comb)[8], u32* sl, int stride) {
  const u32 BETA[8] = SECP_BETA;
  const u32 ONE[8] = {1, 0, 0, 0, 0, 0, 0, 0};
  const u32 ZERO[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  u32 ka[8], kb[8];
  bool sa, sb;
  glv_split(u2, ka, sa, kb, sb);

  slot_put(sl, stride, S_K, BETA);
  slot_put(sl, stride, S_QX, qx);
  slot_put(sl, stride, S_QY, qy);
  slot_put(sl, stride, S_X, qx);
  slot_put(sl, stride, S_Y, qy);
  slot_put(sl, stride, S_Z, ONE);
#pragma unroll 1
  for (int k = 0; k < VERIFY_TAB; k++) {
    if (k) fop_run<SecpField>(SECP_MADD, FOP_LEN(SECP_MADD), sl, stride);
    slot_copy(sl, stride, S_TAB + 3 * k, S_X);
    slot_copy(sl, stride, S_TAB + 3 * k + 1, S_Y);
    slot_copy(sl, stride, S_TAB + 3 * k + 2, S_Z);
  }
  slot_put(sl, stride, S_X, ZERO);
  slot_put(sl, stride, S_Y, ONE);
  slot_put(sl, stride, S_Z, ZERO);

  u32 wa[5], wb[5], wl[5], wh[5];
  win5_init(wa, ka);
  win5_init(wb, kb);
  const u32 u1lo[5] = {u1[0], u1[1], u1[2], u1[3], 0};
  const u32 u1hi[5] = {u1[4], u1[5], u1[6], u1[7], 0};
  win5_init(wl, u1lo);
  win5_init(wh, u1hi);
#pragma unroll 1
  for (int i = VERIFY_WINDOWS - 1; i >= 0; i--) {
    // the first window's doublings would double the identity: skipped
#pragma unroll 1
    for (int d = i < VERIFY_WINDOWS - 1 ? 0 : 5; d < 5; d++)
      fop_run<SecpField>(SECP_DBL, FOP_LEN(SECP_DBL), sl, stride);
    int da = win5_next(wa), db = win5_next(wb);
    int dl = win5_next(wl), dh = win5_next(wh);
#pragma unroll 1
    for (int j = 0; j < 2; j++) {  // ka from (X : Y : Z), then kb from (βX : Y : Z)
      int d = j ? db : da;
      if (d) {
        int e = S_TAB + 3 * ((d < 0 ? -d : d) - 1);
        u32 y[8];
        slot_copy(sl, stride, S_QX, e);
        slot_get(y, sl, stride, e + 1);
        if ((j ? sb : sa) != (d < 0)) fp_neg(y, y);
        slot_put(sl, stride, S_QY, y);
        slot_copy(sl, stride, S_QZ, e + 2);
        if (j) fop_run<SecpField>(SECP_BETA_QX, FOP_LEN(SECP_BETA_QX), sl, stride);
        fop_run<SecpField>(SECP_ADD, FOP_LEN(SECP_ADD), sl, stride);
      }
    }
#pragma unroll 1
    for (int j = 0; j < 2; j++) {  // u1's low half from G, its high half from 2^128·G
      int d = j ? dh : dl;
      if (d) {
        int c = (d < 0 ? -d : d) - 1;
        u32 y[8];
        copy_w<8>(y, comb[2 * VERIFY_TAB * j + VERIFY_TAB + c]);
        if (d < 0) fp_neg(y, y);
        slot_put(sl, stride, S_QX, comb[2 * VERIFY_TAB * j + c]);
        slot_put(sl, stride, S_QY, y);
        fop_run<SecpField>(SECP_MADD, FOP_LEN(SECP_MADD), sl, stride);
      }
    }
  }
  slot_get(acc.X, sl, stride, S_X);
  slot_get(acc.Y, sl, stride, S_Y);
  slot_get(acc.Z, sl, stride, S_Z);
}

// 32 big-endian bytes -> 8 little-endian words. On the card two 16-byte
// loads and byte swaps (the row is 16-byte aligned: the wrapper checks).
DEV void load_be_words(u32* w, const uint8_t* be) {
#if FISCO_PTX
  const uint4* q = reinterpret_cast<const uint4*>(be);
  uint4 hi = q[0], lo = q[1];
  const u32 v[8] = {lo.w, lo.z, lo.y, lo.x, hi.w, hi.z, hi.y, hi.x};
#pragma unroll
  for (int i = 0; i < 8; i++) w[i] = __byte_perm(v[i], 0, 0x0123);
#else
  for (int i = 0; i < 8; i++) {
    const uint8_t* b = be + 4 * (7 - i);
    w[i] = (u32)b[0] << 24 | (u32)b[1] << 16 | (u32)b[2] << 8 | b[3];
  }
#endif
}

// One signature from its 160-byte row. comb: VERIFY_COMB_ROWS x 8 words;
// `slots` is the lane's slot memory (VERIFY_SLOT_WORDS words at stride
// `stride`).
DEV void verify_lane(const uint8_t* row, const u32 (*comb)[8], u32* slots, int stride,
                     uint8_t* ok) {
  const u32 P[8] = SECP_P, N[8] = SECP_N;
  const u32 SEVEN[8] = {7, 0, 0, 0, 0, 0, 0, 0};
  u32 z[8], r[8], s[8], qx[8], qy[8];
  load_be_words(z, row);
  load_be_words(r, row + 32);
  load_be_words(s, row + 64);
  load_be_words(qx, row + 96);
  load_be_words(qy, row + 128);

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
  fn_inv_divstep(sinv, sn);
  fn_mul(u1, zn, sinv);
  fn_mul(u2, rn, sinv);
  Pt acc;
  glv_dual_mul5(acc, qx, qy, u1, u2, comb, slots, stride);

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

// One warp a block: 10,240 lanes make 320 blocks, which reach all 132 SMs;
// 70,656 + 2,048 B of shared memory a block, three blocks a SM.
#define VERIFY_THREADS 32
#define VERIFY_SMEM_BYTES (VERIFY_SLOT_WORDS * 4 * VERIFY_THREADS)

__global__ void __launch_bounds__(VERIFY_THREADS, 1)
secp256k1_verify_kernel(const uint8_t* __restrict__ rows, const u32* __restrict__ comb,
                        uint8_t* __restrict__ ok, int n) {
  // every thread reads a different comb row: shared memory, not __constant__
  __shared__ u32 s_comb[VERIFY_COMB_ROWS][8];
  extern __shared__ uint4 s_slots[];  // the lanes' slots, lane-minor quads
  for (int i = threadIdx.x; i < VERIFY_COMB_ROWS * 8; i += blockDim.x) s_comb[i >> 3][i & 7] = comb[i];
  __syncthreads();
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  verify_lane(rows + (size_t)VERIFY_ROW_BYTES * lane, s_comb,
              reinterpret_cast<u32*>(s_slots + threadIdx.x), VERIFY_THREADS, ok + lane);
}

// Launch geometry for n lanes: threads a block, blocks, dynamic shared bytes.
extern "C" void secp256k1_verify_geometry(int n, int* out) {
  out[0] = VERIFY_THREADS;
  out[1] = (n + VERIFY_THREADS - 1) / VERIFY_THREADS;
  out[2] = VERIFY_SMEM_BYTES;
}

// C entry point for ctypes: launches on `stream` of `device`, does not
// synchronise; returns the first CUDA error (0 on success).
extern "C" int secp256k1_verify_launch(const void* rows, const void* comb, void* ok, int n,
                                       int device, void* stream) {
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
      (const uint8_t*)rows, (const u32*)comb, (uint8_t*)ok, n);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
