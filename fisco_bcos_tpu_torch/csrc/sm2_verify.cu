// SM2 (GB/T 32918.2) signature verification, one thread per signature, for
// sm_90a.
//
// Replaces the Pallas TPU kernel `_sm2_verify_kernel`
// (fisco_bcos_tpu/ops/pallas_ec.py:163, launched from `_sm2_verify_call`)
// together with `verify_finish` (fisco_bcos_tpu/ops/sm2.py:75), which the
// TPU ran after it because Mosaic cannot slice lanes. The plain PyTorch
// version is fisco_bcos_tpu_torch/ops/sm2.py verify_core.
//
// Per lane (e, r, s, qx, qy) -> ok:
//   valid = 1 <= r, s < n and qx, qy < p and Q on y^2 = x^3 - 3x + b
//   (checked in the Montgomery domain); t = (r mod n + s) mod n != 0;
//   (X : Y : Z) = s·G + t·Q by the 64-window dual ladder (no GLV on SM2);
//   ok = valid and Z != 0 and (e mod n + x1 mod n) mod n = r, x1 = X/Z.
// The last test runs projectively, with no inversion: with k = (r - e mod n)
// mod n and x1 < p < 2n, x1 ≡ k (mod n) exactly when X = k·Z, or k + n < p
// and X = (k+n)·Z. Both forms give the same bit on every lane.
// Every lane runs the whole ladder; an invalid lane computes on garbage
// without a fault and its valid bit masks the verdict.
//
// Field: GF(p), p = 2^256 - 2^224 - 2^96 + 2^64 - 1, in the Montgomery
// domain x·R mod p (R = 2^256), word-level CIOS over 8 x 32-bit words. REDC
// of a product below p·R has one canonical result, so every value equals
// the plain version's (limb.py MontField) and the comb table is the JAX
// package's g_comb_table("sm2") word for word. Constants a, b, 3b and 1 are
// all in the Montgomery domain: a·x = -(3x) by additions, 3b·x a full
// Montgomery product.
//
// What bounds it on an H100: 32-bit integer multiply issue (IMAD, 64 per
// clock per SM, half the fp32 FMA rate); the bytes (5 x 64 B in, 1 B out a
// lane) are negligible. A Montgomery product is 64 + 64 word products, and
// a lane needs about 5.1k of them (the 14-add table ~200, the ladder
// 64 x (4 doublings + up to 2 additions) ~4.9k). chip_smoke.py counts them
// per lane from the run's own windows. This first version is plain: 128
// threads a block, the comb in shared memory, the 15-entry projective Q
// table (1,440 B a lane) in local memory; the special form of p is not used
// in the reduction yet.
//
// The arithmetic compiles as host C++ too (no __CUDACC__): only the kernel
// and its C entry point are CUDA-specific.

#include "wide_int.cuh"

#define SM2_P {0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000000u, 0xFFFFFFFFu, \
               0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFEu}
#define SM2_N {0x39D54123u, 0x53BBF409u, 0x21C6052Bu, 0x7203DF6Bu, \
               0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFEu}
// R mod p (the Montgomery one) and R^2 mod p
#define SM2_R1 {0x00000001u, 0x00000000u, 0xFFFFFFFFu, 0x00000000u, \
                0x00000000u, 0x00000000u, 0x00000000u, 0x00000001u}
#define SM2_R2 {0x00000003u, 0x00000002u, 0xFFFFFFFFu, 0x00000002u, \
                0x00000001u, 0x00000001u, 0x00000002u, 0x00000004u}
// b·R mod p and 3b·R mod p
#define SM2_B_MONT {0x2BC0DD42u, 0x90D23063u, 0xE9B537ABu, 0x71CF379Au, \
                    0x5EA51C3Cu, 0x52798150u, 0xBA20E2C8u, 0x240FE188u}
#define SM2_B3_MONT {0x834297C6u, 0xB2769129u, 0xBD1FA702u, 0x556DA6D0u, \
                     0x1BEF54B5u, 0xF76C83F1u, 0x2E62A858u, 0x6C2FA49Au}
// -p^-1 mod 2^32 (the low word of -p^-1 mod R)
#define SM2_PINV_NEG0 0x00000001u

// ---------------------------------------------------------------------------
// GF(p) in the Montgomery domain
// ---------------------------------------------------------------------------

// r = a·b·R^-1 mod p by CIOS, for a < 2^256 and b < p (so a·b < p·R and the
// result before its one conditional subtract is < 2p). r may alias a or b.
DEV void mm_mul(u32* r, const u32* a, const u32* b) {
  const u32 P[8] = SM2_P;
  u32 t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (u64)a[j] * b[i] + t[j];
      t[j] = (u32)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (u32)c;
    t[9] = (u32)(c >> 32);
    u32 m = t[0] * SM2_PINV_NEG0;
    c = ((u64)m * P[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      c += (u64)m * P[j] + t[j];
      t[j - 1] = (u32)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (u32)c;
    t[8] = t[9] + (u32)(c >> 32);
  }
  u32 s[8];
  u32 borrow = sub_w<8>(s, t, P);
  select8(r, t[8] != 0 || borrow == 0, s, t);
}

DEV void mm_add(u32* r, const u32* a, const u32* b) {
  const u32 P[8] = SM2_P;
  add_mod(r, a, b, P);
}

DEV void mm_sub(u32* r, const u32* a, const u32* b) {
  const u32 P[8] = SM2_P;
  sub_mod(r, a, b, P);
}

// a·x for SM2's a = p - 3: -(3x), the addition chain of MontField.mul_small
DEV void mm_a_mul(u32* r, const u32* x) {
  const u32 Z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  u32 t[8];
  mm_add(t, x, x);
  mm_add(t, t, x);
  mm_sub(r, Z, t);
}

DEV void mm_b3_mul(u32* r, const u32* x) {
  const u32 B3[8] = SM2_B3_MONT;
  mm_mul(r, x, B3);
}

// ---------------------------------------------------------------------------
// Complete projective group law for a = -3 (Renes–Costello–Batina 1, 2, 3)
// ---------------------------------------------------------------------------

// RCB algorithm 3; R may alias P.
DEV_NOINLINE void sm2_pt_double(Pt& R, const Pt& P) {
  u32 t0[8], t1[8], t2[8], t3[8], t2a[8], x3[8], y3[8], z3[8];
  mm_mul(t0, P.X, P.X);
  mm_mul(t1, P.Y, P.Y);
  mm_mul(t2, P.Z, P.Z);
  mm_mul(t3, P.X, P.Y);
  mm_add(t3, t3, t3);
  mm_mul(z3, P.X, P.Z);
  mm_add(z3, z3, z3);
  mm_a_mul(x3, z3);
  mm_b3_mul(y3, t2);
  mm_add(y3, x3, y3);
  mm_sub(x3, t1, y3);
  mm_add(y3, t1, y3);
  mm_mul(y3, x3, y3);
  mm_mul(x3, t3, x3);
  mm_b3_mul(z3, z3);
  mm_a_mul(t2a, t2);
  mm_sub(t3, t0, t2a);
  mm_a_mul(t3, t3);
  mm_add(t3, t3, z3);
  mm_add(z3, t0, t0);
  mm_add(t0, z3, t0);
  mm_add(t0, t0, t2a);
  mm_mul(t0, t0, t3);
  mm_add(y3, y3, t0);
  mm_mul(t2, P.Y, P.Z);
  mm_add(t2, t2, t2);
  mm_mul(t0, t2, t3);
  mm_sub(x3, x3, t0);
  mm_mul(z3, t2, t1);
  mm_add(z3, z3, z3);
  mm_add(z3, z3, z3);
  copy_w<8>(R.X, x3);
  copy_w<8>(R.Y, y3);
  copy_w<8>(R.Z, z3);
}

// RCB algorithm 1; R may alias P or Q.
DEV_NOINLINE void sm2_pt_add(Pt& R, const Pt& P, const Pt& Q) {
  u32 t0[8], t1[8], t2[8], t3[8], t4[8], t5[8], t4b[8], x3[8], y3[8], z3[8], u[8], v[8];
  mm_mul(t0, P.X, Q.X);
  mm_mul(t1, P.Y, Q.Y);
  mm_mul(t2, P.Z, Q.Z);
  mm_add(u, P.X, P.Y);
  mm_add(v, Q.X, Q.Y);
  mm_mul(t3, u, v);
  mm_add(u, t0, t1);
  mm_sub(t3, t3, u);  // X1Y2 + X2Y1
  mm_add(u, P.X, P.Z);
  mm_add(v, Q.X, Q.Z);
  mm_mul(t4, u, v);
  mm_add(u, t0, t2);
  mm_sub(t4, t4, u);  // X1Z2 + X2Z1
  mm_add(u, P.Y, P.Z);
  mm_add(v, Q.Y, Q.Z);
  mm_mul(t5, u, v);
  mm_add(u, t1, t2);
  mm_sub(t5, t5, u);  // Y1Z2 + Y2Z1
  mm_a_mul(z3, t4);
  mm_b3_mul(x3, t2);
  mm_add(z3, x3, z3);
  mm_sub(x3, t1, z3);
  mm_add(z3, t1, z3);
  mm_mul(y3, x3, z3);
  mm_add(t1, t0, t0);
  mm_add(t1, t1, t0);  // 3·X1X2
  mm_a_mul(t2, t2);
  mm_b3_mul(t4b, t4);
  mm_add(t1, t1, t2);
  mm_sub(t2, t0, t2);
  mm_a_mul(t2, t2);
  mm_add(t4b, t4b, t2);
  mm_mul(t0, t1, t4b);
  mm_add(y3, y3, t0);
  mm_mul(t0, t5, t4b);
  mm_mul(x3, t3, x3);
  mm_sub(x3, x3, t0);
  mm_mul(t0, t3, t1);
  mm_mul(z3, t5, z3);
  mm_add(z3, z3, t0);
  copy_w<8>(R.X, x3);
  copy_w<8>(R.Y, y3);
  copy_w<8>(R.Z, z3);
}

// RCB algorithm 2, affine (x2, y2) a genuine curve point; R may alias P.
DEV_NOINLINE void sm2_pt_add_mixed(Pt& R, const Pt& P, const u32* x2, const u32* y2) {
  u32 t0[8], t1[8], t2[8], t3[8], t4[8], t5[8], t4b[8], x3[8], y3[8], z3[8], u[8], v[8];
  mm_mul(t0, P.X, x2);
  mm_mul(t1, P.Y, y2);
  mm_add(u, x2, y2);
  mm_add(v, P.X, P.Y);
  mm_mul(t3, u, v);
  mm_add(u, t0, t1);
  mm_sub(t3, t3, u);  // X1Y2 + X2Y1
  mm_mul(u, x2, P.Z);
  mm_add(t4, u, P.X);  // X1 + X2Z1
  mm_mul(u, y2, P.Z);
  mm_add(t5, u, P.Y);  // Y1 + Y2Z1
  mm_a_mul(z3, t4);
  mm_b3_mul(x3, P.Z);
  mm_add(z3, x3, z3);
  mm_sub(x3, t1, z3);
  mm_add(z3, t1, z3);
  mm_mul(y3, x3, z3);
  mm_add(t1, t0, t0);
  mm_add(t1, t1, t0);  // 3·X1X2
  mm_a_mul(t2, P.Z);
  mm_b3_mul(t4b, t4);
  mm_add(t1, t1, t2);
  mm_sub(t2, t0, t2);
  mm_a_mul(t2, t2);
  mm_add(t4b, t4b, t2);
  mm_mul(t0, t1, t4b);
  mm_add(y3, y3, t0);
  mm_mul(t0, t5, t4b);
  mm_mul(x3, t3, x3);
  mm_sub(x3, x3, t0);
  mm_mul(t0, t3, t1);
  mm_mul(z3, t5, z3);
  mm_add(z3, z3, t0);
  copy_w<8>(R.X, x3);
  copy_w<8>(R.Y, y3);
  copy_w<8>(R.Z, z3);
}

// acc = k1·G + k2·Q, Q = (x, y) Montgomery-domain affine, k1, k2 plain.
// comb: [30][8] words — Montgomery x then y of c·G, c = 1..15, affine. 64
// windows MSB first of 4 doublings, a complete addition from the runtime
// c·Q table and a mixed addition from the comb; a zero window skips its
// addition. Any Q is safe: garbage in gives garbage out, never a fault.
DEV_NOINLINE void sm2_dual_mul(Pt& acc, const u32* x, const u32* y, const u32* k1,
                               const u32* k2, const u32 (*comb)[8]) {
  const u32 ONE[8] = SM2_R1;
  Pt T[15];
  copy_w<8>(T[0].X, x);
  copy_w<8>(T[0].Y, y);
  copy_w<8>(T[0].Z, ONE);
#pragma unroll 1
  for (int k = 1; k < 15; k++) sm2_pt_add(T[k], T[k - 1], T[0]);
  for (int i = 0; i < 8; i++) acc.X[i] = acc.Z[i] = 0;
  copy_w<8>(acc.Y, ONE);
#pragma unroll 1
  for (int i = 63; i >= 0; i--) {
#pragma unroll 1
    for (int d = 0; d < 4; d++) sm2_pt_double(acc, acc);
    u32 w2 = window_at(k2, i);
    if (w2) sm2_pt_add(acc, acc, T[w2 - 1]);
    u32 w1 = window_at(k1, i);
    if (w1) sm2_pt_add_mixed(acc, acc, comb[w1 - 1], comb[15 + w1 - 1]);
  }
}

// One signature: e is SM3(ZA ‖ M) read as a 256-bit integer.
DEV_NOINLINE void sm2_verify_lane(const int32_t* el, const int32_t* rl, const int32_t* sl,
                                  const int32_t* qxl, const int32_t* qyl,
                                  const u32 (*comb)[8], uint8_t* ok) {
  const u32 P[8] = SM2_P, N[8] = SM2_N, R2[8] = SM2_R2, B[8] = SM2_B_MONT;
  const u32 ONE_PLAIN[8] = {1, 0, 0, 0, 0, 0, 0, 0};
  u32 e[8], r[8], s[8], qx[8], qy[8];
  load_limbs(e, el);
  load_limbs(r, rl);
  load_limbs(s, sl);
  load_limbs(qx, qxl);
  load_limbs(qy, qyl);

  bool valid = !is_zero8(r) && lt8(r, N) && !is_zero8(s) && lt8(s, N);
  valid = valid && lt8(qx, P) && lt8(qy, P);
  // Q into the Montgomery domain (any 256-bit coordinate is safe), on curve
  u32 x[8], y[8], lhs[8], rhs[8], t[8];
  mm_mul(x, qx, R2);
  mm_mul(y, qy, R2);
  mm_mul(lhs, y, y);
  mm_mul(rhs, x, x);
  mm_mul(rhs, rhs, x);
  mm_a_mul(t, x);
  mm_add(rhs, rhs, t);
  mm_add(rhs, rhs, B);
  valid = valid && eq8(lhs, rhs);
  // t = (r mod n + s) mod n: one subtract of n from the 257-bit sum
  u32 rn[8], tk[8], tn[8];
  cond_sub8(rn, r, N);
  u32 carry = add_w<8>(tk, rn, s);
  u32 borrow = sub_w<8>(tn, tk, N);
  select8(tk, carry || !borrow, tn, tk);
  valid = valid && !is_zero8(tk);

  Pt acc;
  sm2_dual_mul(acc, x, y, s, tk, comb);

  // k = (r - e mod n) mod n; x1 ≡ k (mod n) <=> X = k·Z or X = (k+n)·Z, k+n < p
  u32 en[8], k[8], kpn[8], kn[8], xp[8];
  cond_sub8(en, e, N);
  borrow = sub_w<8>(k, r, en);
  add_w<8>(kn, k, N);
  select8(k, borrow != 0, kn, k);
  carry = add_w<8>(kpn, k, N);
  bool kpn_fits = carry == 0 && lt8(kpn, P);
  mm_mul(xp, acc.X, ONE_PLAIN);  // X out of the Montgomery domain
  mm_mul(t, k, acc.Z);           // k·Z, plain
  bool hit = eq8(xp, t);
  mm_mul(t, kpn, acc.Z);
  hit = hit || (kpn_fits && eq8(xp, t));
  *ok = valid && !is_zero8(acc.Z) && hit;
}

#ifdef __CUDACC__

#define SM2_THREADS 128

__global__ void __launch_bounds__(SM2_THREADS)
sm2_verify_kernel(const int32_t* __restrict__ e, const int32_t* __restrict__ r,
                  const int32_t* __restrict__ s, const int32_t* __restrict__ qx,
                  const int32_t* __restrict__ qy, const u32* __restrict__ comb,
                  uint8_t* __restrict__ ok, int n) {
  // every thread reads a different comb row: shared memory, not __constant__
  __shared__ u32 s_comb[30][8];
  for (int i = threadIdx.x; i < 30 * 8; i += blockDim.x) s_comb[i >> 3][i & 7] = comb[i];
  __syncthreads();
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  sm2_verify_lane(e + 16 * lane, r + 16 * lane, s + 16 * lane, qx + 16 * lane,
                  qy + 16 * lane, s_comb, ok + lane);
}

// C entry point for ctypes: launches on `stream` of `device`, does not
// synchronise; returns cudaGetLastError() (0 on success).
extern "C" int sm2_verify_launch(const void* e, const void* r, const void* s, const void* qx,
                                 const void* qy, const void* comb, void* ok, int n,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  int blocks = (n + SM2_THREADS - 1) / SM2_THREADS;
  sm2_verify_kernel<<<blocks, SM2_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)e, (const int32_t*)r, (const int32_t*)s, (const int32_t*)qx,
      (const int32_t*)qy, (const u32*)comb, (uint8_t*)ok, n);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
