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
// The arithmetic compiles as host C++ too (no __CUDACC__): only the kernel
// and its C entry point are CUDA-specific.

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

// Fermat / square-root exponents, little-endian words (uniform reads).
CONSTMEM u32 EXP_P_INV[8] = {0xFFFFFC2Du, 0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                             0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};
CONSTMEM u32 EXP_P_SQRT[8] = {0xBFFFFF0Cu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                              0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x3FFFFFFFu};
CONSTMEM u32 EXP_N_INV[8] = {0xD036413Fu, 0xBFD25E8Cu, 0xAF48A03Bu, 0xBAAEDCE6u,
                             0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};

#define SECP_P {0xFFFFFC2Fu, 0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu, \
                0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu}
#define SECP_N {0xD0364141u, 0xBFD25E8Cu, 0xAF48A03Bu, 0xBAAEDCE6u, \
                0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu}
// 2^256 - n
#define SECP_CN {0x2FC9BEBFu, 0x402DA173u, 0x50B75FC4u, 0x45512319u, 0x00000001u}
// β with φ(x, y) = (βx, y) = λ·(x, y)
#define SECP_BETA {0x719501EEu, 0xC1396C28u, 0x12F58995u, 0x9CF04975u, \
                   0xAC3434E9u, 0x6E64479Eu, 0x657C0710u, 0x7AE96A2Bu}
// GLV: g1 = floor(b2·2^448/n), g2 = floor(-b1·2^448/n); basis a1, |b1|, a2, b2
#define GLV_G1 {0xCA9C9971u, 0xEA815BD6u, 0x45DBB030u, 0xE893209Au, 0x71E8CA7Fu, \
                0x3DAA8A14u, 0x9284EB15u, 0xE86C90E4u, 0xA7D46BCDu, 0x3086D221u}
#define GLV_G2 {0xB37D7630u, 0x46683369u, 0x8AC47F71u, 0x1571B4AEu, 0x9DF506C6u, \
                0x221208ACu, 0x0ABFE4C4u, 0x6F547FA9u, 0x010E8828u, 0xE4437ED6u}
#define GLV_A1 {0x9284EB15u, 0xE86C90E4u, 0xA7D46BCDu, 0x3086D221u, 0x00000000u}
#define GLV_B1 {0x0ABFE4C3u, 0x6F547FA9u, 0x010E8828u, 0xE4437ED6u, 0x00000000u}
#define GLV_A2 {0x9D44CFD8u, 0x57C1108Du, 0xA8E2F3F6u, 0x14CA50F7u, 0x00000001u}
#define GLV_B2 {0x9284EB15u, 0xE86C90E4u, 0xA7D46BCDu, 0x3086D221u, 0x00000000u}

// ---------------------------------------------------------------------------
// Multi-word helpers (little-endian 32-bit words)
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// GF(p), p = 2^256 - 0x1000003D1; canonical residues in and out
// ---------------------------------------------------------------------------

DEV void fp_cond_sub(u32* r) {  // r < 2p -> r mod p
  const u32 P[8] = SECP_P;
  u32 t[8];
  u32 borrow = sub_w<8>(t, r, P);
  select8(r, borrow != 0, r, t);
}

// r (< 2^256) + top·2^256 mod p, for top < 2^34: fold top·0x1000003D1 in,
// then fold the at most one wrap past 2^256 (r is small then), then one
// conditional subtract.
DEV void fp_fold_top(u32* r, u64 top) {
  u64 acc = (u64)r[0] + top * 977u;
  r[0] = (u32)acc;
  acc >>= 32;
  acc += (u64)r[1] + top;
  r[1] = (u32)acc;
  acc >>= 32;
#pragma unroll
  for (int i = 2; i < 8; i++) {
    acc += r[i];
    r[i] = (u32)acc;
    acc >>= 32;
  }
  u32 o = (u32)acc;  // 0 or 1
  acc = (u64)r[0] + (o ? 977u : 0u);
  r[0] = (u32)acc;
  acc >>= 32;
  acc += (u64)r[1] + o;
  r[1] = (u32)acc;
  acc >>= 32;
#pragma unroll
  for (int i = 2; i < 8; i++) {
    acc += r[i];
    r[i] = (u32)acc;
    acc >>= 32;
  }
  fp_cond_sub(r);
}

// 512-bit t -> t mod p: lo + hi·977 + (hi << 32), then fold the top.
DEV void fp_reduce_wide(u32* r, const u32* t) {
  u64 acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    acc += (u64)t[8 + i] * 977u + t[i];
    if (i > 0) acc += t[8 + i - 1];
    r[i] = (u32)acc;
    acc >>= 32;
  }
  fp_fold_top(r, acc + t[15]);
}

DEV void fp_mul(u32* r, const u32* a, const u32* b) {
  u32 t[16];
  mul_w<8, 8>(t, a, b);
  fp_reduce_wide(r, t);
}

DEV void fp_sqr(u32* r, const u32* a) { fp_mul(r, a, a); }

DEV void fp_mul_small(u32* r, const u32* a, u32 k) {
  u64 acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    acc += (u64)a[i] * k;
    r[i] = (u32)acc;
    acc >>= 32;
  }
  fp_fold_top(r, acc);
}

DEV void fp_add(u32* r, const u32* a, const u32* b) {
  const u32 P[8] = SECP_P;
  u32 t[8], s[8];
  u32 carry = add_w<8>(t, a, b);
  u32 borrow = sub_w<8>(s, t, P);
  select8(r, carry || !borrow, s, t);
}

DEV void fp_sub(u32* r, const u32* a, const u32* b) {
  const u32 P[8] = SECP_P;
  u32 t[8], s[8];
  u32 borrow = sub_w<8>(t, a, b);
  add_w<8>(s, t, P);
  select8(r, borrow != 0, s, t);
}

DEV void fp_neg(u32* r, const u32* a) {
  const u32 Z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  fp_sub(r, Z, a);
}

// ---------------------------------------------------------------------------
// GF(n), n = 2^256 - CN with CN < 2^129
// ---------------------------------------------------------------------------

DEV void fn_cond_sub(u32* r) {  // r < 2n -> r mod n
  const u32 N[8] = SECP_N;
  u32 t[8];
  u32 borrow = sub_w<8>(t, r, N);
  select8(r, borrow != 0, r, t);
}

// 512-bit t -> t mod n by four folds of hi·CN (value bounds in comments).
DEV void fn_reduce_wide(u32* r, const u32* t) {
  const u32 CN[5] = SECP_CN;
  u32 u1[14];
  mul_w<8, 5>(u1, t + 8, CN);  // hi·CN < 2^385
  u1[13] = 0;
  add_into<14, 8>(u1, t);      // < 2^386: hi2 = u1[8..12] < 2^130
  u32 u2[10];
  mul_w<5, 5>(u2, u1 + 8, CN);  // < 2^259
  add_into<10, 8>(u2, u1);      // < 2^260: u2[8] < 16, u2[9] = 0
  u32 p3[6];
  mul_w<1, 5>(p3, u2 + 8, CN);  // < 2^133
  u32 u3[9];
  copy_w<8>(u3, u2);
  u3[8] = 0;
  add_into<9, 6>(u3, p3);  // < 2^256 + 2^133: u3[8] in {0, 1}
  u32 wrap[5];
#pragma unroll
  for (int i = 0; i < 5; i++) wrap[i] = u3[8] ? CN[i] : 0u;
  add_into<8, 5>(u3, wrap);  // u3 was < 2^133 if it wrapped: no carry
  fn_cond_sub(u3);
  copy_w<8>(r, u3);
}

DEV void fn_mul(u32* r, const u32* a, const u32* b) {
  u32 t[16];
  mul_w<8, 8>(t, a, b);
  fn_reduce_wide(r, t);
}

DEV void fn_neg(u32* r, const u32* a) {  // canonical a
  const u32 N[8] = SECP_N;
  const u32 Z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  u32 t[8], s[8];
  u32 borrow = sub_w<8>(t, Z, a);
  add_w<8>(s, t, N);
  select8(r, borrow != 0, s, t);
}

enum { EXP_P_INV_ID, EXP_P_SQRT_ID, EXP_N_INV_ID };

// word i of a static exponent, read straight from its __constant__ array
template <int E>
DEV u32 exp_word(int i) {
  return E == EXP_P_INV_ID ? EXP_P_INV[i] : E == EXP_P_SQRT_ID ? EXP_P_SQRT[i] : EXP_N_INV[i];
}

// a^e for a static exponent e, 4-bit windows MSB first; 0 -> 0.
template <bool MODN, int E>
DEV_NOINLINE void f_pow(u32* r, const u32* a) {
  u32 tab[15][8];
  copy_w<8>(tab[0], a);
#pragma unroll 1
  for (int k = 1; k < 15; k++) {
    if (MODN) fn_mul(tab[k], tab[k - 1], a);
    else fp_mul(tab[k], tab[k - 1], a);
  }
  u32 acc[8];
  bool started = false;
#pragma unroll 1
  for (int w = 63; w >= 0; w--) {
    u32 c = (exp_word<E>(w >> 3) >> ((w & 7) * 4)) & 15u;
    if (started) {
#pragma unroll 1
      for (int q = 0; q < 4; q++) {
        if (MODN) fn_mul(acc, acc, acc);
        else fp_sqr(acc, acc);
      }
      if (c) {
        if (MODN) fn_mul(acc, acc, tab[c - 1]);
        else fp_mul(acc, acc, tab[c - 1]);
      }
    } else if (c) {
      copy_w<8>(acc, tab[c - 1]);
      started = true;
    }
  }
  copy_w<8>(r, acc);
}

// ---------------------------------------------------------------------------
// Complete projective group law, a = 0, b3 = 3b = 21 (Renes–Costello–Batina)
// ---------------------------------------------------------------------------

struct Pt {
  u32 X[8], Y[8], Z[8];
};

// RCB algorithm 9 (6M + 2S + 1·b3); R may alias P.
DEV_NOINLINE void pt_double(Pt& R, const Pt& P) {
  u32 t0[8], t1[8], t2[8], x3[8], y3[8], z3[8];
  fp_sqr(t0, P.Y);
  fp_add(z3, t0, t0);
  fp_add(z3, z3, z3);
  fp_add(z3, z3, z3);  // 8·Y^2
  fp_mul(t1, P.Y, P.Z);
  fp_sqr(t2, P.Z);
  fp_mul_small(t2, t2, 21u);
  fp_mul(x3, t2, z3);
  fp_add(y3, t0, t2);
  fp_mul(z3, t1, z3);
  fp_add(t1, t2, t2);
  fp_add(t2, t1, t2);  // 3·b3·Z^2
  fp_sub(t0, t0, t2);
  fp_mul(y3, t0, y3);
  fp_add(y3, x3, y3);
  fp_mul(t1, P.X, P.Y);
  fp_mul(x3, t0, t1);
  fp_add(x3, x3, x3);
  copy_w<8>(R.X, x3);
  copy_w<8>(R.Y, y3);
  copy_w<8>(R.Z, z3);
}

// RCB algorithm 7 (12M + 2·b3); R may alias P or Q.
DEV_NOINLINE void pt_add(Pt& R, const Pt& P, const Pt& Q) {
  u32 t0[8], t1[8], t2[8], t3[8], t4[8], x3[8], y3[8], z3[8], u[8], v[8];
  fp_mul(t0, P.X, Q.X);
  fp_mul(t1, P.Y, Q.Y);
  fp_mul(t2, P.Z, Q.Z);
  fp_add(u, P.X, P.Y);
  fp_add(v, Q.X, Q.Y);
  fp_mul(t3, u, v);
  fp_add(u, t0, t1);
  fp_sub(t3, t3, u);  // X1Y2 + X2Y1
  fp_add(u, P.Y, P.Z);
  fp_add(v, Q.Y, Q.Z);
  fp_mul(t4, u, v);
  fp_add(u, t1, t2);
  fp_sub(t4, t4, u);  // Y1Z2 + Y2Z1
  fp_add(u, P.X, P.Z);
  fp_add(v, Q.X, Q.Z);
  fp_mul(x3, u, v);
  fp_add(u, t0, t2);
  fp_sub(y3, x3, u);  // X1Z2 + X2Z1
  fp_add(x3, t0, t0);
  fp_add(t0, x3, t0);  // 3·X1X2
  fp_mul_small(t2, t2, 21u);
  fp_add(z3, t1, t2);
  fp_sub(t1, t1, t2);
  fp_mul_small(y3, y3, 21u);
  fp_mul(x3, t4, y3);
  fp_mul(t2, t3, t1);
  fp_sub(x3, t2, x3);
  fp_mul(y3, y3, t0);
  fp_mul(t1, t1, z3);
  fp_add(y3, t1, y3);
  fp_mul(t0, t0, t3);
  fp_mul(z3, z3, t4);
  fp_add(z3, z3, t0);
  copy_w<8>(R.X, x3);
  copy_w<8>(R.Y, y3);
  copy_w<8>(R.Z, z3);
}

// RCB algorithm 8 (11M + 2·b3), affine (x2, y2) a genuine curve point.
DEV_NOINLINE void pt_add_mixed(Pt& R, const Pt& P, const u32* x2, const u32* y2) {
  u32 t0[8], t1[8], t2[8], t3[8], t4[8], t5[8], x3[8], y3[8], z3[8], u[8], v[8];
  fp_mul(t0, P.X, x2);
  fp_mul(t1, P.Y, y2);
  fp_add(u, x2, y2);
  fp_add(v, P.X, P.Y);
  fp_mul(t3, u, v);
  fp_add(u, t0, t1);
  fp_sub(t3, t3, u);  // X1Y2 + X2Y1
  fp_mul(u, x2, P.Z);
  fp_add(t4, u, P.X);  // X1 + X2Z1
  fp_mul(u, y2, P.Z);
  fp_add(t5, u, P.Y);  // Y1 + Y2Z1
  fp_add(x3, t0, t0);
  fp_add(t0, x3, t0);  // 3·X1X2
  fp_mul_small(t2, P.Z, 21u);
  fp_add(z3, t1, t2);
  fp_sub(t1, t1, t2);
  fp_mul_small(y3, t4, 21u);
  fp_mul(x3, t5, y3);
  fp_mul(t2, t3, t1);
  fp_sub(x3, t2, x3);
  fp_mul(y3, y3, t0);
  fp_mul(t1, t1, z3);
  fp_add(y3, t1, y3);
  fp_mul(t0, t0, t3);
  fp_mul(z3, z3, t5);
  fp_add(z3, z3, t0);
  copy_w<8>(R.X, x3);
  copy_w<8>(R.Y, y3);
  copy_w<8>(R.Z, z3);
}

// ---------------------------------------------------------------------------
// GLV split and the ladder
// ---------------------------------------------------------------------------

// u2 (< n) -> (ka, sa, kb, sb) with u2 ≡ (-1)^sa·ka + (-1)^sb·kb·λ (mod n),
// floor Barrett rounding c_i = floor(u2·g_i / 2^448) as in the plain version.
DEV void glv_split(const u32* u2, u32* ka, bool& sa, u32* kb, bool& sb) {
  const u32 G1[10] = GLV_G1, G2[10] = GLV_G2;
  const u32 A1[5] = GLV_A1, B1[5] = GLV_B1, A2[5] = GLV_A2, B2[5] = GLV_B2;
  u32 p[18], c1[5], c2[5];
  mul_w<8, 10>(p, u2, G1);
  copy_w<4>(c1, p + 14);  // < 2^128
  c1[4] = 0;
  mul_w<8, 10>(p, u2, G2);
  copy_w<4>(c2, p + 14);
  c2[4] = 0;
  u32 m1[10], m2[10], sum[10], ux[10], d1[10], d2[10];
  mul_w<5, 5>(m1, c1, A1);
  mul_w<5, 5>(m2, c2, A2);
  add_w<10>(sum, m1, m2);  // c1·a1 + c2·a2 < 2^259
  copy_w<8>(ux, u2);
  ux[8] = ux[9] = 0;
  u32 borrow = sub_w<10>(d1, ux, sum);
  sub_w<10>(d2, sum, ux);
  sa = borrow != 0;
  select8(ka, sa, d2, d1);
  mul_w<5, 5>(m1, c1, B1);
  mul_w<5, 5>(m2, c2, B2);
  borrow = sub_w<10>(d1, m1, m2);
  sub_w<10>(d2, m2, m1);
  sb = borrow != 0;
  select8(kb, sb, d2, d1);
}

// 4-bit window i (0 = LSB) of a little-endian word array.
DEV u32 window_at(const u32* k, int i) { return (k[i >> 3] >> ((i & 7) * 4)) & 15u; }

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
  const u32 P[8] = SECP_P, N[8] = SECP_N, BETA[8] = SECP_BETA;
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
  u32 ka[8], kb[8];
  bool sa, sb;
  glv_split(u2, ka, sa, kb, sb);
  u32 u1lo[5] = {u1[0], u1[1], u1[2], u1[3], 0};
  u32 u1hi[5] = {u1[4], u1[5], u1[6], u1[7], 0};

  // runtime table c·R, c = 1..15 (projective), and its λ view (βX : Y : Z)
  Pt T[15];
  u32 TB[15][8];
  copy_w<8>(T[0].X, x);
  copy_w<8>(T[0].Y, y);
  for (int i = 0; i < 8; i++) T[0].Z[i] = i == 0 ? 1u : 0u;
#pragma unroll 1
  for (int k = 1; k < 15; k++) pt_add(T[k], T[k - 1], T[0]);
#pragma unroll 1
  for (int k = 0; k < 15; k++) fp_mul(TB[k], T[k].X, BETA);

  Pt acc;
  for (int i = 0; i < 8; i++) {
    acc.X[i] = 0;
    acc.Y[i] = i == 0 ? 1u : 0u;
    acc.Z[i] = 0;
  }
  Pt q;
#pragma unroll 1
  for (int i = 32; i >= 0; i--) {
#pragma unroll 1
    for (int d = 0; d < 4; d++) pt_double(acc, acc);
    u32 wa = window_at(ka, i);
    if (wa) {
      q = T[wa - 1];
      if (sa) fp_neg(q.Y, q.Y);
      pt_add(acc, acc, q);
    }
    u32 wb = window_at(kb, i);
    if (wb) {
      q = T[wb - 1];
      copy_w<8>(q.X, TB[wb - 1]);
      if (sb) fp_neg(q.Y, q.Y);
      pt_add(acc, acc, q);
    }
    u32 wl = window_at(u1lo, i);
    if (wl) pt_add_mixed(acc, acc, comb[wl - 1], comb[15 + wl - 1]);
    u32 wh = window_at(u1hi, i);
    if (wh) pt_add_mixed(acc, acc, comb[30 + wh - 1], comb[45 + wh - 1]);
  }

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

extern "C" const char* fisco_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

#endif  // __CUDACC__
