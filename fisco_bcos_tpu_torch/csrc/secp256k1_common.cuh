// secp256k1 arithmetic shared by the recover and verify kernels: GF(p) and
// GF(n) on 8 little-endian 32-bit words, the complete projective group law
// for a = 0, the GLV split and the 33-window ladder.
//
// GF(p) reduces with the 2^256 = 0x1000003D1 fold, GF(n) with the ~2^129
// complement fold; every op returns the canonical residue, so values equal
// the plain PyTorch version's (fisco_bcos_tpu_torch/ops/limb.py FoldField)
// bit for bit. Host-compilable, like wide_int.cuh.

#ifndef FISCO_SECP256K1_COMMON_CUH
#define FISCO_SECP256K1_COMMON_CUH

#include "wide_int.cuh"

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
// GF(p), p = 2^256 - 0x1000003D1; canonical residues in and out
// ---------------------------------------------------------------------------

DEV void fp_cond_sub(u32* r) {  // r < 2p -> r mod p
  const u32 P[8] = SECP_P;
  cond_sub8(r, r, P);
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
  add_mod(r, a, b, P);
}

DEV void fp_sub(u32* r, const u32* a, const u32* b) {
  const u32 P[8] = SECP_P;
  sub_mod(r, a, b, P);
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
  cond_sub8(r, r, N);
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
  sub_mod(r, Z, a, N);
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

// acc = u1·G + u2·Q for affine Q = (qx, qy) and scalars u1, u2 < n.
// comb: [60][8] words — x then y of c·G (rows 0..29) and of c·2^128·G
// (rows 30..59), c = 1..15, affine. u2 is split by GLV; the ladder runs 33
// windows MSB first of 4 doublings, then up to two complete additions from
// the runtime c·Q table (its λ view (βX : Y : Z) for kb) and two mixed
// additions from the combs (u1's low and high 128 bits). A lane whose window
// is 0 skips that addition. Any Q is safe: an off-curve or out-of-range Q
// gives garbage, never a fault.
DEV_NOINLINE void glv_dual_mul(Pt& acc, const u32* qx, const u32* qy, const u32* u1,
                               const u32* u2, const u32 (*comb)[8]) {
  const u32 BETA[8] = SECP_BETA;
  u32 ka[8], kb[8];
  bool sa, sb;
  glv_split(u2, ka, sa, kb, sb);
  u32 u1lo[5] = {u1[0], u1[1], u1[2], u1[3], 0};
  u32 u1hi[5] = {u1[4], u1[5], u1[6], u1[7], 0};

  // runtime table c·Q, c = 1..15 (projective), and its λ view (βX : Y : Z)
  Pt T[15];
  u32 TB[15][8];
  copy_w<8>(T[0].X, qx);
  copy_w<8>(T[0].Y, qy);
  for (int i = 0; i < 8; i++) T[0].Z[i] = i == 0 ? 1u : 0u;
#pragma unroll 1
  for (int k = 1; k < 15; k++) pt_add(T[k], T[k - 1], T[0]);
#pragma unroll 1
  for (int k = 0; k < 15; k++) fp_mul(TB[k], T[k].X, BETA);

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
}

#endif  // FISCO_SECP256K1_COMMON_CUH
