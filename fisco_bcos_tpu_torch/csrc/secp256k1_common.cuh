// secp256k1 arithmetic shared by the recover and verify kernels: GF(p) and
// GF(n) on 8 little-endian 32-bit words, the complete projective group law
// for a = 0, the GLV split and the 33-window ladder.
//
// GF(p) reduces with the 2^256 = 0x1000003D1 fold, GF(n) with the ~2^129
// complement fold; every op returns the canonical residue, so values equal
// the plain PyTorch version's (fisco_bcos_tpu_torch/ops/limb.py FoldField)
// bit for bit. Products and squarings (36 word products) come from
// wide_int.cuh. The group law (RCB algorithms 7, 8, 9) runs as constant
// programs of field ops over the lane's slots (fop_run), and the
// Fermat chains keep their 15 powers in the table slots: the slots are
// passed in as a base and a stride (shared memory on the card, a local
// array on the host). Host-compilable, like wide_int.cuh.

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
  wide_mul(t, a, b);
  fp_reduce_wide(r, t);
}

// a^2 mod p in 36 word products; r may alias a.
DEV void fp_sqr(u32* r, const u32* a) {
  u32 t[16];
  wide_sqr(t, a);
  fp_reduce_wide(r, t);
}

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
  wide_mul(t, a, b);
  fn_reduce_wide(r, t);
}

// a^2 mod n in 36 word products; r may alias a.
DEV void fn_sqr(u32* r, const u32* a) {
  u32 t[16];
  wide_sqr(t, a);
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

// r = a^e for a static exponent e, 4-bit windows MSB first; 0 -> 0. The
// powers a^1..a^15 go to the table slots (S_TAB on); r may alias a.
template <bool MODN, int E>
DEV void f_pow(u32* r, const u32* a, u32* sl, int stride) {
  u32 acc[8], t[8];
  copy_w<8>(acc, a);
  slot_put(sl, stride, S_TAB, acc);
#pragma unroll 1
  for (int k = 1; k < 15; k++) {
    if (MODN) fn_mul(acc, acc, a);
    else fp_mul(acc, acc, a);
    slot_put(sl, stride, S_TAB + k, acc);
  }
  bool started = false;
#pragma unroll 1
  for (int w = 63; w >= 0; w--) {
    u32 c = (exp_word<E>(w >> 3) >> ((w & 7) * 4)) & 15u;
    if (started) {
#pragma unroll 1
      for (int q = 0; q < 4; q++) {
        if (MODN) fn_sqr(acc, acc);
        else fp_sqr(acc, acc);
      }
      if (c) {
        slot_get(t, sl, stride, S_TAB + (int)c - 1);
        if (MODN) fn_mul(acc, acc, t);
        else fp_mul(acc, acc, t);
      }
    } else if (c) {
      slot_get(acc, sl, stride, S_TAB + (int)c - 1);
      started = true;
    }
  }
  copy_w<8>(r, acc);
}

// ---------------------------------------------------------------------------
// Complete projective group law, a = 0, b3 = 3b = 21 (Renes–Costello–Batina),
// as field-op programs over the slots: the point (S_X, S_Y, S_Z), the addend
// (S_QX, S_QY, S_QZ), β in S_K; F_SMALL is 21·x.
// ---------------------------------------------------------------------------

// secp256k1's field ops mod p for fop_run.
struct SecpField {
  DEV_MEMBER void op(u32 kind, u32* r, const u32* a, const u32* b) {
    switch (kind) {
      case F_MUL: fp_mul(r, a, b); break;
      case F_SQR: fp_sqr(r, a); break;
      case F_ADD: fp_add(r, a, b); break;
      case F_SUB: fp_sub(r, a, b); break;
      default: fp_mul_small(r, a, 21u); break;
    }
  }
};

// RCB algorithm 9: (X, Y, Z) = 2·(X, Y, Z). 6M + 2S + 1·b3.
CONSTMEM u32 SECP_DBL[] = {
    FOP(F_SQR, S_T0, S_Y, S_Y), FOP(F_SQR, S_T2, S_Z, S_Z),
    FOP(F_MUL, S_T1, S_Y, S_Z), FOP(F_MUL, S_T3, S_X, S_Y),
    FOP(F_ADD, S_T4, S_T0, S_T0), FOP(F_ADD, S_T4, S_T4, S_T4),
    FOP(F_ADD, S_T4, S_T4, S_T4),   // 8·Y^2
    FOP(F_SMALL, S_T2, S_T2, S_T2),  // b3·Z^2
    FOP(F_ADD, S_T5, S_T0, S_T2),
    FOP(F_ADD, S_T6, S_T2, S_T2), FOP(F_ADD, S_T6, S_T6, S_T2),
    FOP(F_SUB, S_T0, S_T0, S_T6),   // Y^2 - 3·b3·Z^2
    FOP(F_MUL, S_T6, S_T2, S_T4), FOP(F_MUL, S_Z, S_T1, S_T4),
    FOP(F_MUL, S_T5, S_T0, S_T5), FOP(F_MUL, S_T3, S_T0, S_T3),
    FOP(F_ADD, S_Y, S_T6, S_T5), FOP(F_ADD, S_X, S_T3, S_T3),
};

// The last level of algorithms 7 and 8, from t0 = 3·X1X2 (T9),
// t1 = Y1Y2 - b3·Z1Z2 (T7), z3 = Y1Y2 + b3·Z1Z2 (T10), t3 = X1Y2 + X2Y1
// (T0), t4 = Y1Z2 + Y2Z1 (T2) and y3 = b3·(X1Z2 + X2Z1) (T4).
#define SECP_ADD_TAIL                                                             \
  FOP(F_MUL, S_T1, S_T2, S_T4), FOP(F_MUL, S_T3, S_T0, S_T7),                      \
      FOP(F_MUL, S_T5, S_T4, S_T9), FOP(F_MUL, S_T6, S_T7, S_T10),                  \
      FOP(F_MUL, S_T8, S_T9, S_T0), FOP(F_MUL, S_T11, S_T10, S_T2),                 \
      FOP(F_SUB, S_X, S_T3, S_T1), FOP(F_ADD, S_Y, S_T6, S_T5), FOP(F_ADD, S_Z, S_T11, S_T8)

// RCB algorithm 7: (X, Y, Z) += (QX, QY, QZ). 12M + 2·b3.
CONSTMEM u32 SECP_ADD[] = {
    FOP(F_ADD, S_T0, S_X, S_Y), FOP(F_ADD, S_T1, S_QX, S_QY),
    FOP(F_ADD, S_T2, S_Y, S_Z), FOP(F_ADD, S_T3, S_QY, S_QZ),
    FOP(F_ADD, S_T4, S_X, S_Z), FOP(F_ADD, S_T5, S_QX, S_QZ),
    FOP(F_MUL, S_T6, S_X, S_QX), FOP(F_MUL, S_T7, S_Y, S_QY), FOP(F_MUL, S_T8, S_Z, S_QZ),
    FOP(F_MUL, S_T0, S_T0, S_T1), FOP(F_MUL, S_T2, S_T2, S_T3), FOP(F_MUL, S_T4, S_T4, S_T5),
    FOP(F_ADD, S_T1, S_T6, S_T7), FOP(F_SUB, S_T0, S_T0, S_T1),   // X1Y2 + X2Y1
    FOP(F_ADD, S_T1, S_T7, S_T8), FOP(F_SUB, S_T2, S_T2, S_T1),   // Y1Z2 + Y2Z1
    FOP(F_ADD, S_T1, S_T6, S_T8), FOP(F_SUB, S_T4, S_T4, S_T1),   // X1Z2 + X2Z1
    FOP(F_ADD, S_T9, S_T6, S_T6), FOP(F_ADD, S_T9, S_T9, S_T6),   // 3·X1X2
    FOP(F_SMALL, S_T8, S_T8, S_T8),
    FOP(F_ADD, S_T10, S_T7, S_T8), FOP(F_SUB, S_T7, S_T7, S_T8),
    FOP(F_SMALL, S_T4, S_T4, S_T4),
    SECP_ADD_TAIL,
};

// RCB algorithm 8: (X, Y, Z) += (QX, QY) affine, a genuine curve point (Z2 =
// 1: algorithm 7 with Z2 = 1, the same values). 11M + 2·b3.
CONSTMEM u32 SECP_MADD[] = {
    FOP(F_ADD, S_T0, S_QX, S_QY), FOP(F_ADD, S_T1, S_X, S_Y),
    FOP(F_MUL, S_T6, S_X, S_QX), FOP(F_MUL, S_T7, S_Y, S_QY), FOP(F_MUL, S_T0, S_T0, S_T1),
    FOP(F_MUL, S_T3, S_QX, S_Z), FOP(F_MUL, S_T5, S_QY, S_Z),
    FOP(F_ADD, S_T1, S_T6, S_T7), FOP(F_SUB, S_T0, S_T0, S_T1),   // X1Y2 + X2Y1
    FOP(F_ADD, S_T3, S_T3, S_X),    // X1 + X2Z1
    FOP(F_ADD, S_T2, S_T5, S_Y),    // Y1 + Y2Z1
    FOP(F_ADD, S_T9, S_T6, S_T6), FOP(F_ADD, S_T9, S_T9, S_T6),   // 3·X1X2
    FOP(F_SMALL, S_T8, S_Z, S_Z),
    FOP(F_ADD, S_T10, S_T7, S_T8), FOP(F_SUB, S_T7, S_T7, S_T8),
    FOP(F_SMALL, S_T4, S_T3, S_T3),
    SECP_ADD_TAIL,
};

// The λ view of a table entry: QX = β·QX.
CONSTMEM u32 SECP_BETA_QX[] = {FOP(F_MUL, S_QX, S_QX, S_K)};

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
// (rows 30..59), c = 1..15, affine. The runtime table c·Q, c = 1..15, goes
// to the slots from S_TAB on; each entry is the one before plus the affine
// Q. u2 is split by GLV; the ladder runs 33 windows MSB first of 4
// doublings, then up to two complete additions from the table ((X : ±Y :
// Z) for ka, (βX : ±Y : Z) for kb) and two mixed additions from the combs
// (u1's low and high 128 bits). A lane whose window is 0 skips that
// addition. Any Q is safe: an off-curve or out-of-range Q gives garbage,
// never a fault.
DEV void glv_dual_mul(Pt& acc, const u32* qx, const u32* qy, const u32* u1, const u32* u2,
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
  for (int k = 0; k < 15; k++) {
    if (k) fop_run<SecpField>(SECP_MADD, FOP_LEN(SECP_MADD), sl, stride);
    slot_copy(sl, stride, S_TAB + 3 * k, S_X);
    slot_copy(sl, stride, S_TAB + 3 * k + 1, S_Y);
    slot_copy(sl, stride, S_TAB + 3 * k + 2, S_Z);
  }
  slot_put(sl, stride, S_X, ZERO);
  slot_put(sl, stride, S_Y, ONE);
  slot_put(sl, stride, S_Z, ZERO);

  // 33 windows of 4 bits: bits 0..131 of each scalar (ka, kb < 2^130)
  u32 wa[5], wb[5], wl[5], wh[5];
  win_init<5, 132>(wa, ka);
  win_init<5, 132>(wb, kb);
  const u32 u1lo[5] = {u1[0], u1[1], u1[2], u1[3], 0};
  const u32 u1hi[5] = {u1[4], u1[5], u1[6], u1[7], 0};
  win_init<5, 132>(wl, u1lo);
  win_init<5, 132>(wh, u1hi);
#pragma unroll 1
  for (int i = 32; i >= 0; i--) {
#pragma unroll 1
    for (int d = 0; d < 4; d++) fop_run<SecpField>(SECP_DBL, FOP_LEN(SECP_DBL), sl, stride);
    u32 ca = win_next<5>(wa), cb = win_next<5>(wb);
    u32 cl = win_next<5>(wl), ch = win_next<5>(wh);
#pragma unroll 1
    for (int j = 0; j < 2; j++) {  // ka from (X : Y : Z), then kb from (βX : Y : Z)
      u32 c = j ? cb : ca;
      if (c) {
        int e = S_TAB + 3 * (int)(c - 1);
        u32 y[8];
        slot_copy(sl, stride, S_QX, e);
        slot_get(y, sl, stride, e + 1);
        if (j ? sb : sa) fp_neg(y, y);
        slot_put(sl, stride, S_QY, y);
        slot_copy(sl, stride, S_QZ, e + 2);
        if (j) fop_run<SecpField>(SECP_BETA_QX, FOP_LEN(SECP_BETA_QX), sl, stride);
        fop_run<SecpField>(SECP_ADD, FOP_LEN(SECP_ADD), sl, stride);
      }
    }
#pragma unroll 1
    for (int j = 0; j < 2; j++) {  // u1's low half from G, its high half from 2^128·G
      u32 c = j ? ch : cl;
      if (c) {
        slot_put(sl, stride, S_QX, comb[30 * j + c - 1]);
        slot_put(sl, stride, S_QY, comb[30 * j + 15 + c - 1]);
        fop_run<SecpField>(SECP_MADD, FOP_LEN(SECP_MADD), sl, stride);
      }
    }
  }
  slot_get(acc.X, sl, stride, S_X);
  slot_get(acc.Y, sl, stride, S_Y);
  slot_get(acc.Z, sl, stride, S_Z);
}

#endif  // FISCO_SECP256K1_COMMON_CUH
