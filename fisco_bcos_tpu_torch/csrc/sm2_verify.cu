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
// domain x·R mod p (R = 2^256). A product is the full 512-bit a·b
// (wide_int.cuh) and then REDC by the form of p:
// -p^-1 ≡ 1 (mod 2^32), so each step's factor m is the low word itself, and
// m·p = m·2^256 - m·2^224 - m·2^96 + m·2^64 - m is one 7-word add of
// m·(2^192 - 2^160 - 2^32 + 1) two words up, with no multiply. A squaring
// takes the 36-product wide_sqr. REDC of a value below p·R has one
// canonical result, so every value equals the plain version's (limb.py
// MontField) and the comb table is the JAX package's g_comb_table("sm2")
// word for word. Constants a, b, 3b and 1 are all in the Montgomery domain:
// a·x = -(3x) by additions, 3b·x a full Montgomery product.
//
// What bounds it on an H100: the bound counts 32-bit integer multiply
// issue (IMAD, 64 per clock per SM, half the fp32 FMA rate); the bytes (5 x
// 64 B in, 1 B out a lane) are negligible. A lane needs about 5.1k field
// products (the 14-add table ~180, the ladder 64 x (4 doublings + up to 2
// additions) ~4.9k); chip_smoke.py counts them per lane from the run's own
// windows. With one thread a signature, 10,240 lanes make 320 warps for the
// card's 528 schedulers, so what one warp issues sets the time: measured,
// a warp pays for every integer instruction whether or not other products
// are in flight, and over twice as much once its loop body outgrows the
// instruction cache (wide_int.cuh; PERF.md §6). The previous version
// inlined every product into out-of-line doubling and addition functions,
// so a ladder window outgrew the cache throughout. The design here:
//   - fewer instructions per field op: the product's rows with a 64-bit
//     carry (wide_int.cuh), REDC by the form of p with no multiply, a
//     36-product squaring, add/sub chains with the carry in a predicate;
//   - the group law (RCB algorithms 1, 2, 3) as constant programs of field
//     ops over per-lane slots in shared memory (wide_int.cuh), run by one
//     loop holding one copy of each op, so a ladder window's code stays
//     inside the cache;
//   - the slots (the point, its addend, b3, 14 temporaries and the c·Q
//     table: 2,112 B a lane) in dynamic shared memory, lane-minor 16-byte
//     quads; 32 threads a block make 320 blocks on 132 SMs (67,584 + 960 B
//     of shared memory a block, three a SM).
// The scalars' windows come from shift registers, so no array is indexed
// at run time and the kernel needs no stack.
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
// -p^-1 mod 2^32 (the low word of -p^-1 mod R): 1, so REDC's factor m is
// the low word itself
#define SM2_PINV_NEG0 0x00000001u

// ---------------------------------------------------------------------------
// GF(p) in the Montgomery domain
// ---------------------------------------------------------------------------

// REDC step i of a 512-bit t (t[0..i) already 0): m = t[i]; t += m·p·2^(32i)
// as m·(2^192 - 2^160 - 2^32 + 1) added at word i + 2 (the -m at word i
// cancels t[i] exactly). Its 7 words are [m, -m, z, z, z, ~m & z, (m-1) & z]
// with z = m ? ~0 : 0; the top one is at most 2^32 - 2, so it absorbs the
// previous step's carry c (which belongs at word i + 8). Returns the carry
// out of word i + 8 in c.
DEV void sm2_redc_step(u32* t, int i, u32& c) {
  u32 m = t[i] * SM2_PINV_NEG0;
  u32 z = 0u - (u32)(m != 0);
  u32 d0 = m, d1 = 0u - m, d5 = ~m & z, d6 = ((m - 1u) & z) + c;
  u32* w = t + i + 2;
#if FISCO_PTX
  asm("add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %10;\n\t"
      "addc.cc.u32 %4, %4, %10;\n\t"
      "addc.cc.u32 %5, %5, %11;\n\t"
      "addc.cc.u32 %6, %6, %12;\n\t"
      "addc.u32 %7, 0, 0;"
      : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(w[4]), "+r"(w[5]),
        "+r"(w[6]), "=r"(c)
      : "r"(d0), "r"(d1), "r"(z), "r"(d5), "r"(d6));
#else
  const u32 d[7] = {d0, d1, z, z, z, d5, d6};
  c = add_into<7, 7>(w, d);
#endif
}

// r = t[8..16) + top·2^256 - p if that is >= p, else t[8..16): the value
// after the 8 steps is below 2p.
DEV void sm2_redc_finish(u32* r, const u32* t, u32 top) {
  const u32 P[8] = SM2_P;
  u32 s[8];
  u32 borrow = sub_w<8>(s, t + 8, P);
  select8(r, top != 0 || borrow == 0, s, t + 8);
}

DEV void sm2_redc(u32* r, u32* t) {
  u32 c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) sm2_redc_step(t, i, c);
  sm2_redc_finish(r, t, c);
}

// r = a·b·R^-1 mod p, for a < 2^256 and b < p (so a·b < p·R). r may alias
// a or b: every output is written after every input is read.
DEV void mm_mul(u32* r, const u32* a, const u32* b) {
  u32 t[16];
  wide_mul(t, a, b);
  sm2_redc(r, t);
}

// r = a^2·R^-1 mod p for a < p, in 36 word products; r may alias a.
DEV void mm_sqr(u32* r, const u32* a) {
  u32 t[16];
  wide_sqr(t, a);
  sm2_redc(r, t);
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

// ---------------------------------------------------------------------------
// Complete projective group law for a = -3 (Renes–Costello–Batina 1, 2, 3)
// as field-op programs over the slots: the point (S_X, S_Y, S_Z), the
// addend (S_QX, S_QY, S_QZ), b3 in S_K; F_SMALL is a·x = -(3x).
// ---------------------------------------------------------------------------

// SM2's field ops for fop_run.
struct Sm2Field {
  DEV_MEMBER void op(u32 kind, u32* r, const u32* a, const u32* b) {
    switch (kind) {
      case F_MUL: mm_mul(r, a, b); break;
      case F_SQR: mm_sqr(r, a); break;
      case F_ADD: mm_add(r, a, b); break;
      case F_SUB: mm_sub(r, a, b); break;
      default: mm_a_mul(r, a); break;
    }
  }
};

// RCB algorithm 3: (X, Y, Z) = 2·(X, Y, Z). 3S + 10M.
CONSTMEM u32 SM2_DBL[] = {
    FOP(F_SQR, S_T0, S_X, S_X), FOP(F_SQR, S_T1, S_Y, S_Y), FOP(F_SQR, S_T2, S_Z, S_Z),
    FOP(F_MUL, S_T3, S_X, S_Y), FOP(F_MUL, S_T4, S_X, S_Z), FOP(F_MUL, S_T5, S_Y, S_Z),
    FOP(F_ADD, S_T3, S_T3, S_T3), FOP(F_ADD, S_T4, S_T4, S_T4), FOP(F_ADD, S_T5, S_T5, S_T5),
    FOP(F_MUL, S_T6, S_T2, S_K),    // b3·Z^2
    FOP(F_MUL, S_T7, S_T4, S_K),    // b3·2XZ
    FOP(F_SMALL, S_T8, S_T4, S_T4),  // a·2XZ
    FOP(F_ADD, S_T6, S_T8, S_T6),
    FOP(F_SUB, S_T8, S_T1, S_T6),   // x3 = Y^2 - (a·2XZ + b3·Z^2)
    FOP(F_ADD, S_T6, S_T1, S_T6),   // y3 = Y^2 + (a·2XZ + b3·Z^2)
    FOP(F_SMALL, S_T9, S_T2, S_T2),  // a·Z^2
    FOP(F_SUB, S_T10, S_T0, S_T9),
    FOP(F_SMALL, S_T10, S_T10, S_T10),
    FOP(F_ADD, S_T10, S_T10, S_T7),  // u = a·(X^2 - a·Z^2) + b3·2XZ
    FOP(F_ADD, S_T11, S_T0, S_T0), FOP(F_ADD, S_T11, S_T11, S_T0),
    FOP(F_ADD, S_T11, S_T11, S_T9),  // w = 3X^2 + a·Z^2
    FOP(F_MUL, S_T6, S_T8, S_T6),  FOP(F_MUL, S_T8, S_T3, S_T8),
    FOP(F_MUL, S_T12, S_T11, S_T10), FOP(F_MUL, S_T13, S_T5, S_T10),
    FOP(F_MUL, S_T0, S_T5, S_T1),
    FOP(F_ADD, S_Y, S_T6, S_T12), FOP(F_SUB, S_X, S_T8, S_T13),
    FOP(F_ADD, S_T0, S_T0, S_T0), FOP(F_ADD, S_Z, S_T0, S_T0),
};

// The rest of algorithms 1 and 2, from t0 = X1X2 (T6), t1 = Y1Y2 (T7),
// t3 = X1Y2 + X2Y1 (T0), t4 = X1Z2 + X2Z1 (T2), t5 = Y1Z2 + Y2Z1 (T4),
// bz = b3·Z1Z2 (T3), az = a·Z1Z2 (T9) and t4b = b3·t4 (T5).
#define SM2_ADD_TAIL                                                              \
  FOP(F_SMALL, S_T10, S_T2, S_T2), FOP(F_ADD, S_T10, S_T3, S_T10),                 \
      FOP(F_SUB, S_T11, S_T7, S_T10), FOP(F_ADD, S_T10, S_T7, S_T10),               \
      FOP(F_ADD, S_T12, S_T6, S_T6), FOP(F_ADD, S_T12, S_T12, S_T6),                \
      FOP(F_ADD, S_T12, S_T12, S_T9),   /* 3·X1X2 + a·Z1Z2 */                       \
      FOP(F_SUB, S_T13, S_T6, S_T9), FOP(F_SMALL, S_T13, S_T13, S_T13),             \
      FOP(F_ADD, S_T5, S_T5, S_T13),    /* t4b + a·(X1X2 - a·Z1Z2) */               \
      FOP(F_MUL, S_T1, S_T11, S_T10), FOP(F_MUL, S_T3, S_T12, S_T5),                \
      FOP(F_MUL, S_T8, S_T4, S_T5), FOP(F_MUL, S_T11, S_T0, S_T11),                 \
      FOP(F_MUL, S_T7, S_T0, S_T12), FOP(F_MUL, S_T10, S_T4, S_T10),                \
      FOP(F_ADD, S_Y, S_T1, S_T3), FOP(F_SUB, S_X, S_T11, S_T8), FOP(F_ADD, S_Z, S_T10, S_T7)

// RCB algorithm 1: (X, Y, Z) += (QX, QY, QZ). 14M.
CONSTMEM u32 SM2_ADD[] = {
    FOP(F_ADD, S_T0, S_X, S_Y), FOP(F_ADD, S_T1, S_QX, S_QY),
    FOP(F_ADD, S_T2, S_X, S_Z), FOP(F_ADD, S_T3, S_QX, S_QZ),
    FOP(F_ADD, S_T4, S_Y, S_Z), FOP(F_ADD, S_T5, S_QY, S_QZ),
    FOP(F_MUL, S_T6, S_X, S_QX), FOP(F_MUL, S_T7, S_Y, S_QY), FOP(F_MUL, S_T8, S_Z, S_QZ),
    FOP(F_MUL, S_T0, S_T0, S_T1), FOP(F_MUL, S_T2, S_T2, S_T3), FOP(F_MUL, S_T4, S_T4, S_T5),
    FOP(F_ADD, S_T1, S_T6, S_T7), FOP(F_SUB, S_T0, S_T0, S_T1),
    FOP(F_ADD, S_T1, S_T6, S_T8), FOP(F_SUB, S_T2, S_T2, S_T1),
    FOP(F_ADD, S_T1, S_T7, S_T8), FOP(F_SUB, S_T4, S_T4, S_T1),
    FOP(F_MUL, S_T3, S_T8, S_K), FOP(F_MUL, S_T5, S_T2, S_K), FOP(F_SMALL, S_T9, S_T8, S_T8),
    SM2_ADD_TAIL,
};

// RCB algorithm 2: (X, Y, Z) += (QX, QY) affine, a genuine curve point (Z2 =
// 1: algorithm 1 with Z2 = 1, the same values). 13M.
CONSTMEM u32 SM2_MADD[] = {
    FOP(F_ADD, S_T0, S_QX, S_QY), FOP(F_ADD, S_T1, S_X, S_Y),
    FOP(F_MUL, S_T6, S_X, S_QX), FOP(F_MUL, S_T7, S_Y, S_QY), FOP(F_MUL, S_T0, S_T0, S_T1),
    FOP(F_MUL, S_T2, S_QX, S_Z), FOP(F_MUL, S_T4, S_QY, S_Z), FOP(F_MUL, S_T3, S_Z, S_K),
    FOP(F_ADD, S_T1, S_T6, S_T7), FOP(F_SUB, S_T0, S_T0, S_T1),
    FOP(F_ADD, S_T2, S_T2, S_X), FOP(F_ADD, S_T4, S_T4, S_Y),
    FOP(F_MUL, S_T5, S_T2, S_K), FOP(F_SMALL, S_T9, S_Z, S_Z),
    SM2_ADD_TAIL,
};

// acc = k1·G + k2·Q, Q = (x, y) Montgomery-domain affine, k1, k2 plain.
// comb: [30][8] words — Montgomery x then y of c·G, c = 1..15, affine. The
// runtime table c·Q, c = 1..15, goes to the slots from S_TAB on; each
// entry is the one before plus the affine Q. 64 windows MSB first of 4
// doublings, a complete addition from the table and a mixed addition from
// the comb; a zero window skips its addition. Any Q is safe: garbage in
// gives garbage out, never a fault.
DEV void sm2_dual_mul(Pt& acc, const u32* x, const u32* y, const u32* k1, const u32* k2,
                      const u32 (*comb)[8], u32* sl, int stride) {
  const u32 ONE[8] = SM2_R1, B3[8] = SM2_B3_MONT;
  const u32 ZERO[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  slot_put(sl, stride, S_K, B3);
  slot_put(sl, stride, S_QX, x);
  slot_put(sl, stride, S_QY, y);
  slot_put(sl, stride, S_X, x);
  slot_put(sl, stride, S_Y, y);
  slot_put(sl, stride, S_Z, ONE);
#pragma unroll 1
  for (int k = 0; k < 15; k++) {
    if (k) fop_run<Sm2Field>(SM2_MADD, FOP_LEN(SM2_MADD), sl, stride);
    slot_copy(sl, stride, S_TAB + 3 * k, S_X);
    slot_copy(sl, stride, S_TAB + 3 * k + 1, S_Y);
    slot_copy(sl, stride, S_TAB + 3 * k + 2, S_Z);
  }
  slot_put(sl, stride, S_X, ZERO);
  slot_put(sl, stride, S_Y, ONE);
  slot_put(sl, stride, S_Z, ZERO);
  u32 w1[8], w2[8];
  win_init<8, 256>(w1, k1);
  win_init<8, 256>(w2, k2);
#pragma unroll 1
  for (int i = 63; i >= 0; i--) {
#pragma unroll 1
    for (int d = 0; d < 4; d++) fop_run<Sm2Field>(SM2_DBL, FOP_LEN(SM2_DBL), sl, stride);
    u32 c2 = win_next<8>(w2);
    if (c2) {
      int e = S_TAB + 3 * (int)(c2 - 1);
      slot_copy(sl, stride, S_QX, e);
      slot_copy(sl, stride, S_QY, e + 1);
      slot_copy(sl, stride, S_QZ, e + 2);
      fop_run<Sm2Field>(SM2_ADD, FOP_LEN(SM2_ADD), sl, stride);
    }
    u32 c1 = win_next<8>(w1);
    if (c1) {
      slot_put(sl, stride, S_QX, comb[c1 - 1]);
      slot_put(sl, stride, S_QY, comb[15 + c1 - 1]);
      fop_run<Sm2Field>(SM2_MADD, FOP_LEN(SM2_MADD), sl, stride);
    }
  }
  slot_get(acc.X, sl, stride, S_X);
  slot_get(acc.Y, sl, stride, S_Y);
  slot_get(acc.Z, sl, stride, S_Z);
}

// One signature: e is SM3(ZA ‖ M) read as a 256-bit integer. `slots` is the
// lane's slot memory (SLOT_WORDS words at stride `stride`, wide_int.cuh).
DEV void sm2_verify_lane(const int32_t* el, const int32_t* rl, const int32_t* sl,
                         const int32_t* qxl, const int32_t* qyl, const u32 (*comb)[8],
                         u32* slots, int stride, uint8_t* ok) {
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
  mm_sqr(lhs, y);
  mm_sqr(rhs, x);
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
  sm2_dual_mul(acc, x, y, s, tk, comb, slots, stride);

  // k = (r - e mod n) mod n; x1 ≡ k (mod n) <=> X = k·Z or X = (k+n)·Z, k+n < p
  u32 en[8], k[8], kpn[8], kn[8], xp[8], kz[8], kpnz[8];
  cond_sub8(en, e, N);
  borrow = sub_w<8>(k, r, en);
  add_w<8>(kn, k, N);
  select8(k, borrow != 0, kn, k);
  carry = add_w<8>(kpn, k, N);
  bool kpn_fits = carry == 0 && lt8(kpn, P);
  // X out of the Montgomery domain; k·Z and (k+n)·Z, plain
  mm_mul(xp, acc.X, ONE_PLAIN);
  mm_mul(kz, k, acc.Z);
  mm_mul(kpnz, kpn, acc.Z);
  bool hit = eq8(xp, kz) || (kpn_fits && eq8(xp, kpnz));
  *ok = valid && !is_zero8(acc.Z) && hit;
}

#ifdef __CUDACC__

// One warp a block: 10,240 lanes make 320 blocks, which reach all 132 SMs.
#define SM2_THREADS 32
#define SM2_SMEM_BYTES (SLOT_WORDS * 4 * SM2_THREADS)

__global__ void __launch_bounds__(SM2_THREADS, 1)
sm2_verify_kernel(const int32_t* __restrict__ e, const int32_t* __restrict__ r,
                  const int32_t* __restrict__ s, const int32_t* __restrict__ qx,
                  const int32_t* __restrict__ qy, const u32* __restrict__ comb,
                  uint8_t* __restrict__ ok, int n) {
  // every thread reads a different comb row: shared memory, not __constant__
  __shared__ u32 s_comb[30][8];
  extern __shared__ uint4 s_slots[];  // the lanes' slots, lane-minor quads
  for (int i = threadIdx.x; i < 30 * 8; i += blockDim.x) s_comb[i >> 3][i & 7] = comb[i];
  __syncthreads();
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  sm2_verify_lane(e + 16 * lane, r + 16 * lane, s + 16 * lane, qx + 16 * lane, qy + 16 * lane,
                  s_comb, reinterpret_cast<u32*>(s_slots + threadIdx.x), SM2_THREADS, ok + lane);
}

// Launch geometry for n lanes: threads a block, blocks, dynamic shared bytes.
extern "C" void sm2_verify_geometry(int n, int* out) {
  out[0] = SM2_THREADS;
  out[1] = (n + SM2_THREADS - 1) / SM2_THREADS;
  out[2] = SM2_SMEM_BYTES;
}

// C entry point for ctypes: launches on `stream` of `device`, does not
// synchronise; returns the first CUDA error (0 on success).
extern "C" int sm2_verify_launch(const void* e, const void* r, const void* s, const void* qx,
                                 const void* qy, const void* comb, void* ok, int n,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  err = cudaFuncSetAttribute(sm2_verify_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SM2_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(sm2_verify_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  int geo[3];
  sm2_verify_geometry(n, geo);
  sm2_verify_kernel<<<geo[1], geo[0], geo[2], (cudaStream_t)stream>>>(
      (const int32_t*)e, (const int32_t*)r, (const int32_t*)s, (const int32_t*)qx,
      (const int32_t*)qy, (const u32*)comb, (uint8_t*)ok, n);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
