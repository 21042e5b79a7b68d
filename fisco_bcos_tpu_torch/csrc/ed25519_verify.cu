// Ed25519 signature verification (RFC 8032, cofactored), one thread per
// signature, for sm_90a.
//
// Replaces the JAX program `_verify_xla` (fisco_bcos_tpu/ops/ed25519.py:286,
// on `verify_core` :230), which the JAX package ran as one fused jitted
// program (it has no Pallas kernel). The plain PyTorch version is
// fisco_bcos_tpu_torch/ops/ed25519.py verify_core.
//
// Per lane, one 128-byte row R ‖ S ‖ A ‖ k_neg, 32 little-endian bytes each
// (k_neg = (L − k) mod L, the challenge k = SHA-512(R ‖ A ‖ M) mod L hashed
// on the host) -> ok:
//   valid = s < L and A and R decompress (y < p; x² = (y² − 1)/(d·y² + 1)
//   has a root; not x = 0 with the sign bit set);
//   ok = valid and 8·(s·B + k_neg·A − R) is the identity.
// The verdict is verify_core's on every lane, by the kernel's own method:
//   - decompression with one exponentiation a point (RFC 8032 §5.1.3):
//     x = u·v³·(u·v⁷)^((p−5)/8), times √−1 when v·x² = −u. The JAX program
//     inverts v, then takes the p ≡ 5 (mod 8) root: two exponentiations.
//     The candidates are the same element (the exponents differ by a
//     multiple of p − 1) and the sign bit fixes the root, so the point is;
//   - 64 signed 4-bit digits in [−8, 7] of s and k_neg (k + 0x88…8, each
//     window less 8), so the runtime table of A holds c·A for c = 1..8 and
//     the comb of B is the JAX table's first 8 entries; a negative digit
//     swaps Y+X and Y−X and negates 2d·T, no product;
//   - the addend in the cached form (Y+X, Y−X, 2d·T, 2Z): an addition is 8
//     products, a mixed one from the comb 7, a doubling 4 products and 4
//     squarings, 3 and 4 where a doubling follows (a doubling reads no T).
// The law (add-2008-hwcd-3, dbl-2008-hwcd, a = −1) is complete on the whole
// curve (−1 is a square and d is not), so no case needs a branch, small-order
// points and the identity included; every value is a canonical residue mod
// p, so the identity test (X = 0, Y = Z) and the parity of x read the
// words as they are. Every lane runs the whole method: an invalid lane
// (s ≥ L, y ≥ p, no root, a zero or garbage row) computes on garbage
// without a fault, and its valid bit masks the verdict.
//
// Field: GF(p), p = 2^255 − 19, on 8 little-endian 32-bit words. A product
// is the 512-bit a·b (wide_int.cuh) folded twice: the high half × 38
// (2^256 ≡ 38), then what lies at and above bit 255 × 19 (2^255 ≡ 19), then
// one conditional subtract of p; any 256-bit operands give the canonical
// residue. Sums and differences take canonical operands (add_mod, sub_mod).
//
// What bounds it on an H100: as for the other EC kernels (secp256k1_verify
// .cu, sm2_verify.cu), 32-bit integer multiply issue; the bytes (128 B in,
// 1 B out a lane) are negligible. A lane needs about 3,400 field products
// (two decompressions ~550, the table 63, the ladder ~2,800); chip_smoke.py
// counts them from this run's digits. One thread a signature: what one warp
// issues sets the time, so the design keeps the layer the EC kernels share
// (wide_int.cuh): the group law and the exponentiation as constant programs
// of field ops over per-lane slots in dynamic shared memory (fop_run), the
// ladder through one call site of fop_run, so that its loop body holds one
// copy of the field ops and stays in the instruction cache; 32 threads a
// block, 56 slots a lane (57,344 + 768 B of shared memory a block, three
// blocks a SM: 10,240 lanes are 320 blocks, all resident at once).
//
// The arithmetic compiles as host C++ too (no __CUDACC__): only the kernel
// and its C entry point are CUDA-specific.

#include "wide_int.cuh"

#define ED25519_P {0xFFFFFFEDu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, \
                   0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x7FFFFFFFu}
#define ED25519_L {0x5CF5D3EDu, 0x5812631Au, 0xA2F79CD6u, 0x14DEF9DEu, \
                   0x00000000u, 0x00000000u, 0x00000000u, 0x10000000u}
#define ED25519_D {0x135978A3u, 0x75EB4DCAu, 0x4141D8ABu, 0x00700A4Du, \
                   0x7779E898u, 0x8CC74079u, 0x2B6FFE73u, 0x52036CEEu}
#define ED25519_D2 {0x26B2F159u, 0xEBD69B94u, 0x8283B156u, 0x00E0149Au, \
                    0xEEF3D130u, 0x198E80F2u, 0x56DFFCE7u, 0x2406D9DCu}
#define ED25519_SQRT_M1 {0x4A0EA0B0u, 0xC4EE1B27u, 0xAD2FE478u, 0x2F431806u, \
                         0x3DFBD7A7u, 0x2B4D0099u, 0x4FC1DF0Bu, 0x2B832480u}
// 8 in every 4-bit window: window i of k + ED25519_RECODE, less 8, is k's
// signed digit d_i in [-8, 7], with sum d_i·16^i = k (k < 2^253)
#define ED25519_RECODE {0x88888888u, 0x88888888u, 0x88888888u, 0x88888888u, \
                        0x88888888u, 0x88888888u, 0x88888888u, 0x88888888u}

#define ED25519_TAB 8  // c·A and c·B for c = 1..8
#define ED25519_COMB_ROWS (3 * ED25519_TAB)
#define ED25519_WINDOWS 64
#define ED25519_ROW_BYTES 128

// ---------------------------------------------------------------------------
// GF(p), p = 2^255 - 19; canonical residues out
// ---------------------------------------------------------------------------

// r (< 2^256) + top·2^256 mod p, for top < 2^26: the bits at and above 255
// (2·top and r's bit 255) fold in × 19, which leaves less than 2^255 + 2^31,
// then one conditional subtract of p. With top = 0, the full reduction of
// any 256-bit r.
DEV void fe_fold_top(u32* r, u32 top) {
  const u32 P[8] = ED25519_P;
  u32 hb = top << 1 | r[7] >> 31;
  r[7] &= 0x7FFFFFFFu;
  u64 acc = (u64)r[0] + (u64)hb * 19u;
  r[0] = (u32)acc;
  acc >>= 32;
#pragma unroll
  for (int i = 1; i < 8; i++) {
    acc += r[i];
    r[i] = (u32)acc;
    acc >>= 32;
  }
  cond_sub8(r, r, P);
}

// 512-bit t -> t mod p: lo + 38·hi (< 39·2^256), then fold the top word.
DEV void fe_reduce_wide(u32* r, const u32* t) {
  u64 acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    acc += (u64)t[8 + i] * 38u + t[i];
    r[i] = (u32)acc;
    acc >>= 32;
  }
  fe_fold_top(r, (u32)acc);
}

// a·b mod p for any 256-bit a, b; r may alias a or b.
DEV void fe_mul(u32* r, const u32* a, const u32* b) {
  u32 t[16];
  wide_mul(t, a, b);
  fe_reduce_wide(r, t);
}

// a^2 mod p in 36 word products, for any 256-bit a; r may alias a.
DEV void fe_sqr(u32* r, const u32* a) {
  u32 t[16];
  wide_sqr(t, a);
  fe_reduce_wide(r, t);
}

DEV void fe_add(u32* r, const u32* a, const u32* b) {
  const u32 P[8] = ED25519_P;
  add_mod(r, a, b, P);
}

DEV void fe_sub(u32* r, const u32* a, const u32* b) {
  const u32 P[8] = ED25519_P;
  sub_mod(r, a, b, P);
}

DEV void fe_neg(u32* r, const u32* a) {
  const u32 Z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  fe_sub(r, Z, a);
}

// Ed25519's field ops for fop_run.
struct Ed25519Field {
  DEV_MEMBER void op(u32 kind, u32* r, const u32* a, const u32* b) {
    switch (kind) {
      case F_MUL: fe_mul(r, a, b); break;
      case F_SQR: fe_sqr(r, a); break;
      case F_ADD: fe_add(r, a, b); break;
      default: fe_sub(r, a, b); break;
    }
  }
};

// ---------------------------------------------------------------------------
// Slots and the field-op programs
// ---------------------------------------------------------------------------

// A lane's slots: the accumulator, the addend, four constants, eight
// temporaries, -R and the table of A, cached.
enum {
  ED_X, ED_Y, ED_Z, ED_T,      // the accumulator, extended (X : Y : Z : T)
  ED_QP, ED_QM, ED_QT, ED_QZ,  // the addend, cached: Y+X, Y-X, 2d·T, 2Z
  ED_ONE, ED_D, ED_D2, ED_I,   // 1, d, 2d, sqrt(-1)
  ED_T0, ED_T1, ED_T2, ED_T3, ED_T4, ED_T5, ED_T6, ED_T7,
  ED_NR,                       // -R, cached (4 slots)
  ED_TAB = ED_NR + 4,          // c·A, cached, c = 1..ED25519_TAB (4 slots each)
  ED25519_SLOTS = ED_TAB + 4 * ED25519_TAB
};
#define ED25519_SLOT_WORDS (ED25519_SLOTS * 8)

// dbl-2008-hwcd (a = -1): A = X², B = Y², C = 2Z², H = A + B,
// E = H - (X+Y)², G = A - B, F = C + G; (E·F, G·H, F·G, E·H). 4S + 3M, and
// ED_DBL_T for T = E·H.
#define ED_DBL_OPS                                                               \
  FOP(F_SQR, ED_T0, ED_X, ED_X), FOP(F_SQR, ED_T1, ED_Y, ED_Y),                   \
      FOP(F_SQR, ED_T2, ED_Z, ED_Z), FOP(F_ADD, ED_T2, ED_T2, ED_T2),             \
      FOP(F_ADD, ED_T3, ED_T0, ED_T1), FOP(F_ADD, ED_T4, ED_X, ED_Y),             \
      FOP(F_SQR, ED_T4, ED_T4, ED_T4), FOP(F_SUB, ED_T4, ED_T3, ED_T4),           \
      FOP(F_SUB, ED_T5, ED_T0, ED_T1), FOP(F_ADD, ED_T6, ED_T2, ED_T5),           \
      FOP(F_MUL, ED_X, ED_T4, ED_T6), FOP(F_MUL, ED_Y, ED_T5, ED_T3),             \
      FOP(F_MUL, ED_Z, ED_T6, ED_T5)
#define ED_DBL_T FOP(F_MUL, ED_T, ED_T4, ED_T3)

// add-2008-hwcd-3 with the cached addend: A = (Y-X)·QM, B = (Y+X)·QP,
// C = T·QT, D = Z·QZ (the mixed form: 2Z, the comb's Z being 1); E = B - A,
// F = D - C, G = D + C, H = B + A; (E·F, G·H, F·G, E·H).
#define ED_ADD_HEAD                                                              \
  FOP(F_SUB, ED_T0, ED_Y, ED_X), FOP(F_MUL, ED_T0, ED_T0, ED_QM),                 \
      FOP(F_ADD, ED_T1, ED_Y, ED_X), FOP(F_MUL, ED_T1, ED_T1, ED_QP),             \
      FOP(F_MUL, ED_T2, ED_T, ED_QT)
#define ED_ADD_TAIL                                                              \
  FOP(F_SUB, ED_T4, ED_T1, ED_T0), FOP(F_SUB, ED_T5, ED_T3, ED_T2),               \
      FOP(F_ADD, ED_T6, ED_T3, ED_T2), FOP(F_ADD, ED_T7, ED_T1, ED_T0),           \
      FOP(F_MUL, ED_X, ED_T4, ED_T5), FOP(F_MUL, ED_Y, ED_T6, ED_T7),             \
      FOP(F_MUL, ED_Z, ED_T5, ED_T6), FOP(F_MUL, ED_T, ED_T4, ED_T7)
#define ED_MADD_OPS ED_ADD_HEAD, FOP(F_ADD, ED_T3, ED_Z, ED_Z), ED_ADD_TAIL  // 7M
#define ED_ADD_OPS ED_ADD_HEAD, FOP(F_MUL, ED_T3, ED_Z, ED_QZ), ED_ADD_TAIL  // 8M

// The accumulator's cached form into T0..T3: Y+X, Y-X, 2d·T, 2Z.
#define ED_CACHE_OPS                                                             \
  FOP(F_ADD, ED_T0, ED_Y, ED_X), FOP(F_SUB, ED_T1, ED_Y, ED_X),                   \
      FOP(F_MUL, ED_T2, ED_T, ED_D2), FOP(F_ADD, ED_T3, ED_Z, ED_Z)
#define ED_XY_T FOP(F_MUL, ED_T, ED_X, ED_Y)  // T of an affine point

// Runs of squarings in place.
#define ED_SQR1(s) FOP(F_SQR, s, s, s)
#define ED_SQR2(s) ED_SQR1(s), ED_SQR1(s)
#define ED_SQR4(s) ED_SQR2(s), ED_SQR2(s)
#define ED_SQR5(s) ED_SQR4(s), ED_SQR1(s)
#define ED_SQR9(s) ED_SQR5(s), ED_SQR4(s)
#define ED_SQR10(s) ED_SQR5(s), ED_SQR5(s)
#define ED_SQR19(s) ED_SQR10(s), ED_SQR9(s)
#define ED_SQR20(s) ED_SQR10(s), ED_SQR10(s)
#define ED_SQR49(s) ED_SQR20(s), ED_SQR20(s), ED_SQR9(s)
#define ED_SQR50(s) ED_SQR49(s), ED_SQR1(s)
#define ED_SQR99(s) ED_SQR50(s), ED_SQR49(s)

// Decompression of y (ED_Y): u = y² - 1 (T1), v = d·y² + 1 (T2), v³ (T3),
// w = u·v⁷ (T4), w^((p-5)/8) = w^(2^252 - 3) by the addition chain of
// 251 squarings and 11 products (t0 = T0, t1 = T5, t2 = T6), then
// x = u·v³·w^((p-5)/8) (T0), v·x² (T3) and x·sqrt(-1) (T4).
#define ED_DECOMP_OPS                                                            \
  FOP(F_SQR, ED_T1, ED_Y, ED_Y), FOP(F_MUL, ED_T2, ED_T1, ED_D),                  \
      FOP(F_SUB, ED_T1, ED_T1, ED_ONE), FOP(F_ADD, ED_T2, ED_T2, ED_ONE),         \
      FOP(F_SQR, ED_T3, ED_T2, ED_T2), FOP(F_MUL, ED_T3, ED_T3, ED_T2),           \
      FOP(F_SQR, ED_T4, ED_T3, ED_T3), FOP(F_MUL, ED_T4, ED_T4, ED_T2),           \
      FOP(F_MUL, ED_T4, ED_T4, ED_T1),                                            \
      FOP(F_SQR, ED_T0, ED_T4, ED_T4),                      /* w^2 */             \
      FOP(F_SQR, ED_T5, ED_T0, ED_T0), ED_SQR1(ED_T5),      /* w^8 */             \
      FOP(F_MUL, ED_T5, ED_T4, ED_T5),                      /* w^9 */             \
      FOP(F_MUL, ED_T0, ED_T0, ED_T5), ED_SQR1(ED_T0),      /* w^22 */            \
      FOP(F_MUL, ED_T0, ED_T5, ED_T0),                      /* 2^5 - 1 */         \
      FOP(F_SQR, ED_T5, ED_T0, ED_T0), ED_SQR4(ED_T5),                            \
      FOP(F_MUL, ED_T0, ED_T5, ED_T0),                      /* 2^10 - 1 */        \
      FOP(F_SQR, ED_T5, ED_T0, ED_T0), ED_SQR9(ED_T5),                            \
      FOP(F_MUL, ED_T5, ED_T5, ED_T0),                      /* 2^20 - 1 */        \
      FOP(F_SQR, ED_T6, ED_T5, ED_T5), ED_SQR19(ED_T6),                           \
      FOP(F_MUL, ED_T5, ED_T6, ED_T5),                      /* 2^40 - 1 */        \
      ED_SQR10(ED_T5), FOP(F_MUL, ED_T0, ED_T5, ED_T0),     /* 2^50 - 1 */        \
      FOP(F_SQR, ED_T5, ED_T0, ED_T0), ED_SQR49(ED_T5),                           \
      FOP(F_MUL, ED_T5, ED_T5, ED_T0),                      /* 2^100 - 1 */       \
      FOP(F_SQR, ED_T6, ED_T5, ED_T5), ED_SQR99(ED_T6),                           \
      FOP(F_MUL, ED_T5, ED_T6, ED_T5),                      /* 2^200 - 1 */       \
      ED_SQR50(ED_T5), FOP(F_MUL, ED_T0, ED_T5, ED_T0),     /* 2^250 - 1 */       \
      ED_SQR2(ED_T0), FOP(F_MUL, ED_T0, ED_T0, ED_T4),      /* 2^252 - 3 */       \
      FOP(F_MUL, ED_T0, ED_T0, ED_T3), FOP(F_MUL, ED_T0, ED_T0, ED_T1),           \
      FOP(F_SQR, ED_T3, ED_T0, ED_T0), FOP(F_MUL, ED_T3, ED_T3, ED_T2),           \
      FOP(F_MUL, ED_T4, ED_T0, ED_I)

template <class... Ops>
constexpr int ed_count(Ops...) {
  return (int)sizeof...(Ops);
}

// Every program in one constant array, each at its offset: a program is
// picked by an offset, never by a pointer. DBL and DBL_T share their ops,
// ADD and ADD_CACHE theirs, as XY_CACHE and CACHE do.
enum {
  ED_DBL_AT = 0,
  ED_DBL_LEN = ed_count(ED_DBL_OPS),
  ED_DBL_T_LEN = ED_DBL_LEN + 1,
  ED_MADD_AT = ED_DBL_T_LEN,
  ED_MADD_LEN = ed_count(ED_MADD_OPS),
  ED_ADD_AT = ED_MADD_AT + ED_MADD_LEN,
  ED_ADD_LEN = ed_count(ED_ADD_OPS),
  ED_ADD_CACHE_LEN = ED_ADD_LEN + ed_count(ED_CACHE_OPS),
  ED_XY_CACHE_AT = ED_ADD_AT + ED_ADD_CACHE_LEN,
  ED_XY_CACHE_LEN = 1 + ed_count(ED_CACHE_OPS),
  ED_DECOMP_AT = ED_XY_CACHE_AT + ED_XY_CACHE_LEN,
  ED_DECOMP_LEN = ed_count(ED_DECOMP_OPS),
};
CONSTMEM u32 ED_PROGS[] = {
    ED_DBL_OPS, ED_DBL_T,        // DBL, DBL_T
    ED_MADD_OPS,                 // MADD
    ED_ADD_OPS, ED_CACHE_OPS,    // ADD, ADD_CACHE (then the sum's cached form)
    ED_XY_T, ED_CACHE_OPS,       // XY_CACHE: T = X·Y, then the cached form
    ED_DECOMP_OPS,               // DECOMP
};
static_assert(sizeof(ED_PROGS) / sizeof(u32) == ED_DECOMP_AT + ED_DECOMP_LEN, "program offsets");

DEV void ed_run(int at, int len, u32* sl, int stride) {
  fop_run<Ed25519Field>(ED_PROGS + at, len, sl, stride);
}

// ---------------------------------------------------------------------------
// Decompression, the ladder, one lane
// ---------------------------------------------------------------------------

// y (< 2^255, the sign bit taken off) and x's parity `sign` -> x, y, 1 in
// the accumulator's X, Y, Z slots (T not written); returns whether the
// encoding is a point: y < p, v·x² = ±u, and not x = 0 with sign 1. Any y
// is safe.
DEV bool ed_decompress(const u32* y, u32 sign, u32* sl, int stride) {
  const u32 P[8] = ED25519_P, ONE[8] = {1, 0, 0, 0, 0, 0, 0, 0};
  bool valid = lt8(y, P);
  slot_put(sl, stride, ED_Y, y);
  ed_run(ED_DECOMP_AT, ED_DECOMP_LEN, sl, stride);
  u32 x[8], u[8], vx2[8], xi[8], nx[8];
  slot_get(x, sl, stride, ED_T0);
  slot_get(u, sl, stride, ED_T1);
  slot_get(vx2, sl, stride, ED_T3);
  slot_get(xi, sl, stride, ED_T4);
  bool root = eq8(vx2, u);
  fe_neg(u, u);
  valid = valid && (root || eq8(vx2, u));  // v·x² = -u: x·sqrt(-1) is the root
  select8(x, root, x, xi);
  valid = valid && !(is_zero8(x) && sign);  // RFC 8032 §5.1.3 step 4
  fe_neg(nx, x);
  select8(x, (x[0] & 1u) != sign, nx, x);
  slot_put(sl, stride, ED_X, x);
  slot_put(sl, stride, ED_Z, ONE);
  return valid;
}

// The addend from table entry `e` (4 cached slots), negated if `neg`:
// -P swaps Y+X and Y-X and negates 2d·T.
DEV void ed_addend(u32* sl, int stride, int e, bool neg) {
  u32 t[8];
  slot_copy(sl, stride, ED_QP, e + (neg ? 1 : 0));
  slot_copy(sl, stride, ED_QM, e + (neg ? 0 : 1));
  slot_get(t, sl, stride, e + 2);
  if (neg) fe_neg(t, t);
  slot_put(sl, stride, ED_QT, t);
  slot_copy(sl, stride, ED_QZ, e + 3);
}

// The addend from comb entry c = |d| (rows 3c-3..3c-1: y+x, y-x, 2dxy of
// c·B, affine), negated if d < 0.
DEV void ed_comb_addend(u32* sl, int stride, const u32 (*comb)[8], int d) {
  int c = 3 * ((d < 0 ? -d : d) - 1);
  u32 t[8];
  slot_put(sl, stride, ED_QP, comb[c + (d < 0 ? 1 : 0)]);
  slot_put(sl, stride, ED_QM, comb[c + (d < 0 ? 0 : 1)]);
  copy_w<8>(t, comb[c + 2]);
  if (d < 0) fe_neg(t, t);
  slot_put(sl, stride, ED_QT, t);
}

// 32 little-endian bytes -> 8 little-endian words. On the card two 16-byte
// loads (the row is 16-byte aligned: the wrapper checks).
DEV void load_le_words(u32* w, const uint8_t* le) {
#if FISCO_PTX
  const uint4* q = reinterpret_cast<const uint4*>(le);
  uint4 lo = q[0], hi = q[1];
  w[0] = lo.x, w[1] = lo.y, w[2] = lo.z, w[3] = lo.w;
  w[4] = hi.x, w[5] = hi.y, w[6] = hi.z, w[7] = hi.w;
#else
  for (int i = 0; i < 8; i++) {
    const uint8_t* b = le + 4 * i;
    w[i] = (u32)b[0] | (u32)b[1] << 8 | (u32)b[2] << 16 | (u32)b[3] << 24;
  }
#endif
}

// One signature from its 128-byte row. comb: ED25519_COMB_ROWS x 8 words;
// `sl` is the lane's slot memory (ED25519_SLOT_WORDS words at stride
// `stride`).
DEV void ed25519_verify_lane(const uint8_t* row, const u32 (*comb)[8], u32* sl, int stride,
                             uint8_t* ok) {
  const u32 L[8] = ED25519_L, RECODE[8] = ED25519_RECODE;
  const u32 ZERO[8] = {0, 0, 0, 0, 0, 0, 0, 0}, ONE[8] = {1, 0, 0, 0, 0, 0, 0, 0};
  const u32 D[8] = ED25519_D, D2[8] = ED25519_D2, I[8] = ED25519_SQRT_M1;
  slot_put(sl, stride, ED_ONE, ONE);
  slot_put(sl, stride, ED_D, D);
  slot_put(sl, stride, ED_D2, D2);
  slot_put(sl, stride, ED_I, I);

  // s and k_neg, recoded: shift registers whose next window, less 8, is
  // the next signed digit, MSB first
  u32 ws[8], wk[8];
  load_le_words(ws, row + 32);
  bool valid = lt8(ws, L);  // the malleability guard
  add_w<8>(ws, ws, RECODE);
  load_le_words(wk, row + 96);
  add_w<8>(wk, wk, RECODE);

  // R, then A: each decompressed and cached; -R kept for the end, A left in
  // the accumulator
#pragma unroll 1
  for (int pt = 0; pt < 2; pt++) {
    u32 y[8];
    load_le_words(y, row + (pt ? 64 : 0));
    u32 sign = y[7] >> 31;
    y[7] &= 0x7FFFFFFFu;
    valid = ed_decompress(y, sign, sl, stride) && valid;
    ed_run(ED_XY_CACHE_AT, ED_XY_CACHE_LEN, sl, stride);
    if (!pt) {
      u32 t[8];
      slot_copy(sl, stride, ED_NR, ED_T1);
      slot_copy(sl, stride, ED_NR + 1, ED_T0);
      slot_get(t, sl, stride, ED_T2);
      fe_neg(t, t);
      slot_put(sl, stride, ED_NR + 2, t);
      slot_copy(sl, stride, ED_NR + 3, ED_T3);
    }
  }
  // the table c·A, c = 1..8: each entry the one before plus A
#pragma unroll 1
  for (int k = 0; k < ED25519_TAB; k++) {
    if (k) ed_run(ED_ADD_AT, ED_ADD_CACHE_LEN, sl, stride);
#pragma unroll 1
    for (int j = 0; j < 4; j++) {
      slot_copy(sl, stride, ED_TAB + 4 * k + j, ED_T0 + j);
      if (!k) slot_copy(sl, stride, ED_QP + j, ED_T0 + j);
    }
  }
  slot_put(sl, stride, ED_X, ZERO);
  slot_put(sl, stride, ED_Y, ONE);
  slot_put(sl, stride, ED_Z, ONE);
  slot_put(sl, stride, ED_T, ZERO);

  // 64 windows, MSB first: 4 doublings (none in the first window, where the
  // accumulator is still the identity; the last writes T), then the A digit
  // from the table and the B digit from the comb; a digit of 0 skips its
  // addition. One call site of fop_run for every step.
#pragma unroll 1
  for (int i = ED25519_WINDOWS - 1; i >= 0; i--) {
    int dk = (int)win_next<8>(wk) - 8, ds = (int)win_next<8>(ws) - 8;
#pragma unroll 1
    for (int step = 0; step < 6; step++) {
      int at = ED_DBL_AT, len;
      if (step < 4) {
        if (i == ED25519_WINDOWS - 1) continue;
        len = step == 3 ? ED_DBL_T_LEN : ED_DBL_LEN;
      } else if (step == 4) {
        if (!dk) continue;
        ed_addend(sl, stride, ED_TAB + 4 * ((dk < 0 ? -dk : dk) - 1), dk < 0);
        at = ED_ADD_AT, len = ED_ADD_LEN;
      } else {
        if (!ds) continue;
        ed_comb_addend(sl, stride, comb, ds);
        at = ED_MADD_AT, len = ED_MADD_LEN;
      }
      ed_run(at, len, sl, stride);
    }
  }

  // + (-R), then the cofactor: 3 doublings
#pragma unroll 1
  for (int j = 0; j < 4; j++) slot_copy(sl, stride, ED_QP + j, ED_NR + j);
#pragma unroll 1
  for (int step = 0; step < 4; step++)
    ed_run(step ? ED_DBL_AT : ED_ADD_AT, step ? ED_DBL_LEN : ED_ADD_LEN, sl, stride);
  u32 x[8], y[8], z[8];
  slot_get(x, sl, stride, ED_X);
  slot_get(y, sl, stride, ED_Y);
  slot_get(z, sl, stride, ED_Z);
  *ok = valid && is_zero8(x) && eq8(y, z);
}

#ifdef __CUDACC__

// One warp a block: 10,240 lanes make 320 blocks, which reach all 132 SMs;
// 57,344 + 768 B of shared memory a block, three blocks a SM.
#define ED25519_THREADS 32
#define ED25519_SMEM_BYTES (ED25519_SLOT_WORDS * 4 * ED25519_THREADS)

__global__ void __launch_bounds__(ED25519_THREADS, 1)
ed25519_verify_kernel(const uint8_t* __restrict__ rows, const u32* __restrict__ comb,
                      uint8_t* __restrict__ ok, int n) {
  // every thread reads a different comb row: shared memory, not __constant__
  __shared__ u32 s_comb[ED25519_COMB_ROWS][8];
  extern __shared__ uint4 s_slots[];  // the lanes' slots, lane-minor quads
  for (int i = threadIdx.x; i < ED25519_COMB_ROWS * 8; i += blockDim.x) s_comb[i >> 3][i & 7] = comb[i];
  __syncthreads();
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  ed25519_verify_lane(rows + (size_t)ED25519_ROW_BYTES * lane, s_comb,
                      reinterpret_cast<u32*>(s_slots + threadIdx.x), ED25519_THREADS, ok + lane);
}

// Launch geometry for n lanes: threads a block, blocks, dynamic shared bytes.
extern "C" void ed25519_verify_geometry(int n, int* out) {
  out[0] = ED25519_THREADS;
  out[1] = (n + ED25519_THREADS - 1) / ED25519_THREADS;
  out[2] = ED25519_SMEM_BYTES;
}

// C entry point for ctypes: launches on `stream` of `device`, does not
// synchronise; returns the first CUDA error (0 on success).
extern "C" int ed25519_verify_launch(const void* rows, const void* comb, void* ok, int n,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  err = cudaFuncSetAttribute(ed25519_verify_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ED25519_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ed25519_verify_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  int geo[3];
  ed25519_verify_geometry(n, geo);
  ed25519_verify_kernel<<<geo[1], geo[0], geo[2], (cudaStream_t)stream>>>(
      (const uint8_t*)rows, (const u32*)comb, (uint8_t*)ok, n);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
