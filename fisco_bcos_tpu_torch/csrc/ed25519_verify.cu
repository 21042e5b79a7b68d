// Ed25519 signature verification (RFC 8032, cofactored), four lanes a
// signature, for sm_90a.
//
// Replaces the JAX program `_verify_xla` (fisco_bcos_tpu/ops/ed25519.py:286,
// on `verify_core` :230), which the JAX package ran as one fused jitted
// program (it has no Pallas kernel). The plain PyTorch version is
// fisco_bcos_tpu_torch/ops/ed25519.py verify_core.
//
// Per lane, one 128-byte row R ‖ S ‖ A ‖ k_neg, 32 little-endian bytes each
// (k_neg = (L − k) mod L, the challenge k = SHA-512(R ‖ A ‖ M) mod L, which
// csrc/ed25519_challenge.cu writes into the row on the card) -> ok:
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
//   - the addend in the cached form (Y+X, Y−X, 2d·T, 2Z).
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
// residue. A sum and a difference share one code path (a − b = a + (p − b)).
//
// What bounds it on an H100: 32-bit integer multiply issue, as for the other
// EC kernels; the bytes (128 B in, 1 B out a signature) are negligible. One
// warp's instruction stream sets the time (PERF.md §6): one thread a
// signature took as long for 4 signatures as for 10,240. So a quad of four
// lanes shares each signature, to cut the length of a signature's stream.
// Hisil, Wong, Carter and Dawson's extended law (2008, §4, the
// 4-processor formulas) splits every point operation into rows of four
// independent field ops: lane j of the quad runs op j of a row, then the
// warp syncs. Every quad of a warp runs every step (a digit of 0 adds the
// identity, and a block's quads past the batch run on its last row), so
// the warp stays converged and syncs whole: __syncwarp() costs a fraction
// of a sync on a quad's own mask (PERF.md §6):
//   doubling   X², Y², Z², (X+Y)² | H, G, 2Z² | E, F | E·F, G·H, F·G, E·H
//   addition   Y−X, Y+X (and 2Z, mixed) | (Y−X)·QM, (Y+X)·QP, T·QT, Z·QZ |
//              E, F, G, H | E·F, G·H, F·G, E·H
// so a doubling is 2 rows of products and an addition 2 (T is always
// written: the fourth product of a row is free); decompression runs the
// exponentiation chains of A and R side by side on lanes 0 and 1, each
// lane reading only what it wrote, with no sync between rows. A
// signature's chain falls from ~3,400 products to ~1,060 rows of products.
// Every row of every program runs through one call site of fop_run, so the
// ladder's loop body holds one copy of the field ops and stays in the
// instruction cache. Every op of a row is of one kind where the row allows
// it (a warp runs a row's kinds one after another): a lane with nothing to
// do runs the row's kind on a sink slot, and the doubling's X + Y is formed
// by the lane that squares it. What a row costs beyond its field op (its
// load, the slots, the sync) is measured by chip_smoke.py's field bench.
//
// Layout: a block is one warp, 8 signatures. Lane t of the block serves
// signature t % 8 as quad lane t / 8: a quarter-warp (8 consecutive lanes,
// served together by a 16-byte shared load) holds one quad lane of all 8
// signatures. A signature's 58 slots lie signature-minor, quad q of slot s
// of signature g at 16-byte index (2s + q)·8 + g, so a quarter-warp reading
// one slot of its 8 signatures covers all 32 banks once (the 4 quad lanes
// reading 4 different slots are 4 quarter-warps): no bank conflict. 1,856 B
// a signature, 14,848 + 768 B a block; 10,240 signatures are 1,280 blocks,
// all resident (about 14 a SM by shared memory).
//
// The arithmetic compiles as host C++ too (no __CUDACC__), where a quad runs
// as four lanes one after another (ED_QUAD_FOR): the programs' rows carry no
// hazard between their lanes (the tests walk every row), so the order of a
// row's ops does not matter. Only the kernel, its C entry points, the
// program's load and the warp's syncs are CUDA-specific.

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

// One warp a block; a quad of its lanes a signature.
#define ED25519_THREADS 32
#define ED25519_SIGS (ED25519_THREADS / 4)

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

// a + b, or a − b as a + (p − b), mod p for canonical a, b: one path for
// both, so the lanes of a row of sums and differences do not diverge. For
// b = 0, p − b = p and the sum's one subtract of p still gives a.
DEV void fe_add_or_sub(u32* r, const u32* a, const u32* b, bool sub) {
  const u32 P[8] = ED25519_P;
  u32 nb[8];
  sub8(nb, P, b);
  select8(nb, sub, nb, b);
  add_mod(r, a, nb, P);
}

// One more kind of op: (a + b)², the doubling's (X + Y)², so the lane that
// squares it forms X + Y itself, in the row of squarings.
enum { ED_F_ADDSQR = F_SMALL + 1 };

// Ed25519's field ops for fop_run. A squaring and (a + b)² share the
// squaring's code; only the sum before it diverges.
struct Ed25519Field {
  DEV_MEMBER void op(u32 kind, u32* r, const u32* a, const u32* b) {
    switch (kind) {
      case F_MUL: fe_mul(r, a, b); break;
      case F_SQR:
      case ED_F_ADDSQR: {
        u32 t[8];
        copy_w<8>(t, a);
        if (kind == ED_F_ADDSQR) fe_add(t, a, b);
        fe_sqr(r, t);
        break;
      }
      default: fe_add_or_sub(r, a, b, kind == F_SUB); break;
    }
  }
};

// ---------------------------------------------------------------------------
// The quad
// ---------------------------------------------------------------------------

// ED_QUAD_FOR(j) { ... } runs its body as quad lane j: on the card once, for
// this lane's j; on the host for j = 0..3 in turn. A body holds no sync.
// ed_sync: the whole warp, which runs every step of every quad together.
#if FISCO_PTX
DEV int ed_quad_lane() { return (int)(threadIdx.x / ED25519_SIGS); }
DEV void ed_sync() { __syncwarp(); }
DEV bool ed_quad_all(bool v) { return __all_sync(0x01010101u << (threadIdx.x % ED25519_SIGS), v); }
#define ED_QUAD_FOR(j) for (int j = ed_quad_lane(), j##_end = j + 1; j < j##_end; j++)
#else
DEV void ed_sync() {}
DEV bool ed_quad_all(bool v) { return v; }  // the host's lanes share their variables
#define ED_QUAD_FOR(j) for (int j = 0; j < 4; j++)
#endif

// ---------------------------------------------------------------------------
// Slots and the field-op programs
// ---------------------------------------------------------------------------

// A signature's slots: the accumulator, the addend, four constants, eight
// temporaries, two sinks, -R and the table of A, cached. While A and R decompress, R's
// chain works in the table's slots (ED_R*), free until the table is built.
enum {
  ED_X, ED_Y, ED_Z, ED_T,      // the accumulator, extended (X : Y : Z : T)
  ED_QP, ED_QM, ED_QT, ED_QZ,  // the addend, cached: Y+X, Y-X, 2d·T, 2Z
  ED_ONE, ED_D, ED_D2, ED_I,   // 1, d, 2d, sqrt(-1)
  ED_T0, ED_T1, ED_T2, ED_T3, ED_T4, ED_T5, ED_T6, ED_T7,
  ED_S0, ED_S1,                // sinks: where a lane with no op of its own in a row writes
  ED_NR,                       // -R, cached (4 slots)
  ED_TAB = ED_NR + 4,          // c·A, cached, c = 1..ED25519_TAB (4 slots each)
  ED25519_SLOTS = ED_TAB + 4 * ED25519_TAB,
  // R's decompression: y, the chain's temporaries, then -x and -x·y
  ED_RY = ED_TAB, ED_RT0, ED_RT1, ED_RT2, ED_RT3, ED_RT4, ED_RT5, ED_RT6, ED_RX, ED_RXY,
  ED_RONE = ED_ONE, ED_RD = ED_D, ED_RI = ED_I,  // the constants both chains read
};
#define ED25519_SLOT_WORDS (ED25519_SLOTS * 8)

// A lane with no op of its own in a row runs the row's kind of op on a
// sink slot, so a row runs one code path (a lane that skips its op makes
// the warp diverge, and costs more than the op it skips).
#define ED_SINK(k, s) FOP(k, s, s, s)

// A row: quad lane j runs op[j].
struct EdRow {
  u32 op[4];
};

// dbl-2008-hwcd (a = -1): A = X², B = Y², C = 2Z², H = A + B,
// E = H - (X+Y)², G = A - B, F = C + G; (E·F, G·H, F·G, E·H).
#define ED_DBL_ROWS                                                              \
  FOP(F_SQR, ED_T0, ED_X, ED_X), FOP(F_SQR, ED_T1, ED_Y, ED_Y),                   \
      FOP(F_SQR, ED_T2, ED_Z, ED_Z), FOP(ED_F_ADDSQR, ED_T3, ED_X, ED_Y),         \
      FOP(F_ADD, ED_T4, ED_T0, ED_T1), FOP(F_SUB, ED_T5, ED_T0, ED_T1),           \
      FOP(F_ADD, ED_T2, ED_T2, ED_T2), ED_SINK(F_ADD, ED_S1),                     \
      FOP(F_SUB, ED_T6, ED_T4, ED_T3), FOP(F_ADD, ED_T7, ED_T2, ED_T5),           \
      ED_SINK(F_ADD, ED_S0), ED_SINK(F_ADD, ED_S1),                               \
      ED_PRODUCTS_ROW(ED_T6, ED_T7, ED_T5, ED_T4)

// The last row of both laws: (E·F, G·H, F·G, E·H).
#define ED_PRODUCTS_ROW(e, f, g, h)                                              \
  FOP(F_MUL, ED_X, e, f), FOP(F_MUL, ED_Y, g, h), FOP(F_MUL, ED_Z, f, g),         \
      FOP(F_MUL, ED_T, e, h)

// add-2008-hwcd-3 with the cached addend: A = (Y-X)·QM, B = (Y+X)·QP,
// C = T·QT, D = Z·QZ (the mixed form: 2Z, the comb's Z being 1); E = B - A,
// F = D - C, G = D + C, H = B + A; (E·F, G·H, F·G, E·H).
#define ED_ADD_TAIL                                                              \
  FOP(F_SUB, ED_T4, ED_T1, ED_T0), FOP(F_SUB, ED_T5, ED_T3, ED_T2),               \
      FOP(F_ADD, ED_T6, ED_T3, ED_T2), FOP(F_ADD, ED_T7, ED_T1, ED_T0),           \
      ED_PRODUCTS_ROW(ED_T4, ED_T5, ED_T6, ED_T7)
#define ED_ADD_ROWS                                                              \
  FOP(F_SUB, ED_T0, ED_Y, ED_X), FOP(F_ADD, ED_T1, ED_Y, ED_X),                   \
      ED_SINK(F_ADD, ED_S0), ED_SINK(F_ADD, ED_S1),                               \
      FOP(F_MUL, ED_T0, ED_T0, ED_QM), FOP(F_MUL, ED_T1, ED_T1, ED_QP),           \
      FOP(F_MUL, ED_T2, ED_T, ED_QT), FOP(F_MUL, ED_T3, ED_Z, ED_QZ), ED_ADD_TAIL
#define ED_MADD_ROWS                                                             \
  FOP(F_SUB, ED_T0, ED_Y, ED_X), FOP(F_ADD, ED_T1, ED_Y, ED_X),                   \
      ED_SINK(F_ADD, ED_S0), FOP(F_ADD, ED_T3, ED_Z, ED_Z),                       \
      FOP(F_MUL, ED_T0, ED_T0, ED_QM), FOP(F_MUL, ED_T1, ED_T1, ED_QP),           \
      FOP(F_MUL, ED_T2, ED_T, ED_QT), ED_SINK(F_MUL, ED_S1), ED_ADD_TAIL

// The accumulator's cached form into table entry k (0-based, k > 0: entry
// 0 is A's, copied from the addend): Y+X, Y-X, 2d·T, 2Z, one row.
#define ED_CACHE_ROW(k)                                                          \
  FOP(F_ADD, ED_TAB + 4 * (k), ED_Y, ED_X), FOP(F_SUB, ED_TAB + 4 * (k) + 1, ED_Y, ED_X), \
      FOP(F_MUL, ED_TAB + 4 * (k) + 2, ED_T, ED_D2), FOP(F_ADD, ED_TAB + 4 * (k) + 3, ED_Z, ED_Z)

// After decompression, A's T = x·y and its cached form into the addend (2Z
// = 2 set by the fix-up), -R = (-x, y) cached into ED_NR (2 likewise).
#define ED_PAIR_CACHE_ROWS                                                       \
  FOP(F_MUL, ED_T, ED_X, ED_Y), FOP(F_MUL, ED_RXY, ED_RX, ED_RY),                 \
      FOP(F_ADD, ED_QP, ED_Y, ED_X), FOP(F_SUB, ED_QM, ED_Y, ED_X),               \
      FOP(F_MUL, ED_QT, ED_T, ED_D2), FOP(F_MUL, ED_NR + 2, ED_RXY, ED_D2),       \
      FOP(F_ADD, ED_NR, ED_RY, ED_RX), FOP(F_SUB, ED_NR + 1, ED_RY, ED_RX)

// One op of the decompression chain for both points: A's on quad lane 0
// (slots ED_Y, ED_T0..), R's on lane 1 (ED_RY, ED_RT0..); lanes 2-3 on
// the sinks. Each lane reads only what it wrote itself, so the program
// runs with no sync between its rows (ed_run<false>).
#define ED_DEC(k, d, a, b)                                                 \
  FOP(k, ED_##d, ED_##a, ED_##b), FOP(k, ED_R##d, ED_R##a, ED_R##b),      \
      ED_SINK(k, ED_S0), ED_SINK(k, ED_S1)

// Runs of squarings in place.
#define ED_SQR1(s) ED_DEC(F_SQR, s, s, s)
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

// Decompression of y (Y): u = y² - 1 (T1), v = d·y² + 1 (T2), v³ (T3),
// w = u·v⁷ (T4), w^((p-5)/8) = w^(2^252 - 3) by the addition chain of
// 251 squarings and 11 products (t0 = T0, t1 = T5, t2 = T6), then
// x = u·v³·w^((p-5)/8) (T0), v·x² (T3) and x·sqrt(-1) (T4).
#define ED_DECOMP_ROWS                                                           \
  ED_DEC(F_SQR, T1, Y, Y), ED_DEC(F_MUL, T2, T1, D),                              \
      ED_DEC(F_SUB, T1, T1, ONE), ED_DEC(F_ADD, T2, T2, ONE),                     \
      ED_DEC(F_SQR, T3, T2, T2),                                                  \
      ED_DEC(F_MUL, T3, T3, T2), ED_DEC(F_SQR, T4, T3, T3),                       \
      ED_DEC(F_MUL, T4, T4, T2), ED_DEC(F_MUL, T4, T4, T1),                       \
      ED_DEC(F_SQR, T0, T4, T4),                            /* w^2 */             \
      ED_DEC(F_SQR, T5, T0, T0), ED_SQR1(T5),               /* w^8 */             \
      ED_DEC(F_MUL, T5, T4, T5),                            /* w^9 */             \
      ED_DEC(F_MUL, T0, T0, T5), ED_SQR1(T0),               /* w^22 */            \
      ED_DEC(F_MUL, T0, T5, T0),                            /* 2^5 - 1 */         \
      ED_DEC(F_SQR, T5, T0, T0), ED_SQR4(T5),                                     \
      ED_DEC(F_MUL, T0, T5, T0),                            /* 2^10 - 1 */        \
      ED_DEC(F_SQR, T5, T0, T0), ED_SQR9(T5),                                     \
      ED_DEC(F_MUL, T5, T5, T0),                            /* 2^20 - 1 */        \
      ED_DEC(F_SQR, T6, T5, T5), ED_SQR19(T6),                                    \
      ED_DEC(F_MUL, T5, T6, T5),                            /* 2^40 - 1 */        \
      ED_SQR10(T5), ED_DEC(F_MUL, T0, T5, T0),              /* 2^50 - 1 */        \
      ED_DEC(F_SQR, T5, T0, T0), ED_SQR49(T5),                                    \
      ED_DEC(F_MUL, T5, T5, T0),                            /* 2^100 - 1 */       \
      ED_DEC(F_SQR, T6, T5, T5), ED_SQR99(T6),                                    \
      ED_DEC(F_MUL, T5, T6, T5),                            /* 2^200 - 1 */       \
      ED_SQR50(T5), ED_DEC(F_MUL, T0, T5, T0),              /* 2^250 - 1 */       \
      ED_SQR2(T0), ED_DEC(F_MUL, T0, T0, T4),               /* 2^252 - 3 */       \
      ED_DEC(F_MUL, T0, T0, T3), ED_DEC(F_MUL, T0, T0, T1),                       \
      ED_DEC(F_SQR, T3, T0, T0), ED_DEC(F_MUL, T3, T3, T2),                       \
      ED_DEC(F_MUL, T4, T0, I)

template <class... Ops>
constexpr int ed_rows(Ops...) {
  static_assert(sizeof...(Ops) % 4 == 0, "a program is whole rows");
  return (int)sizeof...(Ops) / 4;
}

// Every program in one constant array of rows, each at its row offset: a
// program is picked by an offset, never by a pointer.
enum {
  ED_DBL_AT = 0,
  ED_DBL_LEN = ed_rows(ED_DBL_ROWS),
  ED_ADD_AT = ED_DBL_AT + ED_DBL_LEN,
  ED_ADD_LEN = ed_rows(ED_ADD_ROWS),
  ED_MADD_AT = ED_ADD_AT + ED_ADD_LEN,
  ED_MADD_LEN = ed_rows(ED_MADD_ROWS),
  ED_CACHE_AT = ED_MADD_AT + ED_MADD_LEN,  // row k - 1: table entry k
  ED_PAIR_CACHE_AT = ED_CACHE_AT + ED25519_TAB - 1,
  ED_PAIR_CACHE_LEN = ed_rows(ED_PAIR_CACHE_ROWS),
  ED_DECOMP_AT = ED_PAIR_CACHE_AT + ED_PAIR_CACHE_LEN,
  ED_DECOMP_LEN = ed_rows(ED_DECOMP_ROWS),
  ED_PROG_ROWS = ED_DECOMP_AT + ED_DECOMP_LEN,
};
// In global memory, read through the read-only cache: a warp's four
// addresses (one a quad lane) lie in one 16-byte row, one load for the
// warp; from __constant__ memory they cost four.
#if FISCO_PTX
__device__ const EdRow ED_PROGS[] = {
#else
static const EdRow ED_PROGS[] = {
#endif
    ED_DBL_ROWS,
    ED_ADD_ROWS,
    ED_MADD_ROWS,
    ED_CACHE_ROW(1), ED_CACHE_ROW(2), ED_CACHE_ROW(3), ED_CACHE_ROW(4),
    ED_CACHE_ROW(5), ED_CACHE_ROW(6), ED_CACHE_ROW(7),
    ED_PAIR_CACHE_ROWS,
    ED_DECOMP_ROWS,
};
static_assert(sizeof(ED_PROGS) / sizeof(EdRow) == ED_PROG_ROWS, "program offsets");

// Op j of row r, each lane its own.
DEV u32 ed_op(int r, int j) {
#if FISCO_PTX
  return __ldg(&ED_PROGS[r].op[j]);
#else
  return ED_PROGS[r].op[j];
#endif
}

// Runs `len` rows of the programs from row `at` over a signature's slots:
// quad lane j runs op j of each row, then the warp syncs (with SYNC false,
// not: for a program whose lanes read only what they wrote, which the
// tests check).
template <bool SYNC = true>
DEV void ed_run(int at, int len, u32* sl, int stride) {
#pragma unroll 1
  for (int r = at; r < at + len; r++) {
    ED_QUAD_FOR(j) {
      const u32 op = ed_op(r, j);
      fop_run<Ed25519Field>(&op, 1, sl, stride);
    }
    if (SYNC) ed_sync();
  }
}

// ---------------------------------------------------------------------------
// Decompression, the ladder, one signature
// ---------------------------------------------------------------------------

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

// A point's encoding, pt 0 = A (row bytes 64..95), pt 1 = R (bytes 0..31):
// y with the sign bit taken off, and the sign.
DEV u32 ed_point_y(u32* y, const uint8_t* row, int pt) {
  load_le_words(y, row + (pt ? 0 : 64));
  u32 sign = y[7] >> 31;
  y[7] &= 0x7FFFFFFFu;
  return sign;
}

// A and R decompressed side by side, A on quad lane 0 into the accumulator
// (x, y, 1, x·y) and the addend (its cached form), R on lane 1 into ED_NR
// as -R, cached. Returns, on every lane of the quad, whether both
// encodings are points: y < p, v·x² = ±u, and not x = 0 with sign 1. Any
// row is safe.
DEV bool ed_decompress_pair(const uint8_t* row, u32* sl, int stride) {
  const u32 P[8] = ED25519_P, ONE[8] = {1, 0, 0, 0, 0, 0, 0, 0}, TWO[8] = {2, 0, 0, 0, 0, 0, 0, 0};
  bool valid = true;
  ED_QUAD_FOR(j) {
    if (j < 2) {
      u32 y[8];
      ed_point_y(y, row, j);
      slot_put(sl, stride, j ? ED_RY : ED_Y, y);
    }
  }
  ed_sync();
  ed_run<false>(ED_DECOMP_AT, ED_DECOMP_LEN, sl, stride);  // lane-local: no sync
  ED_QUAD_FOR(j) {
    if (j < 2) {  // the root and its sign (lane-local too); R's x is stored negated
      const int t0 = j ? ED_RT0 : ED_T0;
      u32 y[8], x[8], u[8], vx2[8], xi[8], nx[8];
      u32 sign = ed_point_y(y, row, j);
      valid = valid && lt8(y, P);
      slot_get(x, sl, stride, t0);
      slot_get(u, sl, stride, t0 + 1);
      slot_get(vx2, sl, stride, t0 + 3);
      slot_get(xi, sl, stride, t0 + 4);
      bool root = eq8(vx2, u);
      fe_neg(u, u);
      valid = valid && (root || eq8(vx2, u));  // v·x² = -u: x·sqrt(-1) is the root
      select8(x, root, x, xi);
      valid = valid && !(is_zero8(x) && sign);  // RFC 8032 §5.1.3 step 4
      fe_neg(nx, x);
      select8(x, ((x[0] & 1u) != sign) != (j == 1), nx, x);
      slot_put(sl, stride, j ? ED_RX : ED_X, x);
    } else if (j == 2) {
      slot_put(sl, stride, ED_Z, ONE);
    } else {
      slot_put(sl, stride, ED_QZ, TWO);
      slot_put(sl, stride, ED_NR + 3, TWO);
    }
  }
  ed_sync();
  ed_run(ED_PAIR_CACHE_AT, ED_PAIR_CACHE_LEN, sl, stride);
  return ed_quad_all(valid);
}

// The identity's cached words, slot j of (Y+X, Y-X, 2d·T, 2Z) = (1, 1, 0,
// 2): t = that, where `zero`.
DEV void ed_identity_if(u32* t, int j, bool zero) {
  t[0] = zero ? (j == 2 ? 0u : j == 3 ? 2u : 1u) : t[0];
#pragma unroll
  for (int k = 1; k < 8; k++) t[k] = zero ? 0u : t[k];
}

// Four slots from `src` on into the addend, quad lane j the j-th, negated
// if `neg`: -P swaps Y+X and Y-X and negates 2d·T; the identity if `zero`.
DEV void ed_addend(u32* sl, int stride, int src, bool neg, bool zero = false) {
  ED_QUAD_FOR(j) {
    u32 t[8];
    slot_get(t, sl, stride, src + (j < 2 ? j ^ (int)neg : j));
    if (j == 2 && neg) fe_neg(t, t);
    ed_identity_if(t, j, zero);
    slot_put(sl, stride, ED_QP + j, t);
  }
  ed_sync();
}

// The addend for table digit d in [-8, 7]: entry |d| of c·A, negated if
// d < 0; the identity if d = 0.
DEV void ed_table_addend(u32* sl, int stride, int d) {
  const int c = d < 0 ? -d : d;
  ed_addend(sl, stride, ED_TAB + 4 * (c ? c - 1 : 0), d < 0, !d);
}

// The addend from comb entry c = |d| (rows 3c-3..3c-1: y+x, y-x, 2dxy of
// c·B, affine), negated if d < 0, the identity's (1, 1, 0) if d = 0, on
// quad lanes 0-2.
DEV void ed_comb_addend(u32* sl, int stride, const u32 (*comb)[8], int d) {
  const int c = d < 0 ? -d : d;
  ED_QUAD_FOR(j) {
    if (j < 3) {
      u32 t[8];
      copy_w<8>(t, comb[3 * (c ? c - 1 : 0) + (j < 2 ? j ^ (int)(d < 0) : j)]);
      if (j == 2 && d < 0) fe_neg(t, t);
      ed_identity_if(t, j, !d);
      slot_put(sl, stride, ED_QP + j, t);
    }
  }
  ed_sync();
}

// One signature from its 128-byte row, on the four lanes of a quad (all of
// them on the host). comb: ED25519_COMB_ROWS x 8 words; `sl` is the
// signature's slot memory (ED25519_SLOT_WORDS words at stride `stride`);
// the verdict goes to *ok unless ok is null.
DEV void ed25519_verify_lane(const uint8_t* row, const u32 (*comb)[8], u32* sl, int stride,
                             uint8_t* ok) {
  const u32 L[8] = ED25519_L, RECODE[8] = ED25519_RECODE;
  const u32 ZERO[8] = {0, 0, 0, 0, 0, 0, 0, 0}, ONE[8] = {1, 0, 0, 0, 0, 0, 0, 0};
  const u32 D[8] = ED25519_D, D2[8] = ED25519_D2, I[8] = ED25519_SQRT_M1;
  ED_QUAD_FOR(j) {  // constants picked by branch, not by pointer: no array on the stack
    if (j == 0) slot_put(sl, stride, ED_ONE, ONE);
    else if (j == 1) slot_put(sl, stride, ED_D, D);
    else if (j == 2) slot_put(sl, stride, ED_D2, D2);
    else slot_put(sl, stride, ED_I, I);
    if (j < 2) slot_put(sl, stride, ED_S0 + j, ZERO);  // the sinks hold values too
  }

  // s and k_neg, recoded: shift registers whose next window, less 8, is
  // the next signed digit, MSB first (each lane of the quad keeps its copy)
  u32 ws[8], wk[8];
  load_le_words(ws, row + 32);
  bool valid = lt8(ws, L);  // the malleability guard
  add_w<8>(ws, ws, RECODE);
  load_le_words(wk, row + 96);
  add_w<8>(wk, wk, RECODE);

  // A and R; then the table c·A, c = 1..8, each entry the one before plus A
  // (the addend), and the accumulator reset to the identity
  ed_sync();
  valid = ed_decompress_pair(row, sl, stride) && valid;
  ED_QUAD_FOR(j) slot_copy(sl, stride, ED_TAB + j, ED_QP + j);  // A, cached
  ed_sync();
#pragma unroll 1
  for (int k = 1; k < ED25519_TAB; k++) {
    ed_run(ED_ADD_AT, ED_ADD_LEN, sl, stride);
    ed_run(ED_CACHE_AT + k - 1, 1, sl, stride);
  }
  ED_QUAD_FOR(j) {
    if (j == 1 || j == 2) slot_put(sl, stride, ED_X + j, ONE);
    else slot_put(sl, stride, ED_X + j, ZERO);
  }
  ed_sync();

  // 64 windows, MSB first: 4 doublings (none in the first window, where the
  // accumulator is still the identity), then the A digit from the table and
  // the B digit from the comb; a digit of 0 adds the identity, so every
  // quad of the warp runs every step. One call site of fop_run for every
  // step.
#pragma unroll 1
  for (int i = ED25519_WINDOWS - 1; i >= 0; i--) {
    int dk = (int)win_next<8>(wk) - 8, ds = (int)win_next<8>(ws) - 8;
#pragma unroll 1
    for (int step = i == ED25519_WINDOWS - 1 ? 4 : 0; step < 6; step++) {
      int at = ED_DBL_AT, len = ED_DBL_LEN;
      if (step == 4) {
        ed_table_addend(sl, stride, dk);
        at = ED_ADD_AT, len = ED_ADD_LEN;
      } else if (step == 5) {
        ed_comb_addend(sl, stride, comb, ds);
        at = ED_MADD_AT, len = ED_MADD_LEN;
      }
      ed_run(at, len, sl, stride);
    }
  }

  // + (-R), then the cofactor: 3 doublings
  ed_addend(sl, stride, ED_NR, false);
#pragma unroll 1
  for (int step = 0; step < 4; step++)
    ed_run(step ? ED_DBL_AT : ED_ADD_AT, step ? ED_DBL_LEN : ED_ADD_LEN, sl, stride);
  u32 x[8], y[8], z[8];
  slot_get(x, sl, stride, ED_X);
  slot_get(y, sl, stride, ED_Y);
  slot_get(z, sl, stride, ED_Z);
  ED_QUAD_FOR(j) {
    if (j == 0 && ok) *ok = valid && is_zero8(x) && eq8(y, z);
  }
}

#ifdef __CUDACC__

// One warp a block, 8 signatures: 10,240 lanes make 1,280 blocks, all
// resident at once; 14,848 + 768 B of shared memory a block.
#define ED25519_SMEM_BYTES (ED25519_SLOT_WORDS * 4 * ED25519_SIGS)

__global__ void __launch_bounds__(ED25519_THREADS, 1)
ed25519_verify_kernel(const uint8_t* __restrict__ rows, const u32* __restrict__ comb,
                      uint8_t* __restrict__ ok, int n) {
  // every quad reads a different comb row: shared memory, not __constant__
  __shared__ u32 s_comb[ED25519_COMB_ROWS][8];
  extern __shared__ uint4 s_slots[];  // the signatures' slots, signature-minor quads
  for (int i = threadIdx.x; i < ED25519_COMB_ROWS * 8; i += blockDim.x) s_comb[i >> 3][i & 7] = comb[i];
  __syncthreads();
  const int g = threadIdx.x % ED25519_SIGS;
  const int sig = blockIdx.x * ED25519_SIGS + g;
  // a quad past the batch runs on its last row, so the whole warp runs
  // every step, and writes no verdict
  ed25519_verify_lane(rows + (size_t)ED25519_ROW_BYTES * (sig < n ? sig : n - 1), s_comb,
                      reinterpret_cast<u32*>(s_slots + g), ED25519_SIGS, sig < n ? ok + sig : nullptr);
}

// Launch geometry for n signatures: threads a block, blocks, dynamic shared
// bytes.
extern "C" void ed25519_verify_geometry(int n, int* out) {
  out[0] = ED25519_THREADS;
  out[1] = (n + ED25519_SIGS - 1) / ED25519_SIGS;
  out[2] = ED25519_SMEM_BYTES;
}

// Blocks of the kernel resident on one SM at once (the occupancy API, with
// the launch's shared memory), or -1 on an error.
extern "C" int ed25519_verify_resident_blocks(int device) {
  int blocks = -1;
  if (cudaSetDevice(device) != cudaSuccess ||
      cudaFuncSetAttribute(ed25519_verify_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           ED25519_SMEM_BYTES) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ed25519_verify_kernel,
                                                    ED25519_THREADS, ED25519_SMEM_BYTES) != cudaSuccess)
    return -1;
  return blocks;
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
