// Batch Poseidon over the BN254 scalar field on the H100: four lanes a
// message, the packed form of the hash kernels (a packed batch: one byte
// buffer, int64 starts, int32 lengths) in, [B, 32] big-endian digests out.
//
// Replaces the JAX package's poseidon_blocks (fisco_bcos_tpu/ops/poseidon.py
// :127), a jitted lax.scan of 65 uniform rounds over blocks padded and
// Montgomery-encoded on the host, which the TPU ran outside any Pallas
// kernel; the port's plain version is poseidon_packed_plain
// (ops/poseidon.py), which keeps the dense form, so the kernel is held
// against a reference computed another way. Callers: the Poseidon
// HashImpl's batch calls and merkle levels with hasher "poseidon" (the
// succinct state plane's commitment).
//
// Per message: padded in the kernel (0x01, then zeros to a 62-byte
// multiple), each 31-byte chunk read big-endian into a field element and
// encoded to the Montgomery domain by one product with R^2; the sponge
// (t = 3, rate 2) adds a block's two elements to state words 0 and 1 and
// permutes; the squeeze takes word 0 out of the Montgomery domain and writes
// its 32 bytes big-endian.
//
// The permutation runs in the instance's sparse form (eprint 2019/458,
// Appendix B; ops/poseidon.py _sparse_form derives it): round r boxes its
// words (all three in the 8 full rounds, word 0 in the 57 partial ones),
// mixes them by its matrix (dense in a full round; in a partial one
// [[a, v1, v2], [w1, 1, 0], [w2, 0, 1]]) and adds its end constants; the
// start constants come in with the block. Same output as the oracle's
// 65 dense rounds.
//
// Field: GF(FR), FR < 2^254, values as 8 little-endian 32-bit words in the
// Montgomery domain x·R mod FR (R = 2^256). A product is the 512-bit a·b
// (wide_int.cuh's rows, or its 36-product squaring) and then a generic word
// REDC with n0 = -FR^-1 mod 2^32, its steps in PTX carry chains on the card
// (chip_smoke.py's field bench: 12% fewer cycles a product than the u64
// accumulation the host build keeps). A sum of three products (a mix row)
// takes one REDC (3·FR^2 < FR·R). Every value is kept canonical.
//
// What bounds it on an H100: 32-bit integer multiplies (the bytes are a
// few per thousand multiplies). One warp's instruction stream sets how long
// a message takes, and a page tree's levels are 1,088, 68, 5 and 1
// messages wide, one after another (PERF.md §6). So the design is for a
// message's latency, in four lanes:
//   - A group of four lanes a message; group lane j holds state word j in
//     shared-memory slots. The permutation is constant programs of rows of
//     four ops, one op a lane and every op of a row of one kind (a squaring,
//     or a sum of one or three products and two addends), then a sync:
//     a full round is 3 rows of S-box products on lanes 0-2 and one row of
//     mix rows; a partial round is 3 rows: x^2, w1·x, w2·x, a·x side by
//     side, then x^4, v1·x1, v2·x2, then (a·x)·x^4, (w1·x)·x^4, (w2·x)·x^4
//     with their addends (the S-box folded into the sparse mix: 3 products
//     deep, not 4 and a row of sums). A lane with nothing to do runs the
//     row's kind on its sink slot, so the warp never diverges in a row; the
//     field bench measured a row's 8-word exchange through the slots at 59
//     cycles (55 by shuffles) against ~1,200 for a product.
//   - Lane t of a warp serves message t % 8 as group lane t / 8: a
//     quarter-warp holds one group lane of 8 messages and reads one slot of
//     each, 128 contiguous bytes, with no bank conflict.
//   - The round loop and the row loop stay rolled, so the loop body holds
//     one copy of each op kind and stays far inside the instruction cache
//     (wide_int.cuh: a body past ~90 KiB of SASS costs over twice as much an
//     instruction); the three products of a mix row are independent and
//     interleave.
//   - The warp runs the blocks of its longest message; a group past its
//     own last block absorbs zeros and has kept its digest.
//   - Geometry from the lane count (poseidon_geometry): one warp a block
//     while the launch has fewer than two warps for each of the 132 SMs, so
//     a page tree's first level (1,088 messages, 136 warps) spreads over
//     the card; up to four warps a block on wide launches, each block
//     copying the constants once.
// The price: a warp issues a row's op for 8 messages where one thread a
// message issued it for 32, about twice the instructions a message. A
// message takes half the time it took in one thread, but from two warps a
// scheduler on (10,240 messages) the card's issue rate bounds the launch,
// and on 40,960 one-block messages the kernel is slower than one thread a
// message was (PERF.md §6).
//
// Constants: nothing of the instance is written here. The wrapper passes
// one int32 table (ops/poseidon.py kernel_table, derived at import from the
// Grain LFSR and the Cauchy MDS and re-asserted there against the oracle):
// FR, n0, zero, R^2, the start constants and, a round, its end constants and
// its mix, and a full-round flag a round. A block copies it into shared
// memory; the lanes of a quarter-warp read one value at once, a broadcast.
//
// The arithmetic compiles as host C++ too (no __CUDACC__), where a group
// runs as four lanes one after another (PS_LANE_FOR): the programs' rows
// carry no hazard between their lanes (the tests walk every row), so the
// order of a row's ops does not matter. The tier-1 tests build it with g++
// and hold it against Python integers and the oracle.

#include "wide_int.cuh"

#define POSEIDON_T 3
#define POSEIDON_RATE 2
#define POSEIDON_ROUNDS 65
#define POSEIDON_CHUNK 31
#define POSEIDON_BLOCK_BYTES (POSEIDON_RATE * POSEIDON_CHUNK)
#define POSEIDON_GROUP 4                               // lanes a message
#define POSEIDON_WARP_MSGS (32 / POSEIDON_GROUP)       // messages a warp
#define POSEIDON_MAX_WARPS 4                           // warps a block, at most
#define POSEIDON_SMS 132                               // the H100 SXM's

// The table's layout in 32-bit words (ops/poseidon.py kernel_table builds it)
enum {
  PT_FR = 0,                                   // FR
  PT_N0 = 8,                                   // -FR^-1 mod 2^32, then 7 zero words
  PT_ZERO = 16,                                // 0
  PT_R2 = 24,                                  // R^2 mod FR
  PT_START = 32,                               // [3] start constants, Montgomery domain
  PT_ROUNDS = PT_START + POSEIDON_T * 8,       // [65] blocks, Montgomery domain:
  PT_ROUND_WORDS = (POSEIDON_T + POSEIDON_T * POSEIDON_T) * 8,  // end constants [3], mix [3][3]
  PT_FULL = PT_ROUNDS + POSEIDON_ROUNDS * PT_ROUND_WORDS,     // [65]: 1 in a full round, else 0
  PT_WORDS = PT_FULL + POSEIDON_ROUNDS + 3,    // padded to 16 bytes
};

// ---------------------------------------------------------------------------
// GF(FR) in the Montgomery domain
// ---------------------------------------------------------------------------

// t[0..9) += m·q[0..8) + cin·2^256; returns the carry out of t[8]. On the
// card in two chains of PTX carries, the low halves of the word products
// into t[0..8], the high halves into t[1..9); on the host in u64.
DEV u32 fr_mad_row(u32* t, u32 m, const u32* q, u32 cin) {
#if FISCO_PTX
  u32 c;
  asm("mad.lo.cc.u32 %0, %10, %11, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %12, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.lo.cc.u32 %3, %10, %14, %3;\n\t"
      "madc.lo.cc.u32 %4, %10, %15, %4;\n\t"
      "madc.lo.cc.u32 %5, %10, %16, %5;\n\t"
      "madc.lo.cc.u32 %6, %10, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %10, %18, %7;\n\t"
      "addc.cc.u32 %8, %8, %19;\n\t"
      "addc.u32 %9, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %10, %11, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.hi.cc.u32 %4, %10, %14, %4;\n\t"
      "madc.hi.cc.u32 %5, %10, %15, %5;\n\t"
      "madc.hi.cc.u32 %6, %10, %16, %6;\n\t"
      "madc.hi.cc.u32 %7, %10, %17, %7;\n\t"
      "madc.hi.cc.u32 %8, %10, %18, %8;\n\t"
      "addc.u32 %9, %9, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "+r"(t[8]), "=&r"(c)
      : "r"(m), "r"(q[0]), "r"(q[1]), "r"(q[2]), "r"(q[3]), "r"(q[4]), "r"(q[5]), "r"(q[6]),
        "r"(q[7]), "r"(cin));
  return c;
#else
  u64 c = 0;
  for (int j = 0; j < 8; j++) {
    c += (u64)m * q[j] + t[j];
    t[j] = (u32)c;
    c >>= 32;
  }
  c += (u64)t[8] + cin;
  t[8] = (u32)c;
  return (u32)(c >> 32);
#endif
}

// r = t·R^-1 mod FR for t < FR·R (16 words, clobbered): 8 word steps, each
// t += m·FR·2^(32i) with m = t_i·n0, which clears word i (fr_mad_row: in
// PTX carry chains on the card, a product in 12% fewer cycles than with
// the steps accumulated in u64, chip_smoke.py's field bench against the
// parent's fr_mul). The carry out of word i + 8 is owed to word i + 9 and
// added in the next step; after the last, t[8..16) < 2·FR < 2^255, so
// nothing is owed past word 15, and one conditional subtract makes it
// canonical.
DEV void fr_redc(u32* r, u32* t, const u32* p, u32 n0) {
  u32 owed = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) owed = fr_mad_row(t + i, t[i] * n0, p, owed);
  cond_sub8(r, t + 8, p);
}

// r = a·b·R^-1 mod FR for a, b < FR; r may alias a or b
DEV void fr_mul(u32* r, const u32* a, const u32* b, const u32* p, u32 n0) {
  u32 t[16];
  wide_mul(t, a, b);
  fr_redc(r, t, p, n0);
}

// r = a^2·R^-1 mod FR for a < FR, in 36 word products; r may alias a
DEV void fr_sqr(u32* r, const u32* a, const u32* p, u32 n0) {
  u32 t[16];
  wide_sqr(t, a);
  fr_redc(r, t, p, n0);
}

// t = a0·b0 + a1·b1 + a2·b2 (512 bits), three independent products; below
// 3·FR^2 < FR·R for canonical factors, so one REDC takes the sum
DEV void wide_dot3(u32* t, const u32* a0, const u32* b0, const u32* a1, const u32* b1, const u32* a2,
                   const u32* b2) {
  u32 u[16], v[16];
  wide_mul(t, a0, b0);
  wide_mul(u, a1, b1);
  wide_mul(v, a2, b2);
  add_w<16>(t, t, u);
  add_w<16>(t, t, v);  // < 3·FR^2 < 2^510: no carry out
}

// r = (m0·s0 + m1·s1 + m2·s2)·R^-1 mod FR: a dense mix row (m the row's
// three entries, 24 words)
DEV void fr_mds_row(u32* r, const u32* m, const u32* s0, const u32* s1, const u32* s2,
                    const u32* p, u32 n0) {
  u32 t[16];
  wide_dot3(t, m, s0, m + 8, s1, m + 16, s2);
  fr_redc(r, t, p, n0);
}

// ---------------------------------------------------------------------------
// The lane group and its programs
// ---------------------------------------------------------------------------

// PS_LANE_FOR(j) { ... } runs its body as group lane j: on the card once,
// for this lane's j; on the host for j = 0..3 in turn. A body holds no sync.
// ps_sync: the whole warp, which runs every row of every group together.
#if FISCO_PTX
DEV int ps_lane() { return (int)((threadIdx.x & 31) / POSEIDON_WARP_MSGS); }
DEV void ps_sync() { __syncwarp(); }
#define PS_LANE_FOR(j) for (int j = ps_lane(), j##_end = j + 1; j < j##_end; j++)
#else
DEV void ps_sync() {}
#define PS_LANE_FOR(j) for (int j = 0; j < POSEIDON_GROUP; j++)
#endif

// Operands of an op: a message's slots (codes below PS_K0), a value of the
// round's block, or a value of the table.
enum {
  PS_X0, PS_X1, PS_X2,         // the state
  PS_Y0, PS_Y1, PS_Y2,         // the state after an odd full round
  PS_T0, PS_T1, PS_T2, PS_T3, PS_T4, PS_T5,
  PS_RAW0, PS_RAW1,            // the block's two chunks, as read
  PS_S3,                       // lane 3's sink
  PS_SLOTS,
  PS_K0 = 32, PS_K1, PS_K2,    // the round's end constants
  PS_M00, PS_M01, PS_M02, PS_M10, PS_M11, PS_M12, PS_M20, PS_M21, PS_M22,  // its mix
  PS_ZERO = 48, PS_R2, PS_ST0, PS_ST1, PS_ST2,  // the table's: 0, R^2, the start constants
};
#define PS_SLOT_WORDS (PS_SLOTS * 8)

// One op, 64 bits of 6-bit operand codes: d, the products' factors a0, b0,
// a1, b1, a2, b2, the addends c, e; and its kind (the top 2 bits):
//   PS_SQR  d = a0^2,
//   PS_DOT1 d = a0·b0 + c + e,
//   PS_DOT3 d = a0·b0 + a1·b1 + a2·b2 + c + e (a dense mix row),
// the products summed before one REDC; an addend PS_ZERO is skipped. A
// kind's number is its count of products (a squaring's one aside).
enum { PS_SQR, PS_DOT1, PS_DOT3 = 3 };
#define PSOP(kind, d, a0, b0, a1, b1, a2, b2, c, e)                                            \
  ((u64)(kind) << 62 | (u64)(e) << 48 | (u64)(c) << 42 | (u64)(b2) << 36 | (u64)(a2) << 30 | \
   (u64)(b1) << 24 | (u64)(a1) << 18 | (u64)(b0) << 12 | (u64)(a0) << 6 | (u64)(d))
#define PS_Z PS_ZERO
#define PS_SQ(d, a) PSOP(PS_SQR, d, a, PS_Z, PS_Z, PS_Z, PS_Z, PS_Z, PS_Z, PS_Z)
#define PS_MUL(d, a, b, c, e) PSOP(PS_DOT1, d, a, b, PS_Z, PS_Z, PS_Z, PS_Z, c, e)
// lane 3's op of a row with nothing for it, on its sink
#define PS_SINK(kind, s) PSOP(kind, s, s, s, s, s, s, s, PS_Z, PS_Z)

// A block comes in: lanes 0 and 1 encode its chunks (· R^2) and add them,
// with the start constants (the permutation's first additions), to words 0
// and 1; lane 2 adds word 2's.
#define PS_ABSORB_ROWS                                                                        \
  PS_MUL(PS_X0, PS_RAW0, PS_R2, PS_X0, PS_ST0), PS_MUL(PS_X1, PS_RAW1, PS_R2, PS_X1, PS_ST1),  \
      PS_MUL(PS_X2, PS_Z, PS_Z, PS_X2, PS_ST2), PS_SINK(PS_DOT1, PS_S3)

// The start constants alone (a permutation of a given state).
#define PS_START_ROWS                                                                         \
  PS_MUL(PS_X0, PS_Z, PS_Z, PS_X0, PS_ST0), PS_MUL(PS_X1, PS_Z, PS_Z, PS_X1, PS_ST1),          \
      PS_MUL(PS_X2, PS_Z, PS_Z, PS_X2, PS_ST2), PS_SINK(PS_DOT1, PS_S3)

// A full round from the state in x.. into y..: x^2, x^4, x^5 on lanes
// 0-2, then lane j's mix row j and end constant j.
#define PS_MIX_ROW(y, i, x)                                                                   \
  PSOP(PS_DOT3, y, PS_M##i##0, x, PS_M##i##1, x + 1, PS_M##i##2, x + 2, PS_K##i, PS_Z)
#define PS_FULL_ROWS(x, y)                                                                    \
  PS_SQ(PS_T0, x), PS_SQ(PS_T1, x + 1), PS_SQ(PS_T2, x + 2), PS_SINK(PS_SQR, PS_S3),            \
      PS_SQ(PS_T0, PS_T0), PS_SQ(PS_T1, PS_T1), PS_SQ(PS_T2, PS_T2), PS_SINK(PS_SQR, PS_S3),  \
      PS_MUL(x, PS_T0, x, PS_Z, PS_Z), PS_MUL(x + 1, PS_T1, x + 1, PS_Z, PS_Z),               \
      PS_MUL(x + 2, PS_T2, x + 2, PS_Z, PS_Z), PS_SINK(PS_DOT1, PS_S3),                       \
      PS_MIX_ROW(y, 0, x), PS_MIX_ROW(y + 1, 1, x), PS_MIX_ROW(y + 2, 2, x),                  \
      PS_SINK(PS_DOT3, PS_S3)

// A partial round in place, the mix [[a, v1, v2], [w1, 1, 0], [w2, 0, 1]]
// (a = M00, v = M01, M02, w = M10, M20), x = x0, three rows of products
// deep: x^2, w1·x, w2·x, a·x; then x^4, v1·x1 + K0, v2·x2; then
//   x0' = (a·x)·x^4 + (v1·x1 + K0) + v2·x2, x1' = (w1·x)·x^4 + x1 + K1,
//   x2' = (w2·x)·x^4 + x2 + K2.
#define PS_PARTIAL_ROWS                                                                       \
  PS_MUL(PS_T0, PS_X0, PS_X0, PS_Z, PS_Z), PS_MUL(PS_T1, PS_X0, PS_M10, PS_Z, PS_Z),            \
      PS_MUL(PS_T2, PS_X0, PS_M20, PS_Z, PS_Z), PS_MUL(PS_T3, PS_X0, PS_M00, PS_Z, PS_Z),       \
      PS_MUL(PS_T0, PS_T0, PS_T0, PS_Z, PS_Z), PS_MUL(PS_T4, PS_X1, PS_M01, PS_K0, PS_Z),       \
      PS_MUL(PS_T5, PS_X2, PS_M02, PS_Z, PS_Z), PS_SINK(PS_DOT1, PS_S3),                       \
      PS_MUL(PS_X0, PS_T3, PS_T0, PS_T4, PS_T5), PS_MUL(PS_X1, PS_T1, PS_T0, PS_X1, PS_K1),    \
      PS_MUL(PS_X2, PS_T2, PS_T0, PS_X2, PS_K2), PS_SINK(PS_DOT1, PS_S3)

#define PS_FULL_ROUND_ROWS 4
#define PS_PARTIAL_ROUND_ROWS 3

// Every program in one constant array of rows, at its row offset.
enum {
  PS_ABSORB_AT = 0,
  PS_START_AT = PS_ABSORB_AT + 1,
  PS_FULL_XY_AT = PS_START_AT + 1,
  PS_FULL_YX_AT = PS_FULL_XY_AT + PS_FULL_ROUND_ROWS,
  PS_PARTIAL_AT = PS_FULL_YX_AT + PS_FULL_ROUND_ROWS,
  PS_PROG_ROWS = PS_PARTIAL_AT + PS_PARTIAL_ROUND_ROWS,
};
// In global memory, read through the read-only cache: a warp's four
// addresses (one a group lane) lie in one 32-byte row.
#if FISCO_PTX
__device__ const u64 PS_PROGS[][POSEIDON_GROUP] = {
#else
static const u64 PS_PROGS[][POSEIDON_GROUP] = {
#endif
    PS_ABSORB_ROWS,
    PS_START_ROWS,
    PS_FULL_ROWS(PS_X0, PS_Y0),
    PS_FULL_ROWS(PS_Y0, PS_X0),
    PS_PARTIAL_ROWS,
};
static_assert(sizeof(PS_PROGS) / sizeof(PS_PROGS[0]) == PS_PROG_ROWS, "program offsets");

DEV u64 ps_prog(int r, int j) {
#if FISCO_PTX
  return __ldg(reinterpret_cast<const unsigned long long*>(&PS_PROGS[0][0]) + POSEIDON_GROUP * r + j);
#else
  return (&PS_PROGS[0][0])[POSEIDON_GROUP * r + j];
#endif
}

// The 8 words of operand `code`: a slot (quads `stride` apart, as
// slot_get), a value of the round's block `rk` or of the table `tab`
// (8 contiguous words).
DEV void ps_get(u32* v, u32 code, const u32* sl, int stride, const u32* rk, const u32* tab) {
  const u32* at = code < PS_K0 ? sl + 8 * (int)code * stride
                  : code < PS_ZERO ? rk + 8 * (int)(code - PS_K0)
                                   : tab + PT_ZERO + 8 * (int)(code - PS_ZERO);
  const int hi = code < PS_K0 ? 4 * stride : 4;
#if FISCO_PTX
  const uint4 lo = *reinterpret_cast<const uint4*>(at), up = *reinterpret_cast<const uint4*>(at + hi);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = up.x, v[5] = up.y, v[6] = up.z, v[7] = up.w;
#else
  for (int k = 0; k < 4; k++) v[k] = at[k], v[4 + k] = at[hi + k];
#endif
}

// Runs one op over a message's slots; it reads its operands before it
// writes d.
DEV void ps_op(u64 op, u32* sl, int stride, const u32* rk, const u32* tab, const u32* p, u32 n0) {
  const u32 kind = (u32)(op >> 62);
#define PS_FIELD(k) ((u32)(op >> (6 * (k))) & 63u)  // 0 d, 1 a0, 2 b0, 3 a1, 4 b1, 5 a2, 6 b2, 7 c, 8 e
  u32 x[8], y[8], r[8];
  ps_get(x, PS_FIELD(1), sl, stride, rk, tab);
  if (kind == PS_SQR) {
    fr_sqr(r, x, p, n0);
  } else {
    u32 t[16];
    ps_get(y, PS_FIELD(2), sl, stride, rk, tab);
    if (kind == PS_DOT3) {
      u32 x1[8], y1[8], x2[8], y2[8];
      ps_get(x1, PS_FIELD(3), sl, stride, rk, tab);
      ps_get(y1, PS_FIELD(4), sl, stride, rk, tab);
      ps_get(x2, PS_FIELD(5), sl, stride, rk, tab);
      ps_get(y2, PS_FIELD(6), sl, stride, rk, tab);
      wide_dot3(t, x, y, x1, y1, x2, y2);
    } else {
      wide_mul(t, x, y);
    }
    fr_redc(r, t, p, n0);
#pragma unroll
    for (int k = 7; k <= 8; k++) {
      if (PS_FIELD(k) != PS_ZERO) {
        ps_get(y, PS_FIELD(k), sl, stride, rk, tab);
        add_mod(r, r, y, p);
      }
    }
  }
  slot_put(sl, stride, (int)PS_FIELD(0), r);
#undef PS_FIELD
}

// Runs `len` rows from row `at` over a message's slots: group lane j runs
// op j of each row, then the warp syncs. `rk`: the round's block.
DEV void ps_run(int at, int len, u32* sl, int stride, const u32* rk, const u32* tab, const u32* p,
                u32 n0) {
#pragma unroll 1
  for (int r = at; r < at + len; r++) {
    PS_LANE_FOR(j) ps_op(ps_prog(r, j), sl, stride, rk, tab, p, n0);
    ps_sync();
  }
}

// The 65 rounds over the state in X0..X2, start constants added. Full
// rounds alternate X -> Y and Y -> X; each half has an even number of them
// (4), so the partial rounds and the end find the state in X.
DEV void ps_rounds(u32* sl, int stride, const u32* tab, const u32* p, u32 n0) {
  int full = 0;
#pragma unroll 1
  for (int rnd = 0; rnd < POSEIDON_ROUNDS; rnd++) {
    int at = PS_PARTIAL_AT, len = PS_PARTIAL_ROUND_ROWS;
    if (tab[PT_FULL + rnd]) at = (full++ & 1) ? PS_FULL_YX_AT : PS_FULL_XY_AT, len = PS_FULL_ROUND_ROWS;
    ps_run(at, len, sl, stride, tab + PT_ROUNDS + rnd * PT_ROUND_WORDS, tab, p, n0);
  }
}

// Chunk bytes [off, off + 31) of a message of `len` bytes, padded (byte len
// is 0x01, the bytes past it 0), as a big-endian value: 8 little-endian
// words. Loads only bytes of the message.
DEV void read_chunk(u32* w, const uint8_t* msg, int64_t len, int64_t off) {
#pragma unroll
  for (int i = 0; i < 8; i++) w[i] = 0;
#pragma unroll
  for (int k = 0; k < POSEIDON_CHUNK; k++) {
    const int64_t pos = off + k;
    const u32 b = pos < len ? (u32)msg[pos] : (pos == len ? 1u : 0u);
    const int e = POSEIDON_CHUNK - 1 - k;  // the byte's place, from the low end
    w[e >> 2] |= b << (8 * (e & 3));
  }
}

// One message's sponge on its group (the four lanes in turn on the host):
// `nblocks` its blocks (0 for no message), `wblocks` the blocks its warp
// runs (its longest message's: a group past its own last block absorbs
// zeros). `out` gets word 0 after block nblocks - 1 on group lane 0
// (Montgomery domain).
DEV void ps_message(const uint8_t* msg, int64_t len, int nblocks, int wblocks, u32* sl, int stride,
                    const u32* tab, u32* out) {
  u32 p[8];
  copy_w<8>(p, tab + PT_FR);
  const u32 n0 = tab[PT_N0];
  PS_LANE_FOR(j) {
    for (int s = j; s < PS_SLOTS; s += POSEIDON_GROUP) slot_put(sl, stride, s, tab + PT_ZERO);
  }
  ps_sync();
#pragma unroll 1
  for (int blk = 0; blk < wblocks; blk++) {
    PS_LANE_FOR(j) {
      if (j < POSEIDON_RATE) {  // lanes 0 and 1 read the block's two chunks
        u32 w[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        if (blk < nblocks) read_chunk(w, msg, len, (int64_t)blk * POSEIDON_BLOCK_BYTES + j * POSEIDON_CHUNK);
        slot_put(sl, stride, PS_RAW0 + j, w);
      }
    }
    ps_sync();
    ps_run(PS_ABSORB_AT, 1, sl, stride, tab + PT_ROUNDS, tab, p, n0);
    ps_rounds(sl, stride, tab, p, n0);
    PS_LANE_FOR(j) {
      if (j == 0 && blk + 1 == nblocks) slot_get(out, sl, stride, PS_X0);
    }
  }
}

// The squeeze: Montgomery-domain word 0 -> 8 big-endian words of its value
// (the bytes in memory order, read as little-endian words).
DEV void ps_digest(u32* digest, const u32* x, const u32* tab) {
  u32 t[16], v[8];
  copy_w<8>(t, x);
#pragma unroll
  for (int i = 8; i < 16; i++) t[i] = 0;
  fr_redc(v, t, tab + PT_FR, tab[PT_N0]);  // out of the domain, canonical
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const u32 w = v[7 - i];
    digest[i] = (w >> 24) | ((w >> 8) & 0xFF00u) | ((w << 8) & 0xFF0000u) | (w << 24);
  }
}

// Launch geometry for n messages: threads a block, blocks, dynamic shared
// bytes (the warps' slots). One warp a block until the launch has two warps
// for each SM, then more, up to POSEIDON_MAX_WARPS: a narrow launch (a
// page tree's 1,088-message level: 136 warps) takes 136 SMs' worth of
// blocks, a wide one copies the table once every four warps.
#define PS_WARP_QUADS (PS_SLOTS * 2 * POSEIDON_WARP_MSGS)  // 16-byte quads of a warp's slots
extern "C" void poseidon_geometry(int n, int* out) {
  const int warps = (n + POSEIDON_WARP_MSGS - 1) / POSEIDON_WARP_MSGS;
  int per_block = warps / POSEIDON_SMS;
  per_block = per_block < 1 ? 1 : per_block > POSEIDON_MAX_WARPS ? POSEIDON_MAX_WARPS : per_block;
  out[0] = 32 * per_block;
  out[1] = (warps + per_block - 1) / per_block;
  out[2] = per_block * PS_WARP_QUADS * 16;
}

#ifndef __CUDACC__

// Host forms for the tests: the permutation of a Montgomery-domain state
// s[0..3) in place, and one message's digest, a group's lanes in turn.
static void poseidon_permute(u32* s, const u32* tab) {
  u32 sl[PS_SLOT_WORDS] = {0};
  for (int i = 0; i < POSEIDON_T; i++) slot_put(sl, 1, PS_X0 + i, s + 8 * i);
  ps_run(PS_START_AT, 1, sl, 1, tab + PT_ROUNDS, tab, tab + PT_FR, tab[PT_N0]);
  ps_rounds(sl, 1, tab, tab + PT_FR, tab[PT_N0]);
  for (int i = 0; i < POSEIDON_T; i++) slot_get(s + 8 * i, sl, 1, PS_X0 + i);
}

static void poseidon_message(const uint8_t* msg, int64_t len, const u32* tab, u32* digest) {
  u32 sl[PS_SLOT_WORDS], x[8];
  const int nblocks = (int)(len / POSEIDON_BLOCK_BYTES + 1);
  ps_message(msg, len, nblocks, nblocks, sl, 1, tab, x);
  ps_digest(digest, x, tab);
}

#else  // __CUDACC__

#define POSEIDON_MAX_THREADS (32 * POSEIDON_MAX_WARPS)

__global__ void __launch_bounds__(POSEIDON_MAX_THREADS, 4)
poseidon_kernel(const uint8_t* __restrict__ data, const int64_t* __restrict__ starts,
                const int32_t* __restrict__ lengths, const u32* __restrict__ table,
                uint8_t* __restrict__ out, int n, int64_t n_data) {
  __shared__ __align__(16) u32 tab[PT_WORDS];
  extern __shared__ uint4 s_slots[];  // a warp's 8 messages' slots, message-minor quads
  for (int i = threadIdx.x; i < PT_WORDS; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane % POSEIDON_WARP_MSGS;
  const int64_t i = ((int64_t)blockIdx.x * (blockDim.x >> 5) + warp) * POSEIDON_WARP_MSGS + g;
  int64_t start = 0, len = 0;
  bool valid = false;
  if (i < n) {
    start = starts[i], len = lengths[i];
    valid = start >= 0 && len >= 0 && start <= n_data - len;  // else a zero digest
  }
  const int nblocks = valid ? (int)(len / POSEIDON_BLOCK_BYTES + 1) : 0;
  const int wblocks = __reduce_max_sync(0xFFFFFFFFu, nblocks);  // the whole warp runs them
  u32 x[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  ps_message(data + (valid ? start : 0), valid ? len : 0, nblocks, wblocks,
             reinterpret_cast<u32*>(s_slots + warp * PS_WARP_QUADS + g), POSEIDON_WARP_MSGS, tab, x);
  if (lane >= POSEIDON_WARP_MSGS || i >= n) return;  // group lane 0 writes the digest
  u32 digest[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (valid) ps_digest(digest, x, tab);
  uint4* row = reinterpret_cast<uint4*>(out + 32 * i);
  row[0] = make_uint4(digest[0], digest[1], digest[2], digest[3]);
  row[1] = make_uint4(digest[4], digest[5], digest[6], digest[7]);
}

// C entry point for ctypes, all pointers on `device`: data uint8 [n_data],
// starts int64 [n], lengths int32 [n], table int32 [table_words], out uint8
// [n, 32] (16-byte aligned). A table of another length is refused
// (cudaErrorInvalidValue). Launches on `stream`, does not synchronise;
// returns the first CUDA error (0 on success).
extern "C" int poseidon_launch(const void* data, const void* starts, const void* lengths,
                               const void* table, void* out, int table_words, int n,
                               long long n_data, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (table_words != PT_WORDS) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  err = cudaFuncSetAttribute(poseidon_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  int geo[3];
  poseidon_geometry(n, geo);
  poseidon_kernel<<<geo[1], geo[0], geo[2], (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int64_t*)starts, (const int32_t*)lengths, (const u32*)table,
      (uint8_t*)out, n, (int64_t)n_data);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
