// Cycles per field op and per group-law op for one warp (clock64() around
// a loop; Ed25519's programs in the checkout's layout: one lane a
// signature, or a quad of lanes, so the cycles are a signature's latency
// either way), and cycles per SM2 product as a loop body grows: the
// measurements behind the kernels' design (PERF.md §6). Poseidon's GF(FR)
// ops, rounds and permutation likewise (a message's latency: one thread a
// message in a checkout before the lane groups, a group of four lanes
// after; a product's REDC in u64 before them, in PTX carry chains after),
// and 8 words handed between lanes by slots and by shuffles. SHA-256's
// compression and SHA-512's block in the checkout's form and in the forms
// the kernels did not take (the whole unroll, passes of 8 or 16 rounds), a
// lane's 700-byte message (12 blocks) through the staged route alone and
// with both routes compiled in, cold and warm, one lane or a round lane and
// a schedule lane a message, the Ed25519 challenge's lane and pair and its
// reduction mod L (op codes 31-44). BLS12-381's Fp ops and rows of the
// pairing kernels' programs (45-64): one lane an op on one warp, and a
// quad or a pair of lanes an op on a block of warps (59-64). Not a kernel
// of any path: chip_smoke.py builds it against a checkout's csrc/ (-I that
// directory; hence the angle brackets) and prints what it measures.
//
// Built against the current sources (wide_int.cuh defines SLOT_WORDS) it
// times the group law through the field-op programs over shared-memory
// slots; against an earlier checkout, through its point functions. The
// inversions mod n: the Fermat chain f_pow<true, EXP_N_INV_ID> (with slots)
// and verify's safegcd divsteps (where the checkout has
// secp256k1_modinv.cuh); an op a checkout lacks returns -1.

#include <sm2_verify.cu>
#include <secp256k1_common.cuh>
#if __has_include(<secp256k1_modinv.cuh>)
#include <secp256k1_modinv.cuh>
#define FB_HAS_DIVSTEP 1
#endif
#if __has_include(<ed25519_verify.cu>)
#include <ed25519_verify.cu>
#define FB_HAS_ED25519 1
#ifdef ED25519_SIGS
#define FB_ED_SIGS ED25519_SIGS  // a quad of lanes a signature: 8 signatures a warp
#else
#define FB_ED_SIGS 32  // one lane a signature
#endif
#endif

#if __has_include(<poseidon.cu>)
#include <poseidon.cu>
#define FB_HAS_POSEIDON 1
#endif

// The hash kernels' bodies in the checkout's form. hash_kernel.cuh defines
// the CUDA error string that wide_int.cuh already gave: its copy takes
// another name here.
#define fisco_cuda_error_string fisco_hash_error_string
#include <sha256.cuh>
#include <ed25519_challenge.cu>
#undef fisco_cuda_error_string

#if __has_include(<bls12_381_field.cuh>)
#include <bls12_381_field.cuh>
#define FB_HAS_BLS_FIELD 1
#if __has_include(<bls12_381_coop.cuh>)
#include <bls12_381_coop.cuh>
#define FB_HAS_BLS_COOP 1
#endif

// BLS12-381's field ops in the forms the pairing kernel did not take, timed
// against its own (bls_mul, bls_addsub, bls_inv_divstep).

// t[0..13) += m·q[0..12) + cin·2^384; returns the carry out of t[12].
DEV u32 bls_mad_row(u32* t, u32 m, const u32* q, u32 cin) {
#if FISCO_PTX
  u32 c;
  asm("mad.lo.cc.u32 %0, %14, %15, %0;\n\t"
      "madc.lo.cc.u32 %1, %14, %16, %1;\n\t"
      "madc.lo.cc.u32 %2, %14, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %14, %18, %3;\n\t"
      "madc.lo.cc.u32 %4, %14, %19, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %20, %5;\n\t"
      "madc.lo.cc.u32 %6, %14, %21, %6;\n\t"
      "madc.lo.cc.u32 %7, %14, %22, %7;\n\t"
      "madc.lo.cc.u32 %8, %14, %23, %8;\n\t"
      "madc.lo.cc.u32 %9, %14, %24, %9;\n\t"
      "madc.lo.cc.u32 %10, %14, %25, %10;\n\t"
      "madc.lo.cc.u32 %11, %14, %26, %11;\n\t"
      "addc.cc.u32 %12, %12, %27;\n\t"
      "addc.u32 %13, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %14, %15, %1;\n\t"
      "madc.hi.cc.u32 %2, %14, %16, %2;\n\t"
      "madc.hi.cc.u32 %3, %14, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %14, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %14, %19, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %20, %6;\n\t"
      "madc.hi.cc.u32 %7, %14, %21, %7;\n\t"
      "madc.hi.cc.u32 %8, %14, %22, %8;\n\t"
      "madc.hi.cc.u32 %9, %14, %23, %9;\n\t"
      "madc.hi.cc.u32 %10, %14, %24, %10;\n\t"
      "madc.hi.cc.u32 %11, %14, %25, %11;\n\t"
      "madc.hi.cc.u32 %12, %14, %26, %12;\n\t"
      "addc.u32 %13, %13, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "=&r"(c)
      : "r"(m), "r"(q[0]), "r"(q[1]), "r"(q[2]), "r"(q[3]), "r"(q[4]), "r"(q[5]), "r"(q[6]),
        "r"(q[7]), "r"(q[8]), "r"(q[9]), "r"(q[10]), "r"(q[11]), "r"(cin));
  return c;
#else
  u64 c = 0;
  for (int j = 0; j < BLS_NW; j++) {
    c += (u64)m * q[j] + t[j];
    t[j] = (u32)c;
    c >>= 32;
  }
  c += (u64)t[BLS_NW] + cin;
  t[BLS_NW] = (u32)c;
  return (u32)(c >> 32);
#endif
}

// t[0..13) += lo[0..12) + hi[0..12)·2^32; returns the carry out of t[12].
// On the card two chains of PTX carries through adds (IADD3 with its carry
// in a predicate), no multiply in them.
DEV u32 bls_add_row(u32* t, const u32* lo, const u32* hi) {
#if FISCO_PTX
  u32 c, d;
  asm("add.cc.u32 %0, %0, %14;\n\t"
      "addc.cc.u32 %1, %1, %15;\n\t"
      "addc.cc.u32 %2, %2, %16;\n\t"
      "addc.cc.u32 %3, %3, %17;\n\t"
      "addc.cc.u32 %4, %4, %18;\n\t"
      "addc.cc.u32 %5, %5, %19;\n\t"
      "addc.cc.u32 %6, %6, %20;\n\t"
      "addc.cc.u32 %7, %7, %21;\n\t"
      "addc.cc.u32 %8, %8, %22;\n\t"
      "addc.cc.u32 %9, %9, %23;\n\t"
      "addc.cc.u32 %10, %10, %24;\n\t"
      "addc.cc.u32 %11, %11, %25;\n\t"
      "addc.cc.u32 %12, %12, 0;\n\t"
      "addc.u32 %13, 0, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "=&r"(c)
      : "r"(lo[0]), "r"(lo[1]), "r"(lo[2]), "r"(lo[3]), "r"(lo[4]), "r"(lo[5]), "r"(lo[6]),
        "r"(lo[7]), "r"(lo[8]), "r"(lo[9]), "r"(lo[10]), "r"(lo[11]));
  asm("add.cc.u32 %0, %0, %13;\n\t"
      "addc.cc.u32 %1, %1, %14;\n\t"
      "addc.cc.u32 %2, %2, %15;\n\t"
      "addc.cc.u32 %3, %3, %16;\n\t"
      "addc.cc.u32 %4, %4, %17;\n\t"
      "addc.cc.u32 %5, %5, %18;\n\t"
      "addc.cc.u32 %6, %6, %19;\n\t"
      "addc.cc.u32 %7, %7, %20;\n\t"
      "addc.cc.u32 %8, %8, %21;\n\t"
      "addc.cc.u32 %9, %9, %22;\n\t"
      "addc.cc.u32 %10, %10, %23;\n\t"
      "addc.cc.u32 %11, %11, %24;\n\t"
      "addc.u32 %12, 0, 0;"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
        "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "=&r"(d)
      : "r"(hi[0]), "r"(hi[1]), "r"(hi[2]), "r"(hi[3]), "r"(hi[4]), "r"(hi[5]), "r"(hi[6]),
        "r"(hi[7]), "r"(hi[8]), "r"(hi[9]), "r"(hi[10]), "r"(hi[11]));
  return c + d;
#else
  u64 c = 0, d = 0;
  for (int j = 0; j < BLS_NW; j++) {
    c += (u64)t[j] + lo[j];
    t[j] = (u32)c;
    c >>= 32;
  }
  c += t[BLS_NW];
  t[BLS_NW] = (u32)c;
  c >>= 32;
  for (int j = 0; j < BLS_NW; j++) {
    d += (u64)t[j + 1] + hi[j];
    t[j + 1] = (u32)d;
    d >>= 32;
  }
  return (u32)(c + d);
#endif
}

// t[0..13) += m·q[0..12) + cin·2^384 by 12 independent 64-bit word products
// and bls_add_row; returns the carry out of t[12].
DEV u32 bls_mul_add_row(u32* t, u32 m, const u32* q, u32 cin) {
  u32 lo[BLS_NW], hi[BLS_NW];
#pragma unroll
  for (int j = 0; j < BLS_NW; j++) {
    const u64 p = (u64)m * q[j];
    lo[j] = (u32)p;
    hi[j] = (u32)(p >> 32);
  }
  const u64 top = (u64)t[BLS_NW] + cin;
  t[BLS_NW] = (u32)top;
  return bls_add_row(t, lo, hi) + (u32)(top >> 32);
}

// r = a·b·R^-1 mod p for a·b < p·R (canonical a, b); r may alias a or b.
// The 768-bit product in rows of PTX mad chains, then REDC likewise.
DEV void bls_mul_mad(u32* r, const u32* a, const u32* b) {
  u32 t[2 * BLS_NW + 1];
#pragma unroll
  for (int k = 0; k <= BLS_NW; k++) t[k] = 0;
#pragma unroll
  for (int i = 0; i < BLS_NW; i++) t[i + BLS_NW + 1] = bls_mad_row(t + i, b[i], a, 0);
  // REDC: step i clears word i; its carry out of word i + 12 is owed to
  // word i + 13, added in the next step; after the last, t[12..24) < 2p
  u32 owed = 0;
#pragma unroll
  for (int i = 0; i < BLS_NW; i++) owed = bls_mad_row(t + i, t[i] * BLS_N0, BLS_P, owed);
  bls_cond_sub(r, t + BLS_NW);
}

// The same product, its rows' word products 64 bits at a time and added
// by carry chains of adds (bls_mul_add_row).
DEV void bls_mul_addc(u32* r, const u32* a, const u32* b) {
  u32 t[2 * BLS_NW + 1];
#pragma unroll
  for (int k = 0; k <= BLS_NW; k++) t[k] = 0;
#pragma unroll
  for (int i = 0; i < BLS_NW; i++) t[i + BLS_NW + 1] = bls_mul_add_row(t + i, b[i], a, 0);
  u32 owed = 0;
#pragma unroll
  for (int i = 0; i < BLS_NW; i++) owed = bls_mul_add_row(t + i, t[i] * BLS_N0, BLS_P, owed);
  bls_cond_sub(r, t + BLS_NW);
}

// The same product by CIOS with u64 carries (the one-lane kernel's form).
DEV void bls_mul_cios(u32* r, const u32* a, const u32* b) {
  u32 t[BLS_NW + 2];
#pragma unroll
  for (int i = 0; i < BLS_NW + 2; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < BLS_NW; i++) {
    u64 c = 0;
    const u32 bi = b[i];
#pragma unroll
    for (int j = 0; j < BLS_NW; j++) {
      c += (u64)a[j] * bi + t[j];
      t[j] = (u32)c;
      c >>= 32;
    }
    c += t[BLS_NW];
    t[BLS_NW] = (u32)c;
    t[BLS_NW + 1] = (u32)(c >> 32);
    const u32 m = t[0] * BLS_N0;
    c = ((u64)m * BLS_P[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < BLS_NW; j++) {
      c += (u64)m * BLS_P[j] + t[j];
      t[j - 1] = (u32)c;
      c >>= 32;
    }
    c += t[BLS_NW];
    t[BLS_NW - 1] = (u32)c;
    t[BLS_NW] = t[BLS_NW + 1] + (u32)(c >> 32);
  }
  bls_cond_sub(r, t);
}

CONSTMEM u32 BLS_NEG_P[BLS_NW] = {0x00005555u, 0x46010000u, 0x4eac0000u, 0xe1540001u,  // 2^384 - p
                                  0x094f09dbu, 0x98cf2d5fu, 0x0c7aed40u, 0x9b88b47bu,
                                  0xbcb45328u, 0xb4e45849u, 0xc6801965u, 0xe5feee15u};

// a ± b mod p in one path for both and two carry chains side by side: s1 = a ± b and s2 = s1 ∓ p (b's words inverted and
// one carried in for a difference; -p as 2^384 - p for a sum). A sum takes
// s2 when it carries out (s1 >= p), a difference s1 when it does (a >= b).
DEV void bls_addsub_par(u32* r, const u32* a, const u32* b, bool sub) {
  const u32 mask = sub ? 0xFFFFFFFFu : 0u;
  u32 s1[BLS_NW], s2[BLS_NW];
  u64 c1 = sub, c2 = sub;
#pragma unroll
  for (int i = 0; i < BLS_NW; i++) {
    const u32 bx = b[i] ^ mask;
    const u32 q = sub ? BLS_P[i] : BLS_NEG_P[i];
    c1 += (u64)a[i] + bx;
    c2 += (u64)a[i] + bx + q;
    s1[i] = (u32)c1;
    s2[i] = (u32)c2;
    c1 >>= 32;
    c2 >>= 32;
  }
  const bool take2 = sub ? c1 == 0 : (c2 & 1) != 0;
#pragma unroll
  for (int i = 0; i < BLS_NW; i++) r[i] = take2 ? s2[i] : s1[i];
}

// a^-1 = a^(p - 2) (0 -> 0) in the Montgomery domain, (a·R)^-1·R^2: square
// and multiply, MSB first, over the bits of p - 2 below the top one (bit
// 380), by the kernel's product.
DEV void bls_inv_fermat(u32* r, const u32* a) {
  u32 acc[BLS_NW], x[BLS_NW];
#pragma unroll
  for (int i = 0; i < BLS_NW; i++) acc[i] = x[i] = a[i];
#pragma unroll 1
  for (int i = 379; i >= 0; i--) {
    bls_mul(acc, acc, acc);
    const u32 word = BLS_P[i >> 5] - (i >> 5 ? 0u : 2u);
    if ((word >> (i & 31)) & 1) bls_mul(acc, acc, x);
  }
#pragma unroll
  for (int i = 0; i < BLS_NW; i++) r[i] = acc[i];
}
#endif

#ifdef SLOT_WORDS
#define FB_SQR_MM(r, a) mm_sqr(r, a)
#define FB_SQR_FN(r, a) fn_sqr(r, a)
#else
#define FB_SQR_MM(r, a) mm_mul(r, a, a)
#define FB_SQR_FN(r, a) fn_mul(r, a, a)
#endif

enum {
  FB_MM_MUL, FB_MM_SQR, FB_MM_ADD, FB_FP_MUL, FB_FP_SQR, FB_FN_MUL, FB_FN_SQR,
  FB_SM2_DBL, FB_SM2_ADD, FB_SM2_MADD, FB_SECP_DBL, FB_SECP_ADD, FB_SECP_MADD,
  FB_FN_INV_FERMAT, FB_FN_INV_DIVSTEP, FB_ED_MUL, FB_ED_SQR, FB_ED_DBL, FB_ED_ADD, FB_ED_MADD,
  FB_ED_DECOMP, FB_FR_MUL, FB_FR_SQR, FB_FR_SBOX, FB_FR_MDS_ROW, FB_FR_SPARSE_MIX, FB_PS_FULL_ROUND, FB_PS_PARTIAL_ROUND, FB_PS_PERMUTE,
  FB_XCHG_SLOTS, FB_XCHG_SHFL, FB_SHA256_COMPRESS, FB_SHA256_COMPRESS_PASS8, FB_SHA256_COMPRESS_PASS16,
  FB_SHA256_LANE, FB_SHA256_LANE_ROUTES, FB_SHA256_LANE_COLD, FB_SHA256_PAIR, FB_SHA512_BLOCK,
  FB_SHA512_BLOCK_FULL, FB_SHA512_BLOCK_PASS8, FB_CHALLENGE_LANE, FB_CHALLENGE_PAIR, FB_MOD_L,
  FB_CHALLENGE_COLD, FB_BLS_MUL_ONE_LANE, FB_BLS_MUL_CIOS, FB_BLS_MUL, FB_BLS_ADD, FB_BLS_SUB,
  FB_BLS_ROW8, FB_BLS_ROW16, FB_BLS_ROW32, FB_BLS_SUM_ROW32, FB_BLS_INV_FERMAT, FB_BLS_MUL_ADDC, FB_BLS_INV_DIVSTEP, FB_BLS_MUL_COLS, FB_BLS_ADD_PAR,
  FB_BLS_QUAD_ROW32, FB_BLS_QUAD_ROW8, FB_BLS_PAIR_ROW32, FB_BLS_QUAD_SUM_ROW32, FB_BLS_LEAD_SUM_ROW32,
  FB_BLS_QUAD_MIX, FB_OPS
};

extern "C" const char* field_bench_name(int op) {
  static const char* names[FB_OPS] = {
      "SM2 mm_mul", "SM2 mm_sqr", "SM2 mm_add", "secp fp_mul", "secp fp_sqr", "secp fn_mul",
      "secp fn_sqr", "SM2 doubling (RCB 3)", "SM2 addition (RCB 1)", "SM2 mixed addition (RCB 2)",
      "secp doubling (RCB 9)", "secp addition (RCB 7)", "secp mixed addition (RCB 8)",
      "secp s^-1 mod n, Fermat f_pow", "secp s^-1 mod n, safegcd divsteps", "Ed25519 fe_mul",
      "Ed25519 fe_sqr", "Ed25519 doubling program", "Ed25519 addition program",
      "Ed25519 mixed addition program", "Ed25519 decompression program (one point a lane; a quad: A and R)",
      "Fr product (fr_mul; its REDC in PTX carry chains, in u64 before the lane groups)",
      "Fr squaring (fr_sqr; the REDC likewise)", "Fr S-box x^5, one lane (2 squarings, 1 product)",
      "Fr dense mix row (fr_mds_row)", "Fr sparse mix, one lane (a mix row, 2 products, 2 sums)",
      "Poseidon full round, a lane group's 4 rows", "Poseidon partial round, a lane group's 3 rows",
      "Poseidon permutation (a lane group; one thread a message before)",
      "8 words between the lanes of a group: shared-memory slots (put, __syncwarp, get)",
      "8 words between the lanes of a group: 8 __shfl_sync",
      "SHA-256 compression, the checkout's form (all 64 rounds unrolled)",
      "SHA-256 compression, passes of 8 rounds", "SHA-256 compression, passes of 16 rounds",
      "SHA-256 lane, a 700-byte staged message (12 blocks), the staged route alone",
      "SHA-256 lane, the same with both routes compiled in (the kernel's form)",
      "SHA-256 lane, both routes, its first message in a fresh launch (cold)",
      "SHA-256 pair, a round lane and a schedule lane a 700-byte message",
      "SHA-512 block, the checkout's form (passes of 16 rounds)", "SHA-512 block, all 80 rounds unrolled",
      "SHA-512 block, passes of 8 rounds",
      "Ed25519 challenge lane, a 32-byte staged message (1 block and mod L)",
      "Ed25519 challenge pair, a round lane and a schedule lane a 32-byte message",
      "Ed25519 challenge, the Barrett reduction mod L",
      "Ed25519 challenge lane, its first message in a fresh launch (cold)",
      "BLS12-381 Fp product, the one-lane kernel's form (CIOS, u64 carries, by reference, not inlined)",
      "BLS12-381 Fp product, CIOS with u64 carries in registers (bls_mul_cios)",
      "BLS12-381 Fp product, the 768-bit product and REDC in rows of PTX mad carry chains (bls_mul_mad)",
      "BLS12-381 Fp sum, three chains one after another (bls_addsub, the kernel's)",
      "BLS12-381 Fp difference (bls_addsub)",
      "BLS12-381 row of 8 products over shared-memory slots (op from global, 2 loads, 1 store, __syncwarp)",
      "BLS12-381 row of 16 products over shared-memory slots", "BLS12-381 row of 32 products over shared-memory slots",
      "BLS12-381 row of 32 sums over shared-memory slots", "BLS12-381 Fp inversion, Fermat, one lane",
      "BLS12-381 Fp product, 64-bit word products added by chains of add carries (bls_mul_addc)",
      "BLS12-381 Fp inversion, safegcd divsteps and one product, one lane (bls_inv_divstep, the kernel's)",
      "BLS12-381 Fp product by columns with deferred carries (bls_mul, the kernel's)",
      "BLS12-381 Fp sum, two chains side by side (bls_addsub_par)",
      "BLS12-381 row of 32 products, a quad of lanes each (bls_mul_coop<4>), 4 warps, a block sync",
      "BLS12-381 row of 8 products, a quad of lanes each, one warp",
      "BLS12-381 row of 32 products, a pair of lanes each (bls_mul_coop<2>), 2 warps, a block sync",
      "BLS12-381 row of 32 sums, a quad of lanes each (bls_addsub_coop<4>), 4 warps, a block sync",
      "BLS12-381 row of 32 sums, the first lane of each quad (bls_addsub), 4 warps, a block sync",
      "BLS12-381 row of 32 quad products, then 6 rows of 32 quad sums, a block sync each (one loop)"};
  return op >= 0 && op < FB_OPS ? names[op] : "";
}

// 32 lanes; io holds 64 x 8 random words (below 2^255, so below both p)
template <int OP>
__global__ void field_bench(u32* io, long long* cyc, int iters) {
  u32 x[8], y[8], z[8];
  for (int i = 0; i < 8; i++) {
    x[i] = io[8 * threadIdx.x + i];
    y[i] = io[8 * (threadIdx.x + 32) + i];
    z[i] = x[i] ^ y[i];
  }
  x[7] &= 0x7FFFFFFFu, y[7] &= 0x7FFFFFFFu, z[7] &= 0x7FFFFFFFu;
#ifdef SLOT_WORDS
  extern __shared__ uint4 s_slots[];
  u32* sl = reinterpret_cast<u32*>(s_slots + threadIdx.x);
  slot_put(sl, 32, S_X, x), slot_put(sl, 32, S_Y, y), slot_put(sl, 32, S_Z, z);
  slot_put(sl, 32, S_QX, y), slot_put(sl, 32, S_QY, z), slot_put(sl, 32, S_QZ, x);
  slot_put(sl, 32, S_K, z);
#ifdef FB_HAS_ED25519
  // Ed25519's slots in the checkout's layout: a signature's slots at stride
  // FB_ED_SIGS, written by its first lane; every slot holds x, y or z
  u32* esl = reinterpret_cast<u32*>(s_slots + threadIdx.x % FB_ED_SIGS);
  if (OP >= FB_ED_DBL) {
    if (threadIdx.x < FB_ED_SIGS) {
      for (int s = 0; s < ED25519_SLOTS; s++) slot_put(esl, FB_ED_SIGS, s, s % 3 ? (s % 3 == 1 ? y : z) : x);
    }
    __syncwarp();
  }
#endif
#else
  Pt P, Q;
  copy_w<8>(P.X, x), copy_w<8>(P.Y, y), copy_w<8>(P.Z, z);
  copy_w<8>(Q.X, y), copy_w<8>(Q.Y, z), copy_w<8>(Q.Z, x);
#endif
  long long t0 = clock64();
#pragma unroll 1
  for (int k = 0; k < iters; k++) {
    if (OP == FB_MM_MUL) mm_mul(x, x, y);
    if (OP == FB_MM_SQR) FB_SQR_MM(x, x);
    if (OP == FB_MM_ADD) mm_add(x, x, y);
    if (OP == FB_FP_MUL) fp_mul(x, x, y);
    if (OP == FB_FP_SQR) fp_sqr(x, x);
    if (OP == FB_FN_MUL) fn_mul(x, x, y);
    if (OP == FB_FN_SQR) FB_SQR_FN(x, x);
#ifdef SLOT_WORDS
    if (OP == FB_SM2_DBL) fop_run<Sm2Field>(SM2_DBL, FOP_LEN(SM2_DBL), sl, 32);
    if (OP == FB_SM2_ADD) fop_run<Sm2Field>(SM2_ADD, FOP_LEN(SM2_ADD), sl, 32);
    if (OP == FB_SM2_MADD) fop_run<Sm2Field>(SM2_MADD, FOP_LEN(SM2_MADD), sl, 32);
    if (OP == FB_SECP_DBL) fop_run<SecpField>(SECP_DBL, FOP_LEN(SECP_DBL), sl, 32);
    if (OP == FB_SECP_ADD) fop_run<SecpField>(SECP_ADD, FOP_LEN(SECP_ADD), sl, 32);
    if (OP == FB_SECP_MADD) fop_run<SecpField>(SECP_MADD, FOP_LEN(SECP_MADD), sl, 32);
    if (OP == FB_FN_INV_FERMAT) f_pow<true, EXP_N_INV_ID>(x, x, sl, 32);
#ifdef FB_HAS_DIVSTEP
    if (OP == FB_FN_INV_DIVSTEP) fn_inv_divstep(x, x);
#endif
#ifdef FB_HAS_ED25519
    if (OP == FB_ED_MUL) fe_mul(x, x, y);
    if (OP == FB_ED_SQR) fe_sqr(x, x);
    if (OP == FB_ED_DBL) ed_run(ED_DBL_AT, ED_DBL_LEN, esl, FB_ED_SIGS);
    if (OP == FB_ED_ADD) ed_run(ED_ADD_AT, ED_ADD_LEN, esl, FB_ED_SIGS);
    if (OP == FB_ED_MADD) ed_run(ED_MADD_AT, ED_MADD_LEN, esl, FB_ED_SIGS);
#ifdef ED25519_SIGS  // the quad runs the decompression with no sync between rows
    if (OP == FB_ED_DECOMP) ed_run<false>(ED_DECOMP_AT, ED_DECOMP_LEN, esl, FB_ED_SIGS);
#else
    if (OP == FB_ED_DECOMP) ed_run(ED_DECOMP_AT, ED_DECOMP_LEN, esl, FB_ED_SIGS);
#endif
#endif
#else
    if (OP == FB_SM2_DBL) sm2_pt_double(P, P);
    if (OP == FB_SM2_ADD) sm2_pt_add(P, P, Q);
    if (OP == FB_SM2_MADD) sm2_pt_add_mixed(P, P, Q.X, Q.Y);
    if (OP == FB_SECP_DBL) pt_double(P, P);
    if (OP == FB_SECP_ADD) pt_add(P, P, Q);
    if (OP == FB_SECP_MADD) pt_add_mixed(P, P, Q.X, Q.Y);
#endif
  }
  long long t1 = clock64();
#ifdef SLOT_WORDS
  slot_get(y, sl, 32, S_X);
#else
  copy_w<8>(y, P.X);
#endif
  for (int i = 0; i < 8; i++) io[8 * threadIdx.x + i] = x[i] ^ y[i];
  cyc[threadIdx.x] = t1 - t0;
}

#ifdef FB_HAS_POSEIDON
// x <- x^5 on one lane
__device__ __forceinline__ void fb_sbox(u32* x, const u32* p, u32 n0) {
  u32 y[8];
  fr_sqr(y, x, p, n0);
  fr_sqr(y, y, p, n0);
  fr_mul(x, y, x, p, n0);
}

// (x, y, z) <- the sparse mix [[a, v1, v2], [w1, 1, 0], [w2, 0, 1]] of
// them on one lane, m = (a, v1, v2, w1, w2)
__device__ __forceinline__ void fb_sparse_mix(u32* x, u32* y, u32* z, const u32* m, const u32* p, u32 n0) {
  u32 o[8], t[8];
  fr_mds_row(o, m, x, y, z, p, n0);
  fr_mul(t, m + 24, x, p, n0);
  add_mod(y, y, t, p);
  fr_mul(t, m + 32, x, p, n0);
  add_mod(z, z, t, p);
  copy_w<8>(x, o);
}

// Poseidon's ops for one warp, over the checkout's table (on the card)
template <int OP>
__global__ void poseidon_bench(u32* io, long long* cyc, int iters, const u32* table) {
  __shared__ __align__(16) u32 tab[PT_WORDS];
  __shared__ uint4 xchg[2 * 32];
#ifdef PS_SLOT_WORDS
  __shared__ __align__(16) u32 slots[PS_SLOT_WORDS * POSEIDON_WARP_MSGS];
  u32* sl = slots + 4 * (threadIdx.x % POSEIDON_WARP_MSGS);
#endif
  for (int i = threadIdx.x; i < PT_WORDS; i += 32) tab[i] = table[i];
  __syncwarp();
  u32 p[8];
  copy_w<8>(p, tab + PT_FR);
  const u32 n0 = tab[PT_N0];
  u32 x[8], y[8], z[8], m[40];
  for (int i = 0; i < 8; i++) {
    x[i] = io[8 * threadIdx.x + i];
    y[i] = io[8 * (threadIdx.x + 32) + i];
    z[i] = x[i] ^ y[i];
  }
  x[7] &= 0x0FFFFFFFu, y[7] &= 0x0FFFFFFFu, z[7] &= 0x0FFFFFFFu;  // below FR
  for (int i = 0; i < 40; i++) m[i] = i < 8 ? y[i] : i < 16 ? z[i - 8] : i < 24 ? x[i - 16] : m[i - 24];
#ifdef PS_SLOT_WORDS
  if (threadIdx.x < POSEIDON_WARP_MSGS) {
    for (int s = 0; s < PS_SLOTS; s++) slot_put(sl, POSEIDON_WARP_MSGS, s, s % 3 ? (s % 3 == 1 ? y : z) : x);
  }
  __syncwarp();
#endif
  long long t0 = clock64();
#pragma unroll 1
  for (int k = 0; k < iters; k++) {
    if (OP == FB_FR_MUL) fr_mul(x, x, y, p, n0);
    if (OP == FB_FR_SQR) fr_sqr(x, x, p, n0);
    if (OP == FB_FR_SBOX) fb_sbox(x, p, n0);
    if (OP == FB_FR_MDS_ROW) fr_mds_row(x, m, x, y, z, p, n0);
    if (OP == FB_FR_SPARSE_MIX) fb_sparse_mix(x, y, z, m, p, n0);
#ifdef PS_SLOT_WORDS
    if (OP == FB_PS_FULL_ROUND)
      ps_run(k & 1 ? PS_FULL_YX_AT : PS_FULL_XY_AT, PS_FULL_ROUND_ROWS, sl, POSEIDON_WARP_MSGS,
             tab + PT_ROUNDS, tab, p, n0);
    if (OP == FB_PS_PARTIAL_ROUND)
      ps_run(PS_PARTIAL_AT, PS_PARTIAL_ROUND_ROWS, sl, POSEIDON_WARP_MSGS, tab + PT_ROUNDS, tab, p, n0);
    if (OP == FB_PS_PERMUTE) {
      ps_run(PS_START_AT, 1, sl, POSEIDON_WARP_MSGS, tab + PT_ROUNDS, tab, p, n0);
      ps_rounds(sl, POSEIDON_WARP_MSGS, tab, p, n0);
    }
#else
    if (OP == FB_PS_PERMUTE) poseidon_permute(x, y, z, tab, p, n0);
#endif
    if (OP == FB_XCHG_SLOTS) {  // lane t hands its 8 words to lane t + 8, a group's next lane
      u32* own = reinterpret_cast<u32*>(xchg + threadIdx.x);
      slot_put(own, 32, 0, x);
      __syncwarp();
      slot_get(x, reinterpret_cast<u32*>(xchg + (threadIdx.x + 8) % 32), 32, 0);
      __syncwarp();
    }
    if (OP == FB_XCHG_SHFL) {
#pragma unroll
      for (int i = 0; i < 8; i++) x[i] = __shfl_sync(0xFFFFFFFFu, x[i], (threadIdx.x + 8) % 32);
    }
  }
  long long t1 = clock64();
#ifdef PS_SLOT_WORDS
  slot_get(y, sl, POSEIDON_WARP_MSGS, PS_X0 + threadIdx.x % 3);
#endif
  for (int i = 0; i < 8; i++) io[8 * threadIdx.x + i] = x[i] ^ y[i] ^ z[i];
  cyc[threadIdx.x] = t1 - t0;
}

template <int OP>
static int launch_poseidon(u32* io, long long* cyc, int iters, const u32* table) {
  if (!table) return -1;
  poseidon_bench<OP><<<1, 32>>>(io, cyc, iters, table);
  return (int)cudaDeviceSynchronize();
}
#endif  // FB_HAS_POSEIDON

#ifdef SHA512_PASS  // this checkout's hash forms; an earlier checkout's sources lack SHA512_PASS
// The forms the kernels did not take, kept to be timed against theirs
// (PERF.md §6). A compression whose rounds after the first 16 run in
// rolled passes of PASS unrolled rounds (FULL: all unrolled); with passes of
// 8 the 16-word window turns half way, so that slot k holds W[t0 - 8 + k].
#define FB_FULL 0
template <int PASS>
__device__ void fb_sha256_compress(uint32_t* v, uint32_t* w) {
  uint32_t s[8];
  for (int k = 0; k < 8; k++) s[k] = v[k];
#pragma unroll
  for (int j = 0; j < 16; j++) sha256_round(s, j, SHA256_K[j] + w[j]);
#pragma unroll 1
  for (int t0 = 16; t0 < 64; t0 += PASS) {
#pragma unroll
    for (int j = 0; j < PASS; j++) {
      sha256_expand(w, j);
      sha256_round(s, j, SHA256_K[t0 + j] + w[j]);
    }
    if constexpr (PASS == 8) {
#pragma unroll
      for (int k = 0; k < 8; k++) {
        const uint32_t x = w[k];
        w[k] = w[k + 8];
        w[k + 8] = x;
      }
    }
  }
  for (int k = 0; k < 8; k++) v[k] += s[k];
}

template <int PASS>
__device__ void fb_sha512_compress(uint64_t* h, uint64_t* w) {
  uint64_t s[8];
  for (int k = 0; k < 8; k++) s[k] = h[k];
#pragma unroll
  for (int j = 0; j < 16; j++) sha512_round(s, j, SHA512_K[j] + w[j]);
  if constexpr (PASS == FB_FULL) {
#pragma unroll
    for (int j = 16; j < 80; j++) {
      sha512_expand(w, j);
      sha512_round(s, j, SHA512_K[j] + w[j & 15]);
    }
  } else {
#pragma unroll 1
    for (int t0 = 16; t0 < 80; t0 += PASS) {
#pragma unroll
      for (int j = 0; j < PASS; j++) {
        sha512_expand(w, j);
        sha512_round(s, j, SHA512_K[t0 + j] + w[j]);
      }
      if constexpr (PASS == 8) {
#pragma unroll
        for (int k = 0; k < 8; k++) {
          const uint64_t x = w[k];
          w[k] = w[k + 8];
          w[k + 8] = x;
        }
      }
    }
  }
  for (int k = 0; k < 8; k++) h[k] += s[k];
}

// Two lanes a message, the design the kernels did not take: lane t of a
// warp serves message t % 16, as its round lane below 16 and its schedule
// lane above. A slot holds a block's round inputs W[t] + K[t] (SHA-512: of
// rounds 16-79, two words each, low first) and 4 words of padding, so that 8
// messages' slots at that stride (a quarter-warp's 16-byte accesses) fall
// on 32 distinct banks.
#define FB_SHA256_SLOT 68
#define FB_SHA512_SLOT 132

// SHA-256's schedule lane on block blk: its 64 round inputs into kw.
__device__ void fb_sha256_schedule(const MsgReader& msg, uint32_t len, uint32_t blk, uint32_t* kw) {
  uint32_t w[16];
  sha256_block(msg, len, blk, w);
#pragma unroll
  for (int j = 0; j < 16; j += 4)
    *(uint4*)(kw + j) = make_uint4(w[j] + SHA256_K[j], w[j + 1] + SHA256_K[j + 1],
                                   w[j + 2] + SHA256_K[j + 2], w[j + 3] + SHA256_K[j + 3]);
#pragma unroll 1
  for (int t0 = 16; t0 < 64; t0 += 16) {
#pragma unroll
    for (int j = 0; j < 16; j++) sha256_expand(w, j);
#pragma unroll
    for (int j = 0; j < 16; j += 4)
      *(uint4*)(kw + t0 + j) = make_uint4(w[j] + SHA256_K[t0 + j], w[j + 1] + SHA256_K[t0 + j + 1],
                                          w[j + 2] + SHA256_K[t0 + j + 2], w[j + 3] + SHA256_K[t0 + j + 3]);
  }
}

// SHA-256's round lane on one block: v += CF(v, block) from kw, one 16-byte
// read every four rounds.
__device__ void fb_sha256_rounds(uint32_t* v, const uint32_t* kw) {
  uint32_t s[8];
  for (int k = 0; k < 8; k++) s[k] = v[k];
#pragma unroll 1
  for (int t0 = 0; t0 < 64; t0 += 16) {
#pragma unroll
    for (int j = 0; j < 16; j += 4) {
      const uint4 q = *(const uint4*)(kw + t0 + j);
      sha256_round(s, j, q.x);
      sha256_round(s, j + 1, q.y);
      sha256_round(s, j + 2, q.z);
      sha256_round(s, j + 3, q.w);
    }
  }
  for (int k = 0; k < 8; k++) v[k] += s[k];
}

// SHA-512's schedule lane on block blk: rounds 16-79's inputs into slot.
__device__ void fb_sha512_schedule(const uint64_t* prefix, const MsgReader& msg, uint32_t len, uint32_t blk,
                                   uint32_t* slot) {
  uint64_t w[16];
  sha512_block(prefix, msg, len, blk, w);
#pragma unroll 1
  for (int t0 = 16; t0 < 80; t0 += 16) {
#pragma unroll
    for (int j = 0; j < 16; j++) sha512_expand(w, j);
#pragma unroll
    for (int j = 0; j < 16; j += 2) {
      const uint64_t a = w[j] + SHA512_K[t0 + j], b = w[j + 1] + SHA512_K[t0 + j + 1];
      *(uint4*)(slot + 2 * (t0 - 16 + j)) = make_uint4((uint32_t)a, (uint32_t)(a >> 32), (uint32_t)b,
                                                       (uint32_t)(b >> 32));
    }
  }
}

// SHA-512's round lane: rounds 16-79 of a block from its slot, then h += s.
__device__ void fb_sha512_rounds_from(uint64_t* h, uint64_t* s, const uint32_t* slot) {
#pragma unroll 1
  for (int t0 = 16; t0 < 80; t0 += 16) {
#pragma unroll
    for (int j = 0; j < 16; j += 2) {
      const uint4 q = *(const uint4*)(slot + 2 * (t0 - 16 + j));
      sha512_round(s, j, (uint64_t)q.y << 32 | q.x);
      sha512_round(s, j + 1, (uint64_t)q.w << 32 | q.z);
    }
  }
  for (int k = 0; k < 8; k++) h[k] += s[k];
}
#endif  // SHA512_PASS

// The hashes' ops for one warp. Each lane's message lies in shared memory
// at an offset of its own mod 4 (the staged route's words); an iteration's
// result is folded back into the message or the state, so that no iteration
// can be hoisted. `staged` is always true at run time but unknown to the
// compiler, so a "both routes" op compiles the direct route too, as the
// kernels do. Cycles an iteration: one compression or block, one message
// (a pair's: one message a lane pair), one reduction; the cold ops record
// the first iteration alone.
#define FB_MSG_WORDS 176  // a lane's 704 bytes: a 700-byte message at an offset of 0-3
#define FB_SLOT_WORDS 2176  // the larger of the pairs' slots: 2 x 16 x 68 (SHA-256), 16 x 132

template <int OP>
__global__ void hash_bench(u32* io, long long* cyc, int iters) {
  __shared__ __align__(16) uint32_t msgs[32 * FB_MSG_WORDS + 8];
  __shared__ __align__(16) uint32_t slots[FB_SLOT_WORDS];
  const int lane = threadIdx.x;
  for (int k = lane; k < 32 * FB_MSG_WORDS + 8; k += 32) msgs[k] = io[k & 511] * 2654435761u + (uint32_t)k;
  __syncwarp();
  uint32_t v[8], w[16], ra[16], x[16], kk[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  uint64_t h[8], w64[16];
  for (int i = 0; i < 16; i++) {
    w[i] = io[16 * lane + i];
    ra[i] = io[(16 * lane + 5 * i) & 511];
    x[i] = w[i] ^ ra[i];
    w64[i] = (uint64_t)w[i] << 32 | ra[i];
  }
  for (int i = 0; i < 8; i++) v[i] = w[i] ^ w[i + 8], h[i] = w64[i] ^ w64[i + 8];
  const bool staged = iters > 0;
  const int m = OP == FB_SHA256_PAIR || OP == FB_CHALLENGE_PAIR ? lane & 15 : lane;
  const uint32_t off = (uint32_t)m * 4 * FB_MSG_WORDS + (m & 3);  // the lane's message, in bytes
  uint32_t* own = msgs + off / 4 + 1;  // a word of it, which each iteration changes
  long long t0 = clock64(), first = 0;
#pragma unroll 1
  for (int k = 0; k < iters; k++) {
    if (OP == FB_SHA256_COMPRESS) sha256_compress(v, w), w[0] ^= v[0];
    if (OP == FB_SHA512_BLOCK) sha512_compress(h, w64), w64[0] ^= h[0];
    if (OP == FB_MOD_L) {  // every word of x changes, so no product can be hoisted
      mod_l(x, kk);
      for (int i = 0; i < 16; i++) x[i] += kk[i & 7];
    }
#ifdef SHA512_PASS  // this checkout's forms
    if (OP == FB_SHA256_COMPRESS_PASS16) fb_sha256_compress<16>(v, w), w[0] ^= v[0];
    if (OP == FB_SHA256_COMPRESS_PASS8) fb_sha256_compress<8>(v, w), w[0] ^= v[0];
    if (OP == FB_SHA512_BLOCK_FULL) fb_sha512_compress<FB_FULL>(h, w64), w64[0] ^= h[0];
    if (OP == FB_SHA512_BLOCK_PASS8) fb_sha512_compress<8>(h, w64), w64[0] ^= h[0];
    if (OP == FB_SHA256_LANE) sha256_lane(MsgReader::staged(msgs, off), 700, 12, v), *own ^= v[0];
    if (OP == FB_SHA256_LANE_ROUTES || OP == FB_SHA256_LANE_COLD) {
      const MsgReader r = staged ? MsgReader::staged(msgs, off) : MsgReader::direct((const uint8_t*)io);
      sha256_lane(r, 700, 12, v);
      *own ^= v[0];
    }
    if (OP == FB_SHA256_PAIR) {  // phase p: the schedule lane fills block p's slot, the round lane runs p - 1's
      for (int i = 0; i < 8; i++) v[i] = SHA256_IV[i];
      const int nb = (int)sha256_blocks_of(700);
      uint32_t* slot = slots + m * FB_SHA256_SLOT;  // and its second slot, `stride` words on
      const int stride = 16 * FB_SHA256_SLOT;
      for (int p = 0; p <= nb; p++) {
        if (lane >= 16 && p < nb) fb_sha256_schedule(MsgReader::staged(msgs, off), 700, p, slot + (p & 1) * stride);
        if (lane < 16 && p >= 1) fb_sha256_rounds(v, slot + ((p - 1) & 1) * stride);
        __syncwarp();
      }
      if (lane < 16) *own ^= v[0];
      __syncwarp();
    }
    if (OP == FB_CHALLENGE_LANE || OP == FB_CHALLENGE_COLD) {
      challenge_lane(ra, MsgReader::staged(msgs, off), 32, 1, kk);
      *own ^= kk[0];
    }
    if (OP == FB_CHALLENGE_PAIR) {  // the schedule lane fills the slot while the round lane runs 0-15
      uint64_t prefix[8], s[8], w1[16];
      uint32_t* slot = slots + m * FB_SHA512_SLOT;
      ra_prefix(ra, prefix);
      for (int i = 0; i < 8; i++) h[i] = SHA512_IV[i];
      if (lane >= 16) {
        fb_sha512_schedule(prefix, MsgReader::staged(msgs, off), 32, 0, slot);
      } else {
        sha512_block(prefix, MsgReader::staged(msgs, off), 32, 0, w1);
        for (int i = 0; i < 8; i++) s[i] = h[i];
#pragma unroll
        for (int j = 0; j < 16; j++) sha512_round(s, j, SHA512_K[j] + w1[j]);
      }
      __syncwarp();
      if (lane < 16) fb_sha512_rounds_from(h, s, slot), challenge_finish(h, kk), *own ^= kk[0];
      __syncwarp();
    }
#else  // the parent's forms: a reader type a route
    if (OP == FB_SHA256_LANE) Sha256::message(WordReader{msgs, off}, 700, v), *own ^= v[0];
    if (OP == FB_SHA256_LANE_ROUTES || OP == FB_SHA256_LANE_COLD) {
      if (staged) Sha256::message(WordReader{msgs, off}, 700, v);
      else Sha256::message(ByteReader{(const uint8_t*)io}, 700, v);
      *own ^= v[0];
    }
    if (OP == FB_CHALLENGE_LANE || OP == FB_CHALLENGE_COLD) {
      challenge_lane(ra, WordReader{msgs, off}, 32, kk);
      *own ^= kk[0];
    }
#endif
    if ((OP == FB_SHA256_LANE_COLD || OP == FB_CHALLENGE_COLD) && k == 0) first = clock64() - t0;
  }
  long long t1 = clock64();
  for (int i = 0; i < 8; i++) io[8 * lane + i] = v[i] ^ kk[i] ^ x[i] ^ w[i] ^ (uint32_t)h[i] ^ (uint32_t)w64[i];
  io[8 * lane] ^= msgs[lane];
  cyc[lane] = OP == FB_SHA256_LANE_COLD || OP == FB_CHALLENGE_COLD ? first : t1 - t0;
}

// The one-lane BLS12-381 kernel's product as it was: CIOS with u64
// carries on 12-word structs passed by reference to a function that does
// not inline (its operands in local memory).
struct fb_bls_fp { u32 w[12]; };
__device__ __noinline__ void fb_bls_fp_mul_one_lane(fb_bls_fp& r, const fb_bls_fp& a, const fb_bls_fp& b) {
  const u32 P[12] = {0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
                     0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
  u32 t[14];
  for (int i = 0; i < 14; i++) t[i] = 0;
  for (int i = 0; i < 12; i++) {
    u64 c = 0;
    const u32 bi = b.w[i];
    for (int j = 0; j < 12; j++) {
      c += (u64)a.w[j] * bi + t[j];
      t[j] = (u32)c;
      c >>= 32;
    }
    c += t[12];
    t[12] = (u32)c;
    t[13] = (u32)(c >> 32);
    const u32 m = t[0] * 0xfffcfffdu;
    c = ((u64)m * P[0] + t[0]) >> 32;
    for (int j = 1; j < 12; j++) {
      c += (u64)m * P[j] + t[j];
      t[j - 1] = (u32)c;
      c >>= 32;
    }
    c += t[12];
    t[11] = (u32)c;
    t[12] = t[13] + (u32)(c >> 32);
  }
  u32 d[12];
  u32 borrow = sub_w<12>(d, t, P);
  for (int i = 0; i < 12; i++) r.w[i] = borrow ? t[i] : d[i];
}

// a lane's slots in a row bench: 3 of 12 words, lane-major
__device__ const u32 FB_BLS_ROW_OPS[32] = {
    0u, 1u, 2u, 3u, 4u, 5u, 6u, 7u, 8u, 9u, 10u, 11u, 12u, 13u, 14u, 15u,
    16u, 17u, 18u, 19u, 20u, 21u, 22u, 23u, 24u, 25u, 26u, 27u, 28u, 29u, 30u, 31u};

// One warp: each lane's two 12-word values below 2^380 (so below p) from
// io; cycles of `iters` dependent ops (a product's output is its next
// operand).
template <int OP>
__global__ void bls_field_bench(u32* io, long long* cyc, int iters) {
  const int lane = threadIdx.x;
  u32 x[12], y[12];
  for (int i = 0; i < 12; i++) {
    x[i] = io[8 * lane + (i & 7)] ^ (0x9e3779b9u * i);
    y[i] = io[8 * (lane + 32) + (i & 7)] ^ (0x7f4a7c15u * i);
  }
  x[11] &= 0x0FFFFFFFu, y[11] &= 0x0FFFFFFFu;
  fb_bls_fp fx, fy;
  for (int i = 0; i < 12; i++) fx.w[i] = x[i], fy.w[i] = y[i];
  long long t0 = clock64();
#pragma unroll 1
  for (int k = 0; k < iters; k++) {
    if (OP == FB_BLS_MUL_ONE_LANE) fb_bls_fp_mul_one_lane(fx, fx, fy);
#ifdef FB_HAS_BLS_FIELD
    else if (OP == FB_BLS_MUL_CIOS) bls_mul_cios(x, x, y);
    else if (OP == FB_BLS_MUL) bls_mul_mad(x, x, y);
    else if (OP == FB_BLS_MUL_ADDC) bls_mul_addc(x, x, y);
    else if (OP == FB_BLS_INV_DIVSTEP) bls_inv_divstep(x, x);
    else if (OP == FB_BLS_MUL_COLS) bls_mul(x, x, y);
    else if (OP == FB_BLS_ADD_PAR) bls_addsub_par(x, x, y, false);
    else if (OP == FB_BLS_ADD || OP == FB_BLS_SUB) bls_addsub(x, x, y, OP == FB_BLS_SUB);
    else if (OP == FB_BLS_INV_FERMAT) bls_inv_fermat(x, x);
#endif
  }
  long long t1 = clock64();
  for (int i = 0; i < 8; i++) io[8 * lane + i] = x[i] ^ x[i + 4] ^ fx.w[i];
  cyc[lane] = t1 - t0;
}

#ifdef FB_HAS_BLS_FIELD
// A row of the pairing kernel's programs: lanes below GW each run one op (a
// product, or a sum where SUMS) over their own slots, the op's word read
// from global memory as the kernel reads it, then the warp syncs; each
// lane's result is its next row's operand. Nothing but the slots lives
// across the loop, as in the kernel's row loop.
template <int GW, bool SUMS>
__global__ void bls_row_bench(u32* io, long long* cyc, int iters) {
  const int lane = threadIdx.x;
  __shared__ uint4 s_rows[32 * 3 * 3];
  u32* sl = reinterpret_cast<u32*>(s_rows) + lane * 36;
  for (int i = 0; i < 12; i++) {
    sl[i] = io[8 * lane + (i & 7)] ^ (0x9e3779b9u * i);
    sl[12 + i] = io[8 * (lane + 32) + (i & 7)] ^ (0x7f4a7c15u * i);
  }
  sl[11] &= 0x0FFFFFFFu, sl[23] &= 0x0FFFFFFFu;
  __syncwarp();
  long long t0 = clock64();
#pragma unroll 1
  for (int k = 0; k < iters; k++) {
    if (lane < GW) {
      const u32 op = __ldg(&FB_BLS_ROW_OPS[lane]);
      u32* s = reinterpret_cast<u32*>(s_rows) + op * 36;
      const uint4* q = reinterpret_cast<const uint4*>(s);
      u32 a[12], b[12], r[12];
      for (int h = 0; h < 3; h++) {
        uint4 u = q[h], v = q[3 + h];
        a[4 * h] = u.x, a[4 * h + 1] = u.y, a[4 * h + 2] = u.z, a[4 * h + 3] = u.w;
        b[4 * h] = v.x, b[4 * h + 1] = v.y, b[4 * h + 2] = v.z, b[4 * h + 3] = v.w;
      }
      if (SUMS) bls_addsub(r, a, b, k & 1);
      else bls_mul(r, a, b);
      uint4* o = reinterpret_cast<uint4*>(s);
      for (int h = 0; h < 3; h++) o[h] = make_uint4(r[4 * h], r[4 * h + 1], r[4 * h + 2], r[4 * h + 3]);
    }
    __syncwarp();
  }
  long long t1 = clock64();
  for (int i = 0; i < 8; i++) io[8 * lane + i] = sl[i] ^ sl[i + 4];
  cyc[lane] = t1 - t0;
}

template <int GW, bool SUMS>
static int launch_bls_row(u32* io, long long* cyc, int iters) {
  bls_row_bench<GW, SUMS><<<1, 32>>>(io, cyc, iters);
  return (int)cudaDeviceSynchronize();
}
#endif

#ifdef FB_HAS_BLS_COOP
// A row of the multi-pairing kernel's programs on a group of L lanes an op
// (4: a quad, 2: a pair): GW ops, op j on threads [L·j, L·j + L) of the
// block's GW·L, each over its own slots as in bls_row_bench, then the block
// syncs. KIND 0: a product on the group (bls_mul_coop), 1: a sum or a
// difference on the group (bls_addsub_coop), 2: a sum or a difference on
// the group's first lane (bls_addsub), 3: a row of products and then six
// of sums, as the kernel's loop meets them. Warp 0's lanes write their
// cycles.
template <int L, int GW, int KIND>
__global__ void bls_coop_row_bench(u32* io, long long* cyc, int iters) {
  const int t = threadIdx.x, j = t / L;
  __shared__ uint4 s_rows[32 * 3 * 3];
  u32* sl = reinterpret_cast<u32*>(s_rows) + j * 36;
  if (t % L == 0) {
    for (int i = 0; i < 12; i++) {
      sl[i] = io[8 * j + (i & 7)] ^ (0x9e3779b9u * i);
      sl[12 + i] = io[8 * (j + 32) + (i & 7)] ^ (0x7f4a7c15u * i);
    }
    sl[11] &= 0x0FFFFFFFu, sl[23] &= 0x0FFFFFFFu;
  }
  __syncthreads();
  long long t0 = clock64();
#pragma unroll 1
  for (int k = 0; k < iters; k++) {
    const u32 op = __ldg(&FB_BLS_ROW_OPS[j]);
    u32* s = reinterpret_cast<u32*>(s_rows) + op * 36;
    if (KIND == 0) {
      bls_mul_coop<L>(s, s, s + 12, true);
    } else if (KIND == 3) {
      bls_mul_coop<L>(s, s, s + 12, true);
#pragma unroll 1
      for (int m = 0; m < 6; m++) {
        __syncthreads();
        bls_addsub_coop<L>(s, s, s + 12, m & 1, true);
      }
    } else if (KIND == 1) {
      bls_addsub_coop<L>(s, s, s + 12, k & 1, true);
    } else if (t % L == 0) {
      const uint4* q = reinterpret_cast<const uint4*>(s);
      u32 a[12], b[12], r[12];
      for (int h = 0; h < 3; h++) {
        uint4 u = q[h], v = q[3 + h];
        a[4 * h] = u.x, a[4 * h + 1] = u.y, a[4 * h + 2] = u.z, a[4 * h + 3] = u.w;
        b[4 * h] = v.x, b[4 * h + 1] = v.y, b[4 * h + 2] = v.z, b[4 * h + 3] = v.w;
      }
      bls_addsub(r, a, b, k & 1);
      uint4* o = reinterpret_cast<uint4*>(s);
      for (int h = 0; h < 3; h++) o[h] = make_uint4(r[4 * h], r[4 * h + 1], r[4 * h + 2], r[4 * h + 3]);
    }
    __syncthreads();
  }
  long long t1 = clock64();
  if (t % L == 0)
    for (int i = 0; i < 8; i++) io[8 * j + i] = sl[i] ^ sl[i + 4];
  if (t < 32) cyc[t] = t1 - t0;
}

template <int L, int GW, int KIND>
static int launch_bls_coop_row(u32* io, long long* cyc, int iters) {
  bls_coop_row_bench<L, GW, KIND><<<1, GW * L>>>(io, cyc, iters);
  return (int)cudaDeviceSynchronize();
}
#endif

template <int OP>
static int launch_bls(u32* io, long long* cyc, int iters) {
  bls_field_bench<OP><<<1, 32>>>(io, cyc, iters);
  return (int)cudaDeviceSynchronize();
}

template <int OP>
static int launch_hash(u32* io, long long* cyc, int iters) {
  hash_bench<OP><<<1, 32>>>(io, cyc, iters);
  return (int)cudaDeviceSynchronize();
}

// K dependent SM2 products a loop iteration: the loop body is ~K products
// of code.
template <int K>
__global__ void body_size_bench(u32* io, long long* cyc, int iters) {
  u32 x[8], y[8];
  for (int i = 0; i < 8; i++) x[i] = io[8 * threadIdx.x + i], y[i] = io[8 * (threadIdx.x + 32) + i];
  x[7] &= 0x7FFFFFFFu, y[7] &= 0x7FFFFFFFu;
  long long t0 = clock64();
#pragma unroll 1
  for (int k = 0; k < iters; k++) {
#pragma unroll
    for (int j = 0; j < K; j++) {
      mm_mul(x, x, y);
      y[j & 7] ^= x[(j + 3) & 7];
      y[7] &= 0x7FFFFFFFu;
    }
  }
  long long t1 = clock64();
  for (int i = 0; i < 8; i++) io[8 * threadIdx.x + i] = x[i];
  cyc[threadIdx.x] = t1 - t0;
}

template <int OP>
static int launch_op(u32* io, long long* cyc, int iters) {
#ifdef SLOT_WORDS
  const int smem = SLOT_WORDS * 4 * 32;
  cudaError_t err = cudaFuncSetAttribute(field_bench<OP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
#else
  const int smem = 0;
#endif
  field_bench<OP><<<1, 32, smem>>>(io, cyc, iters);
  return (int)cudaDeviceSynchronize();
}

// Runs op `op` (or, for op = 100 + K, the body-size bench with K products a
// body) `iters` times in one warp; cyc gets each lane's cycles (for a
// cold op, the first iteration's). `table`:
// the checkout's Poseidon constants on the card (ops/poseidon.py
// KERNEL_TABLE), or null; an op the checkout lacks returns -1.
extern "C" int field_bench_run(void* io, void* cyc, int op, int iters, const void* table) {
  u32* w = (u32*)io;
  long long* c = (long long*)cyc;
#ifdef FB_HAS_POSEIDON
  const u32* tab = (const u32*)table;
#endif
  switch (op) {
    case FB_MM_MUL: return launch_op<FB_MM_MUL>(w, c, iters);
    case FB_MM_SQR: return launch_op<FB_MM_SQR>(w, c, iters);
    case FB_MM_ADD: return launch_op<FB_MM_ADD>(w, c, iters);
    case FB_FP_MUL: return launch_op<FB_FP_MUL>(w, c, iters);
    case FB_FP_SQR: return launch_op<FB_FP_SQR>(w, c, iters);
    case FB_FN_MUL: return launch_op<FB_FN_MUL>(w, c, iters);
    case FB_FN_SQR: return launch_op<FB_FN_SQR>(w, c, iters);
    case FB_SM2_DBL: return launch_op<FB_SM2_DBL>(w, c, iters);
    case FB_SM2_ADD: return launch_op<FB_SM2_ADD>(w, c, iters);
    case FB_SM2_MADD: return launch_op<FB_SM2_MADD>(w, c, iters);
    case FB_SECP_DBL: return launch_op<FB_SECP_DBL>(w, c, iters);
    case FB_SECP_ADD: return launch_op<FB_SECP_ADD>(w, c, iters);
    case FB_SECP_MADD: return launch_op<FB_SECP_MADD>(w, c, iters);
#ifdef SLOT_WORDS
    case FB_FN_INV_FERMAT: return launch_op<FB_FN_INV_FERMAT>(w, c, iters);
#endif
#ifdef FB_HAS_DIVSTEP
    case FB_FN_INV_DIVSTEP: return launch_op<FB_FN_INV_DIVSTEP>(w, c, iters);
#endif
#if defined(FB_HAS_ED25519) && defined(SLOT_WORDS)
    case FB_ED_MUL: return launch_op<FB_ED_MUL>(w, c, iters);
    case FB_ED_SQR: return launch_op<FB_ED_SQR>(w, c, iters);
    case FB_ED_DBL: return launch_op<FB_ED_DBL>(w, c, iters);
    case FB_ED_ADD: return launch_op<FB_ED_ADD>(w, c, iters);
    case FB_ED_MADD: return launch_op<FB_ED_MADD>(w, c, iters);
    case FB_ED_DECOMP: return launch_op<FB_ED_DECOMP>(w, c, iters);
#endif
#ifdef FB_HAS_POSEIDON
    case FB_FR_MUL: return launch_poseidon<FB_FR_MUL>(w, c, iters, tab);
    case FB_FR_SQR: return launch_poseidon<FB_FR_SQR>(w, c, iters, tab);
    case FB_FR_SBOX: return launch_poseidon<FB_FR_SBOX>(w, c, iters, tab);
    case FB_FR_MDS_ROW: return launch_poseidon<FB_FR_MDS_ROW>(w, c, iters, tab);
    case FB_FR_SPARSE_MIX: return launch_poseidon<FB_FR_SPARSE_MIX>(w, c, iters, tab);
#ifdef PS_SLOT_WORDS
    case FB_PS_FULL_ROUND: return launch_poseidon<FB_PS_FULL_ROUND>(w, c, iters, tab);
    case FB_PS_PARTIAL_ROUND: return launch_poseidon<FB_PS_PARTIAL_ROUND>(w, c, iters, tab);
#endif
    case FB_PS_PERMUTE: return launch_poseidon<FB_PS_PERMUTE>(w, c, iters, tab);
    case FB_XCHG_SLOTS: return launch_poseidon<FB_XCHG_SLOTS>(w, c, iters, tab);
    case FB_XCHG_SHFL: return launch_poseidon<FB_XCHG_SHFL>(w, c, iters, tab);
#endif
    case FB_SHA256_COMPRESS: return launch_hash<FB_SHA256_COMPRESS>(w, c, iters);
    case FB_SHA256_LANE: return launch_hash<FB_SHA256_LANE>(w, c, iters);
    case FB_SHA256_LANE_ROUTES: return launch_hash<FB_SHA256_LANE_ROUTES>(w, c, iters);
    case FB_SHA256_LANE_COLD: return launch_hash<FB_SHA256_LANE_COLD>(w, c, iters);
    case FB_SHA512_BLOCK: return launch_hash<FB_SHA512_BLOCK>(w, c, iters);
    case FB_CHALLENGE_LANE: return launch_hash<FB_CHALLENGE_LANE>(w, c, iters);
    case FB_MOD_L: return launch_hash<FB_MOD_L>(w, c, iters);
    case FB_CHALLENGE_COLD: return launch_hash<FB_CHALLENGE_COLD>(w, c, iters);
#ifdef SHA512_PASS
    case FB_SHA256_COMPRESS_PASS8: return launch_hash<FB_SHA256_COMPRESS_PASS8>(w, c, iters);
    case FB_SHA256_COMPRESS_PASS16: return launch_hash<FB_SHA256_COMPRESS_PASS16>(w, c, iters);
    case FB_SHA256_PAIR: return launch_hash<FB_SHA256_PAIR>(w, c, iters);
    case FB_SHA512_BLOCK_FULL: return launch_hash<FB_SHA512_BLOCK_FULL>(w, c, iters);
    case FB_SHA512_BLOCK_PASS8: return launch_hash<FB_SHA512_BLOCK_PASS8>(w, c, iters);
    case FB_CHALLENGE_PAIR: return launch_hash<FB_CHALLENGE_PAIR>(w, c, iters);
#endif
    case FB_BLS_MUL_ONE_LANE: return launch_bls<FB_BLS_MUL_ONE_LANE>(w, c, iters);
#ifdef FB_HAS_BLS_FIELD
    case FB_BLS_MUL_CIOS: return launch_bls<FB_BLS_MUL_CIOS>(w, c, iters);
    case FB_BLS_MUL: return launch_bls<FB_BLS_MUL>(w, c, iters);
    case FB_BLS_ADD: return launch_bls<FB_BLS_ADD>(w, c, iters);
    case FB_BLS_SUB: return launch_bls<FB_BLS_SUB>(w, c, iters);
    case FB_BLS_ROW8: return launch_bls_row<8, false>(w, c, iters);
    case FB_BLS_ROW16: return launch_bls_row<16, false>(w, c, iters);
    case FB_BLS_ROW32: return launch_bls_row<32, false>(w, c, iters);
    case FB_BLS_SUM_ROW32: return launch_bls_row<32, true>(w, c, iters);
    case FB_BLS_INV_FERMAT: return launch_bls<FB_BLS_INV_FERMAT>(w, c, iters);
    case FB_BLS_MUL_ADDC: return launch_bls<FB_BLS_MUL_ADDC>(w, c, iters);
    case FB_BLS_INV_DIVSTEP: return launch_bls<FB_BLS_INV_DIVSTEP>(w, c, iters);
    case FB_BLS_MUL_COLS: return launch_bls<FB_BLS_MUL_COLS>(w, c, iters);
    case FB_BLS_ADD_PAR: return launch_bls<FB_BLS_ADD_PAR>(w, c, iters);
#endif
#ifdef FB_HAS_BLS_COOP
    case FB_BLS_QUAD_ROW32: return launch_bls_coop_row<4, 32, 0>(w, c, iters);
    case FB_BLS_QUAD_ROW8: return launch_bls_coop_row<4, 8, 0>(w, c, iters);
    case FB_BLS_PAIR_ROW32: return launch_bls_coop_row<2, 32, 0>(w, c, iters);
    case FB_BLS_QUAD_SUM_ROW32: return launch_bls_coop_row<4, 32, 1>(w, c, iters);
    case FB_BLS_LEAD_SUM_ROW32: return launch_bls_coop_row<4, 32, 2>(w, c, iters);
    case FB_BLS_QUAD_MIX: return launch_bls_coop_row<4, 32, 3>(w, c, iters);
#endif
    case 101: body_size_bench<1><<<1, 32>>>(w, c, iters); break;
    case 104: body_size_bench<4><<<1, 32>>>(w, c, iters); break;
    case 108: body_size_bench<8><<<1, 32>>>(w, c, iters); break;
    case 116: body_size_bench<16><<<1, 32>>>(w, c, iters); break;
    case 124: body_size_bench<24><<<1, 32>>>(w, c, iters); break;
    case 132: body_size_bench<32><<<1, 32>>>(w, c, iters); break;
    case 164: body_size_bench<64><<<1, 32>>>(w, c, iters); break;
    default: return -1;
  }
  return (int)cudaDeviceSynchronize();
}
