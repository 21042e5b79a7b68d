// BLS12-381 aggregate-QC pairing check, a warp of lanes a check, for sm_90a.
//
// Replaces the JAX program `_pairing_check_xla` (fisco_bcos_tpu/ops/
// bls12_381.py:591, on `pairing_check_core` :571), which the JAX package ran
// as one jitted program (it has no Pallas kernel). The plain PyTorch version
// is fisco_bcos_tpu_torch/ops/bls12_381.py pairing_check_plain.
//
// Per check, one row of ten Fp values in the Montgomery domain (R = 2^384),
// twelve little-endian 32-bit words each: apk (x, y) in G1, σ and H(m)
// (x0, x1, y0, y1) affine on the twist E'(Fp2): y² = x³ + 4(1 + u); out:
//   ok = e(-g1, σ)·e(apk, H(m)) == 1,
// and, where the caller asks for it, the GT element before the comparison:
// the JAX program's element, bit for bit. The method:
//   - the tower Fp2 = Fp[u]/(u² + 1), Fp6 = Fp2[v]/(v³ - ξ), Fp12 =
//     Fp6[w]/(w² - v), ξ = 1 + u, Karatsuba products (the JAX :178-357);
//   - the double Miller loop over the bits of |x|, x = -0xd201000000010000,
//     one generic squaring of f a bit for both pairs, the twist points in
//     homogeneous projective coordinates with the doubling and mixed
//     addition steps of Costello, Lange and Naehrig (eprint 2009/615) and
//     Aranha et al. (eprint 2010/526 §4-5): a doubling with its line 3 Fp2
//     products, 6 squarings and 4 Fp products, an addition 11, 2 and 4.
//     Each line is the JAX line (c0 + c2·v) + c3·v·w times a factor in Fp2,
//     which the easy part's p⁶ - 1 kills, so the GT element is the same;
//     f times a line in 13 Fp2 products (the JAX f12_mul_line's sparse
//     shape); f conjugated at the end for x < 0;
//   - the final exponentiation: the easy part (p⁶ - 1)(p² + 1) with one
//     tower inversion down to one Fp inversion, then the hard part
//     3(p⁴ - p² + 1)/r by the oracle's chain (x - 1)²(x + p)(x² + p² - 1)
//     + 3 (crypto/ref/bls12_381.py final_exponentiation), the same integer
//     exponent as the JAX scan, so the same element. Its 317 squarings lie
//     in the cyclotomic subgroup and take Granger and Scott's (eprint
//     2009/565), 9 Fp2 squarings each: over Fp4 = Fp2[s]/(s² - ξ) with
//     s = w³ (w⁶ = v³ = ξ), f = A + B·w + C·w² with A = g0 + h1·s, B = h0 +
//     g2·s, C = g1 + h2·s, and f² = (3A² - 2Ā) + (3s·C² + 2B̄)·w + (3B² -
//     2C̄)·w² (ops/bls12_381_programs.py f12_cyclo_sqr).
// A check makes 18,818 Fp products (the bound's least, 18,806, but for the
// tower inverse's two Fp6 squarings, taken as products) and one Fp
// inversion.
//
// What bounds it on an H100: one check is a chain of dependent Fp products,
// and one warp's instruction stream sets its time (the one-lane kernel
// took 85 ms at 1 lane as at 1,024, PERF.md §6). So a check runs on a
// group of BLS_G = 32 lanes, one warp: the method is written as programs of
// rows, each row up to 32 independent Fp ops of one kind (products, or sums
// and differences) over the check's slots in shared memory; lane j of the
// warp runs op j of a row, its operands loaded from their slots into
// registers and its result stored to one, then the warp syncs. A check runs
// 800 rows of products and 4,768 rows of sums, one after another: its
// latency floor is those rows at the field bench's ~3,810 and ~383 cycles a
// row (chip_smoke.py bls_latency_floor). ops/bls12_381_programs.py writes
// the programs: its scheduler packs each program's DAG into rows, the ops
// on the longest remaining path first, a level's products together, and
// allocates the slots so that no op of a row writes a slot another op of
// the row reads. Rows of products + rows of sums a program, and its runs a
// check: a Miller iteration 6 + 31 (58 runs), with the addition steps
// 11 + 53 (5), the cyclotomic squaring 1 + 7 (317), an Fp12 product 2 + 12
// (32), the easy part's inverse 5 + 25 and 9 + 56 (1 each). The rows are
// data in global memory, read through the read-only cache, the next row's
// op a row ahead; the kernel's loop body holds one copy of each field op
// (csrc/bls12_381_field.cuh), so it stays inside the instruction cache. The
// Fp inversion runs on one lane by the safegcd divsteps (bls_inv_divstep,
// 37 rounds of 30 on 13 signed 30-bit limbs): Fermat's 570 products in
// series took 1.8 M cycles a warp (field bench), a fifth of the check. A
// group of 64 lanes (two warps: 628 rows of products) took 0.92× the time
// of 32 at one lane but 1.62× at 1,024 (PERF.md §6), so a group is a warp.
//
// Layout: a block is one warp, one check; its BLS_SLOTS slots of 48 bytes
// (12,768 B) in dynamic shared memory, a slot's 12 words read and written as
// three 16-byte accesses. 1,024 checks are 1,024 blocks, all resident.
// The Frobenius constants γ, the Montgomery 1 and -g1 come from the
// caller's table (ops/bls12_381.py kernel_table, derived from the oracle).
//
// The arithmetic and the programs' runner compile as host C++ too (no
// __CUDACC__): there a group's lanes run one after another (BLS_GROUP_FOR),
// which a row allows since no op of it reads what another writes, and the
// tier-1 tests build it with g++ and run whole checks against the oracle.
// The Miller loop (bls_miller) and the final exponentiation
// (bls_final_exp) are separate functions over a check's slots.
//
// The multi-pairing (bls12_381_multi_pairing_launch) replaces the JAX
// program `_multi_pairing_xla` (fisco_bcos_tpu/ops/bls12_381.py:599; no
// Pallas kernel): ok = ∏ e(P_i, Q_i) == 1 over K pairs, one row of six Fp
// values a pair (P x, y; Q x0, x1, y0, y1, the JAX program's argument
// order); the plain PyTorch version is ops/bls12_381.py multi_pairing_plain.
// The JAX program runs B (a power of two) one-pair Miller loops side by
// side, makes its invalid and pad lanes the Fp12 identity, multiplies the
// lanes by a halving tree and runs one final exponentiation. Here the
// caller sends only live pairs (no pad lane). What bounds it on this card:
// one launch of ⌈K/2⌉ groups, all resident (65 pairs are 33 of the 132
// SMs), so its time is one group's latency through its rows, and the
// least work is some 0.5% of it. So a group is a block of four warps, one
// on each of its SM's schedulers, and runs the check's programs by a
// runner of its own (bls_run_program_coop): quad j (lanes 4j to 4j + 3)
// runs op j of a row, a product or a sum split over its four lanes
// (csrc/bls12_381_coop.cuh), and a row ends at a block sync. The same
// rows, the slots (BLS_SLOTS) and the load lists stay; a copy of the
// programs' tables sits after the slots in shared memory, each row's
// header read two rows ahead and its ops one. In one launch:
//   - the Miller phase: a group of two consecutive pairs runs the check's
//     Miller loop with both G1 points from its rows (BLS_MP_LOADS; a lone
//     last pair of an odd K the one-pair loop of the same programs),
//     conjugated (the product's conjugate is the conjugate of the product);
//   - the product phase: a binary tree over the groups (bls_mp_tree): at
//     each level where its node has a sibling, a group writes its f to the
//     scratch `fs` and counts itself at the parent's counter (a fence, an
//     atomic; the counters set to 0 on the stream before the launch); the
//     first to arrive exits, the second reads its sibling's f through L2
//     and multiplies it into its own (BLS_SCRIPT_FMUL, 2 rows of products
//     and 12 of sums) and climbs: ⌈log2 G⌉ products on the critical path,
//     G - 1 in all. The group at the root runs the check's final
//     exponentiation and writes ok and, where asked, the GT element, which
//     is the JAX program's: an Fp12 product is exact, so its order is
//     free, and the lines' Fp2 factors die in the final exponentiation as
//     in the check.
// Timed in turns with the one-warp form this replaced (PERF.md §6):
// 0.71× at 65 pairs, 0.59× at 257, 0.76× at 2. Forms that lost there: the
// sums on the first lane of each quad (a row 424 cycles on the field bench
// against the quad's 263), a pair of lanes a product (2,634 against the
// quad's 2,336, both with the digits' meet by branches, which lost to the
// selects' 1,993), the programs' tables read from global memory (1.12× the
// shared copy), one non-inlined copy of the script runner (1.02×) or of
// the product (1.01×). Inside the kernel a row still costs some 150-250
// cycles more than on the bench.

#include "bls12_381_coop.cuh"  // and bls12_381_field.cuh

#if FISCO_PTX
#define BLS_PROG_ARRAY(type, name) __device__ const type name[]
#else
#define BLS_PROG_ARRAY(type, name) static const type name[]
#endif
#include "bls12_381_programs.cuh"

#define BLS_ROW_WORDS (10 * BLS_NW)  // a check's row
#define BLS_PAIR_WORDS (6 * BLS_NW)  // a multi-pairing pair's row
#define BLS_GT_WORDS (12 * BLS_NW)  // an Fp12 element: the GT element, a group's f
#define BLS_MP_GROUPS(n) (((n) + 1) / 2)  // groups of a K-pair multi-pairing: two pairs a group
#define BLS_MP_THREADS (BLS_G * BLS_Q)  // a multi-pairing group: a quad of lanes an op of a row
#define BLS_TABLE_WORDS (3 * BLS_NW + 3 * 6 * 2 * BLS_NW)
#define BLS_THREADS 32  // one warp a block
#define BLS_CHECKS (BLS_THREADS / BLS_G)  // checks a block
#define BLS_SLOT_WORDS (BLS_SLOTS * BLS_NW)  // a check's slots
#define BLS_SMEM_BYTES (BLS_CHECKS * BLS_SLOT_WORDS * 4)
// a multi-pairing group's shared memory: its slots, then a copy of the
// programs' tables (BLS_PROG_AT, BLS_ROWS, BLS_OPS)
#define BLS_MP_TABLE_WORDS (BLS_N_PROGS + 1 + BLS_N_ROWS + BLS_N_OPS)
#define BLS_MP_SMEM_WORDS (BLS_SLOT_WORDS + BLS_MP_TABLE_WORDS)

#ifndef __CUDACC__
// the host build counts the Fp products a check makes (a squaring where both
// operands are one slot), the inversion's too, for chip_smoke.py's figures
static unsigned long long bls_count_mul = 0, bls_count_sqr = 0;
#define BLS_COUNT(sq) ((sq) ? bls_count_sqr++ : bls_count_mul++)
#else
#define BLS_COUNT(sq) ((void)0)
#endif

// ---------------------------------------------------------------------------
// Slots, the group, the programs
// ---------------------------------------------------------------------------

DEV void bls_get(u32* v, const u32* sl, int s) {
#if FISCO_PTX
  const uint4* q = reinterpret_cast<const uint4*>(sl + BLS_NW * s);
#pragma unroll
  for (int h = 0; h < 3; h++) {
    const uint4 u = q[h];
    v[4 * h] = u.x, v[4 * h + 1] = u.y, v[4 * h + 2] = u.z, v[4 * h + 3] = u.w;
  }
#else
  for (int i = 0; i < BLS_NW; i++) v[i] = sl[BLS_NW * s + i];
#endif
}

DEV void bls_put(u32* sl, int s, const u32* v) {
#if FISCO_PTX
  uint4* q = reinterpret_cast<uint4*>(sl + BLS_NW * s);
#pragma unroll
  for (int h = 0; h < 3; h++) q[h] = make_uint4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
#else
  for (int i = 0; i < BLS_NW; i++) sl[BLS_NW * s + i] = v[i];
#endif
}

// A word of the programs (global memory, through the read-only cache).
template <class T>
DEV u32 bls_ld(const T* p) {
#if FISCO_PTX
  return (u32)__ldg(p);
#else
  return (u32)*p;
#endif
}

// BLS_GROUP_FOR(j) { ... } runs its body as group lane j: on the card once,
// for this lane's j; on the host for every j in turn. A body holds no sync.
// BLS_THREAD_FOR(T, j) likewise over a group of T threads (32: a check's
// warp; BLS_MP_THREADS: a multi-pairing group's block), bls_group_sync<T>
// its sync; BLS_COOP_FOR(j) over the ops of a multi-pairing group's row,
// op j on quad j (on the host the quad's lanes run inside the op).
#if FISCO_PTX
DEV int bls_lane() { return (int)(threadIdx.x % BLS_G); }
DEV void bls_sync() { __syncwarp(); }
template <int T>
DEV void bls_group_sync() {
  if (T == BLS_G) __syncwarp();
  else __syncthreads();
}
#define BLS_GROUP_FOR(j) for (int j = bls_lane(), j##_end = j + 1; j < j##_end; j++)
#define BLS_THREAD_FOR(T, j) for (int j = (int)(threadIdx.x % (T)), j##_end = j + 1; j < j##_end; j++)
#define BLS_COOP_FOR(j) for (int j = (int)(threadIdx.x / BLS_Q), j##_end = j + 1; j < j##_end; j++)
#define BLS_LV(j) 0  // a lane's own copy of a per-lane variable: a register
#define BLS_LANE_VARS 1
#else
DEV void bls_sync() {}
template <int T>
DEV void bls_group_sync() {}
#define BLS_GROUP_FOR(j) for (int j = 0; j < BLS_G; j++)
#define BLS_THREAD_FOR(T, j) for (int j = 0; j < (T); j++)
#define BLS_COOP_FOR(j) for (int j = 0; j < BLS_G; j++)
#define BLS_LV(j) (j)  // the host runs every lane: an array of them
#define BLS_LANE_VARS BLS_G
#endif

// Program `prog` over a check's slots: lane j runs op j of each row (a row
// of products, or of sums and differences), then the warp syncs. The next
// row's header and this lane's op in it are read before the row runs, so
// their global-memory latency hides under it.
DEV void bls_run_program(int prog, u32* sl) {
  const int r1 = (int)bls_ld(&BLS_PROG_AT[prog + 1]);
  int r = (int)bls_ld(&BLS_PROG_AT[prog]);
  u32 row = bls_ld(&BLS_ROWS[r]);
  u32 ops[BLS_LANE_VARS];
  BLS_GROUP_FOR(j) ops[BLS_LV(j)] = bls_ld(&BLS_OPS[(row >> 8) + (j < (int)((row >> 1) & 127) ? j : 0)]);
#pragma unroll 1
  for (; r < r1; r++) {
    const u32 next = r + 1 < r1 ? bls_ld(&BLS_ROWS[r + 1]) : 0u;
    BLS_GROUP_FOR(j) {
      const u32 op = ops[BLS_LV(j)];
      ops[BLS_LV(j)] = bls_ld(&BLS_OPS[(next >> 8) + (j < (int)((next >> 1) & 127) ? j : 0)]);
      if (j < (int)((row >> 1) & 127)) {
        const int sa = (int)(op >> 10) & 1023, sb = (int)(op >> 20) & 1023;
        u32 a[BLS_NW], b[BLS_NW], c[BLS_NW];
        bls_get(a, sl, sa);
        bls_get(b, sl, sb);
        if (row & 1) {
          bls_addsub(c, a, b, (op >> 30) & 1);
        } else {
          BLS_COUNT(sa == sb);
          bls_mul(c, a, b);
        }
        bls_put(sl, (int)op & 1023, c);
      }
    }
    row = next;
    bls_sync();
  }
}

// Whether quad j runs a row of n products: on the card where its warp holds
// one of them (every lane of a warp joins its shuffles), on the host where
// it holds one.
DEV bool bls_coop_live(int j, int n) {
#if FISCO_PTX
  return (j & ~(32 / BLS_Q - 1)) < n;
#else
  return j < n;
#endif
}

// Program `prog` over a multi-pairing group's slots, on its BLS_MP_THREADS
// threads: quad j runs op j of each row, then the block syncs. A row runs
// on every warp that holds one of its ops, each op over its quad
// (bls_mul_coop, bls_addsub_coop; a quad past the row's ops runs the row's
// first op and stores nothing, so that its warp's shuffles have every
// lane). The rows and ops come from the group's copy of the tables after
// its slots, a row's header two rows ahead and its ops one row ahead.
DEV void bls_run_program_coop(int prog, u32* sl) {
  const u32* at = sl + BLS_SLOT_WORDS;
  const u32* rows = at + BLS_N_PROGS + 1;
  const u32* ops_at = rows + BLS_N_ROWS;
  const int r1 = (int)at[prog + 1];
  int r = (int)at[prog];
  u32 row = rows[r], next = r + 1 < r1 ? rows[r + 1] : 0u;
  u32 ops[BLS_LANE_VARS];
  BLS_COOP_FOR(j) ops[BLS_LV(j)] = ops_at[(row >> 8) + (j < (int)((row >> 1) & 127) ? j : 0)];
#pragma unroll 1
  for (; r < r1; r++) {
    const u32 after = r + 2 < r1 ? rows[r + 2] : 0u;
    const int n = (int)((row >> 1) & 127);
    BLS_COOP_FOR(j) {
      const u32 op = ops[BLS_LV(j)];
      ops[BLS_LV(j)] = ops_at[(next >> 8) + (j < (int)((next >> 1) & 127) ? j : 0)];
      const int sa = (int)(op >> 10) & 1023, sb = (int)(op >> 20) & 1023;
      u32* d = sl + BLS_NW * (int)(op & 1023);
      if (!bls_coop_live(j, n)) continue;
      if (row & 1) {
        bls_addsub_coop<BLS_Q>(d, sl + BLS_NW * sa, sl + BLS_NW * sb, (op >> 30) & 1, j < n);
      } else {
        if (j < n) BLS_COUNT(sa == sb);
        bls_mul_coop<BLS_Q>(d, sl + BLS_NW * sa, sl + BLS_NW * sb, j < n);
      }
    }
    row = next;
    next = after;
    bls_group_sync<BLS_MP_THREADS>();
  }
}

// Entries [from, to) of the script: its programs, and the Fp inversion of
// slot BLS_S_N on lane 0; COOP: on a multi-pairing group's block.
template <bool COOP = false>
DEV void bls_run_script(int from, int to, u32* sl) {
  constexpr int T = COOP ? BLS_MP_THREADS : BLS_G;
#pragma unroll 1
  for (int k = from; k < to; k++) {
    const int prog = (int)bls_ld(&BLS_SCRIPT[k]);
    if (prog == BLS_INV) {
      BLS_THREAD_FOR(T, j) {
        if (j == 0) {
          u32 v[BLS_NW];
          bls_get(v, sl, BLS_S_N);
          BLS_COUNT(false);  // the divsteps' result into the Montgomery domain
          bls_inv_divstep(v, v);
          bls_put(sl, BLS_S_N, v);
        }
      }
      bls_group_sync<T>();
    } else if (COOP) {
      bls_run_program_coop(prog, sl);
    } else {
      bls_run_program(prog, sl);
    }
  }
}

// ---------------------------------------------------------------------------
// A check
// ---------------------------------------------------------------------------

// A group's inputs into its slots, by a load list (BLS_LOADS for a check,
// BLS_MP_LOADS for a multi-pairing group): the row's values below
// `row_vals` (a load of a value past them is skipped), the table's
// constants, zero.
template <int T = BLS_G>
DEV void bls_load(const u32* loads, int n_loads, const u32* row, int row_vals, const u32* table, u32* sl) {
  BLS_THREAD_FOR(T, j) {
#pragma unroll 1
    for (int i = j; i < n_loads; i += T) {
      const u32 e = bls_ld(&loads[i]);
      const u32 src = (e >> 10) & 3, idx = e >> 12;
      if (src == 1 && (int)idx >= row_vals) continue;
      u32 v[BLS_NW];
      for (int k = 0; k < BLS_NW; k++)
        v[k] = src == 0 ? 0u : bls_ld((src == 1 ? row : table) + BLS_NW * idx + k);
      bls_put(sl, (int)(e & 1023), v);
    }
  }
  bls_group_sync<T>();
}

// An Fp12 register's 12 slots from `src`'s 144 words (lanes 0-11), then a
// sync; bls_store_f12 writes them to `dst`. The loads go through L2 (other
// blocks of the kernel wrote `src`; the read-only path may hold stale lines).
template <int T = BLS_G>
DEV void bls_load_f12(const u32* src, int slot, u32* sl) {
  BLS_THREAD_FOR(T, j) {
    if (j < 12) {
      u32 v[BLS_NW];
#if FISCO_PTX
      for (int k = 0; k < BLS_NW; k++) v[k] = __ldcg(src + BLS_NW * j + k);
#else
      for (int k = 0; k < BLS_NW; k++) v[k] = src[BLS_NW * j + k];
#endif
      bls_put(sl, slot + j, v);
    }
  }
  bls_group_sync<T>();
}

template <int T = BLS_G>
DEV void bls_store_f12(u32* dst, int slot, const u32* sl) {
  BLS_THREAD_FOR(T, j) {
    if (j < 12) {
      u32 v[BLS_NW];
      bls_get(v, sl, slot + j);
      for (int k = 0; k < BLS_NW; k++) dst[BLS_NW * j + k] = v[k];
    }
  }
}

// f_{|x|}(P1, Q1)·f_{|x|}(P2, Q2), conjugated, into the register F, from the
// loaded slots.
DEV void bls_miller(u32* sl) { bls_run_script(0, BLS_SCRIPT_FINAL, sl); }

// F^((p¹² - 1)/r · 3) into the register BLS_S_GT (F is clobbered).
DEV void bls_final_exp(u32* sl) { bls_run_script(BLS_SCRIPT_FINAL, BLS_SCRIPT_LEN, sl); }

// The verdict (the GT element == 1) to *ok and the GT element's 144 words
// to gt, each unless null.
template <int T = BLS_G>
DEV void bls_result(const u32* sl, uint8_t* ok, u32* gt) {
  if (gt) bls_store_f12<T>(gt, BLS_S_GT, sl);
  BLS_THREAD_FOR(T, j) {
    if (j == 0 && ok) {
      u32 one[BLS_NW], v[BLS_NW], acc = 0;
      bls_get(one, sl, BLS_S_ONE);
      for (int i = 0; i < 12; i++) {
        bls_get(v, sl, BLS_S_GT + i);
        for (int k = 0; k < BLS_NW; k++) acc |= v[k] ^ (i ? 0u : one[k]);
      }
      *ok = acc == 0;
    }
  }
}

// One check on its group's lanes (all of them on the host): `sl` its
// BLS_SLOT_WORDS words of slots. Writes the verdict to *ok and the GT
// element's 144 words to gt, each unless null.
DEV void bls_pairing_check(const u32* row, const u32* table, u32* sl, uint8_t* ok, u32* gt) {
  bls_load(BLS_LOADS, BLS_N_LOADS, row, 10, table, sl);
  bls_miller(sl);
  bls_final_exp(sl);
  bls_result(sl, ok, gt);
}

// ---------------------------------------------------------------------------
// A multi-pairing
// ---------------------------------------------------------------------------

// The Miller phase of one group on its block: `pairs` (2, or 1 for the
// last of an odd K) consecutive pairs' rows from `rows`; f_{|x|} of each pair
// multiplied together with one shared squaring, conjugated, into its F.
// `sl`: the group's BLS_MP_SMEM_WORDS words, slots and tables.
DEV void bls_mp_miller(const u32* rows, int pairs, const u32* table, u32* sl) {
  u32* tab = sl + BLS_SLOT_WORDS;  // the tables first (bls_load's sync covers them)
  BLS_THREAD_FOR(BLS_MP_THREADS, j) {
    for (int i = j; i <= BLS_N_PROGS; i += BLS_MP_THREADS) tab[i] = bls_ld(&BLS_PROG_AT[i]);
    for (int i = j; i < BLS_N_ROWS; i += BLS_MP_THREADS) tab[BLS_N_PROGS + 1 + i] = bls_ld(&BLS_ROWS[i]);
    for (int i = j; i < BLS_N_OPS; i += BLS_MP_THREADS) tab[BLS_N_PROGS + 1 + BLS_N_ROWS + i] = bls_ld(&BLS_OPS[i]);
  }
  bls_load<BLS_MP_THREADS>(BLS_MP_LOADS, BLS_N_MP_LOADS, rows, 6 * pairs, table, sl);
  bls_run_script<true>(pairs == 2 ? 0 : BLS_SCRIPT_MILLER1, pairs == 2 ? BLS_SCRIPT_FINAL : BLS_SCRIPT_MILLER1_END,
                       sl);
}

// Counts the caller's arrival at a node of the product tree (*c, 0 at the
// launch): false for the first of its two children to arrive. The second
// reads the first's f after the fence, through L2.
DEV bool bls_mp_arrive(unsigned* c) {
#if FISCO_PTX
  __shared__ unsigned s_first;
  __threadfence();  // each thread's f words reach every block before the count
  __syncthreads();
  if (threadIdx.x == 0) s_first = atomicAdd(c, 1u) == 0;
  __syncthreads();
  if (s_first) return false;
  __threadfence();
  return true;
#else
  return (*c)++ != 0;
#endif
}

// The product phase's tree, in group `group` of `groups` after its Miller
// phase: a binary tree over the groups, node n of level l the groups [n·2^l,
// (n + 1)·2^l), its f at fs[n·2^l] (144 words). At each level where its node
// has a sibling, the group writes its F there and counts itself at the
// parent's counter (cnt: one a node with two children, level by level);
// the first to arrive exits, the second multiplies the sibling's f into its
// F (BLS_SCRIPT_FMUL: F <- F·A) and climbs. Returns true in the group that
// reaches the root with the product of every group's f: ⌈log2 groups⌉
// products on its path, groups - 1 in all.
DEV bool bls_mp_tree(u32* fs, unsigned* cnt, int groups, int group, u32* sl) {
  int node = group, width = groups, at = 0;
#pragma unroll 1
  for (int l = 0; width > 1; l++) {
    if ((node ^ 1) < width) {
      bls_store_f12<BLS_MP_THREADS>(fs + (long)(node << l) * BLS_GT_WORDS, BLS_S_F, sl);
      if (!bls_mp_arrive(cnt + at + (node >> 1))) return false;
      bls_load_f12<BLS_MP_THREADS>(fs + (long)((node ^ 1) << l) * BLS_GT_WORDS, BLS_S_A, sl);
      bls_run_script<true>(BLS_SCRIPT_FMUL, BLS_SCRIPT_FMUL + 1, sl);
    }
    at += width >> 1;
    node >>= 1;
    width = (width + 1) >> 1;
  }
  return true;
}

// The root's end: the final exponentiation, the verdict and the GT element.
DEV void bls_mp_finish(u32* sl, uint8_t* ok, u32* gt) {
  bls_run_script<true>(BLS_SCRIPT_FINAL, BLS_SCRIPT_LEN, sl);
  bls_result<BLS_MP_THREADS>(sl, ok, gt);
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(BLS_THREADS)
bls12_381_pairing_kernel(const u32* __restrict__ rows, const u32* __restrict__ table,
                         uint8_t* __restrict__ ok, u32* __restrict__ gt, int n) {
  extern __shared__ uint4 s_slots[];
  const int c = (int)threadIdx.x / BLS_G;
  const int check = (int)blockIdx.x * BLS_CHECKS + c;
  const int row = check < n ? check : n - 1;  // a group past the batch runs the last row, writes nothing
  bls_pairing_check(rows + (size_t)row * BLS_ROW_WORDS, table,
                    reinterpret_cast<u32*>(s_slots) + (size_t)c * BLS_SLOT_WORDS,
                    check < n ? ok + check : nullptr,
                    gt && check < n ? gt + (size_t)check * 12 * BLS_NW : nullptr);
}

// A block a group: its Miller phase, then its climb of the product tree;
// the group that reaches the root ends the multi-pairing. `cnt` holds the
// tree's counters (0 at the launch).
static_assert(BLS_MP_THREADS == 4 * 32, "a multi-pairing group is four warps: a quad of lanes for each of a row's 32 ops");
__global__ void __launch_bounds__(BLS_MP_THREADS, 1)
bls12_381_multi_pairing_kernel(const u32* __restrict__ rows, const u32* __restrict__ table, u32* fs,
                               unsigned* cnt, uint8_t* __restrict__ ok, u32* __restrict__ gt, int n) {
  extern __shared__ uint4 s_slots[];
  u32* sl = reinterpret_cast<u32*>(s_slots);
  const int groups = BLS_MP_GROUPS(n), group = (int)blockIdx.x, first = 2 * group;
  bls_mp_miller(rows + (size_t)first * BLS_PAIR_WORDS, n - first < 2 ? 1 : 2, table, sl);
  if (bls_mp_tree(fs, cnt, groups, group, sl)) bls_mp_finish(sl, ok, gt);
}

extern "C" void bls12_381_geometry(int n, int* out) {
  out[0] = BLS_THREADS;
  out[1] = (n + BLS_CHECKS - 1) / BLS_CHECKS;
  out[2] = BLS_SMEM_BYTES;
}

// C entry point for ctypes: launches on `stream` of `device`, does not
// synchronise; returns the first CUDA error (0 on success). `gt` may be
// null; else it takes each lane's GT element, 144 words a lane.
extern "C" int bls12_381_pairing_launch(const void* rows, const void* table, void* ok, void* gt,
                                        int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  err = cudaFuncSetAttribute(bls12_381_pairing_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             BLS_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int geo[3];
  bls12_381_geometry(n, geo);
  bls12_381_pairing_kernel<<<geo[1], geo[0], geo[2], (cudaStream_t)stream>>>(
      (const u32*)rows, (const u32*)table, (uint8_t*)ok, (u32*)gt, n);
  return (int)cudaGetLastError();
}

// C entry point of the multi-pairing: rows [n, 72] words (n >= 1 pairs),
// the table, `fs` the caller's scratch of ⌈n/2⌉ f values (144 words each)
// and as many words more (the product tree's counters, one a node with two
// children), ok one byte, gt null or 144 words. The counters' reset and one
// launch on `stream` of `device`, no sync; returns the first CUDA error (0
// on success).
extern "C" int bls12_381_multi_pairing_launch(const void* rows, const void* table, void* fs, void* ok, void* gt,
                                              int n, int device, void* stream) {
  static_assert(BLS_MP_SMEM_WORDS * 4 <= 48 * 1024, "a group's slots and tables fit the default dynamic shared memory");
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const int groups = BLS_MP_GROUPS(n);
  unsigned* cnt = reinterpret_cast<unsigned*>((u32*)fs + (size_t)groups * BLS_GT_WORDS);
  if (groups > 1) {
    err = cudaMemsetAsync(cnt, 0, (groups - 1) * sizeof(unsigned), (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  bls12_381_multi_pairing_kernel<<<groups, BLS_MP_THREADS, BLS_MP_SMEM_WORDS * 4, (cudaStream_t)stream>>>(
      (const u32*)rows, (const u32*)table, (u32*)fs, cnt, (uint8_t*)ok, (u32*)gt, n);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
