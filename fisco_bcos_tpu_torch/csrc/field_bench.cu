// Cycles per field op and per group-law op for one warp (clock64() around
// a loop; Ed25519's programs in the checkout's layout: one lane a
// signature, or a quad of lanes, so the cycles are a signature's latency
// either way), and cycles per SM2 product as a loop body grows: the
// measurements behind the kernels' design (PERF.md §6). Poseidon's GF(FR)
// ops, rounds and permutation likewise (a message's latency: one thread a
// message in a checkout before the lane groups, a group of four lanes
// after; a product's REDC in u64 before them, in PTX carry chains after),
// and 8 words handed between lanes by slots and by shuffles. Not a kernel
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
  FB_XCHG_SLOTS, FB_XCHG_SHFL, FB_OPS
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
      "8 words between the lanes of a group: 8 __shfl_sync"};
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
// body) `iters` times in one warp; cyc gets each lane's cycles. `table`:
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
