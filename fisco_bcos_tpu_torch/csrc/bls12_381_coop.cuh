// BLS12-381's base field GF(p) split over a group of L lanes an op (a quad,
// L = 4, in the kernel): the field layer of csrc/bls12_381.cu's
// multi-pairing kernel, which replaces the JAX program `_multi_pairing_xla`
// (fisco_bcos_tpu/ops/bls12_381.py:599; no Pallas kernel). The values are
// csrc/bls12_381_field.cuh's: 12 little-endian 32-bit words in the
// Montgomery domain (R = 2^384), canonical residues, in shared-memory
// slots; lane q of a group holds digit q, words [DW·q, DW·q + DW) with DW =
// 12 / L, of every value it works on.
//
// Why: a multi-pairing is one launch of at most ⌈K/2⌉ groups, all
// resident, so only a group's latency counts; one lane an Fp product
// (bls_mul) is one warp's dependent instruction stream, 3,809 cycles a row
// of products on the field bench, on one of its SM's four schedulers. Here
// a row's ops run on four warps, a quad of lanes each: a row of 32
// products 1,993 cycles, of 32 sums 263 (one lane a sum: 383; PERF.md
// §6). The quad is latency-bound too (some 0.4 instructions a cycle): its
// chains of carries and its shuffles and ballots, not the rate at which it
// issues, set its time.
//
// The product (bls_mul_coop) is Montgomery's by whole products, each split
// like the first: with N' = -p^-1 mod R,
//   T = a·b: lane q the strip a_q·b (a_q its digit of a, 3 × 12 word
//     products with 64-bit carries; DW + 12 words);
//   m = (T mod R)·N' mod R: the strips' low digits meet by shuffles (lane q
//     sums digit q of every strip, DW words and a carry word, unnormalised),
//     lane q the strip of that digit times N', truncated at R; those meet
//     likewise and are normalised across the group (a carry word by one
//     shuffle, then the 0/1 carries through digits of all ones by two
//     ballots: bls_qcarries);
//   r = (T + m·p) / R: lane q adds m_q·p into its strip, the strips meet
//     at the high digits, and the carry out of the low half, which is
//     ≡ 0 mod R, is hi + [lo ≠ 0] of the top lane's low digit alone (every
//     normalised low digit is 0, so no chain runs through them); then one
//     normalisation and the conditional subtraction of p by one more chain.
// The result is the canonical a·b·R^-1 mod p, which is unique: bls_mul's,
// bit for bit. A sum or a difference (bls_addsub_coop) is two such chains.
//
// Everything compiles as host C++ too (no __CUDACC__): there a group's
// lanes run in turn (BLS_QFOR), a per-lane variable is an array of L, a
// shuffle reads another lane's element (bls_qget) and a ballot gathers the
// L elements (bls_qballot). A loop that shuffles an array never writes it,
// so running the lanes in turn gives what the lanes give together. The
// tier-1 tests build it with g++ against bls_mul and bls_addsub.

#ifndef FISCO_BLS12_381_COOP_CUH
#define FISCO_BLS12_381_COOP_CUH

#include "bls12_381_field.cuh"

#define BLS_Q 4  // lanes an op in the multi-pairing kernel: a quad

// N' = -p^-1 mod 2^384
CONSTMEM u32 BLS_NP[BLS_NW] = {0xfffcfffdu, 0x89f3fffcu, 0xd9d113e8u, 0x286adb92u,
                               0xc8e30b48u, 0x16ef2ef0u, 0x8eb2db4cu, 0x19ecca0eu,
                               0xe268cf58u, 0x68b316feu, 0xfeaafc94u, 0xceb06106u};

// BLS_QFOR(L, q) { ... } runs its body as lane q of a group of L: on the
// card once, for this thread's q; on the host for every q in turn.
// BLS_QI(q) indexes a per-lane array of BLS_QN(L) elements.
#if FISCO_PTX
#define BLS_QFOR(L, q) for (int q = (int)(threadIdx.x % (L)), q##_end = q + 1; q < q##_end; q++)
#define BLS_QI(q) 0
#define BLS_QN(L) 1
#else
#define BLS_QFOR(L, q) for (int q = 0; q < (L); q++)
#define BLS_QI(q) (q)
#define BLS_QN(L) (L)
#endif

// Lane `src`'s element of the per-lane array v, in the caller's group.
template <int L>
DEV u32 bls_qget(const u32* v, int src) {
#if FISCO_PTX
  return __shfl_sync(0xffffffffu, v[0], (int)(threadIdx.x & 31 & ~(L - 1)) | src);
#else
  return v[src];
#endif
}

// The group's predicates as L bits, bit i lane i's.
template <int L>
DEV u32 bls_qballot(const bool* v) {
#if FISCO_PTX
  return (__ballot_sync(0xffffffffu, v[0]) >> (threadIdx.x & 31 & ~(L - 1))) & ((1u << L) - 1);
#else
  u32 m = 0;
  for (int i = 0; i < L; i++) m |= (u32)v[i] << i;
  return m;
#endif
}

// The carries of a chain over the group's digits, from each lane's generate
// bit g (its digit overflowed) and propagate bit p (its digit is all ones;
// never both), c0 the carry into lane 0: bit i is the carry into lane i,
// bit L the carry out of the top lane.
DEV u32 bls_qcarries(u32 g, u32 p, u32 c0) { return (((g << 1) | c0) + p) ^ p; }

// Word t of lane q's digit of the constant c (12 words): a select over the
// lanes, so the words stay immediates.
template <int L>
DEV u32 bls_qdigit(const u32* c, int q, int t) {
  constexpr int DW = BLS_NW / L;
  u32 v = c[t];
#pragma unroll
  for (int i = 1; i < L; i++) v = q == i ? c[DW * i + t] : v;
  return v;
}

// x (DW words) += y (DW words) + cin; returns the carry out.
template <int DW>
DEV u32 bls_qadd(u32* x, const u32* y, u32 cin) {
  u64 c = cin;
#pragma unroll
  for (int t = 0; t < DW; t++) {
    c += (u64)x[t] + y[t];
    x[t] = (u32)c;
    c >>= 32;
  }
  return (u32)c;
}

template <int DW>
DEV bool bls_qones(const u32* x) {
  u32 a = x[0];
#pragma unroll
  for (int t = 1; t < DW; t++) a &= x[t];
  return a == 0xffffffffu;
}

// Lane q's sum of digit q (low) and digit q + L (high) of the group's
// strips: lane q' holds s[·][q'], SW words from word DW·q' of the whole.
// lo, hi: DW words and a carry word each; `high` false skips the high digit.
template <int L, int SW>
DEV void bls_qmeet(u32 (*s)[BLS_QN(L)], int q, u32* lo, u32* hi, bool high) {
  constexpr int DW = BLS_NW / L;
  u64 cl[DW], ch[DW];
#pragma unroll
  for (int t = 0; t < DW; t++) cl[t] = s[t][BLS_QI(q)], ch[t] = 0;
#pragma unroll
  for (int d = 1; d * DW < SW; d++) {
#pragma unroll
    for (int t = 0; t < DW && d * DW + t < SW; t++) {
      if (d == L) {  // the lane's own high digit
        if (high) ch[t] += s[d * DW + t][BLS_QI(q)];
        continue;
      }
      if (!high && d >= L) continue;
      // selects, not branches: the lanes of a warp take different sides
      const int src = (q - d) & (L - 1);
      const u32 x = bls_qget<L>(s[d * DW + t], src);
      cl[t] += src + d == q ? x : 0u;
      if (high) ch[t] += src + d == q + L ? x : 0u;
    }
  }
  u64 k = 0, kh = 0;
#pragma unroll
  for (int t = 0; t < DW; t++) {
    k += cl[t], kh += ch[t];
    lo[t] = (u32)k, hi[t] = (u32)kh;
    k >>= 32, kh >>= 32;
  }
  lo[DW] = (u32)k, hi[DW] = (u32)kh;
}

// d = a·b·R^-1 mod p on a group of L lanes (a, b canonical; the slots'
// words); lane q loads its digit of a and all of b, and stores its digit of
// d where `store`. Every lane of the warp calls it together.
template <int L>
DEV void bls_mul_coop(u32* d, const u32* a, const u32* b, bool store) {
  constexpr int DW = BLS_NW / L, SW = DW + BLS_NW, QN = BLS_QN(L);
  u32 s[SW + 1][QN];       // the lane's strip: a_q·b, then + m_q·p
  u32 ms[BLS_NW][QN];      // the lane's strip of m, truncated at R
  u32 md[DW][QN], mh[QN];  // digit q of m, and its carry word
  u32 r[DW][QN], rh[QN];   // digit q of (T + m·p) / R, and the carry word it passes on
  // a chain's generate and propagate bits; a loop that ballots one pair
  // writes the other
  bool g[QN], pr[QN], g2[QN], pr2[QN];
  BLS_QFOR(L, q) {  // T's strip
    u32 ad[DW], bw[BLS_NW], acc[SW];
#pragma unroll
    for (int t = 0; t < DW; t++) ad[t] = a[DW * q + t];
#if FISCO_PTX
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
#pragma unroll
    for (int h = 0; h < 3; h++) {
      const uint4 v = b4[h];
      bw[4 * h] = v.x, bw[4 * h + 1] = v.y, bw[4 * h + 2] = v.z, bw[4 * h + 3] = v.w;
    }
#else
    for (int j = 0; j < BLS_NW; j++) bw[j] = b[j];
#endif
#pragma unroll
    for (int k = 0; k < SW; k++) acc[k] = 0;
#pragma unroll
    for (int i = 0; i < DW; i++) {
      u64 c = 0;
#pragma unroll
      for (int j = 0; j < BLS_NW; j++) {
        c += (u64)ad[i] * bw[j] + acc[i + j];
        acc[i + j] = (u32)c;
        c >>= 32;
      }
      acc[i + BLS_NW] = (u32)c;
    }
#pragma unroll
    for (int k = 0; k < SW; k++) s[k][BLS_QI(q)] = acc[k];
    s[SW][BLS_QI(q)] = 0;
  }
  BLS_QFOR(L, q) {  // digit q of T mod R, then m's strip: that digit times N', mod R
    u32 lo[DW + 1], hi[DW + 1], m[BLS_NW];
    bls_qmeet<L, SW>(s, q, lo, hi, false);
#pragma unroll
    for (int k = 0; k < BLS_NW; k++) m[k] = 0;
#pragma unroll
    for (int i = 0; i <= DW; i++) {
      u64 c = 0;
#pragma unroll
      for (int j = 0; i + j < BLS_NW; j++) {
        c += (u64)lo[i] * BLS_NP[j] + m[i + j];
        m[i + j] = (u32)c;
        c >>= 32;
      }
    }
#pragma unroll
    for (int k = 0; k < BLS_NW; k++) ms[k][BLS_QI(q)] = m[k];
  }
  BLS_QFOR(L, q) {  // digit q of m, unnormalised
    u32 lo[DW + 1], hi[DW + 1];
    bls_qmeet<L, BLS_NW>(ms, q, lo, hi, false);
#pragma unroll
    for (int t = 0; t < DW; t++) md[t][BLS_QI(q)] = lo[t];
    mh[BLS_QI(q)] = lo[DW];
  }
  BLS_QFOR(L, q) {  // m's carry words one digit up (the top one leaves R)
    const u32 cin = bls_qget<L>(mh, (q - 1) & (L - 1));
    u32 x[DW], z[DW] = {0};
#pragma unroll
    for (int t = 0; t < DW; t++) x[t] = md[t][BLS_QI(q)];
    g[BLS_QI(q)] = bls_qadd<DW>(x, z, q ? cin : 0u) != 0;
    pr[BLS_QI(q)] = bls_qones<DW>(x);
#pragma unroll
    for (int t = 0; t < DW; t++) md[t][BLS_QI(q)] = x[t];
  }
  BLS_QFOR(L, q) {  // m normalised; the lane adds m_q·p into its strip
    const u32 c = bls_qcarries(bls_qballot<L>(g), bls_qballot<L>(pr), 0);
    u32 x[DW], z[DW] = {0}, acc[SW + 1];
#pragma unroll
    for (int t = 0; t < DW; t++) x[t] = md[t][BLS_QI(q)];
    bls_qadd<DW>(x, z, (c >> q) & 1);
#pragma unroll
    for (int k = 0; k <= SW; k++) acc[k] = s[k][BLS_QI(q)];
#pragma unroll
    for (int i = 0; i < DW; i++) {
      u64 cc = 0;
#pragma unroll
      for (int j = 0; j < BLS_NW; j++) {
        cc += (u64)x[i] * BLS_P[j] + acc[i + j];
        acc[i + j] = (u32)cc;
        cc >>= 32;
      }
#pragma unroll
      for (int k = i + BLS_NW; k <= SW; k++) {
        cc += acc[k];
        acc[k] = (u32)cc;
        cc >>= 32;
      }
    }
#pragma unroll
    for (int k = 0; k <= SW; k++) s[k][BLS_QI(q)] = acc[k];
  }
  BLS_QFOR(L, q) {  // digit q + L of T + m·p; the top lane's low digit gives the carry out of R
    u32 lo[DW + 1], hi[DW + 1];
    bls_qmeet<L, SW + 1>(s, q, lo, hi, true);
    u32 nz = 0;
#pragma unroll
    for (int t = 0; t < DW; t++) nz |= lo[t], r[t][BLS_QI(q)] = hi[t];
    rh[BLS_QI(q)] = q == L - 1 ? lo[DW] + (nz != 0) : hi[DW];
  }
  BLS_QFOR(L, q) {  // the carry words one digit up
    const u32 cin = bls_qget<L>(rh, (q - 1) & (L - 1));
    u32 x[DW], z[DW] = {0};
#pragma unroll
    for (int t = 0; t < DW; t++) x[t] = r[t][BLS_QI(q)];
    g[BLS_QI(q)] = bls_qadd<DW>(x, z, cin) != 0;
    pr[BLS_QI(q)] = bls_qones<DW>(x);
#pragma unroll
    for (int t = 0; t < DW; t++) r[t][BLS_QI(q)] = x[t];
  }
  BLS_QFOR(L, q) {  // normalised: r < 2p; then y = r + ~p + 1 = r - p
    const u32 c = bls_qcarries(bls_qballot<L>(g), bls_qballot<L>(pr), 0);
    u32 x[DW], z[DW] = {0}, np[DW];
#pragma unroll
    for (int t = 0; t < DW; t++) x[t] = r[t][BLS_QI(q)], np[t] = ~bls_qdigit<L>(BLS_P, q, t);
    bls_qadd<DW>(x, z, (c >> q) & 1);
#pragma unroll
    for (int t = 0; t < DW; t++) r[t][BLS_QI(q)] = x[t];
    g2[BLS_QI(q)] = bls_qadd<DW>(x, np, 0) != 0;
    pr2[BLS_QI(q)] = bls_qones<DW>(x);
#pragma unroll
    for (int t = 0; t < DW; t++) md[t][BLS_QI(q)] = x[t];  // y, in m's registers
  }
  BLS_QFOR(L, q) {  // r - p where it does not borrow (r >= p), else r
    const u32 c = bls_qcarries(bls_qballot<L>(g2), bls_qballot<L>(pr2), 1);
    u32 y[DW], z[DW] = {0};
#pragma unroll
    for (int t = 0; t < DW; t++) y[t] = md[t][BLS_QI(q)];
    bls_qadd<DW>(y, z, (c >> q) & 1);
    const bool ge = (c >> L) & 1;
    if (store) {
#pragma unroll
      for (int t = 0; t < DW; t++) d[DW * q + t] = ge ? y[t] : r[t][BLS_QI(q)];
    }
  }
}

// d = a + b, or a - b, mod p on a group of L lanes (a, b canonical): x = a
// + b (a - b as a + ~b + 1), then y = x - p (x + ~p + 1; taken where it does
// not borrow) or, for a difference that borrowed, y = x + p (mod 2^384).
template <int L>
DEV void bls_addsub_coop(u32* d, const u32* a, const u32* b, bool sub, bool store) {
  constexpr int DW = BLS_NW / L, QN = BLS_QN(L);
  u32 x[DW][QN], y[DW][QN];
  bool g[QN], pr[QN], g2[QN], pr2[QN];
  BLS_QFOR(L, q) {
    u32 v[DW], w[DW];
#pragma unroll
    for (int t = 0; t < DW; t++) v[t] = a[DW * q + t], w[t] = sub ? ~b[DW * q + t] : b[DW * q + t];
    g[BLS_QI(q)] = bls_qadd<DW>(v, w, 0) != 0;
    pr[BLS_QI(q)] = bls_qones<DW>(v);
#pragma unroll
    for (int t = 0; t < DW; t++) x[t][BLS_QI(q)] = v[t];
  }
  u32 take[QN];
  BLS_QFOR(L, q) {
    const u32 c = bls_qcarries(bls_qballot<L>(g), bls_qballot<L>(pr), sub);
    u32 v[DW], w[DW], z[DW] = {0};
#pragma unroll
    for (int t = 0; t < DW; t++) {
      v[t] = x[t][BLS_QI(q)];
      const u32 pw = bls_qdigit<L>(BLS_P, q, t);
      w[t] = sub ? pw : ~pw;
    }
    bls_qadd<DW>(v, z, (c >> q) & 1);
    take[BLS_QI(q)] = sub && !((c >> L) & 1);  // a < b: x + p
#pragma unroll
    for (int t = 0; t < DW; t++) x[t][BLS_QI(q)] = v[t];
    g2[BLS_QI(q)] = bls_qadd<DW>(v, w, 0) != 0;
    pr2[BLS_QI(q)] = bls_qones<DW>(v);
#pragma unroll
    for (int t = 0; t < DW; t++) y[t][BLS_QI(q)] = v[t];
  }
  BLS_QFOR(L, q) {
    const u32 c = bls_qcarries(bls_qballot<L>(g2), bls_qballot<L>(pr2), !sub);
    u32 v[DW], z[DW] = {0};
#pragma unroll
    for (int t = 0; t < DW; t++) v[t] = y[t][BLS_QI(q)];
    bls_qadd<DW>(v, z, (c >> q) & 1);
    const bool use_y = sub ? take[BLS_QI(q)] != 0 : ((c >> L) & 1) != 0;  // a + b >= p
    if (store) {
#pragma unroll
      for (int t = 0; t < DW; t++) d[DW * q + t] = use_y ? v[t] : x[t][BLS_QI(q)];
    }
  }
}

#endif  // FISCO_BLS12_381_COOP_CUH
