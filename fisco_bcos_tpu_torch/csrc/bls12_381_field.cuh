// BLS12-381's base field GF(p), p < 2^381, as 12 little-endian 32-bit
// words in the Montgomery domain (R = 2^384), canonical residues: the field
// ops of csrc/bls12_381.cu, which runs them one lane an op, operands in
// registers, and of chip_smoke.py's field bench (csrc/field_bench.cu).
//
// The product is a·b·R^-1 mod p for a·b < p·R by columns with deferred
// carries (bls_mul): in the kernel 0.948× its time with the CIOS product
// (in turns), though alone, on one dependent chain, it takes 5,035 cycles
// a warp against CIOS's 3,118. A sum or a difference is one path of three
// carry chains (bls_addsub: 188 cycles; two chains side by side took 284,
// and the kernel 1.04× at one lane though 0.92× at 1,024). The Fp
// inversion is safegcd divsteps (bls_inv_divstep: 90,251 cycles against
// Fermat's 1,811,533). The forms the kernel did not take (CIOS, rows of PTX
// mad or add carries, the two-chain sum, Fermat) live in the field bench,
// which times them against these (PERF.md §6).
//
// Everything compiles as host C++ too (no __CUDACC__): the tier-1 tests
// build it with g++.

#ifndef FISCO_BLS12_381_FIELD_CUH
#define FISCO_BLS12_381_FIELD_CUH

#include "wide_int.cuh"
#include "secp256k1_modinv.cuh"  // divsteps_30

#define BLS_NW 12  // words of an Fp value

CONSTMEM u32 BLS_P[BLS_NW] = {0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
                              0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
                              0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
#define BLS_N0 0xfffcfffdu  // -p^-1 mod 2^32

// r = s - p if s >= p else s, for s < 2p
DEV void bls_cond_sub(u32* r, const u32* s) {
  u32 d[BLS_NW];
  const u32 borrow = sub_w<BLS_NW>(d, s, BLS_P);
#pragma unroll
  for (int i = 0; i < BLS_NW; i++) r[i] = borrow ? s[i] : d[i];
}

// r = a·b·R^-1 mod p for a·b < p·R (canonical a, b); r may alias a or b.
// By columns with deferred carries: every word product's
// low and high halves are added into 64-bit column sums (each under 2^38:
// at most 48 terms below 2^32), with no carry between columns, so the adds
// are independent of each other; REDC by columns, m_k from column k once
// the carry of column k - 1 is in; then one carry pass over the top 12
// columns.
DEV void bls_mul(u32* r, const u32* a, const u32* b) {
  u64 acc[2 * BLS_NW];
#pragma unroll
  for (int k = 0; k < 2 * BLS_NW; k++) acc[k] = 0;
#pragma unroll
  for (int i = 0; i < BLS_NW; i++) {
#pragma unroll
    for (int j = 0; j < BLS_NW; j++) {
      const u64 p = (u64)a[j] * b[i];
      acc[i + j] += (u32)p;
      if (i + j + 1 < 2 * BLS_NW) acc[i + j + 1] += p >> 32;
    }
  }
#pragma unroll
  for (int k = 0; k < BLS_NW; k++) {
    if (k) acc[k] += acc[k - 1] >> 32;  // the low word of column k - 1 is 0 now
    const u32 m = (u32)acc[k] * BLS_N0;
#pragma unroll
    for (int j = 0; j < BLS_NW; j++) {
      const u64 q = (u64)m * BLS_P[j];
      acc[k + j] += (u32)q;
      acc[k + j + 1] += q >> 32;
    }
  }
  u32 t[BLS_NW];
  u64 c = acc[BLS_NW - 1] >> 32;
#pragma unroll
  for (int k = BLS_NW; k < 2 * BLS_NW; k++) {
    c += acc[k];
    t[k - BLS_NW] = (u32)c;
    c >>= 32;
  }
  bls_cond_sub(r, t);  // < 2p, and no carry past the top word
}

// r = a + b, or a - b as a + (p - b), mod p for canonical a, b: one path
// for both, so the lanes of a row of sums and differences do not diverge
// (for b = 0, p - b = p, and the subtract of p gives a back).
DEV void bls_addsub(u32* r, const u32* a, const u32* b, bool sub) {
  u32 nb[BLS_NW], s[BLS_NW];
  sub_w<BLS_NW>(nb, BLS_P, b);
#pragma unroll
  for (int i = 0; i < BLS_NW; i++) nb[i] = sub ? nb[i] : b[i];
  add_w<BLS_NW>(s, a, nb);  // < 2p < 2^382: no carry out
  bls_cond_sub(r, s);
}

// ---------------------------------------------------------------------------
// The Fp inversion by safegcd divsteps
// ---------------------------------------------------------------------------

// p in 13 signed 30-bit limbs (little-endian; the top limb carries a
// value's sign), p^-1 mod 2^30, and R^3 mod p (Montgomery words)
#define BLS_P_S30 {0x3fffaaab, 0x27fbffff, 0x153ffffb, 0x2affffac, 0x30f6241e, 0x034a83da, 0x112bf673, \
                   0x12e13ce1, 0x2cd76477, 0x1ed90d2e, 0x29a4b1ba, 0x3a8e5ff9, 0x001a0111}
#define BLS_P_INV30 0x30003u
#define BLS_S30 13
CONSTMEM u32 BLS_R3[BLS_NW] = {0xd94ca1e0u, 0xed48ac6bu, 0x03a7adf8u, 0x315f831eu, 0x615e29ddu, 0x9a53352au,
                               0x921e1761u, 0x34c04e5eu, 0x65724728u, 0x2512d435u, 0x91755d4du, 0x0aa63460u};

// (d, e) = (t·(d, e) + p·(md, me)) / 2^30, md, me chosen so the division is
// exact and d, e stay in (-2p, p) (secp256k1_modinv.cuh update_de_30 over
// 13 limbs)
DEV void bls_update_de_30(int32_t* d, int32_t* e, const int32_t* t) {
  const int32_t N[BLS_S30] = BLS_P_S30;
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  const int32_t sd = d[BLS_S30 - 1] >> 31, se = e[BLS_S30 - 1] >> 31;
  int32_t md = (u & sd) + (v & se), me = (q & sd) + (r & se);
  int64_t cd = (int64_t)u * d[0] + (int64_t)v * e[0];
  int64_t ce = (int64_t)q * d[0] + (int64_t)r * e[0];
  md -= (int32_t)((BLS_P_INV30 * (u32)cd + (u32)md) & S30_MASK);
  me -= (int32_t)((BLS_P_INV30 * (u32)ce + (u32)me) & S30_MASK);
  cd += (int64_t)N[0] * md;
  ce += (int64_t)N[0] * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < BLS_S30; i++) {
    cd += (int64_t)u * d[i] + (int64_t)v * e[i] + (int64_t)N[i] * md;
    ce += (int64_t)q * d[i] + (int64_t)r * e[i] + (int64_t)N[i] * me;
    d[i - 1] = (int32_t)cd & S30_MASK;
    e[i - 1] = (int32_t)ce & S30_MASK;
    cd >>= 30;
    ce >>= 30;
  }
  d[BLS_S30 - 1] = (int32_t)cd;
  e[BLS_S30 - 1] = (int32_t)ce;
}

// (f, g) = t·(f, g) / 2^30
DEV void bls_update_fg_30(int32_t* f, int32_t* g, const int32_t* t) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  int64_t cf = (int64_t)u * f[0] + (int64_t)v * g[0];
  int64_t cg = (int64_t)q * f[0] + (int64_t)r * g[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < BLS_S30; i++) {
    cf += (int64_t)u * f[i] + (int64_t)v * g[i];
    cg += (int64_t)q * f[i] + (int64_t)r * g[i];
    f[i - 1] = (int32_t)cf & S30_MASK;
    g[i - 1] = (int32_t)cg & S30_MASK;
    cf >>= 30;
    cg >>= 30;
  }
  f[BLS_S30 - 1] = (int32_t)cf;
  g[BLS_S30 - 1] = (int32_t)cg;
}

// d in (-2p, p) -> (sign < 0 ? -d : d) mod p in [0, p), limbs in [0, 2^30)
DEV void bls_normalize_30(int32_t* d, int32_t sign) {
  const int32_t N[BLS_S30] = BLS_P_S30;
  int32_t add = d[BLS_S30 - 1] >> 31;
  const int32_t neg = sign >> 31;
#pragma unroll
  for (int i = 0; i < BLS_S30; i++) d[i] = ((d[i] + (N[i] & add)) ^ neg) - neg;
#pragma unroll
  for (int i = 0; i < BLS_S30 - 1; i++) d[i + 1] += d[i] >> 30, d[i] &= S30_MASK;
  add = d[BLS_S30 - 1] >> 31;
#pragma unroll
  for (int i = 0; i < BLS_S30; i++) d[i] += N[i] & add;
#pragma unroll
  for (int i = 0; i < BLS_S30 - 1; i++) d[i + 1] += d[i] >> 30, d[i] &= S30_MASK;
}

// r = a^-1 mod p for a < p (12 little-endian words), 0 -> 0, by the
// Bernstein-Yang divsteps in libsecp256k1's modinv32 form: 37 rounds of 30
// branch-free divsteps on the low limbs of f and g, each round's matrix
// applied to (f, g) and (d, e) over signed 30-bit limbs. 1,110 divsteps:
// the paper's bound for 381 bits is 1,101 (extra rounds leave g = 0, f =
// ±1 and d as they are). r may alias a.
DEV void bls_inv_divstep_plain(u32* r, const u32* a) {
  int32_t f[BLS_S30] = BLS_P_S30, g[BLS_S30], d[BLS_S30] = {0}, e[BLS_S30] = {1}, t[4];
  g[0] = (int32_t)(a[0] & S30_MASK);
#pragma unroll
  for (int i = 1; i < BLS_S30 - 1; i++)
    g[i] = (int32_t)((a[(30 * i) / 32] >> ((30 * i) % 32) | a[(30 * i) / 32 + 1] << (32 - (30 * i) % 32)) &
                     S30_MASK);
  g[BLS_S30 - 1] = (int32_t)(a[BLS_NW - 1] >> 8);
  int32_t zeta = -1;  // delta = 1/2
#pragma unroll 1
  for (int round = 0; round < 37; round++) {
    zeta = divsteps_30(zeta, (u32)f[0], (u32)g[0], t);
    bls_update_de_30(d, e, t);
    bls_update_fg_30(f, g, t);
  }
  bls_normalize_30(d, f[BLS_S30 - 1]);  // f = ±1: d = ±a^-1
#pragma unroll
  for (int i = 0; i < BLS_NW; i++)
    r[i] = (u32)d[(32 * i) / 30] >> ((32 * i) % 30) | (u32)d[(32 * i) / 30 + 1] << (30 - (32 * i) % 30);
}

// In the Montgomery domain: (a·R)^-1·R^2 = (a·R)^-1·R^3·R^-1, one product
// after the divsteps.
DEV void bls_inv_divstep(u32* r, const u32* a) {
  u32 x[BLS_NW], r3[BLS_NW];
  bls_inv_divstep_plain(x, a);
#pragma unroll
  for (int i = 0; i < BLS_NW; i++) r3[i] = BLS_R3[i];
  bls_mul(r, x, r3);
}

#endif  // FISCO_BLS12_381_FIELD_CUH
