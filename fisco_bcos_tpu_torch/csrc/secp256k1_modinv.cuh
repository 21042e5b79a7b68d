// s^-1 mod n for the secp256k1 verify kernel by the Bernstein–Yang safegcd
// divsteps, constant time: libsecp256k1's modinv32 design (20 rounds of 30
// branch-free divsteps on the low words of f and g, each round's 2x2
// transition matrix then applied to f, g and to d, e over signed 30-bit
// limbs). Every lane runs the same instructions, so a warp stays
// converged; a round is 30 divsteps of adds, masks and shifts, then 4 x 9
// signed 32x32 -> 64-bit products for each of (f, g) and (d, e), where a
// Fermat chain mod n costs ~330 products of 256 bits. An input of 0
// returns 0 without a fault (g = 0 stays 0; d stays 0), as the Fermat
// chain did.
//
// Host-compilable, like wide_int.cuh: the tier-1 tests hold it against
// Python's pow(s, -1, n).

#ifndef FISCO_SECP256K1_MODINV_CUH
#define FISCO_SECP256K1_MODINV_CUH

#include "wide_int.cuh"

// n in signed 30-bit limbs (little-endian; the top limb carries the sign of
// a value), and n^-1 mod 2^30
#define MODN_S30 {0x10364141, 0x3F497A33, 0x348A03BB, 0x2BB739AB, -0x146, 0, 0, 0, 65536}
#define MODN_INV30 0x2A774EC1u
#define S30_MASK 0x3FFFFFFF

// 30 divsteps on the low words of f (odd) and g: returns the new zeta
// (-(delta + 1/2)) and the transition matrix t = (u, v, q, r), scaled by
// 2^30, with t·(f, g) = 2^30·(f', g').
DEV int32_t divsteps_30(int32_t zeta, u32 f, u32 g, int32_t* t) {
  u32 u = 1, v = 0, q = 0, r = 1;
#pragma unroll
  for (int i = 0; i < 30; i++) {
    u32 c1 = (u32)(zeta >> 31);  // zeta < 0
    u32 c2 = 0u - (g & 1u);      // g odd
    u32 x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
    g += x & c2;
    q += y & c2;
    r += z & c2;
    c1 &= c2;  // zeta < 0 and g odd: swap
    zeta = (zeta ^ (int32_t)c1) - 1;
    f += g & c1;
    u += q & c1;
    v += r & c1;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t[0] = (int32_t)u, t[1] = (int32_t)v, t[2] = (int32_t)q, t[3] = (int32_t)r;
  return zeta;
}

// (d, e) = (t·(d, e) + n·(md, me)) / 2^30 mod n, with md, me chosen so the
// division is exact and d, e stay in (-2n, n).
DEV void update_de_30(int32_t* d, int32_t* e, const int32_t* t) {
  const int32_t N[9] = MODN_S30;
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  int32_t sd = d[8] >> 31, se = e[8] >> 31;
  int32_t md = (u & sd) + (v & se), me = (q & sd) + (r & se);
  int64_t cd = (int64_t)u * d[0] + (int64_t)v * e[0];
  int64_t ce = (int64_t)q * d[0] + (int64_t)r * e[0];
  md -= (int32_t)((MODN_INV30 * (u32)cd + (u32)md) & S30_MASK);
  me -= (int32_t)((MODN_INV30 * (u32)ce + (u32)me) & S30_MASK);
  cd += (int64_t)N[0] * md;
  ce += (int64_t)N[0] * me;
  cd >>= 30;  // the low 30 bits are 0
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < 9; i++) {
    cd += (int64_t)u * d[i] + (int64_t)v * e[i] + (int64_t)N[i] * md;
    ce += (int64_t)q * d[i] + (int64_t)r * e[i] + (int64_t)N[i] * me;
    d[i - 1] = (int32_t)cd & S30_MASK;
    e[i - 1] = (int32_t)ce & S30_MASK;
    cd >>= 30;
    ce >>= 30;
  }
  d[8] = (int32_t)cd;
  e[8] = (int32_t)ce;
}

// (f, g) = t·(f, g) / 2^30 (exact by construction of t)
DEV void update_fg_30(int32_t* f, int32_t* g, const int32_t* t) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  int64_t cf = (int64_t)u * f[0] + (int64_t)v * g[0];
  int64_t cg = (int64_t)q * f[0] + (int64_t)r * g[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < 9; i++) {
    cf += (int64_t)u * f[i] + (int64_t)v * g[i];
    cg += (int64_t)q * f[i] + (int64_t)r * g[i];
    f[i - 1] = (int32_t)cf & S30_MASK;
    g[i - 1] = (int32_t)cg & S30_MASK;
    cf >>= 30;
    cg >>= 30;
  }
  f[8] = (int32_t)cf;
  g[8] = (int32_t)cg;
}

// d in (-2n, n) -> (sign < 0 ? -d : d) mod n in [0, n), limbs in [0, 2^30)
DEV void normalize_30(int32_t* d, int32_t sign) {
  const int32_t N[9] = MODN_S30;
  int32_t add = d[8] >> 31, neg = sign >> 31;
#pragma unroll
  for (int i = 0; i < 9; i++) d[i] = ((d[i] + (N[i] & add)) ^ neg) - neg;
#pragma unroll
  for (int i = 0; i < 8; i++) d[i + 1] += d[i] >> 30, d[i] &= S30_MASK;
  add = d[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; i++) d[i] += N[i] & add;
#pragma unroll
  for (int i = 0; i < 8; i++) d[i + 1] += d[i] >> 30, d[i] &= S30_MASK;
}

// r = a^-1 mod n for a < n (8 little-endian words); 0 -> 0. r may alias a.
DEV void fn_inv_divstep(u32* r, const u32* a) {
  int32_t f[9] = MODN_S30, g[9], d[9] = {0}, e[9] = {1}, t[4];
  g[0] = (int32_t)(a[0] & S30_MASK);
#pragma unroll
  for (int i = 1; i < 8; i++) g[i] = (int32_t)((a[(30 * i) / 32] >> ((30 * i) % 32) |
                                                a[(30 * i) / 32 + 1] << (32 - (30 * i) % 32)) & S30_MASK);
  g[8] = (int32_t)(a[7] >> 16);
  int32_t zeta = -1;  // delta = 1/2
#pragma unroll 1
  for (int round = 0; round < 20; round++) {  // 600 divsteps; 590 suffice for 256 bits
    zeta = divsteps_30(zeta, (u32)f[0], (u32)g[0], t);
    update_de_30(d, e, t);
    update_fg_30(f, g, t);
  }
  normalize_30(d, f[8]);  // f = ±1: d = ±a^-1
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = (u32)d[(32 * i) / 30] >> ((32 * i) % 30) |
                                     (u32)d[(32 * i) / 30 + 1] << (30 - (32 * i) % 30);
}

#endif  // FISCO_SECP256K1_MODINV_CUH
