// BLS12-381 aggregate-QC pairing check, one thread a lane, for sm_90a.
//
// Replaces the JAX program `_pairing_check_xla` (fisco_bcos_tpu/ops/
// bls12_381.py:590, on `pairing_check_core` :571), which the JAX package ran
// as one jitted program (it has no Pallas kernel). The plain PyTorch version
// is fisco_bcos_tpu_torch/ops/bls12_381.py pairing_check_plain.
//
// Per lane, one row of ten Fp values in the Montgomery domain (R = 2^384),
// twelve little-endian 32-bit words each: apk (x, y) in G1, σ and H(m)
// (x0, x1, y0, y1) affine on the twist E'(Fp2): y² = x³ + 4(1 + u); out:
//   ok = e(-g1, σ)·e(apk, H(m)) == 1,
// and, where the caller asks for it, the GT element before the comparison.
// The method is the JAX program's:
//   - the tower Fp2 = Fp[u]/(u² + 1), Fp6 = Fp2[v]/(v³ - ξ), Fp12 =
//     Fp6[w]/(w² - v), ξ = 1 + u, Karatsuba products (the JAX :178-357);
//   - the double Miller loop over the bits of |x|, x = -0xd201000000010000,
//     one squaring of f a bit for both pairs, the twist points in Jacobian
//     coordinates, each step's line by the JAX _dbl_step / _add_step
//     formulas (denominator-free, sparse: (c0 + c2·v) + c3·v·w), f
//     conjugated at the end for x < 0;
//   - the final exponentiation: the easy part (p⁶ - 1)(p² + 1) with one
//     tower inversion, then the hard part 3(p⁴ - p² + 1)/r by the chain
//     (x - 1)²(x + p)(x² + p² - 1) + 3 of the oracle's
//     final_exponentiation (crypto/ref/bls12_381.py), the same integer
//     exponent as the JAX scan over its 1,268 bits, so the same element.
// The bits of |x| and of p - 2 are static, so the loops branch on them
// (every lane of a warp takes the same branch) where the JAX scan computes
// both sides and selects.
//
// The Frobenius constants γ, the Montgomery 1 and -g1 come from the
// caller's table (ops/bls12_381.py kernel_table, derived from the oracle),
// copied into shared memory once a block; p and -p⁻¹ mod 2^32 are compiled
// in (the host build's products are held against Python integers).
//
// Field: GF(p), p < 2^381, as 12 little-endian 32-bit words, Montgomery
// products by CIOS (a row of a·b_i, then a row of m·p with
// m = t_0·(-p⁻¹) mod 2^32, twelve times) and one conditional subtraction;
// canonical residues everywhere.
//
// What bounds it on an H100: 32-bit integer multiply issue (a pairing check
// is some 26,000 Fp products, each 288 word products; the 480 bytes in and
// 1 out a lane are nothing). This first form runs one thread a lane: a
// warp's instruction stream is a whole pairing's, its accumulators (an Fp12
// is 144 words, two Jacobian twist points 144 more) live in local memory,
// and the products do not inline (__noinline__ below keeps the build to
// seconds and the code in the instruction cache). Spreading a lane's
// independent products (an Fp12 product's 18 Fp2 products) over several
// lanes is the redesign left for later.
//
// The arithmetic compiles as host C++ too (no __CUDACC__): the tier-1 tests
// build it with g++ and run whole pairing checks against the oracle.

#include "wide_int.cuh"

#define BLS_NW 12                      // words of an Fp value
#define BLS_ROW_WORDS (10 * BLS_NW)    // a lane's row
#define BLS_TABLE_WORDS (3 * BLS_NW + 3 * 6 * 2 * BLS_NW)
#define BLS_K_ONE 0                    // table: the Montgomery 1
#define BLS_K_NEG_G1 BLS_NW            // -g1 (x, y)
#define BLS_K_GAMMA (3 * BLS_NW)       // γ_k, k = 1, 2, 6: six Fp2 values each
#define BLS_THREADS 32

#ifdef __CUDACC__
#define BLS_FN __device__ __noinline__
#define BLS_INL __device__ __forceinline__
#else
#define BLS_FN static
#define BLS_INL static inline
#endif

CONSTMEM u32 BLS_P[BLS_NW] = {0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
                              0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
                              0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
#define BLS_N0 0xfffcfffdu  // -p^-1 mod 2^32
CONSTMEM u64 BLS_X_ABS = 0xd201000000010000ull;  // |x|, 64 bits, the top one set

#ifndef __CUDACC__
// the host build counts the Fp products a pairing check makes (a squaring
// where both operands are one value), for chip_smoke.py's bound
static unsigned long long bls_count_mul = 0, bls_count_sqr = 0;
#define BLS_COUNT(a, b) (&(a) == &(b) ? bls_count_sqr++ : bls_count_mul++)
#else
#define BLS_COUNT(a, b) ((void)0)
#endif

struct fp { u32 w[BLS_NW]; };
struct fp2 { fp c0, c1; };
struct fp6 { fp2 c0, c1, c2; };
struct fp12 { fp6 c0, c1; };  // g + h·w
struct g2j { fp2 x, y, z; };  // Jacobian on the twist

// ---------------------------------------------------------------------------
// Fp
// ---------------------------------------------------------------------------

BLS_INL void fp_load(fp& r, const u32* p) {
  for (int i = 0; i < BLS_NW; i++) r.w[i] = p[i];
}

BLS_INL void fp_zero(fp& r) {
  for (int i = 0; i < BLS_NW; i++) r.w[i] = 0;
}

BLS_INL bool fp_is_zero(const fp& a) {
  u32 acc = 0;
  for (int i = 0; i < BLS_NW; i++) acc |= a.w[i];
  return acc == 0;
}

BLS_INL bool fp_eq(const fp& a, const fp& b) {
  u32 acc = 0;
  for (int i = 0; i < BLS_NW; i++) acc |= a.w[i] ^ b.w[i];
  return acc == 0;
}

// r = s - p if s >= p else s, for s < 2p
BLS_INL void fp_cond_sub(fp& r, const u32* s) {
  u32 d[BLS_NW];
  u32 borrow = sub_w<BLS_NW>(d, s, BLS_P);
  for (int i = 0; i < BLS_NW; i++) r.w[i] = borrow ? s[i] : d[i];
}

BLS_FN void fp_add(fp& r, const fp& a, const fp& b) {
  u32 s[BLS_NW];
  add_w<BLS_NW>(s, a.w, b.w);  // < 2p < 2^382: no carry out
  fp_cond_sub(r, s);
}

BLS_FN void fp_sub(fp& r, const fp& a, const fp& b) {
  u32 d[BLS_NW], e[BLS_NW];
  u32 borrow = sub_w<BLS_NW>(d, a.w, b.w);
  add_w<BLS_NW>(e, d, BLS_P);
  for (int i = 0; i < BLS_NW; i++) r.w[i] = borrow ? e[i] : d[i];
}

BLS_INL void fp_neg(fp& r, const fp& a) {
  fp z;
  fp_zero(z);
  fp_sub(r, z, a);
}

// Montgomery product a·b/R mod p (CIOS), canonical for canonical a, b
BLS_FN void fp_mul(fp& r, const fp& a, const fp& b) {
  BLS_COUNT(a, b);
  u32 t[BLS_NW + 2];
  for (int i = 0; i < BLS_NW + 2; i++) t[i] = 0;
  for (int i = 0; i < BLS_NW; i++) {
    u64 c = 0;
    const u32 bi = b.w[i];
    for (int j = 0; j < BLS_NW; j++) {
      c += (u64)a.w[j] * bi + t[j];
      t[j] = (u32)c;
      c >>= 32;
    }
    c += t[BLS_NW];
    t[BLS_NW] = (u32)c;
    t[BLS_NW + 1] = (u32)(c >> 32);
    const u32 m = t[0] * BLS_N0;
    c = ((u64)m * BLS_P[0] + t[0]) >> 32;  // the low word is 0 by the choice of m
    for (int j = 1; j < BLS_NW; j++) {
      c += (u64)m * BLS_P[j] + t[j];
      t[j - 1] = (u32)c;
      c >>= 32;
    }
    c += t[BLS_NW];
    t[BLS_NW - 1] = (u32)c;
    t[BLS_NW] = t[BLS_NW + 1] + (u32)(c >> 32);
  }
  fp_cond_sub(r, t);  // t < 2p
}

// a^-1 = a^(p - 2) (0 -> 0): square and multiply, MSB first, over the bits
// of p - 2 (bit 380 is the top one)
BLS_FN void fp_inv(fp& r, const fp& a) {
  fp acc = a;
  for (int i = 379; i >= 0; i--) {
    fp_mul(acc, acc, acc);
    const u32 word = BLS_P[i >> 5] - (i >> 5 ? 0u : 2u);
    if ((word >> (i & 31)) & 1) fp_mul(acc, acc, a);
  }
  r = acc;
}

// ---------------------------------------------------------------------------
// Fp2 = Fp[u]/(u² + 1)
// ---------------------------------------------------------------------------

BLS_INL void fp2_load(fp2& r, const u32* p) {
  fp_load(r.c0, p);
  fp_load(r.c1, p + BLS_NW);
}

BLS_FN void fp2_add(fp2& r, const fp2& a, const fp2& b) {
  fp_add(r.c0, a.c0, b.c0);
  fp_add(r.c1, a.c1, b.c1);
}

BLS_FN void fp2_sub(fp2& r, const fp2& a, const fp2& b) {
  fp_sub(r.c0, a.c0, b.c0);
  fp_sub(r.c1, a.c1, b.c1);
}

BLS_INL void fp2_neg(fp2& r, const fp2& a) {
  fp_neg(r.c0, a.c0);
  fp_neg(r.c1, a.c1);
}

BLS_INL void fp2_conj(fp2& r, const fp2& a) {
  r.c0 = a.c0;
  fp_neg(r.c1, a.c1);
}

// (a0 + a1 u)(b0 + b1 u): v0 = a0 b0, v1 = a1 b1, (v0 - v1, (a0 + a1)(b0 + b1) - v0 - v1)
BLS_FN void fp2_mul(fp2& r, const fp2& a, const fp2& b) {
  fp v0, v1, s, t;
  fp_mul(v0, a.c0, b.c0);
  fp_mul(v1, a.c1, b.c1);
  fp_add(s, a.c0, a.c1);
  fp_add(t, b.c0, b.c1);
  fp_mul(s, s, t);
  fp_add(t, v0, v1);
  fp_sub(r.c1, s, t);
  fp_sub(r.c0, v0, v1);
}

// ((a0 + a1)(a0 - a1), 2·a0·a1)
BLS_FN void fp2_sqr(fp2& r, const fp2& a) {
  fp s, d, m;
  fp_add(s, a.c0, a.c1);
  fp_sub(d, a.c0, a.c1);
  fp_mul(m, a.c0, a.c1);
  fp_mul(r.c0, s, d);
  fp_add(r.c1, m, m);
}

// a·(1 + u) = (a0 - a1, a0 + a1)
BLS_FN void fp2_mul_xi(fp2& r, const fp2& a) {
  fp s;
  fp_add(s, a.c0, a.c1);
  fp_sub(r.c0, a.c0, a.c1);
  r.c1 = s;
}

// a·s for s in Fp, coefficient by coefficient
BLS_FN void fp2_mul_fp(fp2& r, const fp2& a, const fp& s) {
  fp_mul(r.c0, a.c0, s);
  fp_mul(r.c1, a.c1, s);
}

// a·k for k = 2, 3, 4 or 8, by additions
BLS_FN void fp2_muli(fp2& r, const fp2& a, int k) {
  fp2 d;
  fp2_add(d, a, a);
  if (k == 3) {
    fp2_add(r, d, a);
    return;
  }
  if (k >= 4) fp2_add(d, d, d);
  if (k == 8) fp2_add(d, d, d);
  r = d;
}

BLS_FN void fp2_inv(fp2& r, const fp2& a) {
  fp n, t;
  fp_mul(n, a.c0, a.c0);
  fp_mul(t, a.c1, a.c1);
  fp_add(n, n, t);
  fp_inv(n, n);
  fp_mul(t, a.c1, n);
  fp_mul(r.c0, a.c0, n);
  fp_neg(r.c1, t);
}

// ---------------------------------------------------------------------------
// Fp6 = Fp2[v]/(v³ - ξ)
// ---------------------------------------------------------------------------

BLS_FN void fp6_add(fp6& r, const fp6& a, const fp6& b) {
  fp2_add(r.c0, a.c0, b.c0);
  fp2_add(r.c1, a.c1, b.c1);
  fp2_add(r.c2, a.c2, b.c2);
}

BLS_FN void fp6_sub(fp6& r, const fp6& a, const fp6& b) {
  fp2_sub(r.c0, a.c0, b.c0);
  fp2_sub(r.c1, a.c1, b.c1);
  fp2_sub(r.c2, a.c2, b.c2);
}

BLS_INL void fp6_neg(fp6& r, const fp6& a) {
  fp2_neg(r.c0, a.c0);
  fp2_neg(r.c1, a.c1);
  fp2_neg(r.c2, a.c2);
}

// a·v = (ξ·a2, a0, a1)
BLS_FN void fp6_mul_v(fp6& r, const fp6& a) {
  fp2 t;
  fp2_mul_xi(t, a.c2);
  r.c2 = a.c1;
  r.c1 = a.c0;
  r.c0 = t;
}

// Karatsuba (the JAX f6_mul)
BLS_FN void fp6_mul(fp6& r, const fp6& a, const fp6& b) {
  fp2 v0, v1, v2, s, t, c0, c1, c2;
  fp2_mul(v0, a.c0, b.c0);
  fp2_mul(v1, a.c1, b.c1);
  fp2_mul(v2, a.c2, b.c2);
  fp2_add(s, a.c1, a.c2);
  fp2_add(t, b.c1, b.c2);
  fp2_mul(s, s, t);
  fp2_add(t, v1, v2);
  fp2_sub(s, s, t);
  fp2_mul_xi(s, s);
  fp2_add(c0, v0, s);  // v0 + ξ((a1 + a2)(b1 + b2) - v1 - v2)
  fp2_add(s, a.c0, a.c1);
  fp2_add(t, b.c0, b.c1);
  fp2_mul(s, s, t);
  fp2_add(t, v0, v1);
  fp2_sub(s, s, t);
  fp2_mul_xi(t, v2);
  fp2_add(c1, s, t);  // (a0 + a1)(b0 + b1) - v0 - v1 + ξ·v2
  fp2_add(s, a.c0, a.c2);
  fp2_add(t, b.c0, b.c2);
  fp2_mul(s, s, t);
  fp2_add(t, v0, v2);
  fp2_sub(s, s, t);
  fp2_add(c2, s, v1);  // (a0 + a2)(b0 + b2) - v0 - v2 + v1
  r.c0 = c0;
  r.c1 = c1;
  r.c2 = c2;
}

// a·(b0 + b1·v), the line's Fp6 half
BLS_FN void fp6_mul_by_01(fp6& r, const fp6& a, const fp2& b0, const fp2& b1) {
  fp2 v0, v1, t, c0, c1, c2;
  fp2_mul(v0, a.c0, b0);
  fp2_mul(v1, a.c1, b1);
  fp2_mul(t, a.c2, b1);
  fp2_mul_xi(t, t);
  fp2_add(c0, v0, t);
  fp2_mul(c1, a.c1, b0);
  fp2_mul(t, a.c0, b1);
  fp2_add(c1, c1, t);
  fp2_mul(c2, a.c2, b0);
  fp2_add(c2, c2, v1);
  r.c0 = c0;
  r.c1 = c1;
  r.c2 = c2;
}

// a·(b1·v)
BLS_FN void fp6_mul_by_1(fp6& r, const fp6& a, const fp2& b1) {
  fp2 c0, c1, c2;
  fp2_mul(c0, a.c2, b1);
  fp2_mul_xi(c0, c0);
  fp2_mul(c1, a.c0, b1);
  fp2_mul(c2, a.c1, b1);
  r.c0 = c0;
  r.c1 = c1;
  r.c2 = c2;
}

// the v³ = ξ tower inversion (the JAX f6_inv)
BLS_FN void fp6_inv(fp6& r, const fp6& a) {
  fp2 c0, c1, c2, s, t;
  fp2_sqr(c0, a.c0);
  fp2_mul(s, a.c1, a.c2);
  fp2_mul_xi(s, s);
  fp2_sub(c0, c0, s);  // a0² - ξ·a1·a2
  fp2_sqr(c1, a.c2);
  fp2_mul_xi(c1, c1);
  fp2_mul(s, a.c0, a.c1);
  fp2_sub(c1, c1, s);  // ξ·a2² - a0·a1
  fp2_sqr(c2, a.c1);
  fp2_mul(s, a.c0, a.c2);
  fp2_sub(c2, c2, s);  // a1² - a0·a2
  fp2_mul(s, a.c1, c2);
  fp2_mul(t, a.c2, c1);
  fp2_add(s, s, t);
  fp2_mul_xi(s, s);
  fp2_mul(t, a.c0, c0);
  fp2_add(t, t, s);  // a0·c0 + ξ(a1·c2 + a2·c1)
  fp2_inv(t, t);
  fp2_mul(r.c0, c0, t);
  fp2_mul(r.c1, c1, t);
  fp2_mul(r.c2, c2, t);
}

// ---------------------------------------------------------------------------
// Fp12 = Fp6[w]/(w² - v)
// ---------------------------------------------------------------------------

BLS_INL void fp12_one(fp12& r, const u32* K) {
  fp* c = &r.c0.c0.c0;
  for (int i = 0; i < 12; i++) fp_zero(c[i]);
  fp_load(r.c0.c0.c0, K + BLS_K_ONE);
}

BLS_FN void fp12_mul(fp12& r, const fp12& a, const fp12& b) {
  fp6 vg, vh, s, t;
  fp6_mul(vg, a.c0, b.c0);
  fp6_mul(vh, a.c1, b.c1);
  fp6_add(s, a.c0, a.c1);
  fp6_add(t, b.c0, b.c1);
  fp6_mul(s, s, t);
  fp6_sub(s, s, vg);
  fp6_sub(r.c1, s, vh);  // (g1 + h1)(g2 + h2) - vg - vh
  fp6_mul_v(vh, vh);
  fp6_add(r.c0, vg, vh);  // vg + v·vh
}

// the JAX f12_sqr: v0 = g·h, t = (g + h)(g + v·h), (t - v0 - v·v0, 2·v0)
BLS_FN void fp12_sqr(fp12& r, const fp12& a) {
  fp6 v0, s, t;
  fp6_mul(v0, a.c0, a.c1);
  fp6_add(s, a.c0, a.c1);
  fp6_mul_v(t, a.c1);
  fp6_add(t, a.c0, t);
  fp6_mul(t, s, t);
  fp6_sub(t, t, v0);
  fp6_mul_v(s, v0);
  fp6_sub(r.c0, t, s);
  fp6_add(r.c1, v0, v0);
}

// (g, h)^-1 = (g·t, -h·t), t = (g² - v·h²)^-1
BLS_FN void fp12_inv(fp12& r, const fp12& a) {
  fp6 s, t;
  fp6_mul(s, a.c0, a.c0);
  fp6_mul(t, a.c1, a.c1);
  fp6_mul_v(t, t);
  fp6_sub(s, s, t);
  fp6_inv(t, s);
  fp6_mul(r.c0, a.c0, t);
  fp6_mul(s, a.c1, t);
  fp6_neg(r.c1, s);
}

// f·((c0 + c2·v) + (c3·v)·w), the sparse line (the JAX f12_mul_line)
BLS_FN void fp12_mul_line(fp12& r, const fp12& f, const fp2& c0, const fp2& c2, const fp2& c3) {
  fp6 a, b, c;
  fp2 s;
  fp6_mul_by_01(a, f.c0, c0, c2);
  fp6_mul_by_1(b, f.c1, c3);
  fp2_add(s, c2, c3);
  fp6_add(c, f.c0, f.c1);
  fp6_mul_by_01(c, c, c0, s);
  fp6_sub(c, c, a);
  fp6_sub(r.c1, c, b);
  fp6_mul_v(b, b);
  fp6_add(r.c0, a, b);
}

// f^(p^k): each Fp2 coefficient conjugated for odd k, times its γ_k (the
// table's block kidx = 0, 1, 2 for k = 1, 2, 6)
BLS_FN void fp12_frob(fp12& r, const fp12& f, int kidx, const u32* K) {
  const fp2* src = &f.c0.c0;
  fp2* dst = &r.c0.c0;
  for (int i = 0; i < 6; i++) {
    fp2 c, g;
    if (kidx == 0) fp2_conj(c, src[i]);
    else c = src[i];
    fp2_load(g, K + BLS_K_GAMMA + (kidx * 6 + i) * 2 * BLS_NW);
    fp2_mul(dst[i], c, g);
  }
}

BLS_INL bool fp12_is_one(const fp12& a, const u32* K) {
  fp one;
  fp_load(one, K + BLS_K_ONE);
  bool ok = fp_eq(a.c0.c0.c0, one);
  const fp* c = &a.c0.c0.c0;
  for (int i = 1; i < 12; i++) ok &= fp_is_zero(c[i]);
  return ok;
}

// ---------------------------------------------------------------------------
// The twist's Jacobian steps with their lines (the JAX _dbl_step :461,
// _add_step :476, on jac_double / jac_add_affine :423-452)
// ---------------------------------------------------------------------------

// T <- 2T (dbl-2009-l); the tangent at T evaluated at (xp, yp):
// c0 = 3X³ - 2Y², c2 = -3X²Z²·xp, c3 = 2YZ³·yp
BLS_FN void dbl_step(g2j& t, const fp& xp, const fp& yp, fp2& c0, fp2& c2, fp2& c3) {
  fp2 x2, z2, y2, s, u, d, e;
  fp2_sqr(x2, t.x);
  fp2_sqr(z2, t.z);
  fp2_sqr(y2, t.y);
  fp2_mul(s, x2, t.x);
  fp2_muli(s, s, 3);
  fp2_muli(u, y2, 2);
  fp2_sub(c0, s, u);
  fp2_mul(s, x2, z2);
  fp2_muli(s, s, 3);
  fp2_mul_fp(s, s, xp);
  fp2_neg(c2, s);
  fp2_mul(s, t.z, z2);
  fp2_mul(s, t.y, s);
  fp2_muli(s, s, 2);
  fp2_mul_fp(c3, s, yp);
  // A = X², B = Y², C = B², D = 2((X + B)² - A - C), E = 3A
  fp2_sqr(u, y2);  // C
  fp2_add(s, t.x, y2);
  fp2_sqr(s, s);
  fp2_sub(s, s, x2);
  fp2_sub(s, s, u);
  fp2_muli(d, s, 2);
  fp2_muli(e, x2, 3);
  fp2_mul(s, t.y, t.z);
  fp2_muli(t.z, s, 2);  // Z3 = 2YZ
  fp2_sqr(s, e);
  fp2_muli(t.x, d, 2);
  fp2_sub(t.x, s, t.x);  // X3 = E² - 2D
  fp2_sub(s, d, t.x);
  fp2_mul(s, e, s);
  fp2_muli(u, u, 8);
  fp2_sub(t.y, s, u);  // Y3 = E(D - X3) - 8C
}

// T <- T + Q (madd-2007-bl, Q = (xq, yq) affine); the chord through T and
// Q at (xp, yp): with N = Y - yq·Z³, D = X - xq·Z², c0 = N·xq - D·Z·yq,
// c2 = -N·xp, c3 = D·Z·yp
BLS_FN void add_step(g2j& t, const fp2& xq, const fp2& yq, const fp& xp, const fp& yp,
                     fp2& c0, fp2& c2, fp2& c3) {
  fp2 z2, z3, n, d, dz, s, u, h, hh, i4, j, v, r;
  fp2_sqr(z2, t.z);
  fp2_mul(z3, t.z, z2);
  fp2_mul(s, yq, z3);  // yq·Z³ = S2 of the madd
  fp2_sub(n, t.y, s);
  fp2_mul(u, xq, z2);  // xq·Z² = U2
  fp2_sub(d, t.x, u);
  fp2_mul(dz, d, t.z);
  fp2_mul(c0, n, xq);
  fp2_mul(v, dz, yq);
  fp2_sub(c0, c0, v);
  fp2_mul_fp(v, n, xp);
  fp2_neg(c2, v);
  fp2_mul_fp(c3, dz, yp);
  // H = U2 - X, r = 2(S2 - Y), I = 4H², J = H·I, V = X·I
  fp2_sub(h, u, t.x);
  fp2_sub(r, s, t.y);
  fp2_muli(r, r, 2);
  fp2_sqr(hh, h);
  fp2_muli(i4, hh, 4);
  fp2_mul(j, h, i4);
  fp2_mul(v, t.x, i4);
  fp2_add(s, t.z, h);
  fp2_sqr(s, s);
  fp2_sub(s, s, z2);
  fp2_sub(t.z, s, hh);  // Z3 = (Z + H)² - Z² - H²
  fp2_sqr(s, r);
  fp2_sub(s, s, j);
  fp2_muli(u, v, 2);
  fp2_sub(t.x, s, u);  // X3 = r² - J - 2V
  fp2_sub(s, v, t.x);
  fp2_mul(s, r, s);
  fp2_mul(u, t.y, j);
  fp2_muli(u, u, 2);
  fp2_sub(t.y, s, u);  // Y3 = r(V - X3) - 2·Y·J
}

// ---------------------------------------------------------------------------
// The Miller loop, the final exponentiation, a lane's check
// ---------------------------------------------------------------------------

// f_{|x|}(P1, Q1)·f_{|x|}(P2, Q2), conjugated for x < 0
BLS_FN void miller2(fp12& f, const fp& p1x, const fp& p1y, const fp2& q1x, const fp2& q1y,
                    const fp& p2x, const fp& p2y, const fp2& q2x, const fp2& q2y, const u32* K) {
  g2j t1, t2;
  t1.x = q1x;
  t1.y = q1y;
  t2.x = q2x;
  t2.y = q2y;
  fp_load(t1.z.c0, K + BLS_K_ONE);
  fp_zero(t1.z.c1);
  t2.z = t1.z;
  fp12_one(f, K);
  fp2 c0, c2, c3;
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int i = 62; i >= 0; i--) {
    fp12_sqr(f, f);
    dbl_step(t1, p1x, p1y, c0, c2, c3);
    fp12_mul_line(f, f, c0, c2, c3);
    dbl_step(t2, p2x, p2y, c0, c2, c3);
    fp12_mul_line(f, f, c0, c2, c3);
    if ((BLS_X_ABS >> i) & 1) {
      add_step(t1, q1x, q1y, p1x, p1y, c0, c2, c3);
      fp12_mul_line(f, f, c0, c2, c3);
      add_step(t2, q2x, q2y, p2x, p2y, c0, c2, c3);
      fp12_mul_line(f, f, c0, c2, c3);
    }
  }
  fp12_frob(f, f, 2, K);
}

// a^|x| (square and multiply over the bits of |x| below the top one)
BLS_FN void cyclo_pow_abs_x(fp12& r, const fp12& a) {
  fp12 acc = a;
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int i = 62; i >= 0; i--) {
    fp12_sqr(acc, acc);
    if ((BLS_X_ABS >> i) & 1) fp12_mul(acc, acc, a);
  }
  r = acc;
}

// the easy part, then the oracle's chain for 3(p⁴ - p² + 1)/r (conj = the
// p⁶-Frobenius, the inverse in the cyclotomic subgroup)
BLS_FN void final_exp(fp12& r, const fp12& f, const u32* K) {
  fp12 m, a, b, g, h;
  fp12_inv(a, f);
  fp12_frob(b, f, 2, K);
  fp12_mul(m, b, a);  // f^(p⁶ - 1)
  fp12_frob(b, m, 1, K);
  fp12_mul(m, b, m);  // ^(p² + 1)
  cyclo_pow_abs_x(a, m);  // m^|x|
  cyclo_pow_abs_x(b, a);  // m^(x²)
  fp12_sqr(a, a);
  fp12_mul(g, b, a);
  fp12_mul(g, g, m);  // m^((x - 1)²)
  cyclo_pow_abs_x(a, g);
  fp12_frob(a, a, 2, K);
  fp12_frob(b, g, 0, K);
  fp12_mul(h, a, b);  // g^(x + p)
  cyclo_pow_abs_x(a, h);
  cyclo_pow_abs_x(a, a);  // h^(x²)
  fp12_frob(b, h, 1, K);
  fp12_mul(a, a, b);
  fp12_frob(b, h, 2, K);
  fp12_mul(a, a, b);  // h^(x² + p² - 1)
  fp12_sqr(b, m);
  fp12_mul(b, b, m);
  fp12_mul(r, a, b);  // ·m³
}

// one lane: its row (ten Fp values) -> ok, and its GT element in gt
BLS_FN bool bls_pairing_lane(const u32* row, const u32* K, fp12& gt) {
  fp apk_x, apk_y, ng1_x, ng1_y;
  fp2 sx, sy, hx, hy;
  fp_load(apk_x, row);
  fp_load(apk_y, row + BLS_NW);
  fp2_load(sx, row + 2 * BLS_NW);
  fp2_load(sy, row + 4 * BLS_NW);
  fp2_load(hx, row + 6 * BLS_NW);
  fp2_load(hy, row + 8 * BLS_NW);
  fp_load(ng1_x, K + BLS_K_NEG_G1);
  fp_load(ng1_y, K + BLS_K_NEG_G1 + BLS_NW);
  fp12 f;
  miller2(f, ng1_x, ng1_y, sx, sy, apk_x, apk_y, hx, hy, K);
  final_exp(gt, f, K);
  return fp12_is_one(gt, K);
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(BLS_THREADS)
bls12_381_pairing_kernel(const u32* __restrict__ rows, const u32* __restrict__ table,
                         uint8_t* __restrict__ ok, u32* __restrict__ gt, int n) {
  __shared__ u32 k_table[BLS_TABLE_WORDS];
  for (int i = threadIdx.x; i < BLS_TABLE_WORDS; i += blockDim.x) k_table[i] = table[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  fp12 e;
  ok[lane] = bls_pairing_lane(rows + (size_t)lane * BLS_ROW_WORDS, k_table, e);
  if (gt) {
    const u32* w = e.c0.c0.c0.w;
    for (int i = 0; i < 12 * BLS_NW; i++) gt[(size_t)lane * 12 * BLS_NW + i] = w[i];
  }
}

extern "C" void bls12_381_geometry(int n, int* out) {
  out[0] = BLS_THREADS;
  out[1] = (n + BLS_THREADS - 1) / BLS_THREADS;
  out[2] = 0;
}

// C entry point for ctypes: launches on `stream` of `device`, does not
// synchronise; returns the first CUDA error (0 on success). `gt` may be
// null; else it takes each lane's GT element, 144 words a lane.
extern "C" int bls12_381_pairing_launch(const void* rows, const void* table, void* ok, void* gt,
                                        int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  int geo[3];
  bls12_381_geometry(n, geo);
  bls12_381_pairing_kernel<<<geo[1], geo[0], geo[2], (cudaStream_t)stream>>>(
      (const u32*)rows, (const u32*)table, (uint8_t*)ok, (u32*)gt, n);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
