// Multi-word integer helpers shared by the port's EC kernels: 256-bit values
// as 8 little-endian 32-bit words, one thread per signature, and the small
// interpreter that runs their group laws.
//
// What limits these kernels on an H100 (measured on one warp with
// clock64() by chip_smoke.py's field bench, csrc/field_bench.cu; figures in
// PERF.md §6): each warp has a scheduler to itself and pays for every
// integer instruction it issues, with or without independent work in
// flight, so a product costs what its instructions cost; and once a loop
// body outgrows the instruction cache, every instruction costs over twice
// as much.
// So the arithmetic here is written for the fewest instructions (a
// product's rows with a 64-bit carry, one IMAD.WIDE and two adds a word
// product; a 36-product squaring; add/sub chains with the carry in a
// predicate), and the group law does not inline: it runs as constant
// programs of field ops over per-lane slots in shared memory, through one
// copy of each field op (fop_run), so a ladder window stays far inside the
// cache. A register-resident group law, fully inlined, with two or three
// products interleaved row by row and their carry chains in PTX
// mad.lo.cc / madc.hi.cc, was tried first and ran slower than the previous
// version: ptxas emulates the multiply's carry-out (IMAD has none here)
// with predicate moves and selects, the register file fills, and the
// ladder still outgrows the cache.
//
// Everything compiles as host C++ too (no __CUDACC__): the tier-1 tests
// build the kernels' arithmetic with g++. Only the add/sub chains' PTX, the
// slots' 16-byte accesses and the error-string entry point are
// CUDA-specific.

#ifndef FISCO_WIDE_INT_CUH
#define FISCO_WIDE_INT_CUH

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DEV __device__ __forceinline__
#define DEV_MEMBER static __device__ __forceinline__
#define CONSTMEM __constant__
#else
#define DEV static inline
#define DEV_MEMBER static inline
#define CONSTMEM static const
#endif

#if defined(__CUDA_ARCH__)
#define FISCO_PTX 1
#else
#define FISCO_PTX 0
#endif

typedef uint32_t u32;
typedef uint64_t u64;

template <int N>
DEV u32 add_w(u32* r, const u32* a, const u32* b) {
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    c += (u64)a[i] + b[i];
    r[i] = (u32)c;
    c >>= 32;
  }
  return (u32)c;
}

// r[0..N) += a[0..M), carry rippling to the top; returns the carry out.
template <int N, int M>
DEV u32 add_into(u32* r, const u32* a) {
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    c += (u64)r[i] + (i < M ? a[i] : 0u);
    r[i] = (u32)c;
    c >>= 32;
  }
  return (u32)c;
}

template <int N>
DEV u32 sub_w(u32* r, const u32* a, const u32* b) {  // returns the borrow
  u32 borrow = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    u64 d = (u64)a[i] - b[i] - borrow;
    r[i] = (u32)d;
    borrow = (u32)(d >> 63);
  }
  return borrow;
}

// r[NA+NB] = a[NA] * b[NB] (schoolbook; r must not alias a or b). For the
// short products of the GLV split and the mod-n folds.
template <int NA, int NB>
DEV void mul_w(u32* r, const u32* a, const u32* b) {
#pragma unroll
  for (int i = 0; i < NA + NB; i++) r[i] = 0;
#pragma unroll
  for (int i = 0; i < NA; i++) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < NB; j++) {
      c += (u64)a[i] * b[j] + r[i + j];
      r[i + j] = (u32)c;
      c >>= 32;
    }
    r[i + NB] = (u32)c;
  }
}

template <int N>
DEV void copy_w(u32* r, const u32* a) {
#pragma unroll
  for (int i = 0; i < N; i++) r[i] = a[i];
}

DEV void select8(u32* r, bool take_a, const u32* a, const u32* b) {
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = take_a ? a[i] : b[i];
}

DEV bool is_zero8(const u32* a) {
  u32 acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a[i];
  return acc == 0;
}

DEV bool eq8(const u32* a, const u32* b) {
  u32 acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a[i] ^ b[i];
  return acc == 0;
}

// r = a + b over 8 words; returns the carry out. On the card one chain of
// adds with the carry in a predicate (IADD3 / IADD3.X), which Hopper has.
DEV u32 add8(u32* r, const u32* a, const u32* b) {
#if FISCO_PTX
  u32 c;
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=&r"(r[0]), "=&r"(r[1]), "=&r"(r[2]), "=&r"(r[3]),
        "=&r"(r[4]), "=&r"(r[5]), "=&r"(r[6]), "=&r"(r[7]), "=&r"(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  return c;
#else
  return add_w<8>(r, a, b);
#endif
}

// r = a - b over 8 words; returns the borrow (0 or 1).
DEV u32 sub8(u32* r, const u32* a, const u32* b) {
#if FISCO_PTX
  u32 c;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=&r"(r[0]), "=&r"(r[1]), "=&r"(r[2]), "=&r"(r[3]),
        "=&r"(r[4]), "=&r"(r[5]), "=&r"(r[6]), "=&r"(r[7]), "=&r"(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  return c & 1u;  // 0 - 0 - borrow
#else
  return sub_w<8>(r, a, b);
#endif
}

DEV bool lt8(const u32* a, const u32* b) {
  u32 t[8];
  return sub8(t, a, b) != 0;
}

// r = a - m if a >= m else a, for a < 2m (an m above 2^255 takes any a).
DEV void cond_sub8(u32* r, const u32* a, const u32* m) {
  u32 t[8];
  u32 borrow = sub8(t, a, m);
  select8(r, borrow != 0, a, t);
}

// (a + b) mod m for canonical a, b < m
DEV void add_mod(u32* r, const u32* a, const u32* b, const u32* m) {
  u32 t[8], s[8];
  u32 carry = add8(t, a, b);
  u32 borrow = sub8(s, t, m);
  select8(r, (carry | (borrow ^ 1u)) != 0, s, t);
}

// (a - b) mod m for canonical a, b < m
DEV void sub_mod(u32* r, const u32* a, const u32* b, const u32* m) {
  u32 t[8], s[8];
  u32 borrow = sub8(t, a, b);
  add8(s, t, m);
  select8(r, borrow != 0, s, t);
}

// ---------------------------------------------------------------------------
// 256 x 256 -> 512-bit products and squarings
// ---------------------------------------------------------------------------

// r[16] = a·b (r must not alias a or b): schoolbook rows with a 64-bit
// carry, one IMAD.WIDE (a_i·b_j + r_ij) and two adds a word product.
DEV void wide_mul(u32* r, const u32* a, const u32* b) { mul_w<8, 8>(r, a, b); }

// r[16] = a^2 (r must not alias a) in 36 word products: the 28 of the
// triangle sum_{i<j} a_i·a_j·2^(32(i+j)) by rows as above, doubled, plus
// the 8 squares.
DEV void wide_sqr(u32* r, const u32* a) {
  u32 t[16];
#pragma unroll
  for (int i = 0; i < 16; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 7; i++) {
    u64 c = 0;
#pragma unroll
    for (int j = i + 1; j < 8; j++) {
      c += (u64)a[i] * a[j] + t[i + j];
      t[i + j] = (u32)c;
      c >>= 32;
    }
    t[i + 8] = (u32)c;  // no earlier row reaches word i + 8
  }
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    u64 d = (u64)a[i] * a[i];
    u32 lo = t[2 * i] << 1 | (i ? t[2 * i - 1] >> 31 : 0u);
    u32 hi = t[2 * i + 1] << 1 | t[2 * i] >> 31;
    c += (u64)lo + (u32)d;
    r[2 * i] = (u32)c;
    c >>= 32;
    c += (u64)hi + (u32)(d >> 32);
    r[2 * i + 1] = (u32)c;
    c >>= 32;
  }
}

// ---------------------------------------------------------------------------
// Points, scalars, per-lane tables, limb I/O
// ---------------------------------------------------------------------------

// A projective point (X : Y : Z), each coordinate in its field's domain.
struct Pt {
  u32 X[8], Y[8], Z[8];
};

// A scalar read 4 bits at a time, MSB first, from a shift register of NW
// words: the next window is always the top nibble, so no word is picked by
// a runtime index (which would put the scalar in local memory).
// win_init loads the low BITS bits of k (little-endian words, at least NW
// of them), BITS a multiple of 4 in (32·NW - 32, 32·NW].
template <int NW, int BITS>
DEV void win_init(u32* w, const u32* k) {
  constexpr int shift = 32 * NW - BITS;
  static_assert(shift >= 0 && shift < 32 && BITS % 4 == 0, "window register width");
#pragma unroll
  for (int i = NW - 1; i >= 0; i--) {
    u32 lo = i > 0 ? k[i - 1] : 0u;
    w[i] = shift ? (k[i] << shift | lo >> ((32 - shift) & 31)) : k[i];
  }
}

// the next window, MSB first
template <int NW>
DEV u32 win_next(u32* w) {
  u32 top = w[NW - 1] >> 28;
#pragma unroll
  for (int i = NW - 1; i > 0; i--) w[i] = w[i] << 4 | w[i - 1] >> 28;
  w[0] <<= 4;
  return top;
}

// ---------------------------------------------------------------------------
// Per-lane slots and field-op programs
// ---------------------------------------------------------------------------

// Slot s of a lane holds one 8-word value as two 16-byte quads, quad q at
// quad index (2s + q)·stride from the lane's base: on the card the base is
// the block's shared memory plus the lane (stride = threads a block), so a
// warp's access to one quad is 512 contiguous bytes and meets no bank
// conflict; on the host a lane's slots are one array (stride 1).
DEV void slot_get(u32* v, const u32* sl, int stride, int s) {
#if FISCO_PTX
  const uint4* q = reinterpret_cast<const uint4*>(sl);
  uint4 lo = q[(2 * s) * stride], hi = q[(2 * s + 1) * stride];
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
#else
  for (int h = 0; h < 2; h++)
    for (int k = 0; k < 4; k++) v[4 * h + k] = sl[4 * (2 * s + h) * stride + k];
#endif
}

DEV void slot_put(u32* sl, int stride, int s, const u32* v) {
#if FISCO_PTX
  uint4* q = reinterpret_cast<uint4*>(sl);
  q[(2 * s) * stride] = make_uint4(v[0], v[1], v[2], v[3]);
  q[(2 * s + 1) * stride] = make_uint4(v[4], v[5], v[6], v[7]);
#else
  for (int h = 0; h < 2; h++)
    for (int k = 0; k < 4; k++) sl[4 * (2 * s + h) * stride + k] = v[4 * h + k];
#endif
}

// The slots: the accumulator point, the point added to it, a curve
// constant, 14 temporaries, then 15 table entries of three slots (X, Y, Z).
enum {
  S_X, S_Y, S_Z, S_QX, S_QY, S_QZ, S_K,
  S_T0, S_T1, S_T2, S_T3, S_T4, S_T5, S_T6, S_T7, S_T8, S_T9, S_T10, S_T11, S_T12, S_T13,
  S_TAB, S_COUNT = S_TAB + 45
};
// 32-bit words of one lane's slots
#define SLOT_WORDS (S_COUNT * 8)

// One field op: d = a (op) b over slots; its 4 bytes are kind, d, a, b.
enum { F_MUL, F_SQR, F_ADD, F_SUB, F_SMALL };
#define FOP(k, d, a, b) ((u32)(k) | (u32)(d) << 8 | (u32)(a) << 16 | (u32)(b) << 24)
// ops in a program (a constant array)
#define FOP_LEN(prog) ((int)(sizeof(prog) / sizeof(prog[0])))

DEV void slot_copy(u32* sl, int stride, int d, int s) {
  u32 v[8];
  slot_get(v, sl, stride, s);
  slot_put(sl, stride, d, v);
}

// Runs `len` ops of `prog` over the lane's slots through a curve's field
// ops, F::op(kind, r, a, b): r = a (kind) b. An op reads its operands
// before it writes its result, so d may be a or b.
template <class F>
DEV void fop_run(const u32* prog, int len, u32* sl, int stride) {
#pragma unroll 1
  for (int pc = 0; pc < len; pc++) {
    u32 op = prog[pc];
    u32 a[8], b[8], r[8];
    slot_get(a, sl, stride, (op >> 16) & 0xFF);
    slot_get(b, sl, stride, op >> 24);
    F::op(op & 0xFF, r, a, b);
    slot_put(sl, stride, (op >> 8) & 0xFF, r);
  }
}

// 16 little-endian 16-bit limbs (the port's [B, 16] int32 layout) <-> words
DEV void load_limbs(u32* w, const int32_t* limbs) {
#pragma unroll
  for (int i = 0; i < 8; i++) w[i] = ((u32)limbs[2 * i] & 0xFFFFu) | ((u32)limbs[2 * i + 1] << 16);
}

DEV void store_limbs(int32_t* limbs, const u32* w) {
#pragma unroll
  for (int i = 0; i < 8; i++) {
    limbs[2 * i] = (int32_t)(w[i] & 0xFFFFu);
    limbs[2 * i + 1] = (int32_t)(w[i] >> 16);
  }
}

#ifdef __CUDACC__
extern "C" const char* fisco_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
#endif  // __CUDACC__

#endif  // FISCO_WIDE_INT_CUH
