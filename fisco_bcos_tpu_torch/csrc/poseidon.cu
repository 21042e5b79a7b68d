// Batch Poseidon over the BN254 scalar field on the H100: one thread a
// message, the packed form of the hash kernels (a packed batch: one byte
// buffer, int64 starts, int32 lengths) in, [B, 32] big-endian digests out.
//
// Replaces the JAX package's poseidon_blocks (fisco_bcos_tpu/ops/poseidon.py
// :127), a jitted lax.scan of 65 uniform rounds over blocks padded and
// Montgomery-encoded on the host, which the TPU ran outside any Pallas
// kernel; the port's plain version is poseidon_packed_plain
// (ops/poseidon.py). Callers: the Poseidon HashImpl's batch calls and merkle
// levels with hasher "poseidon" (the succinct state plane's commitment).
//
// Per lane: the message is padded in the kernel (0x01, then zeros to a
// 62-byte multiple), each 31-byte chunk read big-endian into a field element
// and encoded to the Montgomery domain by one product with R^2; the sponge
// (t = 3, rate 2) adds a block's two elements to state words 0 and 1 and
// permutes; the squeeze takes word 0 out of the Montgomery domain and writes
// its 32 bytes big-endian. A permutation is 65 rounds: the round constants
// added, the S-box x^5 = (x^2)^2·x on all three words (the 8 full rounds) or
// on word 0 alone (the 57 partial ones), then the 3x3 MDS mix.
//
// Field: GF(FR), FR < 2^254, values as 8 little-endian 32-bit words in the
// Montgomery domain x·R mod FR (R = 2^256). A product is the 512-bit a·b
// (wide_int.cuh's rows, or its 36-product squaring) and then a generic word
// REDC with n0 = -FR^-1 mod 2^32: FR has no special form, so each step's
// factor m = t_i·n0 takes a multiply and m·FR eight word products. An MDS
// row sums its three 512-bit products before one REDC (3·FR^2 < FR·R), so a
// mix is 9 products and 3 reductions. Every value is kept canonical (< FR),
// so every state word equals the plain version's (limb.MontField).
//
// Constants: nothing of the instance is written here. The wrapper passes
// one int32 table (ops/poseidon.py kernel_table, derived at import from the
// Grain LFSR and the Cauchy MDS and re-asserted there): FR, R^2 mod FR, n0,
// the 9 MDS entries and the 195 round constants in the Montgomery domain,
// and a full-round flag a round. A block copies it into shared memory; every
// lane reads the same word at once, a broadcast.
//
// What bounds it on an H100: 32-bit integer multiplies. A block costs about
// 157k multiplies a lane as this kernel runs it (a dense mix every round),
// 128k in the least form (chip_smoke.py POSEIDON_BLOCK_MULS, sparse partial
// mixes) against 62 bytes read; the card's integer multiply rate
// (16.75 T/s) makes the bound, not its memory. The design for the warp's
// instruction stream: the round loop stays rolled and so do the S-box's
// squarings, the full rounds' three S-boxes (the state rotated through word
// 0) and the MDS rows (the outputs rotated in), so the loop body holds one
// copy of each product kind and stays well inside the instruction cache
// (wide_int.cuh: a body past ~90 KiB of SASS costs over twice as much an
// instruction). Lanes of a warp that absorb fewer blocks idle until the
// warp's longest message is done.
//
// The arithmetic compiles as host C++ too (no __CUDACC__): the tier-1 tests
// build it with g++ and hold it against Python integers and the oracle.

#include "wide_int.cuh"

#define POSEIDON_T 3
#define POSEIDON_RATE 2
#define POSEIDON_ROUNDS 65
#define POSEIDON_CHUNK 31
#define POSEIDON_BLOCK_BYTES (POSEIDON_RATE * POSEIDON_CHUNK)

// The table's layout in 32-bit words (ops/poseidon.py kernel_table builds it)
enum {
  PT_FR = 0,                                        // FR
  PT_R2 = 8,                                        // R^2 mod FR
  PT_N0 = 16,                                       // -FR^-1 mod 2^32, then 7 zero words
  PT_MDS = 24,                                      // [3][3][8], Montgomery domain
  PT_RC = PT_MDS + 9 * 8,                           // [65][3][8], Montgomery domain
  PT_FULL = PT_RC + POSEIDON_ROUNDS * POSEIDON_T * 8,  // [65]: 1 in a full round, else 0
  PT_WORDS = PT_FULL + POSEIDON_ROUNDS + 3,          // padded to 16 bytes
};

// ---------------------------------------------------------------------------
// GF(FR) in the Montgomery domain
// ---------------------------------------------------------------------------

// r = t·R^-1 mod FR for t < FR·R (16 words, clobbered): 8 word steps, each
// t += m·FR·2^(32i) with m = t_i·n0, which clears word i. The carry out of
// word i + 8 is owed to word i + 9 and added in the next step; after the
// last, t[8..16) < 2·FR < 2^255, so nothing is owed past word 15, and one
// conditional subtract makes it canonical.
DEV void fr_redc(u32* r, u32* t, const u32* p, u32 n0) {
  u32 owed = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const u32 m = t[i] * n0;
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (u64)m * p[j] + t[i + j];
      t[i + j] = (u32)c;
      c >>= 32;
    }
    c += (u64)t[i + 8] + owed;
    t[i + 8] = (u32)c;
    owed = (u32)(c >> 32);
  }
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

// r = (m0·s0 + m1·s1 + m2·s2)·R^-1 mod FR: an MDS row (m the row's three
// entries, 24 words), the three products summed before one REDC
DEV void fr_mds_row(u32* r, const u32* m, const u32* s0, const u32* s1, const u32* s2,
                    const u32* p, u32 n0) {
  u32 t[16], u[16];
  wide_mul(t, m, s0);
  wide_mul(u, m + 8, s1);
  add_w<16>(t, t, u);
  wide_mul(u, m + 16, s2);
  add_w<16>(t, t, u);  // < 3·FR^2 < 2^510: no carry out
  fr_redc(r, t, p, n0);
}

// x <- x^5 = (x^2)^2·x, the two squarings one loop body
DEV void fr_sbox(u32* x, const u32* p, u32 n0) {
  u32 y[8];
  copy_w<8>(y, x);
#pragma unroll 1
  for (int k = 0; k < 2; k++) fr_sqr(y, y, p, n0);
  fr_mul(x, y, x, p, n0);
}

// (s0, s1, s2) <- (s1, s2, s0)
DEV void rotate3(u32* s0, u32* s1, u32* s2) {
  u32 t[8];
  copy_w<8>(t, s0);
  copy_w<8>(s0, s1);
  copy_w<8>(s1, s2);
  copy_w<8>(s2, t);
}

// The permutation over Montgomery-domain state words s0, s1, s2, with the
// constants of table `tab` and FR = p in the caller's registers.
DEV void poseidon_permute(u32* s0, u32* s1, u32* s2, const u32* tab, const u32* p, u32 n0) {
#pragma unroll 1
  for (int rnd = 0; rnd < POSEIDON_ROUNDS; rnd++) {
    const u32* rc = tab + PT_RC + rnd * (POSEIDON_T * 8);
    add_mod(s0, s0, rc, p);
    add_mod(s1, s1, rc + 8, p);
    add_mod(s2, s2, rc + 16, p);
    // word 0 boxed; in a full round the state turns three times through it
    const int boxes = tab[PT_FULL + rnd] ? POSEIDON_T : 1;
#pragma unroll 1
    for (int k = 0; k < boxes; k++) {
      fr_sbox(s0, p, n0);
      if (boxes == POSEIDON_T) rotate3(s0, s1, s2);
    }
    // the mix, a row a pass: row i lands in o2 and turns down to o_i
    u32 o0[8], o1[8], o2[8];
#pragma unroll 1
    for (int i = 0; i < POSEIDON_T; i++) {
      copy_w<8>(o0, o1);
      copy_w<8>(o1, o2);
      fr_mds_row(o2, tab + PT_MDS + i * (POSEIDON_T * 8), s0, s1, s2, p, n0);
    }
    copy_w<8>(s0, o0);
    copy_w<8>(s1, o1);
    copy_w<8>(s2, o2);
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

// The sponge over one message: digest = 8 big-endian words of the squeezed
// word 0 (the bytes in memory order, read as little-endian words).
DEV void poseidon_message(const uint8_t* msg, int64_t len, const u32* tab, u32* digest) {
  u32 p[8];
  copy_w<8>(p, tab + PT_FR);
  const u32 n0 = tab[PT_N0];
  u32 s0[8] = {0}, s1[8] = {0}, s2[8] = {0};
  const int64_t nblocks = len / POSEIDON_BLOCK_BYTES + 1;
#pragma unroll 1
  for (int64_t blk = 0; blk < nblocks; blk++) {
    // element e into word e: word 0 takes it, then words 0 and 1 swap
#pragma unroll 1
    for (int e = 0; e < POSEIDON_RATE; e++) {
      u32 x[8];
      read_chunk(x, msg, len, blk * POSEIDON_BLOCK_BYTES + e * POSEIDON_CHUNK);
      fr_mul(x, x, tab + PT_R2, p, n0);  // < 2^248 < FR, into the domain
      add_mod(s0, s0, x, p);
      copy_w<8>(x, s0);
      copy_w<8>(s0, s1);
      copy_w<8>(s1, x);
    }
    poseidon_permute(s0, s1, s2, tab, p, n0);
  }
  u32 t[16];
  copy_w<8>(t, s0);
#pragma unroll
  for (int i = 8; i < 16; i++) t[i] = 0;
  u32 v[8];
  fr_redc(v, t, p, n0);  // out of the domain, canonical
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const u32 x = v[7 - i];
    digest[i] = (x >> 24) | ((x >> 8) & 0xFF00u) | ((x << 8) & 0xFF0000u) | (x << 24);
  }
}

#ifdef __CUDACC__

// Two warps a block: 10,240 lanes make 160 blocks over the 132 SMs, a warp
// a scheduler; each block copies the 6.9 KB table once.
#define POSEIDON_THREADS 64

__global__ void __launch_bounds__(POSEIDON_THREADS)
poseidon_kernel(const uint8_t* __restrict__ data, const int64_t* __restrict__ starts,
                const int32_t* __restrict__ lengths, const u32* __restrict__ table,
                uint8_t* __restrict__ out, int n, int64_t n_data) {
  __shared__ __align__(16) u32 tab[PT_WORDS];
  for (int i = threadIdx.x; i < PT_WORDS; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t start = starts[i], len = lengths[i];
  u32 digest[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  // a range outside data is read from no memory: a zero digest
  if (start >= 0 && len >= 0 && start <= n_data - len) poseidon_message(data + start, len, tab, digest);
  uint4* row = reinterpret_cast<uint4*>(out + 32 * i);
  row[0] = make_uint4(digest[0], digest[1], digest[2], digest[3]);
  row[1] = make_uint4(digest[4], digest[5], digest[6], digest[7]);
}

// Launch geometry for n lanes: threads a block, blocks, dynamic shared bytes.
extern "C" void poseidon_geometry(int n, int* out) {
  out[0] = POSEIDON_THREADS;
  out[1] = (n + POSEIDON_THREADS - 1) / POSEIDON_THREADS;
  out[2] = 0;
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
  int geo[3];
  poseidon_geometry(n, geo);
  poseidon_kernel<<<geo[1], geo[0], geo[2], (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int64_t*)starts, (const int32_t*)lengths, (const u32*)table,
      (uint8_t*)out, n, (int64_t)n_data);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
