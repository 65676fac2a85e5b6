// w=8 nibble-table lookups (gf-complete's SPLIT 8/4), shared by the two
// kernels that compute the w=8 GF(2) bitmatrix product from the same
// operand: gf2_matrix_w8 (gf_kernels.cu) and sweep_pipelined_w8
// (sweep_kernels.cu).  nvcc builds each source on its own, so the one
// lookup body lives here; cuda_gf.source_digest hashes this header into
// both builds.
//
// The 8x8 block B_ij (output byte-row i, input row j) is GF(2)-linear, so
// it splits over the input byte's two nibbles:
//   B_ij x = T_ij0[x & 15] ^ T_ij1[x >> 4],
// T_ijp[v] the XOR over the bits s of v of column 8j + 4p + s of bit-rows
// 8i .. 8i+7, as a byte (bit t = bit-row 8i + t).  The tables come from the
// bitmatrix alone and hold for any bitmatrix, encode and decode alike.
//
// Operand (cuda_gf.prep_matrix_w8): uint32 [ceil(m/4)][k][2][16], entry
// (g, j, p, v) holding T_ijp[v] of output rows i = 4g .. 4g+3 in its bytes
// 0 .. 3 (rows past m zero): 128 bytes per input row and output group.  A
// 16-entry table spans 16 banks, so the 32 lookups of one warp instruction
// never conflict (equal entries broadcast).

#pragma once

#include <stdint.h>

// uint32 entries of one input row's two nibble tables, one output group
constexpr int kW8Entries = 32;

// The entry at byte offset o of a table.
__device__ __forceinline__ uint32_t w8_entry(const char* t, uint32_t o) {
  return *reinterpret_cast<const uint32_t*>(t + o);
}

// XOR the entries of lane x (four input bytes of row j) into acc[gg][b]
// (byte position b of the lane; byte r of acc = output row 4g + r) for GP
// output groups, whose tables for row j start at tj, group_bytes apart.
// Per byte position: two nibbles times 4 (an entry's byte offset), picked
// with one PRMT each, two lookups folded into acc with one three-input XOR.
template <int GP>
__device__ __forceinline__ void w8_lookup(uint32_t (&acc)[GP][4],
                                          const char* tj, int group_bytes,
                                          uint32_t x) {
  // low nibbles times 4 in a4, high nibbles times 4 in b4, a byte each
  const uint32_t a4 = (x << 2) & 0x3C3C3C3Cu;
  const uint32_t b4 = (x >> 2) & 0x3C3C3C3Cu;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t lo = __byte_perm(a4, 0u, 0x4440u + b);
    const uint32_t hi = __byte_perm(b4, 0u, 0x4440u + b);
#pragma unroll
    for (int gg = 0; gg < GP; ++gg) {
      const char* t = tj + gg * group_bytes;
      acc[gg][b] ^= w8_entry(t, lo) ^ w8_entry(t + 16 * sizeof(uint32_t), hi);
    }
  }
}

// One group's accumulators -> the lanes of its 4 output rows: o[r] holds
// byte r of acc[0], acc[1], acc[2], acc[3] (a 4x4 byte transpose, 8 PRMTs).
__device__ __forceinline__ void w8_rows(const uint32_t (&acc)[4],
                                        uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(acc[0], acc[1], 0x5140u);  // bytes 0, 1
  const uint32_t t1 = __byte_perm(acc[0], acc[1], 0x7362u);  // bytes 2, 3
  const uint32_t t2 = __byte_perm(acc[2], acc[3], 0x5140u);
  const uint32_t t3 = __byte_perm(acc[2], acc[3], 0x7362u);
  o[0] = __byte_perm(t0, t2, 0x5410u);
  o[1] = __byte_perm(t0, t2, 0x7632u);
  o[2] = __byte_perm(t1, t3, 0x5410u);
  o[3] = __byte_perm(t1, t3, 0x7632u);
}
