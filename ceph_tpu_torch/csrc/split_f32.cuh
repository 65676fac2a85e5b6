// sweep_split_f32's kernel, with the field conversion and the transposed
// Bp staging that sweep_prec_f32 and sweep_planes_f32 use too.
// sweep_kernels.cu includes it; cuda_gf.source_digest hashes it into that
// library's digest.  ceph_tpu_torch/tools/split_probe.py builds edited
// copies of it.
//
// sweep_split_f32 replaces experiments/kernel_r4_split.py _kernel_split
// (:51) at HIGHEST: sweep_prec_f32's function with each tile of T lanes cut
// into parts column chunks of T/parts lanes.  On the TPU the chunks are
// independent chains that let extraction overlap the products; on this card
// an independent chain is a warp, so warp w of a block takes chunk w mod
// parts, 32 lanes at a time, and a thread keeps one lane.  Bound:
// sweep_prec_f32's, operations: 2 * 2 * 8m * 8k FFMA a lane, 0.2564 ms at
// k=8 m=4 over 2097152 lanes.  Design, for FFMA issue:
// - one pass a lane: its 16m accumulators stay in registers (a block of 512
//   threads at m <= 4, 128 registers a thread; 256 above), each input word
//   is loaded once, one row ahead of its products (the next row's word, or
//   the first of the warp's next lane), and each field is converted once
//   (field_float);
// - the parity without F2I: the accumulators start at 2^23, so each count
//   c < 2^23 ends in the mantissa of 2^23 + c, whose bits 0 and 16 are the
//   count's, as float_parity reads bit 0.  Counts reach 8k * 65537, which is
//   below 2^23 for k <= 15; at k = 16 the accumulators start at 0 and F2I
//   reads them;
// - the coefficients, Bp, stay a run-time operand: staged in shared memory
//   transposed and read as broadcast LDS.128, one for each 8 FFMA.
// The product stays dense: all 2 * 8m * 8k FFMA a lane, Bp's zeros
// included.  One block a tile; the grid is the tiles.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// float32 of the masked field bits u < 2^23, exactly: 2^23's exponent
// ORed in gives 2^23 + u, and the FADD removes 2^23
__device__ __forceinline__ float field_float(uint32_t u) {
  return __uint_as_float(u | 0x4B000000u) - 8388608.0f;
}

// Bp [8m, 8k] into shared memory transposed, [8k][8m]: row j*8 + s holds
// column s*k + j
__device__ __forceinline__ void stage_bp_t(const float* __restrict__ bp,
                                           int k, int R, float* sbp) {
  const int depth = 8 * k;
  for (int idx = threadIdx.x; idx < depth * R; idx += blockDim.x) {
    const int col = idx / R, r = idx % R;  // col = j*8 + s
    sbp[idx] = bp[r * depth + (col % 8) * k + col / 8];
  }
}

// threads a block of sweep_split_f32: 16 warps where a lane's 16m
// accumulators leave room in 128 registers (m <= 4), else 8
__host__ __device__ constexpr int split_threads(int M) {
  return M <= 4 ? 512 : 256;
}

// one input row's products for the thread's lane: its 16 fields, converted
// once, times the coefficients of all 16m accumulators; each coefficient
// read (an LDS.128 of Bp[4q .. 4q + 3][s*k + j]) feeds 8 FFMA
template <int M>
__device__ __forceinline__ void split_row(const float* sbp, int j,
                                          uint32_t v, float (&accL)[8 * M],
                                          float (&accH)[8 * M]) {
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const float lo = field_float((v >> s) & 0x00010001u);
    const float hi = field_float((v >> (8 + s)) & 0x00010001u);
    const float4* col =
        reinterpret_cast<const float4*>(sbp + (j * 8 + s) * 8 * M);
#pragma unroll
    for (int q = 0; q < 2 * M; ++q) {
      const float4 b = col[q];
      accL[4 * q] = fmaf(b.x, lo, accL[4 * q]);
      accL[4 * q + 1] = fmaf(b.y, lo, accL[4 * q + 1]);
      accL[4 * q + 2] = fmaf(b.z, lo, accL[4 * q + 2]);
      accL[4 * q + 3] = fmaf(b.w, lo, accL[4 * q + 3]);
      accH[4 * q] = fmaf(b.x, hi, accH[4 * q]);
      accH[4 * q + 1] = fmaf(b.y, hi, accH[4 * q + 1]);
      accH[4 * q + 2] = fmaf(b.z, hi, accH[4 * q + 2]);
      accH[4 * q + 3] = fmaf(b.w, hi, accH[4 * q + 3]);
    }
  }
}

// bits 0 and 16 of a count held exactly in a float: the mantissa's, where
// the accumulator started at 2^23 (kWide false), else through F2I
template <bool kWide>
__device__ __forceinline__ uint32_t count_bits(float acc) {
  if constexpr (kWide) return __float2uint_rn(acc) & 0x00010001u;
  return __float_as_uint(acc) & 0x00010001u;
}

// bit l of byte b of output row i: bit 8b of z = accL + (accH << 8), that is
// bit 0 or 16 of accL's count (b = 0, 2) or of accH's (b = 1, 3): each
// count is below 256, so no carry crosses a byte
template <int M, bool kWide>
__device__ __forceinline__ void store_split(const float (&accL)[8 * M],
                                            const float (&accH)[8 * M],
                                            uint32_t* __restrict__ out,
                                            long long n4, long long lane) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    uint32_t word = 0u;
#pragma unroll
    for (int l = 0; l < 8; ++l)
      word |= (count_bits<kWide>(accL[8 * i + l]) |
               count_bits<kWide>(accH[8 * i + l]) << 8)
              << l;
    out[static_cast<long long>(i) * n4 + lane] = word;
  }
}

// A block takes tile blockIdx.x; warp w of its W takes chunk w mod parts
// (W is a multiple of parts), 32 lanes at a time, the W / parts warps of a
// chunk in turn.
template <int M>
__global__ void __launch_bounds__(split_threads(M))
sweep_split_f32_kernel(const uint32_t* __restrict__ x,
                       const float* __restrict__ bp,
                       uint32_t* __restrict__ out, int k, long long n4, int T,
                       int parts, int wide) {
  __shared__ __align__(16) float sbp[16 * 8 * 8 * M];
  stage_bp_t(bp, k, 8 * M, sbp);
  __syncthreads();
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  const int span = T / parts, chunk = warp % parts;
  const long long tile0 = static_cast<long long>(blockIdx.x) * T;
  const long long chunk_end = tile0 + static_cast<long long>(chunk + 1) * span;
  const long long stop = chunk_end < n4 ? chunk_end : n4;
  const long long step = 32LL * (warps / parts);
  const int lane_id = threadIdx.x % 32;
  const float start = wide ? 0.0f : 8388608.0f;
  // input word j of lane l, 0 past the chunk
  auto word = [&](int j, long long l) {
    return l < stop ? __ldg(x + static_cast<long long>(j) * n4 + l) : 0u;
  };

  long long lane = tile0 + static_cast<long long>(chunk) * span +
                   32LL * (warp / parts) + lane_id;
  uint32_t next = word(0, lane);
  for (; lane - lane_id < stop; lane += step) {
    float accL[8 * M], accH[8 * M];
#pragma unroll
    for (int r = 0; r < 8 * M; ++r) accL[r] = accH[r] = start;
#pragma unroll 1
    for (int j = 0; j < k; ++j) {
      // each word is loaded one row ahead: the next row's, or the first
      // row of the warp's next lane
      const uint32_t v = next;
      const bool last = j + 1 == k;
      next = word(last ? 0 : j + 1, last ? lane + step : lane);
      split_row<M>(sbp, j, v, accL, accH);
    }
    if (lane >= stop) continue;
    if (wide)
      store_split<M, true>(accL, accH, out, n4, lane);
    else
      store_split<M, false>(accL, accH, out, n4, lane);
  }
}

// the checks of the entry point: parts 2, 4 or 8, T a positive multiple of
// 32 * parts, 1 <= k <= 16, and a grid of at most 2^31 - 1 tiles
inline bool split_shape_ok(int k, long long n4, int T, int parts) {
  return T > 0 && (parts == 2 || parts == 4 || parts == 8) &&
         T % (32 * parts) == 0 && k >= 1 && k <= 16 &&
         (n4 + T - 1) / T <= 0x7FFFFFFF;
}

template <int M>
int launch_split_f32(const void* x, const void* bp, void* out, int k,
                     long long n4, int T, int parts, cudaStream_t s) {
  // 8k * 65537 reaches 2^23 at k = 16
  const int wide = 8LL * k * 65537 >= (1LL << 23);
  sweep_split_f32_kernel<M>
      <<<static_cast<unsigned>((n4 + T - 1) / T), split_threads(M), 0, s>>>(
          static_cast<const uint32_t*>(x), static_cast<const float*>(bp),
          static_cast<uint32_t*>(out), k, n4, T, parts, wide);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
