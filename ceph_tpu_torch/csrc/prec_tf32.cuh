// sweep_prec_tf32x3's and sweep_prec_tf32's kernel: _kernel_prec's field-sum
// product on the TF32 tensor cores through wgmma.  sweep_kernels.cu includes
// it; cuda_gf.source_digest hashes it into that library's digest.
// ceph_tpu_torch/tools/prec_probe.py builds edited copies of it.
//
// Replaces experiments/kernel_r4.py _kernel_prec (:315) at precision HIGH
// (sweep_prec_tf32x3: split TF32, exact) and DEFAULT (sweep_prec_tf32: one
// TF32 pass, which rounds the plane value 65537 to 65536 as the TPU's one
// reduced pass does).  Bound: the function's 2 * 2 * 8m * 8k multiply-adds
// a lane at the TF32 rate, 0.0347 ms at k=8 m=4 over 2097152 lanes (bytes:
// 0.0300); the split route runs the products twice, so this design's own
// floor is 0.0694 ms of tensor work.
//
// Design: the product transposed, out^T[lanes, 8m] = planes^T[lanes, 8k] .
// Bp^T[8k, 8m], so the lanes are wgmma's M:
// - A, 64 lanes x 8 planes a K-step, is built in registers from the input
//   words.  K is ordered j*8 + s, so K-step j is input row j: a thread's A
//   fragment (rows g and g + 8 of its warp's 16 lanes, columns t and t + 4)
//   is planes s = t and t + 4 of two words, shifted, masked, converted
//   (plane_float) and, for HIGH, split into big = cvt.rna.tf32(v) and small
//   = v - big (0 or 1, exact).  No plane goes to memory.
// - B = Bp^T, K-major, is staged once a block in shared memory in wgmma's
//   no-swizzle layout: K-step j holds N/8 core matrices of 8 bit-rows x 4
//   planes (128 bytes each; the two K halves 128 bytes apart, LBO; the
//   8-row groups 256 bytes apart, SBO).  Bp is 0 or 1 (the wrapper checks),
//   exact in TF32, so 3xTF32's Bp_small pass is skipped.
// - Per K-step a warpgroup issues wgmma.m64n32k8 for lo and hi, once per
//   pass (big, then small) and per 32 bit-rows, each into an accumulator of
//   its own (16 floats a thread per 32 bit-rows): no product waits on
//   another.  The A fragments come in two register sets: the next K-step's
//   extraction runs while the products of this one are in flight, and
//   wait_group 0 ends each K-step (the other warpgroups of the SM keep the
//   tensor cores busy meanwhile).
// - The input words reach shared memory by cp.async, a ring of kRing
//   sub-tiles a group (kRing - 1 in flight), and each K-step reads its two
//   words from there.  Not through registers: wgmma.fence waits for every
//   register write in flight, so a word loaded ahead into a register
//   stalls each K-step for the load.
// - Epilogue: the counts are exact integers below 2^24 (8k * 65537), held
//   in float32; + 2^23 puts a count below 2^23 in the mantissa (bits 0 and
//   16 are those of bytes 0 and 2, as count_bits reads them), and at k = 16,
//   where counts reach 2^23, F2I reads them.  A thread holds bit-rows 2t and
//   2t + 1 of each output row for lanes g and g + 8; it forms their bits
//   (bit l of byte b = bit 8b of z[8i + l]), and two xor-shuffle rounds
//   (reduce-scatter over the quad) leave thread t with output row 4h + t
//   of its lane, stored as 8 consecutive words a quad column.
// - The grid no longer follows the tile: a block of prec_groups warpgroups
//   takes tiles blockIdx.x, + gridDim.x, ... (as many blocks as fit), and
//   its warpgroups walk a tile's 64-lane sub-tiles in turn; the last
//   sub-tile of a tile may be ragged (the tile is any multiple of 32).
// The descriptor, the fences, the ring and the walk are wgmma_walk.cuh's,
// which dot_wgmma.cuh's product kernel shares.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "split_f32.cuh"
#include "wgmma_walk.cuh"

namespace {

// warpgroups a block: 4 (128 registers a thread) while the accumulators
// of one 32-row half leave room, 2 with both halves.  More warpgroups an
// SM hide more of each K-step's wait for its products (prec_probe.py's
// 2 and 3 warpgroups rows)
__host__ __device__ constexpr int prec_groups(int NB) {
  return NB == 1 ? 4 : 2;
}

// cvt.rna.tf32.f32 of a plane value (0, 1, 65536 or 65537): the 13 bits
// TF32 drops hold at most 0x80, under half a TF32 step, so rounding to
// nearest clears them (65537 -> 65536): one AND, where cvt.rna takes four
// instructions on this card
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return __float_as_uint(v) & 0xFFFFE000u;
}

// precision policies: a plane value -> its A operand for each pass
struct PrecTf32 {  // DEFAULT: one pass, the plane rounded to TF32
  static constexpr int kPasses = 1;
  __device__ static void split(float v, uint32_t (&a)[kPasses]) {
    a[0] = tf32_rna(v);
  }
};

struct PrecTf32x3 {  // HIGH: big, then small = v - big (0 or 1, exact)
  static constexpr int kPasses = 2;
  __device__ static void split(float v, uint32_t (&a)[kPasses]) {
    a[0] = tf32_rna(v);
    a[1] = __float_as_uint(v - __uint_as_float(a[0]));
  }
};

// d (+)= A . B over 64 lanes x 32 bit-rows x 8 planes; scale_d 0 starts d
__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Bp [8m, 8k] (column s*k + j) -> B [K-step j][8-row group][K half][row
// r][plane e], N = 32 NB bit-rows (zero past 8m): float (j, n, s) at j * 8N
// + (n / 8) * 64 + (s / 4) * 32 + (n % 8) * 4 + s % 4
template <int NB>
__device__ __forceinline__ void stage_b(const float* __restrict__ bp, int k,
                                        int m, float* sb) {
  constexpr int N = 32 * NB;
  const int depth = 8 * k;
  for (int idx = threadIdx.x; idx < depth * N; idx += blockDim.x) {
    const int j = idx / (8 * N), rem = idx % (8 * N);
    const int n = rem / 64 * 8 + rem / 4 % 8, s = rem / 32 % 2 * 4 + rem % 4;
    sb[idx] = n < 8 * m ? bp[n * depth + s * k + j] : 0.0f;
  }
}

// field_float(v & 0x00010001) in one LOP3, the mask and 2^23's exponent
// both in registers, where the compiler spends an AND and an OR
// (prec_probe.py's AND, OR fields row)
__device__ __forceinline__ float plane_float(uint32_t v) {
  uint32_t f;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"
      : "=r"(f)
      : "r"(v), "r"(0x00010001u), "r"(0x4B000000u));
  return __uint_as_float(f) - 8388608.0f;
}

// A fragments of one K-step, lo and hi for each pass, from the words of
// lanes g (w0) and g + 8 (w1): register (r & 1) is lane g or g + 8, (r >> 1)
// plane t or t + 4
template <class Prec>
__device__ __forceinline__ void build_a(uint32_t w0, uint32_t w1, int t,
                                        uint32_t (&lo)[Prec::kPasses][4],
                                        uint32_t (&hi)[Prec::kPasses][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t v = ((r & 1 ? w1 : w0) >> t) >> 4 * (r >> 1);
    uint32_t a[Prec::kPasses], b[Prec::kPasses];
    Prec::split(plane_float(v), a);
    Prec::split(plane_float(v >> 8), b);
#pragma unroll
    for (int p = 0; p < Prec::kPasses; ++p) {
      lo[p][r] = a[p];
      hi[p][r] = b[p];
    }
  }
}

// bits 0 and 16 of a count held in a float (kWide: through F2I, else from
// the mantissa of 2^23 + count)
template <bool kWide>
__device__ __forceinline__ uint32_t field_bits(float acc) {
  return count_bits<kWide>(kWide ? acc : acc + 8388608.0f);
}

// the output words of rows 4h + t (h < NB) for lanes lane and lane + 8
template <int NB, bool kWide>
__device__ __forceinline__ void store_prec(const float (&accL)[NB][16],
                                           const float (&accH)[NB][16],
                                           uint32_t* __restrict__ out, int m,
                                           long long n4, long long lane,
                                           long long stop, int t) {
#pragma unroll
  for (int h = 0; h < NB; ++h)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // v[i]: this thread's bit-rows 2t, 2t + 1 of output row 4h + i
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 4 * i + 2 * half;
        const uint32_t b0 = field_bits<kWide>(accL[h][c]) |
                            field_bits<kWide>(accH[h][c]) << 8;
        const uint32_t b1 = field_bits<kWide>(accL[h][c + 1]) |
                            field_bits<kWide>(accH[h][c + 1]) << 8;
        v[i] = b0 << (2 * t) | b1 << (2 * t + 1);
      }
      // reduce-scatter over the quad: thread t keeps row 4h + t
      const bool up = t & 2, odd = t & 1;
      uint32_t k0 = up ? v[2] : v[0], k1 = up ? v[3] : v[1];
      k0 |= __shfl_xor_sync(0xffffffffu, up ? v[0] : v[2], 2);
      k1 |= __shfl_xor_sync(0xffffffffu, up ? v[1] : v[3], 2);
      uint32_t word = odd ? k1 : k0;
      word |= __shfl_xor_sync(0xffffffffu, odd ? k0 : k1, 1);
      const int row = 4 * h + t;
      const long long l = lane + 8 * half;
      if (row < m && l < stop) out[row * n4 + l] = word;
    }
}

// NB: 32-row halves of the output bit-rows (m <= 4 NB); VEC: lanes a copy
// (4 where x is 16-byte aligned and n4 a multiple of 4, else 1).  Shared
// memory: Bp^T (8k x 32 NB floats), then each group's ring of kRing slots
// of [k][64] words.
template <int NB, class Prec, int VEC>
__global__ void __launch_bounds__(128 * prec_groups(NB), 1)
sweep_prec_tf32_kernel(const uint32_t* __restrict__ x,
                       const float* __restrict__ bp,
                       uint32_t* __restrict__ out, int k, int m, long long n4,
                       int T, int wide) {
  constexpr int N = 32 * NB;
  extern __shared__ __align__(128) float prec_smem[];
  float* sb = prec_smem;
  stage_b<NB>(bp, k, m, sb);
  // the staged table, written by the threads, is read by wgmma
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // the group index broadcast from lane 0, so the compiler knows it is
  // uniform over the warp and keeps the wgmma pipeline out of divergent code
  const int groups = blockDim.x / 128;
  const int group = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128, warp = tid / 32, lane_id = tid % 32;
  const int g = lane_id / 4, t = lane_id % 4;
  const uint64_t desc = b_desc(sb);
  const int slot_words = k * kSubLanes;
  uint32_t* ring = reinterpret_cast<uint32_t*>(sb + 8 * k * N) +
                   group * kRing * slot_words;

  Walk cur(blockIdx.x, group, n4, T, groups);
  if (cur.done()) return;
  Walk ahead = cur;
  for (int s = 0; s < kRing - 1; ++s) {
    fetch<VEC>(ring + s * slot_words, x, k, ahead, tid);
    ahead.next(group);
  }

  // acc[p][0] sums pass p of lo, acc[p][1] of hi: one chain each, so a
  // K-step's products do not wait on each other
  constexpr int P = Prec::kPasses;
  float acc[P][2][NB][16];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int h = 0; h < NB; ++h)
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[p][0][h][r] = acc[p][1][h][r] = 0.0f;

  for (int slot = 0; !cur.done(); cur.next(group), slot = (slot + 1) % kRing) {
    // this sub-tile's copies have landed for the whole group; the slot the
    // last sub-tile read is free for the walk's sub-tile kRing - 1 ahead
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 2) : "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + group) : "memory");
    fetch<VEC>(ring + (slot + kRing - 1) % kRing * slot_words, x, k, ahead,
               tid);
    ahead.next(group);

    const uint32_t* words = ring + slot * slot_words + 16 * warp + g;
    // two sets of A fragments: K-step j + 1's is built while the products
    // of K-step j read the other
    uint32_t lo[2][P][4], hi[2][P][4];
    build_a<Prec>(words[0], words[8], t, lo[0], hi[0]);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j < k) {
        wgmma_fence();
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int h = 0; h < NB; ++h) {
            // K-step j's 8N floats, 32 rows (1 KiB) a half: 16-byte units
            const uint64_t d = desc + static_cast<uint64_t>(2 * N * j + 64 * h);
            wgmma_tf32(acc[p][0][h], lo[j % 2][p], d, j > 0);
            wgmma_tf32(acc[p][1][h], hi[j % 2][p], d, j > 0);
          }
        wgmma_commit();
        if (j + 1 < k)
          build_a<Prec>(words[(j + 1) * kSubLanes],
                        words[(j + 1) * kSubLanes + 8], t, lo[(j + 1) % 2],
                        hi[(j + 1) % 2]);
        // the set read here lives until the products are done, so the
        // compiler gives its registers to nothing else while they run
        wgmma_wait<0>();
        fence_regs(lo[j % 2]);
        fence_regs(hi[j % 2]);
      }
    }
    float accL[NB][16], accH[NB][16];
#pragma unroll
    for (int h = 0; h < NB; ++h)
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        // integers below 2^24: the passes' sum is exact
        accL[h][r] = accH[h][r] = 0.0f;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          fence_acc(acc[p][0][h][r]);
          fence_acc(acc[p][1][h][r]);
          accL[h][r] += acc[p][0][h][r];
          accH[h][r] += acc[p][1][h][r];
        }
      }
    const long long lane = cur.lane0 + 16 * warp + g, stop = cur.stop;
    if (wide)
      store_prec<NB, true>(accL, accH, out, m, n4, lane, stop, t);
    else
      store_prec<NB, false>(accL, accH, out, m, n4, lane, stop, t);
  }
}

// shared memory of a block: Bp^T, and each group's ring
__host__ __device__ constexpr size_t prec_smem_bytes(int k, int NB) {
  return 4u * (8 * k * 32 * NB + prec_groups(NB) * kRing * k * kSubLanes);
}

template <int NB, class Prec, int VEC>
int launch_prec_tf32(const void* x, const void* bp, void* out, int k, int m,
                     long long n4, int T, cudaStream_t s) {
  const int threads = 128 * prec_groups(NB);
  const size_t smem = prec_smem_bytes(k, NB);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      sweep_prec_tf32_kernel<NB, Prec, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sweep_prec_tf32_kernel<NB, Prec, VEC>, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long ntiles = (n4 + T - 1) / T;
  const long long most = static_cast<long long>(sms) * per_sm;
  // 8k * 65537 reaches 2^23 at k = 16
  const int wide = 8LL * k * 65537 >= (1LL << 23);
  sweep_prec_tf32_kernel<NB, Prec, VEC>
      <<<static_cast<int>(ntiles < most ? ntiles : most), threads, smem, s>>>(
          static_cast<const uint32_t*>(x), static_cast<const float*>(bp),
          static_cast<uint32_t*>(out), k, m, n4, T, wide);
  return static_cast<int>(cudaGetLastError());
}

// k <= 16, m <= 8, T a positive multiple of 32
template <class Prec>
int run_prec_tf32(const void* x, const void* bp, void* out, int k, int m,
                  long long n4, int T, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0 || T % 32 != 0 || k < 1 || k > 16 || m < 1 || m > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = n4 % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (m <= 4)
    return vec ? launch_prec_tf32<1, Prec, 4>(x, bp, out, k, m, n4, T, s)
               : launch_prec_tf32<1, Prec, 1>(x, bp, out, k, m, n4, T, s);
  return vec ? launch_prec_tf32<2, Prec, 4>(x, bp, out, k, m, n4, T, s)
             : launch_prec_tf32<2, Prec, 1>(x, bp, out, k, m, n4, T, s);
}

}  // namespace
