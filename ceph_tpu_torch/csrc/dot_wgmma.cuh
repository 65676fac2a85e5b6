// sweep_int8_4dot's, sweep_bf16_4dot's, sweep_f32_4dot's and
// sweep_bf16_blockdiag's kernel: one wgmma kernel template for the
// single-bit-plane products of experiments/kernel_r4.py.  sweep_kernels.cu
// includes it; cuda_gf.source_digest hashes it into that library's digest.
// ceph_tpu_torch/tools/dot_probe.py builds edited copies of it.
//
// Replaces kernel_r4._kernel_int8_4dot (:76), _kernel_bf16_4dot (:52) with
// dtype bfloat16 and with float32, and _kernel_bf16_blockdiag (:100).  For
// each byte position b < 4: planes[s*k + j] = (x[j] >> (8b + s)) & 1, and
// bit l of byte b of output row i is the parity of row 8i + l of Bp @
// planes (Bp the shift-major 0/1 bitmatrix [8m, 8k]); the block-diagonal
// row computes all four byte positions as one dense product with Bblk
// [32m, 32k] (block b is Bp), zero blocks included: that product is the
// formulation the row prices.  Every sum is at most 8k (the zero blocks
// add nothing), exact in int32 and float32, so no product is split.
//
// Bound on the card: the function's 2 * 4 * 8m * 8k * n4 operations at the
// type's dense rate (int8 1,979 TOP/s, bf16 989, TF32 495 TFLOP/s) or the
// (k + m) * n4 * 4 bytes at 3.35 TB/s, whichever is longer: bytes for
// int8 (0.0300 ms at k=8 m=4 over 2097152 lanes), operations for bf16
// (0.0347) and TF32 (0.0694); the block-diagonal product's dense
// operations take 4x the function's, 0.139 ms at the bf16 rate.
//
// Design: the product transposed, out^T[lanes, N] = planes^T[lanes, K] .
// table^T[K, N], so the lanes are wgmma's M (64 a warpgroup):
// - A is built in registers from the words; no plane goes to memory.  A
//   K-step holds the 8 planes of one byte position of P input rows (P = 1
//   for TF32, k8; 2 for bf16, k16; 4 for int8, k32), ordered so that
//   thread (g, t)'s fragment -- register r: lane g + 8 (r & 1), K-indices
//   4P (r >> 1) + P t + e in its P elements e, the layout of every wgmma
//   A operand -- comes from one input row: K-index kk is input row jj =
//   floor(t' P / 4) and plane s = P (t' % (4 / P)) + e' + 4 h' of the
//   K-step's rows, with (h', t', e') = (kk / 4P, kk % 4P / P, kk % P).  So
//   a thread reads one word of each of its two lanes a K-step, and each
//   register is a shift, a mask and a spread of P bits (dot_build_a).
// - B is the table^T, staged once a block in shared memory in wgmma's
//   no-swizzle K-major layout (wgmma_walk.cuh), its rows permuted into the
//   K order above (dot_stage_b).  The 4-dot: B = Bp^T, N = 32 NB bit-rows
//   (NB = 1 at m <= 4, 2 at m <= 8; zero past 8m), and each K-step issues
//   four wgmma, one per byte position, byte b's A into accumulator b, all
//   reading one descriptor.  The block-diagonal: B = Bblk^T, N = 32m, a
//   K-step of its own for each (row group, byte position), and each
//   K-step's four wgmma read the K rows of byte b across all 32m columns
//   into one accumulator.
// - wgmma lays N out in blocks of 8 columns, so the 4-dot's four N-column
//   accumulators side by side have the block-diagonal accumulator's
//   register layout: block b * MB + i is byte b of output row i (MB = N /
//   8 for the 4-dot, m for the block-diagonal).  One epilogue serves both
//   (store_dot): the parity of each sum (bit 0 of the int32; of the float
//   after adding 2^23; where sums are below 256, the four byte positions'
//   low bytes added side by side first), 8 bits a byte gathered in
//   registers, and two xor-shuffle rounds (reduce-scatter over the quad)
//   leave thread t with output row 4h + t of its lane.
// - The walk and the loads are prec_tf32.cuh's (wgmma_walk.cuh): blocks
//   of dot_groups warpgroups (as many blocks as fit), each walking 64-lane
//   sub-tiles, the words through a cp.async ring of kRing sub-tiles a
//   warpgroup, one K-step's wgmma in flight while the next K-step's A is
//   built, wait_group 0 ending each K-step.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_walk.cuh"

namespace {

// warpgroups a block: 4 (128 registers a thread) while a thread's
// accumulators are at most 64 registers, 2 above that.  More warpgroups an
// SM hide more of each K-step's wait for its products
__host__ __device__ constexpr int dot_groups(int nacc) {
  return nacc <= 64 ? 4 : 2;
}

// the operand lists of one wgmma with D accumulator registers a thread,
// the A registers, the descriptor and the scale-d predicate
#define DOT_OUT_16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
  "}, {%16, %17, %18, %19}, %20, p"
#define DOT_SETP_16 "setp.ne.b32 p, %21, 0;\n"
#define DOT_OUT_32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31" \
  "}, {%32, %33, %34, %35}, %36, p"
#define DOT_SETP_32 "setp.ne.b32 p, %37, 0;\n"
#define DOT_OUT_48 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47" \
  "}, {%48, %49, %50, %51}, %52, p"
#define DOT_SETP_48 "setp.ne.b32 p, %53, 0;\n"
#define DOT_OUT_64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63" \
  "}, {%64, %65, %66, %67}, %68, p"
#define DOT_SETP_64 "setp.ne.b32 p, %69, 0;\n"

// accumulator constraints: 4 and 16 registers from d[i] on ("+f" float,
// "+r" int32)
#define DOT_C4(c, d, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define DOT_C16(c, d, i) \
  DOT_C4(c, d, i), DOT_C4(c, d, i + 4), DOT_C4(c, d, i + 8), \
      DOT_C4(c, d, i + 12)
#define DOT_C32(c, d) DOT_C16(c, d, 0), DOT_C16(c, d, 16)
#define DOT_C48(c, d) DOT_C32(c, d), DOT_C16(c, d, 32)
#define DOT_C64(c, d) DOT_C32(c, d), DOT_C16(c, d, 32), DOT_C16(c, d, 48)

// one wgmma with A from registers: d (+)= A . B, scale_d 0 starts d.
// INSTR names shape and types, D the accumulator registers a thread,
// SUFFIX the immediates after the predicate, the rest the constraints
#define DOT_ASM(INSTR, D, SUFFIX, ...)                                    \
  asm volatile("{\n.reg .pred p;\n" DOT_SETP_##D INSTR " " DOT_OUT_##D    \
               SUFFIX ";\n}\n"                                              \
               : __VA_ARGS__                                                \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),     \
                 "r"(scale_d))

#define DOT_F(v) "+f"(v)
#define DOT_R(v) "+r"(v)

// the parity of a float sum below 2^23: adding 2^23 puts its bit 0 in the
// mantissa's bit 0, exactly
__device__ __forceinline__ uint32_t dot_parity(float acc) {
  return __float_as_uint(acc + 8388608.0f) & 1u;
}
__device__ __forceinline__ uint32_t dot_parity(int acc) {
  return static_cast<uint32_t>(acc) & 1u;
}

// the parities of four sums below 256 in bits 0, 8, 16 and 24: their low
// bytes added side by side (no carry crosses a byte), bit 0 of each kept.
// A float sum is read from the mantissa of sum + 2^23; the exponent bits
// above it fall off the shifted words and, of the first, add 0x4B to byte
// 3, whose bit 0 the XOR restores
__device__ __forceinline__ uint32_t dot_parity4(float a0, float a1, float a2,
                                                float a3) {
  const uint32_t z = __float_as_uint(a0 + 8388608.0f) +
                     (__float_as_uint(a1 + 8388608.0f) << 8) +
                     (__float_as_uint(a2 + 8388608.0f) << 16) +
                     (__float_as_uint(a3 + 8388608.0f) << 24);
  return (z & 0x01010101u) ^ 0x01000000u;
}
__device__ __forceinline__ uint32_t dot_parity4(int a0, int a1, int a2,
                                                int a3) {
  const uint32_t z = static_cast<uint32_t>(a0) +
                     (static_cast<uint32_t>(a1) << 8) +
                     (static_cast<uint32_t>(a2) << 16) +
                     (static_cast<uint32_t>(a3) << 24);
  return z & 0x01010101u;
}

// Operand types.  P: input rows a K-step (K = 8P elements, 32 bytes a row
// of B); Table: a table element, staged as raw bits; frag: the P plane
// bits in bits 0.. of v (higher bits ignored) -> one A register of P
// elements, each 0 or 1 in the type (element e from bit e)
struct Tf32Dot {
  static constexpr int P = 1;
  using Table = uint32_t;
  using Acc = float;
  __device__ static uint32_t frag(uint32_t v) {
    return (v & 1u) * 0x3F800000u;
  }
  template <int N>
  __device__ static void mma(float* d, const uint32_t (&a)[4], uint64_t desc,
                             int scale_d) {
    if constexpr (N == 32) {
      DOT_ASM("wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32", 16,
              ", 1, 1", DOT_C16(DOT_F, d, 0));
    } else {
      static_assert(N == 64, "the 4-dot takes N = 32 or 64");
      DOT_ASM("wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32", 32,
              ", 1, 1", DOT_C32(DOT_F, d));
    }
  }
};

struct Bf16Dot {
  static constexpr int P = 2;
  using Table = uint16_t;
  using Acc = float;
  // bits 0 and 1 to bf16 1.0 (0x3F80) or 0 in the low and high half
  __device__ static uint32_t frag(uint32_t v) {
    return ((v & 1u) | ((v << 15) & 0x10000u)) * 0x3F80u;
  }
  template <int N>
  __device__ static void mma(float* d, const uint32_t (&a)[4], uint64_t desc,
                             int scale_d) {
    if constexpr (N == 32) {
      DOT_ASM("wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16", 16,
              ", 1, 1, 0", DOT_C16(DOT_F, d, 0));
    } else if constexpr (N == 64) {
      DOT_ASM("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16", 32,
              ", 1, 1, 0", DOT_C32(DOT_F, d));
    } else if constexpr (N == 96) {
      DOT_ASM("wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16", 48,
              ", 1, 1, 0", DOT_C48(DOT_F, d));
    } else {
      static_assert(N == 128, "bf16 takes N = 32, 64, 96 or 128");
      DOT_ASM("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16", 64,
              ", 1, 1, 0", DOT_C64(DOT_F, d));
    }
  }
};

struct Int8Dot {
  static constexpr int P = 4;
  using Table = uint8_t;
  using Acc = int;
  // bits 0..3 to bit 0 of bytes 0..3 (the multiply's partial products land
  // on distinct bits, so nothing carries)
  __device__ static uint32_t frag(uint32_t v) {
    return ((v & 0xFu) * 0x00204081u) & 0x01010101u;
  }
  template <int N>
  __device__ static void mma(int* d, const uint32_t (&a)[4], uint64_t desc,
                             int scale_d) {
    if constexpr (N == 32) {
      DOT_ASM("wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8", 16, "",
              DOT_C16(DOT_R, d, 0));
    } else {
      static_assert(N == 64, "the 4-dot takes N = 32 or 64");
      DOT_ASM("wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8", 32, "",
              DOT_C32(DOT_R, d));
    }
  }
};

// bytes of the staged table: a K-step of N rows x 32 bytes for each group
// of P input rows, and for the block-diagonal table each byte position
__host__ __device__ constexpr size_t dot_table_bytes(int k, int N, bool blk,
                                                     int P) {
  return static_cast<size_t>(blk ? 4 : 1) * ((k + P - 1) / P) * 32 * N;
}

// shared memory of a block: the table, and each group's ring of kRing
// slots of [k][64] words
__host__ __device__ constexpr size_t dot_smem_bytes(int k, int N, bool blk,
                                                    int P, int groups) {
  return dot_table_bytes(k, N, blk, P) +
         static_cast<size_t>(groups) * kRing * k * kSubLanes * 4;
}

// the table [rows, depth] (the 4-dot's Bp [8m, 8k], or Bblk [32m, 32k])
// -> B: K-step st (st = q for the 4-dot, 4q + b for the block-diagonal:
// row group q, byte position b) at st * 32N bytes, row n and K-index kk at
// (n / 8) * 256 + (kk / C) * 128 + (n % 8) * 16 + (kk % C) * (16 / C)
// bytes within it (C = 4P elements a 16-byte core-matrix row); zero past
// the table's rows and its k inputs
template <class Op, int N, bool kBlk>
__device__ __forceinline__ void dot_stage_b(
    const typename Op::Table* __restrict__ table, int k, int m,
    typename Op::Table* sb) {
  constexpr int P = Op::P, K = 8 * P, C = 4 * P;
  const int steps = (kBlk ? 4 : 1) * ((k + P - 1) / P);
  const int rows = kBlk ? 32 * m : 8 * m, depth = (kBlk ? 32 : 8) * k;
  for (int idx = threadIdx.x; idx < steps * N * K; idx += blockDim.x) {
    const int st = idx / (N * K), off = idx % (N * K);
    const int n = off / (8 * K) * 8 + off % (8 * C) / C;
    const int kk = off % (8 * K) / (8 * C) * C + off % C;
    const int tq = kk % C / P;  // the thread of the quad that holds kk
    const int jj = tq * P / 4;
    const int s = P * (tq % (4 / P)) + kk % P + 4 * (kk / C);
    const int q = kBlk ? st / 4 : st, b = kBlk ? st % 4 : 0;
    const int j = P * q + jj;
    sb[idx] = n < rows && j < k ? table[n * depth + b * 8 * k + s * k + j]
                                : typename Op::Table{0};
  }
}

// A fragments of one K-step, one set a byte position, from the words of
// lanes g (w0) and g + 8 (w1) of this thread's input row, each shifted to
// its first plane (P (t % (4 / P))): register r is lane g + 8 (r & 1),
// planes + 4 (r >> 1)
template <class Op>
__device__ __forceinline__ void dot_build_a(uint32_t w0, uint32_t w1,
                                            uint32_t (&a)[4][4]) {
#pragma unroll
  for (int b = 0; b < 4; ++b)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[b][r] = Op::frag((r & 1 ? w1 : w0) >> (8 * b + 4 * (r >> 1)));
}

// the output words of rows 4h + t for lanes lane and lane + 8: block b *
// MB + i of the accumulators is byte b of output row i (registers 4 (b MB
// + i) + 2 hr + c: lane + 8 hr, bit 2t + c).  kBytes: every sum is below
// 256 (8k < 256), so the four byte positions' parities are taken at once
template <int MB, bool kBytes, typename Acc>
__device__ __forceinline__ void store_dot(const Acc (&acc)[16 * MB],
                                          uint32_t* __restrict__ out, int m,
                                          long long n4, long long lane,
                                          long long stop, int t) {
#pragma unroll
  for (int h = 0; h < (MB + 3) / 4; ++h)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      // v[i]: this thread's bits 2t, 2t + 1 of each byte of row 4h + i
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = 0u;
        if (4 * h + i < MB) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const Acc* a = acc + 4 * (4 * h + i) + 2 * hr + c;
            if constexpr (kBytes)
              v[i] |= dot_parity4(a[0], a[4 * MB], a[8 * MB], a[12 * MB])
                      << c;
            else
#pragma unroll
              for (int b = 0; b < 4; ++b)
                v[i] |= dot_parity(a[4 * MB * b]) << (8 * b + c);
          }
        }
        v[i] <<= 2 * t;
      }
      // reduce-scatter over the quad: thread t keeps row 4h + t
      const bool up = t & 2, odd = t & 1;
      uint32_t k0 = up ? v[2] : v[0], k1 = up ? v[3] : v[1];
      k0 |= __shfl_xor_sync(0xffffffffu, up ? v[0] : v[2], 2);
      k1 |= __shfl_xor_sync(0xffffffffu, up ? v[1] : v[3], 2);
      uint32_t word = odd ? k1 : k0;
      word |= __shfl_xor_sync(0xffffffffu, odd ? k0 : k1, 1);
      const int row = 4 * h + t;
      const long long l = lane + 8 * hr;
      if (row < m && l < stop) out[row * n4 + l] = word;
    }
}

// One K-step (row group q): its four wgmma on set cur, the next K-step's A
// built into set next meanwhile, then wait_group 0
template <class Op, int N, bool kBlk>
__device__ __forceinline__ void dot_step(
    typename Op::Acc (&acc)[kBlk ? N / 2 : 2 * N], uint32_t (&cur)[4][4],
    uint32_t (&next)[4][4], uint64_t desc, int q, int Q,
    const uint32_t* words, int jj, int k, int shift) {
  wgmma_fence();
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if constexpr (kBlk)
      // K-step 4q + b of N rows x 32 bytes: 2N 16-byte units each
      Op::template mma<N>(acc, cur[b],
                          desc + static_cast<uint64_t>(2 * N * (4 * q + b)),
                          q > 0 || b > 0);
    else
      Op::template mma<N>(acc + b * (N / 2), cur[b],
                          desc + static_cast<uint64_t>(2 * N * q), q > 0);
  }
  wgmma_commit();
  if (q + 1 < Q) {
    // rows past k read row k - 1, whose planes meet zero rows of B
    const int j = min(Op::P * (q + 1) + jj, k - 1);
    dot_build_a<Op>(words[j * kSubLanes] >> shift,
                    words[j * kSubLanes + 8] >> shift, next);
  }
  // the set read here lives until the products are done, so the compiler
  // gives its registers to nothing else while they run
  wgmma_wait<0>();
  fence_regs(cur);
}

// N: columns of each wgmma (the 4-dot: 32 NB; the block-diagonal: 32m);
// vec: the words come 4 lanes a copy (x 16-byte aligned, n4 a multiple of
// 4), else 1.  Shared memory: the table, then each group's ring.
template <class Op, int N, bool kBlk>
__global__ void __launch_bounds__(128 * dot_groups(kBlk ? N / 2 : 2 * N), 1)
sweep_dot_kernel(const uint32_t* __restrict__ x,
                 const typename Op::Table* __restrict__ table,
                 uint32_t* __restrict__ out, int k, int m, long long n4,
                 int vec) {
  using Acc = typename Op::Acc;
  constexpr int P = Op::P;
  constexpr int MB = kBlk ? N / 32 : N / 8;  // 8-column blocks a byte
  extern __shared__ __align__(128) uint8_t dot_smem[];
  auto* sb = reinterpret_cast<typename Op::Table*>(dot_smem);
  dot_stage_b<Op, N, kBlk>(table, k, m, sb);
  // the staged table, written by the threads, is read by wgmma
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // the group index broadcast from lane 0, so the compiler knows it is
  // uniform over the warp and keeps the wgmma pipeline out of divergent code
  const int groups = blockDim.x / 128;
  const int group = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128, warp = tid / 32, lane_id = tid % 32;
  const int g = lane_id / 4, t = lane_id % 4;
  // this thread's input row of a K-step, and its first plane
  const int jj = t * P / 4, shift = P * (t % (4 / P));
  const int Q = (k + P - 1) / P;
  const uint64_t desc = b_desc(sb);
  const int slot_words = k * kSubLanes;
  uint32_t* ring = reinterpret_cast<uint32_t*>(
                       dot_smem + dot_table_bytes(k, N, kBlk, P)) +
                   group * kRing * slot_words;

  const int T = kSubLanes * groups;  // a tile: one sub-tile a group
  Walk cur(blockIdx.x, group, n4, T, groups);
  if (cur.done()) return;
  Walk ahead = cur;
  for (int s = 0; s < kRing - 1; ++s) {
    if (vec)
      fetch<4>(ring + s * slot_words, x, k, ahead, tid);
    else
      fetch<1>(ring + s * slot_words, x, k, ahead, tid);
    ahead.next(group);
  }

  Acc acc[16 * MB];
#pragma unroll
  for (int r = 0; r < 16 * MB; ++r) acc[r] = Acc{0};

  for (int slot = 0; !cur.done(); cur.next(group), slot = (slot + 1) % kRing) {
    // this sub-tile's copies have landed for the whole group; the slot the
    // last sub-tile read is free for the walk's sub-tile kRing - 1 ahead
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 2) : "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + group) : "memory");
    uint32_t* free_slot = ring + (slot + kRing - 1) % kRing * slot_words;
    if (vec)
      fetch<4>(free_slot, x, k, ahead, tid);
    else
      fetch<1>(free_slot, x, k, ahead, tid);
    ahead.next(group);

    const uint32_t* words = ring + slot * slot_words + 16 * warp + g;
    // two sets of A fragments: K-step q + 1's is built while the products
    // of K-step q read the other
    uint32_t a[2][4][4];
    const int j0 = min(jj, k - 1);
    dot_build_a<Op>(words[j0 * kSubLanes] >> shift,
                    words[j0 * kSubLanes + 8] >> shift, a[0]);
    for (int q = 0; q < Q; q += 2) {
      dot_step<Op, N, kBlk>(acc, a[0], a[1], desc, q, Q, words, jj, k, shift);
      if (q + 1 < Q)
        dot_step<Op, N, kBlk>(acc, a[1], a[0], desc, q + 1, Q, words, jj, k,
                              shift);
    }
#pragma unroll
    for (int r = 0; r < 16 * MB; ++r) fence_acc(acc[r]);
    const long long lane = cur.lane0 + 16 * warp + g;
    // the 4-dot's sums are at most 8k <= 128
    if (!kBlk || 8 * k < 256)
      store_dot<MB, true>(acc, out, m, n4, lane, cur.stop, t);
    else
      store_dot<MB, false>(acc, out, m, n4, lane, cur.stop, t);
  }
}

// the most warpgroups, up to dot_groups, whose block fits the card's
// shared memory (0: not even one)
template <class Op, int N, bool kBlk>
int dot_fit_groups(int k, size_t limit) {
  for (int groups = dot_groups(kBlk ? N / 2 : 2 * N); groups > 0; --groups)
    if (dot_smem_bytes(k, N, kBlk, Op::P, groups) <= limit) return groups;
  return 0;
}

template <class Op, int N, bool kBlk>
int launch_dot(const void* x, const void* table, void* out, int k, int m,
               long long n4, cudaStream_t s) {
  auto kernel = sweep_dot_kernel<Op, N, kBlk>;
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int groups =
      dot_fit_groups<Op, N, kBlk>(k, static_cast<size_t>(optin));
  if (groups == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dot_smem_bytes(k, N, kBlk, Op::P, groups);
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      128 * groups, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long T = static_cast<long long>(kSubLanes) * groups;
  const long long ntiles = (n4 + T - 1) / T;
  const long long most = static_cast<long long>(sms) * per_sm;
  const int vec =
      n4 % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  kernel<<<static_cast<int>(ntiles < most ? ntiles : most), 128 * groups,
           smem, s>>>(static_cast<const uint32_t*>(x),
                      static_cast<const typename Op::Table*>(table),
                      static_cast<uint32_t*>(out), k, m, n4, vec);
  return static_cast<int>(cudaGetLastError());
}

// the 4-dot: k <= 16, m <= 8
template <class Op>
int run_4dot(const void* x, const void* bp, void* out, int k, int m,
             long long n4, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 16 || m < 1 || m > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 4) return launch_dot<Op, 32, false>(x, bp, out, k, m, n4, s);
  return launch_dot<Op, 64, false>(x, bp, out, k, m, n4, s);
}

// the block-diagonal product: m <= 4, and a table and one group's ring
// within the card's shared memory (launch_dot refuses more)
int run_blockdiag(const void* x, const void* bblk, void* out, int k, int m,
                  long long n4, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (m) {
    case 1: return launch_dot<Bf16Dot, 32, true>(x, bblk, out, k, m, n4, s);
    case 2: return launch_dot<Bf16Dot, 64, true>(x, bblk, out, k, m, n4, s);
    case 3: return launch_dot<Bf16Dot, 96, true>(x, bblk, out, k, m, n4, s);
    case 4: return launch_dot<Bf16Dot, 128, true>(x, bblk, out, k, m, n4, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
