// EC kernel-sweep kernels for Hopper (sm_90a): the probes and variants of
// the kernel sweep (ceph_tpu_torch/tools/ec_kernel_sweep.py), over
// little-endian bytes packed 4 to a 32-bit lane, [rows, n4].
//
//   sweep_copy          replaces tools/ec_kernel_sweep.py _copy_kernel (:117)
//   sweep_extract       replaces tools/ec_kernel_sweep.py _extract_only_kernel
//                       (:121)
//   sweep_pipelined_w8  replaces tools/ec_kernel_sweep.py _pipelined_call
//                       (:76, emit_pipeline over pallas_gf._matrix_kernel)
//   sweep_int8_4dot     replaces experiments/kernel_r4.py _kernel_int8_4dot
//                       (:76) (its kernel is dot_wgmma.cuh's)
//   sweep_bf16_4dot     replaces experiments/kernel_r4.py _kernel_bf16_4dot
//                       (:52) with dtype bfloat16 (dot_wgmma.cuh's)
//   sweep_f32_4dot      replaces experiments/kernel_r4.py _kernel_bf16_4dot
//                       (:52) with dtype float32 (dot_wgmma.cuh's)
//   sweep_bf16_blockdiag  replaces experiments/kernel_r4.py
//                       _kernel_bf16_blockdiag (:100) (dot_wgmma.cuh's)
//   sweep_prec_f32      replaces experiments/kernel_r4.py _kernel_prec (:315)
//                       at precision HIGHEST (sweep_split_f32's kernel at
//                       parts 1)
//   sweep_prec_tf32x3   the same at precision HIGH (its kernel is
//                       prec_tf32.cuh's)
//   sweep_prec_tf32     the same at precision DEFAULT (prec_tf32.cuh's)
//   sweep_split_f32     replaces experiments/kernel_r4_split.py _kernel_split
//                       (:51) at precision HIGHEST, parts 2, 4 and 8 (its
//                       kernel is split_f32.cuh's)
//   sweep_extract_fold  replaces experiments/kernel_r4_probe.py
//                       _extract_kernel (:38)
//   sweep_planes_f32    replaces experiments/kernel_r4_probe.py _mxu_kernel
//                       (:54)
//
// (sweep_xornet, the sweep's static XOR network, is csrc/xornet_kernel.cu:
// its network is generated per bitmatrix.)
//
// Each computes what its TPU kernel computes, not the way the TPU does it;
// the note above each kernel says what bounds it on this card and what its
// design does about that.
//
// Interface: plain C, loaded with ctypes.  Pointers come from
// tensor.data_ptr(), the stream from torch.cuda.current_stream().cuda_stream.
// Each entry point launches on that stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() (0 on success) or the error of a
// refused set-up call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dot_wgmma.cuh"
#include "gf_w8_tables.cuh"
#include "prec_tf32.cuh"
#include "split_f32.cuh"

namespace {

constexpr int kThreads = 256;
// shared memory a block may take without opting in, and with it (Hopper)
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Blocks to launch for a kernel that walks its work in a loop: as many as
// fit on the card at once, and no more than there are work items.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, size_t smem, long long items,
                    int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long most = static_cast<long long>(sms) * per_sm;
  *blocks = static_cast<int>(items < most ? items : most);
  return 0;
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// ---------------------------------------------------------------------------
// sweep_copy and sweep_extract: one map over the first m rows
// ---------------------------------------------------------------------------
//
// The rows < m of x [k, n4] are its first m * n4 lanes, laid out as the
// output [m, n4], so both probes are one flat map over m * n4 lanes.
//
// sweep_copy: out = x[:m], the copy control.  Bound on the card: memory,
// m * n4 * 4 bytes read and the same written (3.35 TB/s on an H100 SXM); it
// does no arithmetic.  Its time is what moving this layout costs here, and
// the yardstick of the other rows, so it has to be at least as fast as the
// PyTorch's own copy (x[:m].clone()).  Design: a grid sized to the work
// (no grid-stride loop, no occupancy call), each thread kCopyUnroll
// 16-byte streaming loads in flight, then evict-first stores; a ragged
// total or a pointer that is not 16-byte aligned takes its 4-byte form.
// ceph_tpu_torch/tools/split_probe.py times it beside the clone, at other
// unroll depths, beside the grid-stride map it replaced and beside a TMA
// bulk-copy ring (cp.async.bulk through shared memory on mbarriers), the
// other design measured for it.
//
// sweep_extract: out[i] = sum over s < 8 of ((x[i] >> s) & 0x00010001) +
// ((x[i] >> (8 + s)) & 0x00010001), the bit-plane extraction of the
// production TPU kernel without its dots.  Bound: the same bytes as the
// copy; 48 integer operations a lane are far under the card's issue rate.
// Design: 16-byte loads and stores (VEC = 4), each thread keeping kUnroll
// of them in flight before it stores, grid-stride over the lanes, with the
// 16 shift-and-adds on each lane; a ragged total or a pointer that is not
// 16-byte aligned takes the 4-byte form.  The sum is taken in uint32: each
// 16-bit field collects at most 16, so the fields never carry into each
// other and the result equals the TPU's f32 sum.  Its time against the
// copy's is what extraction costs on this card.

constexpr int kUnroll = 4;

struct ExtractOp {
  __device__ __forceinline__ uint32_t operator()(uint32_t v) const {
    uint32_t acc = 0u;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      acc += (v >> s) & 0x00010001u;
      acc += (v >> (8 + s)) & 0x00010001u;
    }
    return acc;
  }
};

template <typename Op>
__device__ __forceinline__ uint4 apply(Op op, uint4 v) {
  return make_uint4(op(v.x), op(v.y), op(v.z), op(v.w));
}

template <typename Op>
__device__ __forceinline__ uint32_t apply(Op op, uint32_t v) {
  return op(v);
}

// T is uint4 (16-byte vectors) or uint32_t; n counts elements of T
template <typename Op, typename T>
__global__ void __launch_bounds__(kThreads)
rows_map_kernel(const T* __restrict__ x, T* __restrict__ out, long long n) {
  const Op op{};
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x *
                         kUnroll;
  for (long long base =
           static_cast<long long>(blockIdx.x) * blockDim.x * kUnroll +
           threadIdx.x;
       base < n; base += step) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + static_cast<long long>(u) * blockDim.x;
      if (i < n) v[u] = __ldg(x + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + static_cast<long long>(u) * blockDim.x;
      if (i < n) out[i] = apply(op, v[u]);
    }
  }
}

template <typename Op, typename T>
int launch_map(const void* x, void* out, long long n, cudaStream_t s) {
  int blocks = 0;
  const long long items = (n + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const int rc = resident_blocks(rows_map_kernel<Op, T>, kThreads, 0, items,
                                 &blocks);
  if (rc != 0) return rc;
  rows_map_kernel<Op, T><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename Op>
int launch_rows(const void* x, void* out, int m, long long n4,
                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long lanes = static_cast<long long>(m) * n4;
  if (lanes % 4 == 0 && aligned16(x) && aligned16(out))
    return launch_map<Op, uint4>(x, out, lanes / 4, s);
  return launch_map<Op, uint32_t>(x, out, lanes, s);
}

// 16-byte (or 4-byte) elements a thread of the copy keeps in flight
constexpr int kCopyUnroll = 4;

// T is uint4 (the aligned copy) or uint32_t (the 4-byte form); n counts
// elements of T.  Each thread takes kCopyUnroll elements kThreads apart,
// loaded ahead of its stores.
template <typename T>
__global__ void __launch_bounds__(kThreads)
copy_kernel(const T* __restrict__ x, T* __restrict__ out, long long n) {
  const long long base =
      static_cast<long long>(blockIdx.x) * kThreads * kCopyUnroll +
      threadIdx.x;
  T v[kCopyUnroll];
#pragma unroll
  for (int u = 0; u < kCopyUnroll; ++u) {
    const long long i = base + static_cast<long long>(u) * kThreads;
    if (i < n) v[u] = __ldcs(x + i);
  }
#pragma unroll
  for (int u = 0; u < kCopyUnroll; ++u) {
    const long long i = base + static_cast<long long>(u) * kThreads;
    if (i < n) __stcs(out + i, v[u]);
  }
}

template <typename T>
int launch_copy(const void* x, void* out, long long n, cudaStream_t s) {
  const long long blocks =
      (n + kThreads * kCopyUnroll - 1) / (kThreads * kCopyUnroll);
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  copy_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// sweep_extract_fold: every bit plane of all k rows, folded into m rows
// ---------------------------------------------------------------------------
//
// Replaces experiments/kernel_r4_probe.py _extract_kernel (:38): the planes
// lo[r] = (x[j] >> s) & 0x00010001 and hi[r] = (x[j] >> (8 + s)) &
// 0x00010001 of row r = s*k + j, and out[i] = sum over r = i (mod m) of
// lo[r] + hi[r], for m dividing 8k.  Each 16-bit field counts set bits: the
// low field bits s and 8 + s of the lane's low half, the high field those of
// its high half.  So the planes of one row whose r fall into one class are
// one mask, and their sum is two popcounts.
//
// Bound on the card: memory, (k + m) * n4 * 4 bytes (it reads all k rows,
// sweep_extract only m); the work is a few integer operations a lane and
// plane class.  Design: the row maps' loop, grid-stride, 16-byte loads of
// 4 lanes a thread (4-byte loads of one lane where n4 is no multiple of 4
// or a pointer is not 16-byte aligned); each word of each row is loaded
// once.  The fold's row index must stay
// known at compile time, or the accumulators go to local memory: with M = m
// and D = k mod m as template parameters, row r = s*k + j falls into class
// (s*D + j) mod M, the loop over j steps by M, and the class of each plane
// of each unrolled step is a constant.  Only D with M | 8D occur (m | 8k).
// The sum is taken in uint32: each field collects at most 16k/m counts, far
// below a carry; the wrapper refuses 16k/m * 65537 >= 2^24, where the TPU's
// f32 sum would no longer be exact.

// bits of a lane whose planes fall into class u: 0x01010101 << s for each s
// with s*d = u (mod m)
__host__ __device__ constexpr uint32_t fold_mask(int m, int d, int u) {
  uint32_t mask = 0u;
  for (int s = 0; s < 8; ++s)
    if ((s * d) % m == u) mask |= 0x01010101u << s;
  return mask;
}

// the two fields' counts of the bits of v under mask
__device__ __forceinline__ uint32_t field_counts(uint32_t v, uint32_t mask) {
  return static_cast<uint32_t>(__popc(v & mask & 0x0000FFFFu)) +
         (static_cast<uint32_t>(__popc(v & mask & 0xFFFF0000u)) << 16);
}

// the load of L lanes
template <int L> struct LanesOf { using T = uint32_t; };
template <> struct LanesOf<4> { using T = uint4; };

// L lanes a thread: 4 (one 16-byte load a row) or 1.  The accumulators
// are L * M scalars, unpacked from each load: an array of uint4 would let
// part of it go to local memory.
template <int M, int D, int L>
__global__ void __launch_bounds__(kThreads)
sweep_extract_fold_kernel(const uint32_t* __restrict__ x,
                          uint32_t* __restrict__ out, int k, long long n4) {
  using T = typename LanesOf<L>::T;
  const long long n = n4 / L;  // elements of T in a row
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    uint32_t acc[M][L] = {};
    for (int j0 = 0; j0 < k; j0 += M) {
#pragma unroll
      for (int t = 0; t < M; ++t) {
        if (j0 + t < k) {
          const T v = __ldg(reinterpret_cast<const T*>(
                                x + static_cast<long long>(j0 + t) * n4) +
                            i);
          uint32_t w[L];
          if constexpr (L == 4) {
            w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
          } else {
            w[0] = v;
          }
#pragma unroll
          for (int u = 0; u < M; ++u) {
            const uint32_t mask = fold_mask(M, D, u);
            if (mask != 0u)
#pragma unroll
              for (int c = 0; c < L; ++c)
                acc[(t + u) % M][c] += field_counts(w[c], mask);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < M; ++r) {
      T* row = reinterpret_cast<T*>(out + static_cast<long long>(r) * n4);
      if constexpr (L == 4)
        row[i] = make_uint4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      else
        row[i] = acc[r][0];
    }
  }
}

template <int M, int D, int L>
int launch_fold_as(const void* x, void* out, int k, long long n4,
                   cudaStream_t s) {
  int blocks = 0;
  const long long n = n4 / L;
  const int rc = resident_blocks(sweep_extract_fold_kernel<M, D, L>,
                                 kThreads, 0, (n + kThreads - 1) / kThreads,
                                 &blocks);
  if (rc != 0) return rc;
  sweep_extract_fold_kernel<M, D, L><<<blocks, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), k, n4);
  return static_cast<int>(cudaGetLastError());
}

// the instance for d = k mod M, or an error
template <int M, int D = 0>
int launch_fold(int d, const void* x, void* out, int k, long long n4,
                cudaStream_t s) {
  if constexpr ((8 * D) % M == 0) {
    if (d == D) {
      if (n4 % 4 == 0 && aligned16(x) && aligned16(out))
        return launch_fold_as<M, D, 4>(x, out, k, n4, s);
      return launch_fold_as<M, D, 1>(x, out, k, n4, s);
    }
  }
  if constexpr (D + 1 < M)
    return launch_fold<M, D + 1>(d, x, out, k, n4, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// sweep_pipelined_w8: the w=8 product with double-buffered staging
// ---------------------------------------------------------------------------
//
// Computes what gf2_matrix_w8 (gf_kernels.cu) computes, from the same
// nibble tables (uint32 [ceil(m/4)][k][2][16], cuda_gf.prep_matrix_w8) and
// with the same lookup body (w8_lookup and w8_rows, gf_w8_tables.cuh): per
// lane and input row, 8 lookups into 4 byte-position accumulators, whose
// 4x4 byte transpose gives a group's 4 output rows.
//
// Bound on the card: memory, (k + m) * n4 * 4 bytes.  gf2_matrix_w8 loads
// its inputs into registers kBatch rows ahead; this kernel stages them in
// shared memory instead, so the two are an A/B of two ways of staging one
// design.  A block walks over lane tiles of T lanes (tile i, i + gridDim.x,
// ...).  Each [k, T] input tile is staged with cp.async copies (16 bytes,
// or 4 where the rows are not 16-byte aligned) in a two-stage ring, so
// tile i + 1 is in flight while tile i is computed from shared memory.
// The block's tables sit in shared memory for the whole walk where they
// fit beside the two stages; otherwise they are read through the
// read-only cache.  One thread owns 4 lanes (or 1) of a tile and keeps one
// output group's 4 accumulators a lane in registers, group after group.
// The grid is as many blocks as fit on the card at once.  Shared memory
// per block: 2 * k * T * 4 bytes of stages, and 128 * k * ceil(m/4) bytes
// of tables where the sum fits in 227 KiB; opted in above 48 KiB.  On an
// H100 it runs 16-22% slower than gf2_matrix_w8: each staged word is read
// once, so the ring adds a copy, a barrier a tile and shared memory a
// block that cap its resident blocks, and saves no device read (PERF.md).

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group of this thread is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage lanes [lane0, lane0 + width) of the k input rows into dst [k, T].
template <int VEC>
__device__ __forceinline__ void stage_tile(const uint32_t* __restrict__ x,
                                           uint32_t* dst, int k, int T,
                                           long long n4, long long lane0,
                                           int width) {
  const int cols = width / VEC;
  for (int j = 0; j < k; ++j) {
    const uint32_t* src = x + static_cast<long long>(j) * n4 + lane0;
    uint32_t* row = dst + static_cast<long long>(j) * T;
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      if constexpr (VEC == 4)
        cp_async16(row + c * 4, src + c * 4);
      else
        cp_async4(row + c, src + c);
    }
  }
}

// x [k, n4] lanes; tables [ceil(m/4)][k][32] uint32; out [m, n4].
// Dynamic shared memory: the tables (TAB_SMEM), then two stages [k, T].
template <int VEC, bool TAB_SMEM>
__global__ void __launch_bounds__(kThreads)
sweep_pipelined_kernel(const uint32_t* __restrict__ x,
                       const uint32_t* __restrict__ tables,
                       uint32_t* __restrict__ out, int k, int m, long long n4,
                       int T, long long ntiles) {
  extern __shared__ __align__(16) uint32_t pipe_smem[];
  const int groups = (m + 3) >> 2;
  const int ntab = groups * k * kW8Entries;  // a multiple of 32 words
  const uint32_t* tab = tables;
  uint32_t* stages = pipe_smem;
  if constexpr (TAB_SMEM) {
    for (int i = threadIdx.x; i < ntab; i += blockDim.x)
      pipe_smem[i] = __ldg(tables + i);
    tab = pipe_smem;
    stages = pipe_smem + ntab;
  }
  const int group_bytes = k * kW8Entries * static_cast<int>(sizeof(uint32_t));

  long long t = blockIdx.x;
  if (t < ntiles) {
    const long long lane0 = t * T;
    stage_tile<VEC>(x, stages, k, T, n4, lane0,
                    static_cast<int>(n4 - lane0 < T ? n4 - lane0 : T));
  }
  cp_async_commit();
  for (int st = 0; t < ntiles; t += gridDim.x, st ^= 1) {
    // the other stage was last read before the barrier that ended the
    // previous iteration, so it can be refilled now
    const long long next = t + gridDim.x;
    if (next < ntiles) {
      const long long lane0 = next * T;
      stage_tile<VEC>(x, stages + (st ^ 1) * k * T, k, T, n4, lane0,
                      static_cast<int>(n4 - lane0 < T ? n4 - lane0 : T));
    }
    cp_async_commit();  // possibly empty: keeps one group per iteration
    cp_async_wait_one();
    __syncthreads();  // tile t (and, the first time, the tables) visible

    const uint32_t* tile = stages + st * k * T;
    const long long lane0 = t * T;
    const int width = static_cast<int>(n4 - lane0 < T ? n4 - lane0 : T);
    for (int c = threadIdx.x; c < width / VEC; c += blockDim.x) {
      for (int g = 0; g < groups; ++g) {
        const char* tg = reinterpret_cast<const char*>(tab) + g * group_bytes;
        uint32_t acc[VEC][1][4];
#pragma unroll
        for (int v = 0; v < VEC; ++v)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[v][0][b] = 0u;
        for (int j = 0; j < k; ++j) {
          uint32_t xv[VEC];
          if constexpr (VEC == 4) {
            const uint4 q = *reinterpret_cast<const uint4*>(tile + j * T +
                                                           c * 4);
            xv[0] = q.x; xv[1] = q.y; xv[2] = q.z; xv[3] = q.w;
          } else {
            xv[0] = tile[j * T + c];
          }
          const char* tj = tg + j * kW8Entries * sizeof(uint32_t);
#pragma unroll
          for (int v = 0; v < VEC; ++v) w8_lookup<1>(acc[v], tj, 0, xv[v]);
        }
        uint32_t o[VEC][4];
#pragma unroll
        for (int v = 0; v < VEC; ++v) w8_rows(acc[v][0], o[v]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 4 * g + r;
          if (row >= m) break;
          uint32_t* dst = out + static_cast<long long>(row) * n4 + lane0 +
                          c * VEC;
          if constexpr (VEC == 4)
            *reinterpret_cast<uint4*>(dst) =
                make_uint4(o[0][r], o[1][r], o[2][r], o[3][r]);
          else
            dst[0] = o[0][r];
        }
      }
    }
    __syncthreads();  // stage st is refilled two tiles on
  }
}

template <int VEC, bool TAB_SMEM>
int launch_pipelined_as(const uint32_t* x, const uint32_t* tables,
                        uint32_t* out, int k, int m, long long n4, int T,
                        size_t smem, cudaStream_t s) {
  const auto kernel = sweep_pipelined_kernel<VEC, TAB_SMEM>;
  int rc = allow_smem(kernel, smem);
  if (rc != 0) return rc;
  const long long ntiles = (n4 + T - 1) / T;
  int blocks = 0;
  rc = resident_blocks(kernel, kThreads, smem, ntiles, &blocks);
  if (rc != 0) return rc;
  kernel<<<blocks, kThreads, smem, s>>>(x, tables, out, k, m, n4, T, ntiles);
  return static_cast<int>(cudaGetLastError());
}

// The tables sit in shared memory beside the two stages where both fit in
// kMaxSmem; otherwise they are read through the read-only cache.
template <int VEC>
int launch_pipelined(const uint32_t* x, const uint32_t* tables, uint32_t* out,
                     int k, int m, long long n4, int T, cudaStream_t s) {
  const size_t stages = 2ull * k * T * sizeof(uint32_t);
  const size_t tab = static_cast<size_t>((m + 3) / 4) * k * kW8Entries *
                     sizeof(uint32_t);
  if (stages > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (stages + tab <= kMaxSmem)
    return launch_pipelined_as<VEC, true>(x, tables, out, k, m, n4, T,
                                          stages + tab, s);
  return launch_pipelined_as<VEC, false>(x, tables, out, k, m, n4, T, stages,
                                         s);
}

// ---------------------------------------------------------------------------
// sweep_int8_4dot, sweep_bf16_4dot, sweep_f32_4dot, sweep_bf16_blockdiag:
// the single-bit-plane products on wgmma
// ---------------------------------------------------------------------------
//
// For each byte position b < 4: planes[s*k + j] = (x[j] >> (8b + s)) & 1,
// [8k, n4]; acc = Bp @ planes, with Bp the shift-major 0/1 bitmatrix
// [8m, 8k]; bit l of byte b of output row i is acc[8i + l] & 1.  The four
// entry points differ in the operand type of the product and in its table:
//
//   sweep_int8_4dot       kernel_r4._kernel_int8_4dot (:76): int8, int32
//                         sums (wgmma .s32.s8.s8, k32)
//   sweep_bf16_4dot       kernel_r4._kernel_bf16_4dot (:52) with bf16: float
//                         sums (wgmma .f32.bf16.bf16, k16)
//   sweep_f32_4dot        kernel_r4._kernel_bf16_4dot (:52) with float32:
//                         TF32 operands, float sums (wgmma .f32.tf32.tf32,
//                         k8; 0, 1 and sums <= 8k are exact in TF32)
//   sweep_bf16_blockdiag  kernel_r4._kernel_bf16_blockdiag (:100): the
//                         four byte positions as one dense bf16 product
//                         with the block-diagonal Bblk [32m, 32k], zero
//                         blocks included (the formulation the row prices)
//
// One kernel template serves all four: dot_wgmma.cuh's (the note there
// gives its design and bounds).  The 4-dot takes k <= 16 and m <= 8; the
// block-diagonal product m <= 4 and any k whose table and one warpgroup's
// ring fit in the card's shared memory.

// ---------------------------------------------------------------------------
// sweep_prec_f32, sweep_prec_tf32x3, sweep_prec_tf32: the production
// product's field sums at three precisions (the sweep's precision stage);
// sweep_planes_f32, the HIGHEST product over planes made beforehand
// ---------------------------------------------------------------------------
//
// Replace experiments/kernel_r4.py _kernel_prec (:315) as main_prec (:341)
// runs it: pallas_gf._matrix_kernel's arithmetic with the dots' precision
// exposed.  lo[s*k + j] = (x[j] >> s) & 0x00010001 and hi[s*k + j] =
// (x[j] >> (8 + s)) & 0x00010001 as floats (0, 1, 65536, 65537: bit s of
// bytes 0 and 2, or of bytes 1 and 3); accL = Bp @ lo, accH = Bp @ hi (Bp
// the shift-major 0/1 float32 bitmatrix [8m, 8k]); z = accL + (accH << 8)
// holds the four byte positions' counts in its four bytes; bit l of byte b
// of output row i is bit 8b of z[8i + l].  Every count is at most 8k, so z
// is exact wherever the planes are (sums <= 8k * 65537 < 2^24).
//
//   JAX precision  kernel             route on Hopper                exact?
//   HIGHEST        sweep_prec_f32     FFMA on the CUDA cores         yes
//   HIGH           sweep_prec_tf32x3  split TF32 on wgmma            yes
//   DEFAULT        sweep_prec_tf32    one TF32 pass on wgmma         no
//
// sweep_prec_tf32 rounds each plane with cvt.rna.tf32.f32: 65537 = 0x10001
// needs 17 significant bits, TF32 keeps 11, so it becomes 65536 and bytes 0
// and 1 lose the count of that plane -- as the TPU's one bf16 pass at
// DEFAULT does, which is why the JAX tool expects that row to MISMATCH.
// sweep_prec_tf32x3 splits each plane b into b_big = cvt.rna(b) and b_small
// = b - b_big and accumulates Bp * b_big + Bp * b_small in float32: exact.
// Their kernel is prec_tf32.cuh's (the note there gives its design).
//
// sweep_prec_f32 is _kernel_split's function at parts 1, so it runs
// split_f32.cuh's one-pass FFMA kernel with one chunk a tile.
//
// Bound on the card: the function's 2 * 2 * 8m * 8k * n4 operations (two
// products, a multiply-add counted twice) at the float32 rate of the CUDA
// cores (67 TFLOP/s) for sweep_prec_f32, at the TF32 tensor-core rate (495
// TFLOP/s) for the other two, or the (k + m) * n4 * 4 bytes at 3.35 TB/s,
// whichever is longer: operations at k=8 m=4 for sweep_prec_f32 (0.2564
// ms), operations for the TF32 kernels (0.0347 ms, bytes 0.0300).
//
// sweep_planes_f32 replaces experiments/kernel_r4_probe.py _mxu_kernel
// (:54): sweep_prec_f32's product and epilogue at HIGHEST over planes
// extracted beforehand, float32 [2, 8k, n4] (lo rows s*k + j, then hi).
// One thread per lane over a persistent grid (tiles i, i + gridDim.x, ...).
// Bp sits in shared memory transposed, [8k][8m] (stage_bp_t), so for input
// row j and plane s the 8m coefficients are consecutive and every warp
// reads them as broadcast 16-byte loads: one LDS.128 feeds 8 FFMA (4 rows,
// lo and hi).  The thread keeps 16m float accumulators; each plane value
// is one 4-byte load, and a warp's load is one whole 128-byte line.
// Bound: bytes, the planes are 64 times the payload: (16k + m) * n4 * 4
// bytes, 0.3305 ms at k=8 m=4 and 2097152 lanes, above the FFMA bound of
// 0.2564.  A thread keeps one lane: four lanes a thread (16-byte loads)
// would need 4 x 16m accumulators.

template <int M>
__global__ void __launch_bounds__(kThreads)
sweep_planes_f32_kernel(const float* __restrict__ planes,
                        const float* __restrict__ bp,
                        uint32_t* __restrict__ out, int k, long long n4,
                        int T) {
  constexpr int R = 8 * M;  // bit-rows
  __shared__ __align__(16) float sbp[16 * 8 * R];
  stage_bp_t(bp, k, R, sbp);
  __syncthreads();

  // plane s of input row j to plane s + 1, and lo to hi
  const long long step = static_cast<long long>(k) * n4;
  const long long ntiles = (n4 + T - 1) / T;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long end = (tile + 1) * T < n4 ? (tile + 1) * T : n4;
    for (long long lane = tile * T + threadIdx.x; lane < end;
         lane += blockDim.x) {
      float accL[R], accH[R];
#pragma unroll
      for (int r = 0; r < R; ++r) accL[r] = accH[r] = 0.0f;
      for (int j = 0; j < k; ++j) {
        const float* v = planes + static_cast<long long>(j) * n4 + lane;
        const float4* col = reinterpret_cast<const float4*>(sbp + j * 8 * R);
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const float lo = __ldg(v + s * step);
          const float hi = __ldg(v + (8 + s) * step);
#pragma unroll
          for (int q = 0; q < R / 4; ++q) {
            const float4 b = col[s * (R / 4) + q];
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
#pragma unroll
      for (int i = 0; i < M; ++i) {
        uint32_t word = 0u;
#pragma unroll
        for (int l = 0; l < 8; ++l) {
          const uint32_t z = __float2uint_rn(accL[8 * i + l]) +
                             (__float2uint_rn(accH[8 * i + l]) << 8);
          word |= (z & 0x01010101u) << l;
        }
        out[static_cast<long long>(i) * n4 + lane] = word;
      }
    }
  }
}

template <int M>
int launch_planes_f32(const void* planes, const void* bp, void* out, int k,
                      long long n4, int T, cudaStream_t s) {
  const long long ntiles = (n4 + T - 1) / T;
  int blocks = 0;
  const int rc = resident_blocks(sweep_planes_f32_kernel<M>, kThreads, 0,
                                 ntiles, &blocks);
  if (rc != 0) return rc;
  sweep_planes_f32_kernel<M><<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(planes), static_cast<const float*>(bp),
      static_cast<uint32_t*>(out), k, n4, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [>= m, n4] lanes; out [m, n4] = x[:m]
int sweep_copy(const void* x, void* out, int m, long long n4, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long lanes = static_cast<long long>(m) * n4;
  if (lanes % 4 != 0 || !aligned16(x) || !aligned16(out))
    return launch_copy<uint32_t>(x, out, lanes, s);
  return launch_copy<uint4>(x, out, lanes / 4, s);
}

// x [>= m, n4] lanes; out [m, n4], the 16 shifted plane sums of x[:m]
int sweep_extract(const void* x, void* out, int m, long long n4,
                  void* stream) {
  return launch_rows<ExtractOp>(x, out, m, n4, stream);
}

// x [k, n4] lanes; tables [ceil(m/4), 32k] int32 (nibble tables, uint32
// [ceil(m/4)][k][2][16]); out [m, n4]; T lanes per stage, a multiple of 4
// whose two stages fit in 227 KiB
int sweep_pipelined_w8(const void* x, const void* tables, void* out, int k,
                       int m, long long n4, int T, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const uint32_t*>(x);
  const auto* ti = static_cast<const uint32_t*>(tables);
  auto* oi = static_cast<uint32_t*>(out);
  if (T <= 0 || T % 4 != 0 || k < 0 || m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n4 % 4 == 0 && aligned16(x) && aligned16(out))
    return launch_pipelined<4>(xi, ti, oi, k, m, n4, T, s);
  return launch_pipelined<1>(xi, ti, oi, k, m, n4, T, s);
}

// x [k, n4] lanes; bp [8m, 8k] 0/1, shift-major (column s*k + j is bit s
// of chunk j), of the product's operand type; out [m, n4]; k <= 16, m <= 8

// int8 bp
int sweep_int8_4dot(const void* x, const void* bp, void* out, int k, int m,
                    long long n4, void* stream) {
  return run_4dot<Int8Dot>(x, bp, out, k, m, n4, stream);
}

// bf16 bp
int sweep_bf16_4dot(const void* x, const void* bp, void* out, int k, int m,
                    long long n4, void* stream) {
  return run_4dot<Bf16Dot>(x, bp, out, k, m, n4, stream);
}

// float32 bp (used as TF32)
int sweep_f32_4dot(const void* x, const void* bp, void* out, int k, int m,
                   long long n4, void* stream) {
  return run_4dot<Tf32Dot>(x, bp, out, k, m, n4, stream);
}

// x [k, n4] lanes; bblk [32m, 32k] bf16, block-diagonal (block b is the
// shift-major bp); out [m, n4]; m <= 4, and the staged table (32 bytes for
// each of 4 ceil(k/2) K-steps of 32m rows) and one warpgroup's ring (4
// sub-tiles of [k][64] words) within the card's shared memory
int sweep_bf16_blockdiag(const void* x, const void* bblk, void* out, int k,
                         int m, long long n4, void* stream) {
  return run_blockdiag(x, bblk, out, k, m, n4, stream);
}

// x [k, n4] lanes; bp [8m, 8k] float32 0/1, shift-major; out [m, n4]; T
// lanes a block takes per step, a positive multiple of 32

// HIGHEST: FFMA, split_f32.cuh's kernel at parts 1; k <= 16, m <= 8
int sweep_prec_f32(const void* x, const void* bp, void* out, int k, int m,
                   long long n4, int T, void* stream) {
  return run_split_f32(x, bp, out, k, m, n4, T, 1,
                       static_cast<cudaStream_t>(stream));
}

// HIGHEST, FFMA, each tile of T lanes in parts column chunks (parts 1, 2,
// 4 or 8; T a positive multiple of 32 * parts); k <= 16, m <= 8
int sweep_split_f32(const void* x, const void* bp, void* out, int k, int m,
                    long long n4, int T, int parts, void* stream) {
  return run_split_f32(x, bp, out, k, m, n4, T, parts,
                       static_cast<cudaStream_t>(stream));
}

// planes [2, 8k, n4] float32 (lo rows s*k + j, then hi rows), as
// sweep_gf.field_planes builds them; bp as above; out [m, n4]; HIGHEST,
// FFMA; k <= 16, m <= 8
int sweep_planes_f32(const void* planes, const void* bp, void* out, int k,
                     int m, long long n4, int T, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0 || T % 32 != 0 || k < 1 || k > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (m) {
    case 1: return launch_planes_f32<1>(planes, bp, out, k, n4, T, s);
    case 2: return launch_planes_f32<2>(planes, bp, out, k, n4, T, s);
    case 3: return launch_planes_f32<3>(planes, bp, out, k, n4, T, s);
    case 4: return launch_planes_f32<4>(planes, bp, out, k, n4, T, s);
    case 5: return launch_planes_f32<5>(planes, bp, out, k, n4, T, s);
    case 6: return launch_planes_f32<6>(planes, bp, out, k, n4, T, s);
    case 7: return launch_planes_f32<7>(planes, bp, out, k, n4, T, s);
    case 8: return launch_planes_f32<8>(planes, bp, out, k, n4, T, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// x [k, n4] lanes; out [m, n4] int32: the sum over planes r = s*k + j with
// r = i (mod m) of (x[j] >> s) & 0x00010001 and (x[j] >> (8 + s)) &
// 0x00010001; m <= 8 dividing 8k, and 16k/m * 65537 < 2^24
int sweep_extract_fold(const void* x, void* out, int k, int m, long long n4,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || m < 1 || m > 8 || (8 * k) % m != 0 ||
      16LL * k / m * 65537 >= (1LL << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (m) {
    case 1: return launch_fold<1>(k % 1, x, out, k, n4, s);
    case 2: return launch_fold<2>(k % 2, x, out, k, n4, s);
    case 3: return launch_fold<3>(k % 3, x, out, k, n4, s);
    case 4: return launch_fold<4>(k % 4, x, out, k, n4, s);
    case 5: return launch_fold<5>(k % 5, x, out, k, n4, s);
    case 6: return launch_fold<6>(k % 6, x, out, k, n4, s);
    case 7: return launch_fold<7>(k % 7, x, out, k, n4, s);
    case 8: return launch_fold<8>(k % 8, x, out, k, n4, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// HIGH: split TF32 on wgmma (Bp must hold only 0 and 1); k <= 16, m <= 8
int sweep_prec_tf32x3(const void* x, const void* bp, void* out, int k,
                      int m, long long n4, int T, void* stream) {
  return run_prec_tf32<PrecTf32x3>(x, bp, out, k, m, n4, T, stream);
}

// DEFAULT: one TF32 pass on wgmma; k <= 16, m <= 8
int sweep_prec_tf32(const void* x, const void* bp, void* out, int k, int m,
                    long long n4, int T, void* stream) {
  return run_prec_tf32<PrecTf32>(x, bp, out, k, m, n4, T, stream);
}

}  // extern "C"
