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
//                       (:76)
//   sweep_bf16_4dot     replaces experiments/kernel_r4.py _kernel_bf16_4dot
//                       (:52) with dtype bfloat16
//   sweep_f32_4dot      replaces experiments/kernel_r4.py _kernel_bf16_4dot
//                       (:52) with dtype float32
//   sweep_bf16_blockdiag  replaces experiments/kernel_r4.py
//                       _kernel_bf16_blockdiag (:100)
//   sweep_prec_f32      replaces experiments/kernel_r4.py _kernel_prec (:315)
//                       at precision HIGHEST
//   sweep_prec_tf32x3   the same at precision HIGH
//   sweep_prec_tf32     the same at precision DEFAULT
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

#include "gf_w8_tables.cuh"
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
// sweep_int8_4dot, sweep_bf16_4dot, sweep_f32_4dot: one tensor-core product
// per byte position
// ---------------------------------------------------------------------------
//
// For each byte position b < 4: planes[s*k + j] = (x[j] >> (8b + s)) & 1,
// [8k, n4]; acc = Bp @ planes, with Bp the shift-major 0/1 bitmatrix
// [8m, 8k]; bit l of byte b of output row i is acc[8i + l] & 1.  Every sum
// is at most 8k, exact in int32 and in float32.  The three entry points
// differ only in the operand type of the product:
//
//   sweep_int8_4dot  kernel_r4._kernel_int8_4dot (:76): int8 operands,
//                    mma m16n8k32 .s8.s8.s32, int32 accumulators
//   sweep_bf16_4dot  kernel_r4._kernel_bf16_4dot (:52) with bf16: mma
//                    m16n8k16 .f32.bf16.bf16.f32 (1.0 is 0x3F80)
//   sweep_f32_4dot   kernel_r4._kernel_bf16_4dot (:52) with float32: mma
//                    m16n8k8 .f32.tf32.tf32.f32, the tensor-core path that
//                    takes 32-bit float operands (1.0 is 0x3F800000; 0, 1
//                    and sums <= 8k are exact in TF32 and float32)
//
// Bound on the card: the product's 2 * 4 * 8m * 8k * n4 operations at the
// type's dense rate (1,979 TOP/s int8, 989 TFLOP/s bf16, 495 TFLOP/s
// TF32) or the (k + m) * n4 * 4 bytes at 3.35 TB/s, whichever is longer:
// bytes for int8, operations for bf16 and TF32 at k=8 m=4.  Besides the
// products, what costs is the integer work around them -- making the
// planes and packing the parity -- so the design keeps all of it in
// registers, with no shared memory and no block barrier:
//
// - Products: mma.sync with A = Bp (16 bit-rows, i.e. two output rows, by
//   one K-step of plane rows) and B = planes (one K-step by 8 lanes of one
//   byte position).  In each of the three shapes a thread (g, t) =
//   (lane / 4, lane % 4) holds in B register i, and in A registers 2i and
//   2i + 1 (bit-rows g and g + 8), E = P/2 K-indices of the step, one in
//   each element (E = 4 int8, 2 bf16 or 1 TF32 element a register):
//     m16n8k32 (P = 8): K 4t + e (i = 0) and 4t + 16 + e (i = 1), e < 4
//     m16n8k16 (P = 4): K 2t + e (i = 0) and 2t + 8 + e (i = 1), e < 2
//     m16n8k8  (P = 2): K t (i = 0) and t + 4 (i = 1)
//   The K-steps are ordered so that these are bit planes of one input row:
//   K-step ks = H*jq + h (H = 8/P steps cover the 8 planes of 4 rows)
//   gives element e of register i the plane (s, j) = (P*h + E*i + e,
//   t + 4jq).  So a thread builds its B fragment from one 32-bit lane of
//   x[j]: a shift and a mask select E bits, which are spread to the E
//   elements and multiplied by the type's 1.0.  Bp's fragments are loaded
//   once, in the same order, and stay in registers: 4 ceil(m/2) ceil(k/4)
//   8/P of them, at most 64 (the limits below).
// - Parity: the accumulator layout is the same in the three shapes
//   (registers 2h + p: row g + 8h, column 2t + p).  A ballot of the parity
//   of each accumulator register -- bit 0 of an int32, of the float's
//   mantissa after adding 2^23 -- gives, for 8 bit-rows by 4 columns, the
//   parity bits of the whole warp; each thread gathers the 8 bits of one
//   output byte of its own (row, lane) from it.
//
// A warp takes 32 lanes (four groups of 8) at a time and walks its lanes;
// the grid is as many blocks as fit on the card.  Templates on ceil(k/4)
// and the 16-row tiles of Bp (ceil(m/2)) keep every fragment index
// constant.  At k=8 m=4 a byte position of an 8-lane group takes 4 mma
// (int8), 8 (bf16) or 16 (TF32).  wgmma is a later step.

constexpr int kDotThreads = 128;
constexpr int kDotGroups = 4;                  // 8-lane groups a warp takes
constexpr int kDotWarpLanes = 8 * kDotGroups;  // lanes a warp takes at once

// bits 0..3 of nib to bit 0 of bytes 0..3 (the partial products of the
// multiply land on distinct bits, so nothing carries)
__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

// bits t, t + 4, ..., t + 28 of mask to bits 0..7
__device__ __forceinline__ uint32_t gather8(uint32_t mask, int t) {
  uint32_t v = (mask >> t) & 0x11111111u;
  v = (v | (v >> 3)) & 0x03030303u;
  v = (v | (v >> 6)) & 0x000F000Fu;
  return (v | (v >> 12)) & 0xFFu;
}

// parity of a float accumulator holding an integer below 2^23: adding 2^23
// puts the integer's bit 0 in the mantissa's bit 0, exactly
__device__ __forceinline__ uint32_t float_parity(float acc) {
  return __float_as_uint(acc + 8388608.0f) & 1u;
}

// Operand types.  P: bit planes of one input row in a K-step; Bits: a
// table element, copied as raw bits into the A fragments; kMaxJQ, kMaxMS:
// the widest ceil(k/4) and ceil(m/2) whose A fragments stay in registers.
struct Int8Op {
  static constexpr int P = 8, kMaxJQ = 4, kMaxMS = 4;  // k <= 16, m <= 8
  using Bits = uint8_t;
  using Acc = int;
  __device__ static uint32_t frag(uint32_t bits) { return spread4(bits); }
  __device__ static uint32_t parity(int acc) { return acc & 1; }
  __device__ static void mma(int (&d)[4], const uint32_t (&a)[4],
                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

struct Bf16Op {
  static constexpr int P = 4, kMaxJQ = 4, kMaxMS = 2;  // k <= 16, m <= 4
  using Bits = uint16_t;
  using Acc = float;
  // bits 0 and 1 to bf16 0.0 or 1.0 in the low and high half
  __device__ static uint32_t frag(uint32_t bits) {
    return ((bits & 1u) | ((bits & 2u) << 15)) * 0x3F80u;
  }
  __device__ static uint32_t parity(float acc) { return float_parity(acc); }
  __device__ static void mma(float (&d)[4], const uint32_t (&a)[4],
                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

struct Tf32Op {
  static constexpr int P = 2, kMaxJQ = 2, kMaxMS = 2;  // k <= 8, m <= 4
  using Bits = uint32_t;
  using Acc = float;
  __device__ static uint32_t frag(uint32_t bits) { return bits * 0x3F800000u; }
  __device__ static uint32_t parity(float acc) { return float_parity(acc); }
  __device__ static void mma(float (&d)[4], const uint32_t (&a)[4],
                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// Bp's A fragments, loaded once and kept in registers for a whole walk:
// register r of tile (mt, ks = H*jq + h) holds Bp row 16mt + g + 8(r & 1),
// plane rows (s, j) = (P*h + E*(r >> 1) + e, t + 4jq) in element e; zero
// past the 8m rows or the k inputs
template <class Op, int JQ, int MS>
__device__ __forceinline__ void load_a_frags(
    const typename Op::Bits* __restrict__ bp, int k, int m,
    uint32_t (&a)[MS][JQ * (8 / Op::P)][4]) {
  constexpr int P = Op::P, H = 8 / P, KS = JQ * H;
  constexpr int E = P / 2, EB = 32 / E;  // elements a register, their bits
  const int lane_id = threadIdx.x % 32;
  const int g = lane_id / 4, t = lane_id % 4;
  const int rows = 8 * m, depth = 8 * k;
#pragma unroll
  for (int mt = 0; mt < MS; ++mt)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 16 * mt + g + 8 * (r & 1), j = t + 4 * (ks / H);
        uint32_t word = 0u;
        if (row < rows && j < k) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int s = P * (ks % H) + E * (r >> 1) + e;
            word |= static_cast<uint32_t>(bp[row * depth + s * k + j])
                    << (EB * e);
          }
        }
        a[mt][ks][r] = word;
      }
}

// x[t + 4jq] of lanes lane0 + 8c + g, c < kDotGroups: column g of each
// 8-lane group's B fragments (0 past n4 or k)
template <int JQ>
__device__ __forceinline__ void load_b_lanes(
    const uint32_t* __restrict__ x, int k, long long n4, long long lane0,
    uint32_t (&v)[kDotGroups][JQ]) {
  const int lane_id = threadIdx.x % 32;
  const int g = lane_id / 4, t = lane_id % 4;
#pragma unroll
  for (int c = 0; c < kDotGroups; ++c)
#pragma unroll
    for (int jq = 0; jq < JQ; ++jq) {
      const long long lane = lane0 + 8 * c + g;
      const int j = t + 4 * jq;
      v[c][jq] = lane < n4 && j < k
                     ? __ldg(x + static_cast<long long>(j) * n4 + lane)
                     : 0u;
    }
}

template <class Op, int JQ, int MS>
__global__ void __launch_bounds__(kDotThreads)
sweep_4dot_kernel(const uint32_t* __restrict__ x,
                  const typename Op::Bits* __restrict__ bp,
                  uint32_t* __restrict__ out, int k, int m, long long n4) {
  constexpr int P = Op::P, H = 8 / P, KS = JQ * H;
  constexpr int E = P / 2;  // elements a register
  // output rows a thread packs: (lane / 8) + 4q for q < Q
  constexpr int Q = (MS + 1) / 2;
  const int lane_id = threadIdx.x % 32;

  uint32_t a[MS][KS][4];
  load_a_frags<Op, JQ, MS>(bp, k, m, a);

  const int my_n = lane_id % 8;  // lane within an 8-lane group
  const int my_t = my_n / 2, my_p = my_n % 2;
  const long long warps =
      static_cast<long long>(gridDim.x) * (blockDim.x / 32);
  const long long spans = (n4 + kDotWarpLanes - 1) / kDotWarpLanes;
  for (long long span = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
       span < spans; span += warps) {
    const long long lane0 = span * kDotWarpLanes;
    uint32_t v[kDotGroups][JQ];
    load_b_lanes<JQ>(x, k, n4, lane0, v);
#pragma unroll
    for (int c = 0; c < kDotGroups; ++c) {
      uint32_t word[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) word[q] = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        uint32_t bf[KS][2];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const uint32_t bits = v[c][ks / H] >> (8 * b + P * (ks % H));
          bf[ks][0] = Op::frag(bits & ((1u << E) - 1u));
          bf[ks][1] = Op::frag((bits >> E) & ((1u << E) - 1u));
        }
        uint32_t mine[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) mine[q] = 0u;
#pragma unroll
        for (int mt = 0; mt < MS; ++mt) {
          typename Op::Acc acc[4] = {};
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            Op::mma(acc, a[mt][ks], bf[ks][0], bf[ks][1]);
          // bit 4g' + t' of bal[2h + p]: parity of bit-row 16mt + 8h + g'
          // (bit g' of output row 2mt + h), column 2t' + p
          uint32_t bal[4];
#pragma unroll
          for (int ci = 0; ci < 4; ++ci)
            bal[ci] = __ballot_sync(0xffffffffu, Op::parity(acc[ci]));
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int i = lane_id / 8 + 4 * q;
            if (i / 2 == mt) {
              const uint32_t lo = my_p ? bal[1] : bal[0];
              const uint32_t hi = my_p ? bal[3] : bal[2];
              mine[q] = (i % 2) ? hi : lo;
            }
          }
        }
#pragma unroll
        for (int q = 0; q < Q; ++q) word[q] |= gather8(mine[q], my_t) << (8 * b);
      }
      const long long lane = lane0 + 8 * c + my_n;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int i = lane_id / 8 + 4 * q;
        if (i < m && lane < n4)
          out[static_cast<long long>(i) * n4 + lane] = word[q];
      }
    }
  }
}

// blocks for a kernel whose warps each take kDotWarpLanes lanes at a time
template <typename Kernel>
int dot_blocks(Kernel kernel, size_t smem, long long n4, int* blocks) {
  const long long spans = (n4 + kDotWarpLanes - 1) / kDotWarpLanes;
  const long long items = (spans + kDotThreads / 32 - 1) / (kDotThreads / 32);
  return resident_blocks(kernel, kDotThreads, smem, items, blocks);
}

template <class Op, int JQ, int MS>
int launch_4dot(const void* x, const void* bp, void* out, int k, int m,
                long long n4, cudaStream_t s) {
  int blocks = 0;
  const int rc = dot_blocks(sweep_4dot_kernel<Op, JQ, MS>, 0, n4, &blocks);
  if (rc != 0) return rc;
  sweep_4dot_kernel<Op, JQ, MS><<<blocks, kDotThreads, 0, s>>>(
      static_cast<const uint32_t*>(x),
      static_cast<const typename Op::Bits*>(bp), static_cast<uint32_t*>(out),
      k, m, n4);
  return static_cast<int>(cudaGetLastError());
}

// the instance for ceil(m/2) = ms, counted up from MS
template <class Op, int JQ, int MS = 1>
int dispatch_ms(int ms, const void* x, const void* bp, void* out, int k,
                int m, long long n4, cudaStream_t s) {
  if (ms == MS) return launch_4dot<Op, JQ, MS>(x, bp, out, k, m, n4, s);
  if constexpr (MS < Op::kMaxMS)
    return dispatch_ms<Op, JQ, MS + 1>(ms, x, bp, out, k, m, n4, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the instance for ceil(k/4) and ceil(m/2), or an error beyond Op's limits
template <class Op, int JQ = 1>
int dispatch_4dot(const void* x, const void* bp, void* out, int k, int m,
                  long long n4, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((k + 3) / 4 == JQ && m >= 1)
    return dispatch_ms<Op, JQ>((m + 1) / 2, x, bp, out, k, m, n4, s);
  if constexpr (JQ < Op::kMaxJQ)
    return dispatch_4dot<Op, JQ + 1>(x, bp, out, k, m, n4, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// sweep_bf16_blockdiag: one dense bf16 product over all four byte positions
// ---------------------------------------------------------------------------
//
// Replaces kernel_r4._kernel_bf16_blockdiag (:100).  planes[b*8k + s*k + j]
// = (x[j] >> (8b + s)) & 1, all 32k plane rows at once; acc = Bblk @
// planes, with Bblk [32m, 32k] block-diagonal: block b (rows b*8m.., columns
// b*8k..) is the shift-major Bp, the rest zero; bit l of byte b of output
// row i is acc[b*8m + 8i + l] & 1.
//
// The product is dense, zero blocks included: that one [32m, 32k] product
// is the formulation this row prices (on the TPU it fills the 128-row
// matrix unit).  Skipping the zero blocks would make it sweep_bf16_4dot
// again.  So it does 4x the operations the function needs: at k=8 m=4, 8
// m-tiles by 16 K-steps = 128 mma m16n8k16 per 8-lane group, against 32
// for sweep_bf16_4dot.  Bound on the card: the function's operations,
// 2 * 4 * 8m * 8k * n4 at 989 TFLOP/s (bf16), over its bytes at k=8 m=4;
// the dense product's own operations take 4x that.
//
// Design: sweep_bf16_4dot's B fragments, ballots and walk, with Bblk in
// shared memory instead of registers (64 KiB at k=8 m=4, 128 x 256 bf16,
// far more than a thread's registers).  Each block stages the table once,
// with its columns permuted into the kernel's K order: K-step ks = 8jq +
// 2b + h holds planes (b, s = 4h + 2i + e, j = t + 4jq) at the m16n8k16
// B positions of thread t (i, e as in sweep_bf16_4dot), zero where j >= k.
// Rows are padded by 16 bytes, so the 8 rows an ldmatrix reads fall in
// distinct banks.  One barrier, then each warp walks its 32-lane spans: for
// each group of 4 input rows it loads one lane a row per group, and for
// each of the 8 K-steps of those rows builds the 4 groups' B fragments
// and runs every m-tile on them, A fragments from one ldmatrix.x4 each,
// shared by the 4 groups.  All 2m m-tiles' accumulators of the 4 groups
// stay in registers (32m floats a thread: m <= 4), and the parity is
// packed by ballots as in sweep_bf16_4dot.  Shared memory: 32m rows of
// 128 ceil(k/4) + 8 bf16, opted in above 48 KiB; the wrapper refuses a
// table over the card's 227 KiB.  wgmma (64-row tiles, A from shared
// memory) fits this shape and is a later step.

// the staged table's row pitch in bf16 elements: 16 K-steps of 16 per
// group of 4 input rows, and 8 elements (16 bytes) of padding
__host__ __device__ constexpr int blockdiag_pitch(int k) {
  return 128 * ((k + 3) / 4) + 8;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4],
                                            const uint16_t* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

template <int M>
__global__ void __launch_bounds__(kDotThreads)
sweep_blockdiag_kernel(const uint32_t* __restrict__ x,
                       const uint16_t* __restrict__ bblk,
                       uint32_t* __restrict__ out, int k, long long n4) {
  constexpr int MT = 2 * M;  // 16-row m-tiles of the 32M table rows
  extern __shared__ __align__(16) uint16_t blk_smem[];
  const int pitch = blockdiag_pitch(k);
  const int kcols = pitch - 8, depth = 32 * k;
  // staged column 16ks + kappa holds the plane at K-index kappa of step
  // ks: thread t = (kappa % 8) / 2, register i = kappa / 8, element
  // e = kappa % 2
  for (int idx = threadIdx.x; idx < 32 * M * kcols; idx += blockDim.x) {
    const int row = idx / kcols, col = idx % kcols;
    const int ks = col / 16, kappa = col % 16;
    const int jq = ks / 8, b = (ks % 8) / 2, h = ks % 2;
    const int s = 4 * h + 2 * (kappa / 8) + kappa % 2;
    const int j = (kappa % 8) / 2 + 4 * jq;
    blk_smem[row * pitch + col] =
        j < k ? bblk[row * depth + b * 8 * k + s * k + j] : uint16_t{0};
  }
  __syncthreads();

  const int lane_id = threadIdx.x % 32;
  const int g = lane_id / 4, t = lane_id % 4;
  const int my_n = lane_id % 8, my_t = my_n / 2, my_p = my_n % 2;
  // the row of the 8x8 matrix this thread addresses for ldmatrix.x4:
  // matrices 0..3 are (rows +0, cols +0), (+8, +0), (+0, +8), (+8, +8)
  const uint16_t* a_base = blk_smem +
                           (lane_id % 8 + 8 * ((lane_id / 8) % 2)) * pitch +
                           8 * (lane_id / 16);
  const long long warps =
      static_cast<long long>(gridDim.x) * (blockDim.x / 32);
  const long long spans = (n4 + kDotWarpLanes - 1) / kDotWarpLanes;
  for (long long span = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
       span < spans; span += warps) {
    const long long lane0 = span * kDotWarpLanes;
    float acc[MT][kDotGroups][4] = {};
    for (int jq = 0; jq < (k + 3) / 4; ++jq) {
      const int j = t + 4 * jq;
      uint32_t v[kDotGroups];
#pragma unroll
      for (int c = 0; c < kDotGroups; ++c) {
        const long long lane = lane0 + 8 * c + g;
        v[c] = lane < n4 && j < k
                   ? __ldg(x + static_cast<long long>(j) * n4 + lane)
                   : 0u;
      }
#pragma unroll
      for (int bh = 0; bh < 8; ++bh) {  // byte position bh / 2, half bh % 2
        uint32_t bf[kDotGroups][2];
#pragma unroll
        for (int c = 0; c < kDotGroups; ++c) {
          const uint32_t bits = v[c] >> (4 * bh);
          bf[c][0] = Bf16Op::frag(bits & 3u);
          bf[c][1] = Bf16Op::frag((bits >> 2) & 3u);
        }
        const uint16_t* a_col = a_base + 16 * (8 * jq + bh);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          ldmatrix_x4(a, a_col + 16 * mt * pitch);
#pragma unroll
          for (int c = 0; c < kDotGroups; ++c)
            Bf16Op::mma(acc[mt][c], a, bf[c][0], bf[c][1]);
        }
      }
    }
    // bit-rows 16mt + 8h + g' form octet o = 2mt + h: byte o / M of
    // output row o % M.  A thread packs output row lane / 8 (< 4).
    const int i = lane_id / 8;
#pragma unroll
    for (int c = 0; c < kDotGroups; ++c) {
      uint32_t word = 0u;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t bal[4];
#pragma unroll
        for (int ci = 0; ci < 4; ++ci)
          bal[ci] = __ballot_sync(0xffffffffu, float_parity(acc[mt][c][ci]));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = 2 * mt + h;
          if (o % M == i)
            word |= gather8(my_p ? bal[2 * h + 1] : bal[2 * h], my_t)
                    << (8 * (o / M));
        }
      }
      const long long lane = lane0 + 8 * c + my_n;
      if (i < M && lane < n4) out[static_cast<long long>(i) * n4 + lane] = word;
    }
  }
}

size_t blockdiag_smem(int k, int m) {
  return static_cast<size_t>(32 * m) * blockdiag_pitch(k) * sizeof(uint16_t);
}

template <int M>
int launch_blockdiag(const void* x, const void* bblk, void* out, int k,
                     long long n4, cudaStream_t s) {
  const size_t smem = blockdiag_smem(k, M);
  int rc = allow_smem(sweep_blockdiag_kernel<M>, smem);
  if (rc != 0) return rc;
  int blocks = 0;
  rc = dot_blocks(sweep_blockdiag_kernel<M>, smem, n4, &blocks);
  if (rc != 0) return rc;
  sweep_blockdiag_kernel<M><<<blocks, kDotThreads, smem, s>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint16_t*>(bblk),
      static_cast<uint32_t*>(out), k, n4);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// sweep_prec_f32, sweep_prec_tf32x3, sweep_prec_tf32: the production
// product's field sums at three precisions (the sweep's precision stage)
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
//   HIGH           sweep_prec_tf32x3  split TF32 on mma.sync         yes
//   DEFAULT        sweep_prec_tf32    one TF32 pass on mma.sync      no
//
// sweep_prec_tf32 rounds each plane with cvt.rna.tf32.f32: 65537 = 0x10001
// needs 17 significant bits, TF32 keeps 11, so it becomes 65536 and bytes 0
// and 1 lose the count of that plane -- as the TPU's one bf16 pass at
// DEFAULT does, which is why the JAX tool expects that row to MISMATCH.
// sweep_prec_tf32x3 splits each plane b into b_big = cvt.rna(b) and b_small
// = cvt.rna(b - b_big) and accumulates Bp * b_big + Bp * b_small in float32:
// exact.  3xTF32's third pass, Bp_small * b_big, multiplies zeros here --
// Bp is 0 or 1, exact in TF32 -- so the kernel skips it; the wrapper checks
// on the host that the table holds only 0 and 1.
//
// The tile: the JAX BlockSpec width (4096 or 16384 lanes) is here the lanes
// a block takes per step of its walk over a persistent grid (tiles i, i +
// gridDim.x, ...), so both tiles run on as many blocks as fit on the card;
// at 16384 and 2097152 lanes only 128 tiles exist, and 128 blocks work.
//
// Bound on the card: the function's 2 * 2 * 8m * 8k * n4 operations (two
// products, a multiply-add counted twice) at the float32 rate of the CUDA
// cores (67 TFLOP/s) for sweep_prec_f32, at the TF32 tensor-core rate (495
// TFLOP/s) for the other two, or the (k + m) * n4 * 4 bytes at 3.35 TB/s,
// whichever is longer: operations at k=8 m=4 for sweep_prec_f32 (0.2564
// ms), operations for the TF32 kernels (0.0347 ms, bytes 0.0300).
//
// sweep_prec_f32 design: one thread per lane.  Bp sits in shared memory
// transposed, [8k][8m] (row j*8 + s holds column s*k + j), so for input row
// j and plane s the 8m coefficients are consecutive and every warp reads
// them as broadcast 16-byte loads: one LDS.128 feeds 8 FFMA (4 rows, lo and
// hi).  The thread keeps 16m float accumulators (8m each for accL and
// accH), walks the k input rows with one coalesced 4-byte load each, and
// turns each field into a float with an OR of 2^23's exponent and one FADD
// (no I2F).  Shared memory: the widest table, 16 * 8 * 8m floats (32 KiB
// at m = 8), static.
//
// sweep_prec_tf32x3 and sweep_prec_tf32 design: sweep_f32_4dot's (Tf32Op
// m16n8k8, Bp's fragments in registers, one input lane a thread builds its
// B fragments from), with two products in place of four: K-step (jq, h)
// takes planes s = 2h and 2h + 1 of rows j = t + 4jq from bits 8*half + 2h
// of the lane.  The epilogue differs: each accumulator carries four parity
// bits (bit 8b of z), not one, so a ballot per register would take four
// ballots and four 8-bit gathers.  Instead each thread converts its
// accumulators (F2I), forms z & 0x01010101 at its own bit-row g (shifted
// left by g), and three xor-shuffles across the 8 threads of equal t OR the
// eight bit-rows of an output row together: the finished word, 3 shuffles
// and 3 ORs a register.  Thread g < 4 of each quad column stores register
// g's word (row 2mt + g/2, lane 2t + g%2).
//
// sweep_planes_f32 replaces experiments/kernel_r4_probe.py _mxu_kernel
// (:54): sweep_prec_f32's product and epilogue at HIGHEST over planes
// extracted beforehand, float32 [2, 8k, n4] (lo rows s*k + j, then hi).
// It is sweep_prec_f32's kernel with another source of planes (FromPlanes
// in place of FromLanes): each plane value is one 4-byte load, and a warp's
// load is one whole 128-byte line.  Bound: bytes, the planes are 64 times
// the payload: (16k + m) * n4 * 4 bytes, 0.3305 ms at k=8 m=4 and 2097152
// lanes, above the FFMA bound of 0.2564.  A thread keeps one lane: four
// lanes a thread (16-byte loads) would need 4 x 16m accumulators.

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// precision policies: a plane value -> the B operand of each mma pass
struct PrecTf32 {  // DEFAULT: one pass, the plane rounded to TF32
  static constexpr int kPasses = 1;
  __device__ static void split(float v, uint32_t (&b)[kPasses]) {
    b[0] = tf32_rna(v);
  }
};

struct PrecTf32x3 {  // HIGH: b_big, then b_small (Bp_small is zero)
  static constexpr int kPasses = 2;
  __device__ static void split(float v, uint32_t (&b)[kPasses]) {
    b[0] = tf32_rna(v);
    b[1] = tf32_rna(v - __uint_as_float(b[0]));
  }
};

// where sweep_prec_f32_kernel takes plane s of input row j: extracted from
// the lanes (sweep_prec_f32) or loaded as floats (sweep_planes_f32)
struct FromLanes {
  const uint32_t* x;  // [k, n4] lanes
  using Row = uint32_t;
  __device__ __forceinline__ Row row(int j, long long n4,
                                     long long lane) const {
    return __ldg(x + static_cast<long long>(j) * n4 + lane);
  }
  __device__ __forceinline__ float lo(Row v, int s) const {
    return field_float((v >> s) & 0x00010001u);
  }
  __device__ __forceinline__ float hi(Row v, int s) const {
    return field_float((v >> (8 + s)) & 0x00010001u);
  }
};

struct FromPlanes {
  const float* p;  // [2, 8k, n4]: lo rows s*k + j, then hi rows
  long long step;  // k * n4: plane s to plane s + 1 of one input row
  using Row = const float*;
  __device__ __forceinline__ Row row(int j, long long n4,
                                     long long lane) const {
    return p + static_cast<long long>(j) * n4 + lane;
  }
  __device__ __forceinline__ float lo(Row r, int s) const {
    return __ldg(r + s * step);
  }
  __device__ __forceinline__ float hi(Row r, int s) const {
    return __ldg(r + (8 + s) * step);
  }
};

template <int M, class Src>
__global__ void __launch_bounds__(kThreads)
sweep_prec_f32_kernel(const Src src, const float* __restrict__ bp,
                      uint32_t* __restrict__ out, int k, long long n4,
                      int T) {
  constexpr int R = 8 * M;  // bit-rows
  __shared__ __align__(16) float sbp[16 * 8 * R];
  stage_bp_t(bp, k, R, sbp);
  __syncthreads();

  const long long ntiles = (n4 + T - 1) / T;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long end = (tile + 1) * T < n4 ? (tile + 1) * T : n4;
    for (long long lane = tile * T + threadIdx.x; lane < end;
         lane += blockDim.x) {
      float accL[R], accH[R];
#pragma unroll
      for (int r = 0; r < R; ++r) accL[r] = accH[r] = 0.0f;
      for (int j = 0; j < k; ++j) {
        const typename Src::Row v = src.row(j, n4, lane);
        const float4* col = reinterpret_cast<const float4*>(sbp + j * 8 * R);
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const float lo = src.lo(v, s);
          const float hi = src.hi(v, s);
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

template <int M, class Src>
int launch_prec_f32(const Src& src, const void* bp, void* out, int k,
                    long long n4, int T, cudaStream_t s) {
  const long long ntiles = (n4 + T - 1) / T;
  int blocks = 0;
  const int rc = resident_blocks(sweep_prec_f32_kernel<M, Src>, kThreads, 0,
                                 ntiles, &blocks);
  if (rc != 0) return rc;
  sweep_prec_f32_kernel<M, Src><<<blocks, kThreads, 0, s>>>(
      src, static_cast<const float*>(bp), static_cast<uint32_t*>(out), k, n4,
      T);
  return static_cast<int>(cudaGetLastError());
}

// k <= 16, m <= 8, T a positive multiple of 32
template <class Src>
int run_prec_f32(const Src& src, const void* bp, void* out, int k, int m,
                 long long n4, int T, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0 || T % 32 != 0 || k < 1 || k > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (m) {
    case 1: return launch_prec_f32<1>(src, bp, out, k, n4, T, s);
    case 2: return launch_prec_f32<2>(src, bp, out, k, n4, T, s);
    case 3: return launch_prec_f32<3>(src, bp, out, k, n4, T, s);
    case 4: return launch_prec_f32<4>(src, bp, out, k, n4, T, s);
    case 5: return launch_prec_f32<5>(src, bp, out, k, n4, T, s);
    case 6: return launch_prec_f32<6>(src, bp, out, k, n4, T, s);
    case 7: return launch_prec_f32<7>(src, bp, out, k, n4, T, s);
    case 8: return launch_prec_f32<8>(src, bp, out, k, n4, T, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class Prec, int JQ, int MS>
__global__ void __launch_bounds__(kDotThreads)
sweep_prec_tf32_kernel(const uint32_t* __restrict__ x,
                       const uint32_t* __restrict__ bp,
                       uint32_t* __restrict__ out, int k, int m,
                       long long n4, int T) {
  using Op = Tf32Op;
  constexpr int H = 8 / Op::P, KS = JQ * H;
  const int lane_id = threadIdx.x % 32;
  const int g = lane_id / 4, t = lane_id % 4;

  uint32_t a[MS][KS][4];
  load_a_frags<Op, JQ, MS>(bp, k, m, a);

  const long long ntiles = (n4 + T - 1) / T;
  const int spans = T / kDotWarpLanes, warps = blockDim.x / 32;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    for (int sp = threadIdx.x / 32; sp < spans; sp += warps) {
      const long long lane0 =
          tile * T + static_cast<long long>(sp) * kDotWarpLanes;
      if (lane0 >= n4) break;
      uint32_t v[kDotGroups][JQ];
      load_b_lanes<JQ>(x, k, n4, lane0, v);
#pragma unroll
      for (int c = 0; c < kDotGroups; ++c) {
        float acc[2][MS][4] = {};
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            const uint32_t bits = v[c][ks / H] >> (8 * half + 2 * (ks % H));
            uint32_t b0[Prec::kPasses], b1[Prec::kPasses];
            Prec::split(field_float(bits & 0x00010001u), b0);
            Prec::split(field_float((bits >> 1) & 0x00010001u), b1);
#pragma unroll
            for (int pass = 0; pass < Prec::kPasses; ++pass)
#pragma unroll
              for (int mt = 0; mt < MS; ++mt)
                Op::mma(acc[half][mt], a[mt][ks], b0[pass], b1[pass]);
          }
#pragma unroll
        for (int mt = 0; mt < MS; ++mt) {
          // word[2h + p]: output row 2mt + h, lane 2t + p of group c
          uint32_t word[4];
#pragma unroll
          for (int ci = 0; ci < 4; ++ci) {
            const uint32_t z = __float2uint_rn(acc[0][mt][ci]) +
                               (__float2uint_rn(acc[1][mt][ci]) << 8);
            uint32_t w = (z & 0x01010101u) << g;
            w |= __shfl_xor_sync(0xffffffffu, w, 4);
            w |= __shfl_xor_sync(0xffffffffu, w, 8);
            w |= __shfl_xor_sync(0xffffffffu, w, 16);
            word[ci] = w;
          }
          if (g < 4) {
            const int row = 2 * mt + g / 2;
            const long long lane = lane0 + 8 * c + 2 * t + g % 2;
            const uint32_t mine = g == 0   ? word[0]
                                  : g == 1 ? word[1]
                                  : g == 2 ? word[2]
                                           : word[3];
            if (row < m && lane < n4)
              out[static_cast<long long>(row) * n4 + lane] = mine;
          }
        }
      }
    }
  }
}

template <class Prec, int JQ, int MS>
int launch_prec_tf32(const void* x, const void* bp, void* out, int k, int m,
                     long long n4, int T, cudaStream_t s) {
  const long long ntiles = (n4 + T - 1) / T;
  int blocks = 0;
  const int rc = resident_blocks(sweep_prec_tf32_kernel<Prec, JQ, MS>,
                                 kDotThreads, 0, ntiles, &blocks);
  if (rc != 0) return rc;
  sweep_prec_tf32_kernel<Prec, JQ, MS><<<blocks, kDotThreads, 0, s>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(bp),
      static_cast<uint32_t*>(out), k, m, n4, T);
  return static_cast<int>(cudaGetLastError());
}

// the instance for ceil(k/4) = jq and ceil(m/2) = ms, or an error beyond
// Tf32Op's limits (k <= 8, m <= 4)
template <class Prec, int JQ = 1, int MS = 1>
int dispatch_prec(int jq, int ms, const void* x, const void* bp, void* out,
                  int k, int m, long long n4, int T, cudaStream_t s) {
  if (jq == JQ && ms == MS)
    return launch_prec_tf32<Prec, JQ, MS>(x, bp, out, k, m, n4, T, s);
  if constexpr (MS < Tf32Op::kMaxMS)
    return dispatch_prec<Prec, JQ, MS + 1>(jq, ms, x, bp, out, k, m, n4, T,
                                           s);
  else if constexpr (JQ < Tf32Op::kMaxJQ)
    return dispatch_prec<Prec, JQ + 1, 1>(jq, ms, x, bp, out, k, m, n4, T,
                                          s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class Prec>
int run_prec_tf32(const void* x, const void* bp, void* out, int k, int m,
                  long long n4, int T, void* stream) {
  if (T <= 0 || T % kDotWarpLanes != 0 || k < 1 || m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_prec<Prec>((k + 3) / 4, (m + 1) / 2, x, bp, out, k, m, n4,
                             T, static_cast<cudaStream_t>(stream));
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
// of chunk j), of the product's operand type; out [m, n4]

// int8 bp; k <= 16, m <= 8
int sweep_int8_4dot(const void* x, const void* bp, void* out, int k, int m,
                    long long n4, void* stream) {
  return dispatch_4dot<Int8Op>(x, bp, out, k, m, n4, stream);
}

// bf16 bp; k <= 16, m <= 4
int sweep_bf16_4dot(const void* x, const void* bp, void* out, int k, int m,
                    long long n4, void* stream) {
  return dispatch_4dot<Bf16Op>(x, bp, out, k, m, n4, stream);
}

// float32 bp (used as TF32); k <= 8, m <= 4
int sweep_f32_4dot(const void* x, const void* bp, void* out, int k, int m,
                   long long n4, void* stream) {
  return dispatch_4dot<Tf32Op>(x, bp, out, k, m, n4, stream);
}

// x [k, n4] lanes; bblk [32m, 32k] bf16, block-diagonal (block b is the
// shift-major bp); out [m, n4]; m <= 4, and 32m * (128 ceil(k/4) + 8) * 2
// bytes of staged table within the card's shared memory
int sweep_bf16_blockdiag(const void* x, const void* bblk, void* out, int k,
                         int m, long long n4, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (m) {
    case 1: return launch_blockdiag<1>(x, bblk, out, k, n4, s);
    case 2: return launch_blockdiag<2>(x, bblk, out, k, n4, s);
    case 3: return launch_blockdiag<3>(x, bblk, out, k, n4, s);
    case 4: return launch_blockdiag<4>(x, bblk, out, k, n4, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// x [k, n4] lanes; bp [8m, 8k] float32 0/1, shift-major; out [m, n4]; T
// lanes a block takes per step, a positive multiple of 32

// HIGHEST: FFMA; k <= 16, m <= 8
int sweep_prec_f32(const void* x, const void* bp, void* out, int k, int m,
                   long long n4, int T, void* stream) {
  return run_prec_f32(FromLanes{static_cast<const uint32_t*>(x)}, bp, out, k,
                      m, n4, T, stream);
}

// HIGHEST, FFMA, each tile of T lanes in parts column chunks (parts 2, 4
// or 8; T a positive multiple of 32 * parts); k <= 16, m <= 8
int sweep_split_f32(const void* x, const void* bp, void* out, int k, int m,
                    long long n4, int T, int parts, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!split_shape_ok(k, n4, T, parts))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (m) {
    case 1: return launch_split_f32<1>(x, bp, out, k, n4, T, parts, s);
    case 2: return launch_split_f32<2>(x, bp, out, k, n4, T, parts, s);
    case 3: return launch_split_f32<3>(x, bp, out, k, n4, T, parts, s);
    case 4: return launch_split_f32<4>(x, bp, out, k, n4, T, parts, s);
    case 5: return launch_split_f32<5>(x, bp, out, k, n4, T, parts, s);
    case 6: return launch_split_f32<6>(x, bp, out, k, n4, T, parts, s);
    case 7: return launch_split_f32<7>(x, bp, out, k, n4, T, parts, s);
    case 8: return launch_split_f32<8>(x, bp, out, k, n4, T, parts, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// planes [2, 8k, n4] float32 (lo rows s*k + j, then hi rows), as
// sweep_gf.field_planes builds them; bp as above; out [m, n4]; HIGHEST,
// FFMA; k <= 16, m <= 8
int sweep_planes_f32(const void* planes, const void* bp, void* out, int k,
                     int m, long long n4, int T, void* stream) {
  return run_prec_f32(FromPlanes{static_cast<const float*>(planes),
                                 static_cast<long long>(k) * n4},
                      bp, out, k, m, n4, T, stream);
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

// HIGH: split TF32 (Bp must hold only 0 and 1); k <= 8, m <= 4
int sweep_prec_tf32x3(const void* x, const void* bp, void* out, int k,
                      int m, long long n4, int T, void* stream) {
  return run_prec_tf32<PrecTf32x3>(x, bp, out, k, m, n4, T, stream);
}

// DEFAULT: one TF32 pass; k <= 8, m <= 4
int sweep_prec_tf32(const void* x, const void* bp, void* out, int k, int m,
                    long long n4, int T, void* stream) {
  return run_prec_tf32<PrecTf32>(x, bp, out, k, m, n4, T, stream);
}

}  // extern "C"
