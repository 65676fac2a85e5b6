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

namespace {

constexpr int kThreads = 256;
// shared memory a block may take without opting in
constexpr size_t kDefaultSmem = 48 * 1024;

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
// does no arithmetic.  Design: 16-byte loads and stores (VEC = 4), each
// thread keeping kUnroll of them in flight before it stores, grid-stride
// over the lanes; a ragged total or a pointer that is not 16-byte aligned
// takes the 4-byte form.  Its time is what moving this layout costs here.
//
// sweep_extract: out[i] = sum over s < 8 of ((x[i] >> s) & 0x00010001) +
// ((x[i] >> (8 + s)) & 0x00010001), the bit-plane extraction of the
// production TPU kernel without its dots.  Bound: the same bytes as the
// copy; 48 integer operations a lane are far under the card's issue rate.
// Design: the copy's loop with the 16 shift-and-adds on each lane.  The sum
// is taken in uint32: each 16-bit field collects at most 16, so the fields
// never carry into each other and the result equals the TPU's f32 sum.
// Its time against the copy's is what extraction costs on this card.

constexpr int kUnroll = 4;

struct CopyOp {
  __device__ __forceinline__ uint32_t operator()(uint32_t v) const {
    return v;
  }
};

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

// ---------------------------------------------------------------------------
// sweep_pipelined_w8: the w=8 product with double-buffered staging
// ---------------------------------------------------------------------------
//
// Computes what gf2_matrix_w8 (gf_kernels.cu) computes, from the same lane
// masks ([m*8, k] byte masks * 0x01010101): acc_r = XOR_j (x_j & mask_rj),
// and the parity of each byte of acc_r is output bit r % 8 of that byte.
//
// Bound on the card: memory, (k + m) * n4 * 4 bytes.  gf2_matrix_w8 reads
// its inputs with plain loads, so each thread waits on its own loads
// before the and-xor work can start.  Design: a block walks over lane tiles
// of T lanes (tile i, i + gridDim.x, ...).  Each [k, T] input tile is
// staged in shared memory with cp.async copies (16 bytes, or 4 where the
// rows are not 16-byte aligned) in a two-stage ring, so tile i + 1 is in
// flight while tile i is computed from shared memory.  The block's masks
// sit in shared memory for the whole walk (every thread of a warp reads the
// same word, a broadcast).  One thread owns 4 lanes (or 1) of a tile and
// keeps one output byte-row's 8 accumulators in registers.  The grid is as
// many blocks as fit on the card at once.  Shared memory per block:
// (m*8*k + 2*k*T) * 4 bytes, opted in above 48 KiB.  On an H100 it runs
// within a few percent of gf2_matrix_w8: the and-xor and parity work, not
// load latency, limits both.  A warp-specialised TMA producer, and less
// integer work a byte, are the next steps.

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

__device__ __forceinline__ uint32_t byte_parity(uint32_t p) {
  p ^= p >> 4;
  p ^= p >> 2;
  p ^= p >> 1;
  return p & 0x01010101u;
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

template <int VEC>
__global__ void __launch_bounds__(kThreads)
sweep_pipelined_kernel(const uint32_t* __restrict__ x,
                       const uint32_t* __restrict__ masks,
                       uint32_t* __restrict__ out, int k, int m, long long n4,
                       int T, long long ntiles) {
  extern __shared__ __align__(16) uint32_t pipe_smem[];
  const int nmask = m * 8 * k;
  uint32_t* smask = pipe_smem;
  // stages start on a 16-byte boundary
  uint32_t* stages = pipe_smem + ((nmask + 3) & ~3);
  for (int i = threadIdx.x; i < nmask; i += blockDim.x) smask[i] = masks[i];

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
    __syncthreads();  // tile t (and, the first time, the masks) visible

    const uint32_t* tile = stages + st * k * T;
    const long long lane0 = t * T;
    const int width = static_cast<int>(n4 - lane0 < T ? n4 - lane0 : T);
    for (int c = threadIdx.x; c < width / VEC; c += blockDim.x) {
      for (int g = 0; g < m; ++g) {
        const uint32_t* mg = smask + g * 8 * k;
        uint32_t acc[8][VEC];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[r][v] = 0u;
        for (int j = 0; j < k; ++j) {
          uint32_t xv[VEC];
          if constexpr (VEC == 4) {
            const uint4 q = *reinterpret_cast<const uint4*>(tile + j * T +
                                                           c * 4);
            xv[0] = q.x; xv[1] = q.y; xv[2] = q.z; xv[3] = q.w;
          } else {
            xv[0] = tile[j * T + c];
          }
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const uint32_t mk = mg[r * k + j];
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[r][v] ^= xv[v] & mk;
          }
        }
        uint32_t o[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) o[v] = 0u;
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int v = 0; v < VEC; ++v) o[v] |= byte_parity(acc[r][v]) << r;
        uint32_t* dst = out + static_cast<long long>(g) * n4 + lane0 + c * VEC;
        if constexpr (VEC == 4)
          *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
        else
          dst[0] = o[0];
      }
    }
    __syncthreads();  // stage st is refilled two tiles on
  }
}

template <int VEC>
int launch_pipelined(const uint32_t* x, const uint32_t* masks, uint32_t* out,
                     int k, int m, long long n4, int T, cudaStream_t s) {
  const size_t smem =
      (static_cast<size_t>((m * 8 * k + 3) & ~3) + 2ull * k * T) *
      sizeof(uint32_t);
  int rc = allow_smem(sweep_pipelined_kernel<VEC>, smem);
  if (rc != 0) return rc;
  const long long ntiles = (n4 + T - 1) / T;
  int blocks = 0;
  rc = resident_blocks(sweep_pipelined_kernel<VEC>, kThreads, smem, ntiles,
                       &blocks);
  if (rc != 0) return rc;
  sweep_pipelined_kernel<VEC><<<blocks, kThreads, smem, s>>>(
      x, masks, out, k, m, n4, T, ntiles);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// sweep_int8_4dot: the product on the int8 tensor cores
// ---------------------------------------------------------------------------
//
// For each byte position b < 4: planes[s*k + j] = (x[j] >> (8b + s)) & 1 as
// int8 [8k, n4]; acc = Bp @ planes in int32, with Bp the shift-major int8
// 0/1 bitmatrix [8m, 8k]; bit l of byte b of output row i is
// acc[8i + l] & 1.  Every sum is at most 8k, exact in int32.
//
// Bound on the card: memory, (k + m) * n4 * 4 bytes; the product's
// 2 * 4 * 8m * 8k * n4 int8 operations at 1,979 TOP/s take less at k=8 m=4.
// What costs is the integer work around the products -- making the planes
// and packing the parity -- so the design keeps all of it in registers,
// with no shared memory and no block barrier:
//
// - Products: mma.sync m16n8k32 .s8.s8.s32, A = Bp (16 bit-rows, i.e. two
//   output rows, by 32 plane rows), B = planes (32 plane rows by 8 lanes of
//   one byte position).  The 32 plane rows of K-step ks are ordered so
//   that the rows a thread holds in its fragment, 4t + e and 4t + 16 + e
//   (t = lane % 4, e < 4), are planes (s, j) = (e, t + 4ks) and
//   (e + 4, t + 4ks): all of one input row j.  So a thread builds its B
//   fragment from one 32-bit lane of x[j], with a shift, a mask and one
//   multiply that spreads 4 bits to 4 bytes per register.  Bp's fragments
//   are loaded once, in the same order, and stay in registers.
// - Parity: a ballot of bit 0 of each accumulator register gives, for 8
//   bit-rows by 4 columns, the parity bits of the whole warp; each thread
//   gathers the 8 bits of one output byte of its own (row, lane) from it.
//
// A warp takes 32 lanes (four groups of 8) at a time and walks its lanes;
// the grid is as many blocks as fit on the card.  Templates on the K-steps
// (ceil(k/4): k <= 16) and the 16-row tiles of Bp (ceil(m/2): m <= 8)
// keep every fragment index constant.  wgmma is a later step.

constexpr int kI8Threads = 128;
constexpr int kI8Groups = 4;                 // 8-lane groups a warp takes
constexpr int kI8WarpLanes = 8 * kI8Groups;  // lanes a warp takes at once

// d += a * b on the int8 tensor cores (int32 accumulators)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

template <int KS, int MS>
__global__ void __launch_bounds__(kI8Threads)
sweep_int8_kernel(const uint32_t* __restrict__ x,
                  const int8_t* __restrict__ bp, uint32_t* __restrict__ out,
                  int k, int m, long long n4) {
  // output rows a thread packs: (lane / 8) + 4q for q < Q
  constexpr int Q = (MS + 1) / 2;
  const int lane_id = threadIdx.x % 32;
  const int g = lane_id / 4, t = lane_id % 4;
  const int rows = 8 * m, depth = 8 * k;

  // A fragment register r of tile (mt, ks): Bp row 16mt + g + 8(r & 1),
  // plane rows (s, j) = (4(r >> 1) + e, t + 4ks) in byte e
  uint32_t a[MS][KS][4];
#pragma unroll
  for (int mt = 0; mt < MS; ++mt)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 16 * mt + g + 8 * (r & 1), j = t + 4 * ks;
        uint32_t word = 0u;
        if (row < rows && j < k) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            word |= static_cast<uint32_t>(
                        bp[row * depth + (4 * (r >> 1) + e) * k + j] & 1)
                    << (8 * e);
        }
        a[mt][ks][r] = word;
      }

  const int my_n = lane_id % 8;  // lane within an 8-lane group
  const int my_t = my_n / 2, my_p = my_n % 2;
  const long long warps =
      static_cast<long long>(gridDim.x) * (blockDim.x / 32);
  const long long spans = (n4 + kI8WarpLanes - 1) / kI8WarpLanes;
  for (long long span = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
       span < spans; span += warps) {
    const long long lane0 = span * kI8WarpLanes;
    // x[t + 4ks] of lane lane0 + 8c + g: column g of group c's B fragments
    uint32_t v[kI8Groups][KS];
#pragma unroll
    for (int c = 0; c < kI8Groups; ++c)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const long long lane = lane0 + 8 * c + g;
        const int j = t + 4 * ks;
        v[c][ks] = lane < n4 && j < k
                       ? __ldg(x + static_cast<long long>(j) * n4 + lane)
                       : 0u;
      }
#pragma unroll
    for (int c = 0; c < kI8Groups; ++c) {
      uint32_t word[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) word[q] = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        uint32_t bf[KS][2];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const uint32_t byte = v[c][ks] >> (8 * b);
          bf[ks][0] = spread4(byte & 0xFu);
          bf[ks][1] = spread4((byte >> 4) & 0xFu);
        }
        uint32_t mine[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) mine[q] = 0u;
#pragma unroll
        for (int mt = 0; mt < MS; ++mt) {
          int acc[4] = {0, 0, 0, 0};
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            mma_s8(acc, a[mt][ks], bf[ks][0], bf[ks][1]);
          // bit 4g' + t' of bal[2h + p]: parity of bit-row 16mt + 8h + g'
          // (bit g' of output row 2mt + h), column 2t' + p
          uint32_t bal[4];
#pragma unroll
          for (int ci = 0; ci < 4; ++ci)
            bal[ci] = __ballot_sync(0xffffffffu, acc[ci] & 1);
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

template <int KS, int MS>
int launch_int8(const void* x, const void* bp, void* out, int k, int m,
                long long n4, cudaStream_t s) {
  const long long spans = (n4 + kI8WarpLanes - 1) / kI8WarpLanes;
  const long long items = (spans + kI8Threads / 32 - 1) / (kI8Threads / 32);
  int blocks = 0;
  const int rc = resident_blocks(sweep_int8_kernel<KS, MS>, kI8Threads, 0,
                                 items, &blocks);
  if (rc != 0) return rc;
  sweep_int8_kernel<KS, MS><<<blocks, kI8Threads, 0, s>>>(
      static_cast<const uint32_t*>(x), static_cast<const int8_t*>(bp),
      static_cast<uint32_t*>(out), k, m, n4);
  return static_cast<int>(cudaGetLastError());
}

template <int KS>
int launch_int8_tiles(const void* x, const void* bp, void* out, int k, int m,
                      long long n4, cudaStream_t s) {
  switch ((m + 1) / 2) {
    case 1: return launch_int8<KS, 1>(x, bp, out, k, m, n4, s);
    case 2: return launch_int8<KS, 2>(x, bp, out, k, m, n4, s);
    case 3: return launch_int8<KS, 3>(x, bp, out, k, m, n4, s);
    case 4: return launch_int8<KS, 4>(x, bp, out, k, m, n4, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// x [>= m, n4] lanes; out [m, n4] = x[:m]
int sweep_copy(const void* x, void* out, int m, long long n4, void* stream) {
  return launch_rows<CopyOp>(x, out, m, n4, stream);
}

// x [>= m, n4] lanes; out [m, n4], the 16 shifted plane sums of x[:m]
int sweep_extract(const void* x, void* out, int m, long long n4,
                  void* stream) {
  return launch_rows<ExtractOp>(x, out, m, n4, stream);
}

// x [k, n4] lanes; masks [m*8, k] byte masks * 0x01010101; out [m, n4];
// T lanes per stage, a multiple of 4
int sweep_pipelined_w8(const void* x, const void* masks, void* out, int k,
                       int m, long long n4, int T, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const uint32_t*>(x);
  const auto* mi = static_cast<const uint32_t*>(masks);
  auto* oi = static_cast<uint32_t*>(out);
  if (T <= 0 || T % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n4 % 4 == 0 && aligned16(x) && aligned16(out))
    return launch_pipelined<4>(xi, mi, oi, k, m, n4, T, s);
  return launch_pipelined<1>(xi, mi, oi, k, m, n4, T, s);
}

// x [k, n4] lanes; bp [8m, 8k] int8 0/1, shift-major (column s*k + j is bit
// s of chunk j); out [m, n4]; k <= 16, m <= 8
int sweep_int8_4dot(const void* x, const void* bp, void* out, int k, int m,
                    long long n4, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || m > 8) return static_cast<int>(cudaErrorInvalidValue);
  switch ((k + 3) / 4) {
    case 1: return launch_int8_tiles<1>(x, bp, out, k, m, n4, s);
    case 2: return launch_int8_tiles<2>(x, bp, out, k, m, n4, s);
    case 3: return launch_int8_tiles<3>(x, bp, out, k, m, n4, s);
    case 4: return launch_int8_tiles<4>(x, bp, out, k, m, n4, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
