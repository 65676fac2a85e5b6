// GF(2) codec kernels for Hopper (sm_90a): the three products of the
// erasure-code pipeline, over little-endian bytes packed 4 to a 32-bit lane.
//
//   gf2_matrix_w8   replaces ceph_tpu/ops/pallas_gf.py _matrix_kernel (:57)
//   gf2_matrix_w16  replaces ceph_tpu/ops/pallas_gf.py _matrix_kernel_w16 (:153)
//   gf2_packet      replaces ceph_tpu/ops/pallas_gf.py _packet_kernel (:240)
//
// Each computes what the TPU kernel computes -- the same jerasure bitmatrix
// in, the same bytes out -- but not the way the TPU does it (f32 MXU dots on
// 0x00010001 fields).  Each takes its bitmatrix at run time, in a form the
// host prepares once per codec or decode matrix (cuda_gf.prep_*): a decode
// matrix, new with every erasure pattern, needs no build.
//
// gf2_matrix_w8: nibble tables derived from the bitmatrix (gf-complete's
//   SPLIT 8/4, the w=8 sibling of gf2_matrix_w16's).  The 8x8 block B_ij
//   splits over input byte x's two nibbles: B_ij x = T_ij0[x & 15] ^
//   T_ij1[x >> 4] (gf_w8_tables.cuh, which sweep_pipelined_w8 shares).  An
//   entry is 4 bytes: byte r holds output row 4g + r's byte, so one LDS.32
//   gives a nibble's share of 4 output rows.  Operand: uint32
//   [ceil(m/4)][k][2][16] (128 k bytes per output group).  Per lane and
//   input row: the nibbles times 4 as bytes of (x << 2) & 0x3C3C3C3C and
//   (x >> 2) & 0x3C3C3C3C, one PRMT per nibble, 8 lookups XORed into four
//   accumulators (one per byte position) two at a time; after the last row
//   a 4x4 byte transpose (8 PRMTs) gives the 4 output rows' lanes.  At k=8
//   m=4: 64 lookups, about 200-270 integer operations a lane, inputs read
//   once.  Staged as gf2_matrix_w16 (the same kernel template,
//   gf2_tables_kernel): a code whose tables fit one 48 KiB slice (k <= 384
//   at m <= 4, k <= 192 at m <= 8) stages them once per block and reads
//   its inputs once; any k and m run.  ceph_tpu_torch/tools/w8_probe.py
//   splits its time on the card into loads and stores alone and lookups
//   alone, and times other batch, thread and VEC settings: on an H100 the
//   loads and stores alone run at the copy's rate and the lookups hide
//   under them, so memory sets the time (PERF.md).
//
// gf2_packet: a sparse XOR over an input tile staged in shared memory.
//   Operand: the bitmatrix's ones per output row as one int32 array,
//   [off (r + 1) | idx (nnz)]: output row i is the XOR of the input rows
//   idx[off[i] .. off[i+1]).  A row without ones gives a zero row.  The work
//   follows the ones (691 at cauchy_good k=8 m=4 w=8), not the r * c pairs
//   (2048) of a dense mask table.  A list and not warp-uniform row masks:
//   one form for every c (the plugin runs c = 527), and the block copies it
//   into shared memory padded so that each row starts on a 16-byte word,
//   where one LDS.128 gives four indices and the next four are read while
//   the current four rows load.
//   Staging: a block of 512 threads stages a tile of all c input rows x T
//   lanes with cp.async copies (16 bytes, or 4 in the one-lane form), T
//   the widest power of two up to 256 lanes whose c rows fit in 64 KiB
//   (at least 8).  cp.async and not TMA: a TMA box is at most 256 rows,
//   needs a tensor map made on the host (cuTensorMapEncodeTiled), and
//   16-byte-aligned rows, which the one-lane form (ragged or unaligned
//   rows) does not have; cp.async serves both forms with one code path.  A
//   persistent grid walks the tiles through a two-stage ring (one stage
//   where two do not fit), so one tile's XORs overlap the next tile's copy;
//   every input byte is read from device memory once and every output byte
//   written once.
//   Work mapping: a tile row holds Q = T / VEC chunks of VEC lanes; a thread
//   takes two chunks, Q / 2 apart, of each output row of its group (one
//   chunk in the one-lane form).  At c = 64 a group is one warp: 16 groups,
//   so each list read is a warp-uniform broadcast and each LDS.128 of a warp
//   reads 512 consecutive bytes of one tile row, with no bank conflict.
//   The groups are contiguous row ranges cut where the prefix count of ones
//   is nearest to g/G of nnz.  The list sits in shared memory where its
//   largest size fits beside one stage; otherwise it is read through the
//   read-only cache.
//   ceph_tpu_torch/tools/packet_probe.py splits its time on the card into
//   the copies and stores alone and the XORs alone, and times the other
//   ring depths, tile widths and block sizes (PERF.md).
//
// gf2_matrix_w16: nibble tables derived from the bitmatrix (gf-complete's
//   SPLIT 16/4).  The 16x16 block B_ij (output word i, input word j) is a
//   GF(2)-linear map, so it splits over x_j's four nibbles:
//   B_ij x = XOR_p T_ijp[(x >> 4p) & 15], with T_ijp[v] the XOR over the
//   bits s of v of column 16j + 4p + s of rows 16i .. 16i+15.  The tables
//   come from the bitmatrix alone and hold for any bitmatrix.  An entry is
//   8 bytes: the 16-bit words of 4 output rows side by side, so one LDS.64
//   gives a nibble's share of 4 output words.  Operand: uint2
//   [ceil(m/4)][k][4][16] (128 k m bytes when 4 | m).  A 16-entry table
//   spans each of the 32 banks at most once, so a warp's lookups never
//   conflict (equal entries broadcast).  Per lane each input nibble is
//   taken once, as a byte of (x << 3) & 0x78787878 or (x >> 1) & 0x78787878
//   (the nibble times 8, a byte offset) picked with one PRMT, and serves
//   every output group of the pass; one PRMT per output row packs the two
//   16-bit halves.  At k=8 m=4: 64 lookups, about 260 integer operations a
//   lane, inputs read once.  A block keeps GP = 1 output group (m <= 4) or
//   GP = 2 in registers per pass and stages the tables of a slice of up to
//   48 KiB of input rows at a time, so any k and m run; a code whose tables
//   fit in one slice (k <= 96 at m <= 4, k <= 48 at m <= 8) stages them
//   once per block and reads its inputs once.  Both table kernels are one
//   template (gf2_tables_kernel) over the code's entry, lookup and row
//   packing.
//
// Bound on the card: memory.  Each kernel reads each input byte from device
// memory once and writes each output byte once, (rows in + rows out) * 4 *
// n4 bytes at 3.35 TB/s on an H100 SXM.  Shifts are on uint32_t, so bytes
// >= 0x80 need no masking after a shift.
//
// Interface: plain C, loaded with ctypes.  Pointers come from
// tensor.data_ptr(), the stream from torch.cuda.current_stream().cuda_stream.
// Each entry point launches on that stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gf_w8_tables.cuh"

namespace {

constexpr int kThreads = 256;

// shared memory a block may take without opting in, and with it (Hopper)
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// VEC consecutive lanes at p: 16-byte loads and stores where VEC is a
// multiple of 4, 8-byte ones at VEC = 2 (p then aligned to match)
template <int VEC>
__device__ __forceinline__ void load_lanes(const uint32_t* __restrict__ p,
                                           uint32_t (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p + i));
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  } else if constexpr (VEC == 2) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = q.x; v[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __ldg(p + i);
  }
}

template <int VEC>
__device__ __forceinline__ void store_lanes(uint32_t* __restrict__ p,
                                            const uint32_t (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<uint4*>(p + i) =
          make_uint4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = v[i];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Set kernel's shared-memory limit where smem is over the default, then
// read its SMs and resident blocks per SM: the persistent grid is their
// product, capped at the items to walk.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem,
                            long long items, int* blocks) {
  cudaError_t e = cudaSuccess;
  if (smem > kDefaultSmem)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long most = static_cast<long long>(sms) * per_sm;
  *blocks = static_cast<int>(items < most ? items : most);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// gf2_packet: sparse XOR over a shared-memory tile
// ---------------------------------------------------------------------------

// threads of a gf2_packet block; bytes of one stage of its input tile (c
// rows x T lanes), the widest and narrowest T, and the most stages
constexpr int kPacketThreads = 512;
constexpr size_t kStageBytes = 64 * 1024;
constexpr int kMaxTileShift = 8;  // 256 lanes
constexpr int kMinTileShift = 3;  // 8 lanes: two 16-byte chunks a row
constexpr int kMaxStages = 2;
// 16-byte chunks of a tile row per thread (the 16-byte form)
constexpr int kChunks = 2;

template <int VEC>
__device__ __forceinline__ void cp_async_lanes(uint32_t* dst,
                                               const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (0 or 1) of this thread's copy groups are in
// flight
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n == 0) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// First output row of group g of G: the row boundary whose prefix count of
// ones lies nearest to g/G of all of them (group G starts at row R).
__device__ int group_row(const int* off, int R, int g, int G) {
  if (g >= G) return R;
  const long long target = static_cast<long long>(off[R]) * g;
  int lo = 0, hi = R;  // first row i with off[i] * G >= target
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<long long>(off[mid]) * G < target) lo = mid + 1;
    else hi = mid;
  }
  if (lo > 0 && target - static_cast<long long>(off[lo - 1]) * G <
                    static_cast<long long>(off[lo]) * G - target)
    --lo;
  return lo;
}

// Row i's entries in the padded copy of the list in shared memory: from
// word pad_start(off[i], i), a multiple of 4, so one 16-byte read gives
// four indices.  Rows stay apart: pad_start grows by at least len + 1.
__device__ __forceinline__ int pad_start(int off_i, int i) {
  return ((off_i + 3) & ~3) + 4 * i;
}

// Load and XOR n <= 4 tile rows (indices j) into acc: CH chunks of VEC
// lanes, chunk h at st + h * hstride.
template <int VEC, int CH>
__device__ __forceinline__ void xor_rows4(const uint32_t* st, int tile_shift,
                                          int hstride, int4 j, int n,
                                          uint32_t (&acc)[CH][VEC]) {
  const int jj[4] = {j.x, j.y, j.z, j.w};
  uint32_t xv[4][CH][VEC];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int h = 0; h < CH; ++h) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) xv[u][h][v] = 0u;
      if (u < n) {
        const uint32_t* p = st + (jj[u] << tile_shift) + h * hstride;
        if constexpr (VEC == 4) {
          const uint4 w = *reinterpret_cast<const uint4*>(p);
          xv[u][h][0] = w.x; xv[u][h][1] = w.y;
          xv[u][h][2] = w.z; xv[u][h][3] = w.w;
        } else {
          xv[u][h][0] = p[0];
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int h = 0; h < CH; ++h)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[h][v] ^= xv[u][h][v];
}

// x:    [C, n4] packet-row lanes
// list: [R + 1 + nnz] int32, offsets then input-row indices
// out:  [R, n4]
// Dynamic shared memory: stages * C * T lanes of tile, then (LIST_SMEM)
// the offsets [R + 1] and the padded indices.
template <int VEC, bool LIST_SMEM>
__global__ void __launch_bounds__(kPacketThreads)
gf2_packet_kernel(const uint32_t* __restrict__ x,
                  const int* __restrict__ list,
                  uint32_t* __restrict__ out,
                  int C, int R, long long n4, int tile_shift, int stages) {
  extern __shared__ __align__(16) uint32_t stile[];
  // a thread takes CH chunks of VEC lanes, Q / CH chunks apart, of each
  // row of its group
  constexpr int CH = VEC == 4 ? kChunks : 1;
  const int qshift = tile_shift - (VEC == 4 ? 2 : 0);
  const int Q = 1 << qshift;            // VEC-lane chunks of a tile row
  const int tq = Q / CH;                // threads of a row group
  const int G = kPacketThreads / tq;    // row groups of the block
  const int q = threadIdx.x % tq;       // this thread's first chunk
  const int hstride = tq * VEC;         // words between its chunks
  const int stage_words = C << tile_shift;
  const int* off = list;
  const int* idx = list + R + 1;
  if constexpr (LIST_SMEM) {
    int* soff = reinterpret_cast<int*>(stile + stages * stage_words);
    int* sidx = soff + ((R + 4) & ~3);  // 16-byte aligned
    for (int i = threadIdx.x; i <= R; i += kPacketThreads)
      soff[i] = __ldg(list + i);
    __syncthreads();
    // row i's entries move to sidx[pad_start(off[i], i) ...]
    for (int i = threadIdx.x >> 5; i < R; i += kPacketThreads >> 5)
      for (int e = soff[i] + (threadIdx.x & 31); e < soff[i + 1]; e += 32)
        sidx[pad_start(soff[i], i) + e - soff[i]] = __ldg(idx + e);
    __syncthreads();
    off = soff;
    idx = sidx;
  }
  const int g = threadIdx.x / tq;
  const int row_lo = group_row(off, R, g, G);
  const int row_hi = group_row(off, R, g + 1, G);
  const long long ntiles = (n4 + (1 << tile_shift) - 1) >> tile_shift;

  // queue tile t's copy into stage s as one group of this thread's copies
  // (an empty group past the last tile keeps the count)
  const int chunks = C << qshift;
  auto issue = [&](long long t, int s) {
    if (t < ntiles) {
      uint32_t* st = stile + s * stage_words;
      const long long base = t << tile_shift;
      for (int i = threadIdx.x; i < chunks; i += kPacketThreads) {
        const int j = i >> qshift;
        const int lane = (i & (Q - 1)) * VEC;
        if (base + lane < n4)
          cp_async_lanes<VEC>(
              st + (j << tile_shift) + lane,
              x + static_cast<long long>(j) * n4 + base + lane);
      }
    }
    cp_async_commit();
  };

  // ring: tile number it of this block sits in stage it % stages, and
  // stages - 1 tiles are in flight ahead of the one being XORed
  const long long t0 = blockIdx.x, step = gridDim.x;
  for (int i = 0; i < stages - 1; ++i) issue(t0 + i * step, i);
  int it = 0;
  for (long long t = t0; t < ntiles; t += step, ++it) {
    issue(t + (stages - 1) * step, (it + stages - 1) % stages);
    cp_async_wait(stages - 1);
    __syncthreads();  // every thread's copies of tile t have landed

    const uint32_t* st = stile + (it % stages) * stage_words + q * VEC;
    const long long lane = (t << tile_shift) + q * VEC;
    for (int row = row_lo; row < row_hi; ++row) {
      uint32_t acc[CH][VEC];
#pragma unroll
      for (int h = 0; h < CH; ++h)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[h][v] = 0u;
      const int e0 = off[row], n = off[row + 1] - e0;
      if constexpr (LIST_SMEM) {
        // the next four indices are read while these four rows load
        const int4* p4 =
            reinterpret_cast<const int4*>(idx + pad_start(e0, row));
        int4 j = p4[0];
        for (int e = 0; e < n; e += 4) {
          const int4 next = p4[(e >> 2) + 1];
          xor_rows4<VEC, CH>(st, tile_shift, hstride, j, n - e, acc);
          j = next;
        }
      } else {
        for (int e = 0; e < n; e += 4) {
          int4 j;
          j.x = __ldg(idx + e0 + e);
          j.y = e + 1 < n ? __ldg(idx + e0 + e + 1) : 0;
          j.z = e + 2 < n ? __ldg(idx + e0 + e + 2) : 0;
          j.w = e + 3 < n ? __ldg(idx + e0 + e + 3) : 0;
          xor_rows4<VEC, CH>(st, tile_shift, hstride, j, n - e, acc);
        }
      }
#pragma unroll
      for (int h = 0; h < CH; ++h)
        if (lane + h * hstride < n4)
          store_lanes<VEC>(
              out + static_cast<long long>(row) * n4 + lane + h * hstride,
              acc[h]);
    }
    __syncthreads();  // this stage is read; a later copy may overwrite it
  }
}

template <int VEC, bool LIST_SMEM>
int launch_packet_vec(const uint32_t* x, const int* list, uint32_t* out,
                      int C, int R, long long n4, int tile_shift, int stages,
                      size_t smem, cudaStream_t s) {
  const auto kernel = gf2_packet_kernel<VEC, LIST_SMEM>;
  const long long ntiles = (n4 + (1 << tile_shift) - 1) >> tile_shift;
  int blocks = 0;
  const cudaError_t e =
      persistent_grid(kernel, kPacketThreads, smem, ntiles, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<blocks, kPacketThreads, smem, s>>>(x, list, out, C, R, n4,
                                              tile_shift, stages);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int launch_packet(const uint32_t* x, const int* list, uint32_t* out, int C,
                  int R, long long n4, cudaStream_t s) {
  int tile_shift = kMaxTileShift;
  while (tile_shift > kMinTileShift &&
         static_cast<size_t>(C) * (sizeof(uint32_t) << tile_shift) >
             kStageBytes)
    --tile_shift;
  const size_t stage = static_cast<size_t>(C) *
                       (sizeof(uint32_t) << tile_shift);
  if (stage > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // the list's largest size in shared memory, every pair a one: offsets
  // (R + 1, rounded up to 4) and padded indices (nnz + 3 + 4R, and the
  // four past the last row that its last prefetch reads); it sits there
  // where it fits beside one stage
  const size_t nmax = static_cast<size_t>(R) * C;
  const size_t list_bytes =
      sizeof(int) * (((static_cast<size_t>(R) + 4) & ~size_t{3}) + nmax + 8 +
                     4 * static_cast<size_t>(R));
  const bool list_smem = stage + list_bytes <= kMaxSmem;
  const size_t room = kMaxSmem - (list_smem ? list_bytes : 0);
  int stages = static_cast<int>(room / stage);
  if (stages > kMaxStages) stages = kMaxStages;
  if (list_smem)
    return launch_packet_vec<VEC, true>(x, list, out, C, R, n4, tile_shift,
                                        stages, stages * stage + list_bytes,
                                        s);
  return launch_packet_vec<VEC, false>(x, list, out, C, R, n4, tile_shift,
                                       stages, stages * stage, s);
}

// ---------------------------------------------------------------------------
// gf2_matrix_w8 and gf2_matrix_w16: nibble tables
// ---------------------------------------------------------------------------

// shared memory for one slice of tables (no opt-in needed)
constexpr size_t kTableBytes = 48 * 1024;
// input rows whose lanes are loaded together, before their lookups
constexpr int kBatch = 4;
// lanes a thread of gf2_matrix_w8 takes in its 16-byte form
constexpr int kW8Vec = 4;

// A table code: the entry type and the entries of one input row's tables
// in one output group (kEntries); Acc, one lane's accumulators for one
// group of 4 output rows; lookup<GP>, XOR lane x's entries of one input
// row from GP groups' tables (starting at tj, group_bytes apart) into
// acc[GP]; rows, one group's accumulators -> its 4 output rows' lanes.

// w=8: uint32 entries [ceil(m/4)][k][2][16], byte r = output row 4g + r
// (gf_w8_tables.cuh).  acc[b]: byte position b of the lane.
struct W8Code {
  using Entry = uint32_t;
  static constexpr int kEntries = kW8Entries;
  using Acc = uint32_t[4];
  static __device__ __forceinline__ void clear(Acc& a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) a[b] = 0u;
  }
  template <int GP>
  static __device__ __forceinline__ void lookup(Acc (&acc)[GP],
                                                const char* tj,
                                                int group_bytes, uint32_t x) {
    w8_lookup<GP>(acc, tj, group_bytes, x);
  }
  static __device__ __forceinline__ void rows(const Acc& a, uint32_t (&o)[4]) {
    w8_rows(a, o);
  }
};

// w=16: uint2 entries [ceil(m/4)][k][4][16], the 16-bit words of output
// rows 4g, 4g+1 in .x and 4g+2, 4g+3 in .y.  acc[h]: word h of the lane.
struct W16Code {
  using Entry = uint2;
  static constexpr int kEntries = 64;
  using Acc = uint2[2];
  static __device__ __forceinline__ void clear(Acc& a) {
    a[0] = make_uint2(0u, 0u);
    a[1] = make_uint2(0u, 0u);
  }
  template <int GP>
  static __device__ __forceinline__ void lookup(Acc (&acc)[GP],
                                                const char* tj,
                                                int group_bytes, uint32_t x) {
    // each nibble times 8 (its entry's byte offset), in a byte: even
    // nibbles of the lane in a8, odd ones in b8
    const uint32_t a8 = (x << 3) & 0x78787878u;
    const uint32_t b8 = (x >> 1) & 0x78787878u;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        // nibble p of word h is nibble 4h + p of the lane: byte 2h + p/2,
        // low half (a8) for even p
        const uint32_t o = __byte_perm((p & 1) ? b8 : a8, 0u,
                                       0x4440u + 2 * h + (p >> 1));
#pragma unroll
        for (int gg = 0; gg < GP; ++gg) {
          const uint2 e = *reinterpret_cast<const uint2*>(
              tj + gg * group_bytes + p * 16 * sizeof(uint2) + o);
          acc[gg][h].x ^= e.x;
          acc[gg][h].y ^= e.y;
        }
      }
  }
  static __device__ __forceinline__ void rows(const Acc& a, uint32_t (&o)[4]) {
    // row r's word: half r & 1 of .x (r < 2) or .y, from both halves
    o[0] = __byte_perm(a[0].x, a[1].x, 0x5410u);
    o[1] = __byte_perm(a[0].x, a[1].x, 0x7632u);
    o[2] = __byte_perm(a[0].y, a[1].y, 0x5410u);
    o[3] = __byte_perm(a[0].y, a[1].y, 0x7632u);
  }
};

// x:      [k, n4] lanes
// tables: [ceil(m/4)][k][Code::kEntries] Code::Entry
// out:    [m, n4]
// Dynamic shared memory: [GP][ks][kEntries] entries, one slice of tables.
// A persistent grid walks chunks of kThreads * VEC lanes; a thread keeps
// GP output groups' accumulators of its VEC lanes in registers per pass,
// over the k input rows in slices of ks, kBatch rows' lanes loaded ahead.
template <class Code, int VEC, int GP>
__global__ void __launch_bounds__(kThreads)
gf2_tables_kernel(const uint32_t* __restrict__ x,
                  const typename Code::Entry* __restrict__ tables,
                  uint32_t* __restrict__ out, int k, int m, long long n4,
                  int ks) {
  using Entry = typename Code::Entry;
  constexpr int kEntries = Code::kEntries;
  extern __shared__ __align__(16) unsigned char table_smem[];
  Entry* stab = reinterpret_cast<Entry*>(table_smem);
  const int groups = (m + 3) >> 2;
  const bool resident = groups <= GP && ks >= k;
  // tables of output groups g0 .. g0+GP-1, input rows j0 .. j0+kn-1
  auto stage = [&](int g0, int j0, int kn) {
    const int gn = groups - g0 < GP ? groups - g0 : GP;
    const int per = kn * kEntries;
    for (int i = threadIdx.x; i < gn * per; i += kThreads) {
      const int gg = i / per;
      stab[i] = __ldg(tables +
                      (static_cast<long long>(g0 + gg) * k + j0) * kEntries +
                      (i - gg * per));
    }
  };
  if (resident) {
    stage(0, 0, k);
    __syncthreads();
  }

  const long long span = static_cast<long long>(kThreads) * VEC;
  const long long nchunks = (n4 + span - 1) / span;
  for (long long ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
    const long long lane0 = ch * span + static_cast<long long>(threadIdx.x) *
                                            VEC;
    const bool live = lane0 < n4;  // n4 % VEC == 0
    for (int g0 = 0; g0 < groups; g0 += GP) {
      typename Code::Acc acc[VEC][GP];
#pragma unroll
      for (int v = 0; v < VEC; ++v)
#pragma unroll
        for (int gg = 0; gg < GP; ++gg) Code::clear(acc[v][gg]);

      for (int j0 = 0; j0 < k; j0 += ks) {
        const int kn = k - j0 < ks ? k - j0 : ks;
        if (!resident) {
          __syncthreads();  // the previous slice is no longer read
          stage(g0, j0, kn);
          __syncthreads();
        }
        if (!live) continue;
        const int group_bytes = kn * kEntries * static_cast<int>(sizeof(Entry));
        for (int jl = 0; jl < kn; jl += kBatch) {
          uint32_t xv[kBatch][VEC];
#pragma unroll
          for (int b = 0; b < kBatch; ++b)
            if (jl + b < kn)
              load_lanes<VEC>(x + (j0 + jl + b) * n4 + lane0, xv[b]);
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            if (jl + b >= kn) break;
            const char* tj = reinterpret_cast<const char*>(
                stab + (jl + b) * kEntries);
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              Code::template lookup<GP>(acc[v], tj, group_bytes, xv[b][v]);
          }
        }
      }
      if (!live) continue;
#pragma unroll
      for (int gg = 0; gg < GP; ++gg) {
        uint32_t o[VEC][4];
#pragma unroll
        for (int v = 0; v < VEC; ++v) Code::rows(acc[v][gg], o[v]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 4 * (g0 + gg) + r;
          if (row >= m) break;
          uint32_t ov[VEC];
#pragma unroll
          for (int v = 0; v < VEC; ++v) ov[v] = o[v][r];
          store_lanes<VEC>(out + static_cast<long long>(row) * n4 + lane0, ov);
        }
      }
    }
  }
}

// GP output groups a pass: 1 where m <= 4, else 2; the widest slice of
// input rows whose GP groups' tables fit kTableBytes
template <class Code, int VEC, int GP>
int launch_tables_gp(const uint32_t* x, const void* tables, uint32_t* out,
                     int k, int m, long long n4, cudaStream_t s) {
  const size_t per_input =
      static_cast<size_t>(GP) * Code::kEntries * sizeof(typename Code::Entry);
  const size_t most = kTableBytes / per_input;
  const int ks = static_cast<int>(static_cast<size_t>(k) < most ? k : most);
  const size_t smem = per_input * ks;
  const auto kernel = gf2_tables_kernel<Code, VEC, GP>;
  const long long span = static_cast<long long>(kThreads) * VEC;
  int blocks = 0;
  const cudaError_t e =
      persistent_grid(kernel, kThreads, smem, (n4 + span - 1) / span, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<blocks, kThreads, smem, s>>>(
      x, static_cast<const typename Code::Entry*>(tables), out, k, m, n4, ks);
  return static_cast<int>(cudaGetLastError());
}

// The VEC-lane form where n4 % VEC == 0 and both pointers are 16-byte
// aligned, the one-lane form otherwise.
template <class Code, int VEC>
int launch_tables(const void* x, const void* tables, void* out, int k, int m,
                  long long n4, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const uint32_t*>(x);
  auto* oi = static_cast<uint32_t*>(out);
  if (k < 0 || m < 1 || n4 < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = n4 % VEC == 0 && aligned16(x) && aligned16(out);
  if (wide && m <= 4)
    return launch_tables_gp<Code, VEC, 1>(xi, tables, oi, k, m, n4, s);
  if (wide) return launch_tables_gp<Code, VEC, 2>(xi, tables, oi, k, m, n4, s);
  if (m <= 4) return launch_tables_gp<Code, 1, 1>(xi, tables, oi, k, m, n4, s);
  return launch_tables_gp<Code, 1, 2>(xi, tables, oi, k, m, n4, s);
}

}  // namespace

extern "C" {

// x [k, n4] lanes of 4 bytes; tables [ceil(m/4), 32k] int32 (nibble
// tables, uint32 [ceil(m/4)][k][2][16]); out [m, n4]; n4 >= 1.
int gf2_matrix_w8(const void* x, const void* tables, void* out, int k, int m,
                  long long n4, void* stream) {
  return launch_tables<W8Code, kW8Vec>(x, tables, out, k, m, n4, stream);
}

// x [k, n4] lanes of two LE uint16 words; tables [ceil(m/4), 128k] int32
// (nibble tables, uint2 [ceil(m/4)][k][4][16]); out [m, n4]; n4 >= 1.
int gf2_matrix_w16(const void* x, const void* tables, void* out, int k,
                   int m, long long n4, void* stream) {
  return launch_tables<W16Code, 4>(x, tables, out, k, m, n4, stream);
}

// x [c, n4] packet-row lanes; list [r + 1 + nnz] int32 (offsets, then
// input-row indices); out [r, n4]; n4 >= 1, c * 32 bytes <= 227 KiB.
int gf2_packet(const void* x, const void* list, void* out, int c, int r,
               long long n4, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const uint32_t*>(x);
  const auto* li = static_cast<const int*>(list);
  auto* oi = static_cast<uint32_t*>(out);
  if (c < 1 || r < 1 || n4 < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n4 % 4 == 0 && aligned16(x) && aligned16(out))
    return launch_packet<4>(xi, li, oi, c, r, n4, s);
  return launch_packet<1>(xi, li, oi, c, r, n4, s);
}

}  // extern "C"
