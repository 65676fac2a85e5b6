// Static XOR network for Hopper (sm_90a): the w=8 GF(2) bitmatrix product
// with the bitmatrix compiled into the kernel, over little-endian bytes
// packed 4 to a 32-bit lane, [rows, n4].
//
//   sweep_xornet  replaces experiments/kernel_r4.py _make_xornet_kernel (:129)
//
// This file is the kernel's frame.  The network itself comes from a header
// that ceph_tpu_torch.ops.sweep_gf.xornet_source generates from one
// bitmatrix; cuda_gf.build writes it to build/gen-<digest>/ and passes that
// directory with -I, so every bitmatrix has a library of its own
// (libxornet_kernel-<digest16>.so).  The header defines
//
//   XORNET_K, XORNET_M   input and output rows
//   xornet_row<J>(p, z)  for p[8], the 8 planes of input row J, and
//                        z[8 * XORNET_M] accumulators: each plane p[s] that
//                        some bit-row uses, XORed into the accumulator of
//                        every bit-row whose support holds (J, s); an input
//                        row that no bit-row uses has no statement
//
// Bit-sliced over transposed 32-bit planes.  A thread takes 8 lanes (32
// bytes) of every row.  transpose8 turns row j's 8 words into 8 planes,
// bit (8b + t) of plane s being bit (8b + s) of word t: bit s of all 32
// bytes, so each XOR of the network carries 32 useful bits and the network
// runs once per 8 lanes.  Accumulator z[8i + l] then holds bit l of all 32
// bytes of output row i, and transpose8, its own inverse, packs them back
// into the row's 8 words.  No shift, no mask and no pack in the network; an
// all-zero bit-row leaves its accumulator 0.  The network is input-major,
// so only the 8m accumulators and one row's planes stay live beside the
// words in flight.
//
// Bound on the card: memory, (k + m) * n4 * 4 bytes at 3.35 TB/s.  The
// integer work per 8 lanes: about 60 operations a transpose (3 delta-swap
// stages of 4 word pairs) for each of the k + m rows, and one XOR per 1 of
// the bitmatrix, fewer where nvcc fuses three-input XORs into LOP3 (at
// reed_sol_van k=8 m=4: about 720 + 411, some 140 a lane, against the 64
// INT32 lanes a clock of each of 132 SMs), under the memory time.  Without
// the transposes a plane (x >> s) & 0x01010101 carries 4 useful bits of
// 32 and the network runs once a lane: some 600 operations a lane, over
// the memory time.
//
// Design: a warp takes a span of kSpan = 256 lanes.  With 16-byte loads
// (n4 a multiple of 4 and both pointers on the 16-byte grid) thread t
// takes lanes 4t..4t+3 and 128+4t..128+4t+3, two uint4 a row, so every
// load and store instruction covers 512 contiguous bytes; otherwise lanes
// t + 32e, e < 8, one word a load, into the same transposes and network.
// Lanes past n4 read as zero and are not stored.  The input rows' loads are
// issued in batches of kBatch rows, all k rows where their words and the
// accumulators fit in about 96 registers (k = 8 at m = 4; 4 rows a batch
// at m = 8), before the network runs over them.  The grid is sized to the
// work: the span loop runs once a warp (a persistent grid walks it).
//
// Interface: plain C, loaded with ctypes.  Pointers come from
// tensor.data_ptr(), the stream from torch.cuda.current_stream().cuda_stream.
// The entry point launches on that stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "xornet_net.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// 16-byte quads of lanes a thread takes from each row: 8 lanes
constexpr int kQuads = 2;
constexpr int kWords = 4 * kQuads;
constexpr int kSpan = 32 * kWords;
constexpr int kRows = 8 * XORNET_M;
// input rows whose loads are in flight at once
constexpr int kBatchRows = (96 - kRows) / 8;
constexpr int kBatch = kBatchRows < XORNET_K ? kBatchRows : XORNET_K;

// exchange the bits of a under ~mask << d with those of b under mask:
// one stage of the 8x8 bit transpose within each byte position
__device__ __forceinline__ void delta_swap(uint32_t& a, uint32_t& b, int d,
                                           uint32_t mask) {
  const uint32_t t = ((a >> d) ^ b) & mask;
  b ^= t;
  a ^= t << d;
}

// bit (8b + t) of w[s] <- bit (8b + s) of w[t], for every byte position b;
// its own inverse
__device__ __forceinline__ void transpose8(uint32_t (&w)[8]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) delta_swap(w[t], w[t + 4], 4, 0x0F0F0F0Fu);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int t = (u & 1) | (u & 2) << 1;  // 0, 1, 4, 5
    delta_swap(w[t], w[t + 2], 2, 0x33333333u);
  }
#pragma unroll
  for (int t = 0; t < 8; t += 2) delta_swap(w[t], w[t + 1], 1, 0x55555555u);
}

// the 8 words a thread takes from one row of a span starting at lane base
template <bool kVec>
__device__ __forceinline__ void load8(const uint32_t* __restrict__ row,
                                      long long base, int lane,
                                      long long n4, uint32_t (&w)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) w[e] = 0u;
  if constexpr (kVec) {
#pragma unroll
    for (int h = 0; h < kQuads; ++h) {
      const long long q = base + 4 * lane + 128 * h;
      if (q < n4) {
        const uint4 v = __ldcs(reinterpret_cast<const uint4*>(row + q));
        w[4 * h] = v.x; w[4 * h + 1] = v.y;
        w[4 * h + 2] = v.z; w[4 * h + 3] = v.w;
      }
    }
  } else {
    // one base pointer and immediate offsets: indexing row with a 64-bit
    // lane index per word took 255 registers and spilled at k=16 m=8
#pragma unroll
    for (int e = 0; e < kWords; ++e)
      if (base + lane + 32 * e < n4)
        w[e] = __ldcs(row + base + lane + 32 * e);
  }
}

template <bool kVec>
__device__ __forceinline__ void store8(uint32_t* __restrict__ row,
                                       long long base, int lane,
                                       long long n4, const uint32_t (&w)[8]) {
  if constexpr (kVec) {
#pragma unroll
    for (int h = 0; h < kQuads; ++h) {
      const long long q = base + 4 * lane + 128 * h;
      if (q < n4)
        __stcs(reinterpret_cast<uint4*>(row + q),
               make_uint4(w[4 * h], w[4 * h + 1], w[4 * h + 2],
                          w[4 * h + 3]));
    }
  } else {
#pragma unroll
    for (int e = 0; e < kWords; ++e)
      if (base + lane + 32 * e < n4) __stcs(row + base + lane + 32 * e, w[e]);
  }
}

// rows J..E-1 of a batch whose words w[0..] start at row J0: transpose each
// into its planes and run its part of the network
template <int J, int J0, int E>
__device__ __forceinline__ void net_rows(uint32_t (&w)[E - J0][8],
                                         uint32_t (&z)[kRows]) {
  if constexpr (J < E) {
    transpose8(w[J - J0]);
    xornet_row<J>(w[J - J0], z);
    net_rows<J + 1, J0, E>(w, z);
  }
}

// input rows from J on, kBatch rows at a time: all of a batch's loads,
// then its transposes and network
template <int J, bool kVec>
__device__ __forceinline__ void batch_rows(const uint32_t* __restrict__ x,
                                           long long base, int lane,
                                           long long n4,
                                           uint32_t (&z)[kRows]) {
  if constexpr (J < XORNET_K) {
    constexpr int E = J + kBatch < XORNET_K ? J + kBatch : XORNET_K;
    uint32_t w[E - J][8];
#pragma unroll
    for (int j = J; j < E; ++j)
      load8<kVec>(x + static_cast<long long>(j) * n4, base, lane, n4,
                  w[j - J]);
    net_rows<J, J, E>(w, z);
    batch_rows<E, kVec>(x, base, lane, n4, z);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
xornet_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
              long long n4) {
  const int lane = threadIdx.x & 31;
  const long long spans = (n4 + kSpan - 1) / kSpan;
  for (long long span = static_cast<long long>(blockIdx.x) * kWarps +
                        (threadIdx.x >> 5);
       span < spans; span += static_cast<long long>(gridDim.x) * kWarps) {
    const long long base = span * kSpan;
    uint32_t z[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) z[r] = 0u;
    batch_rows<0, kVec>(x, base, lane, n4, z);
#pragma unroll
    for (int i = 0; i < XORNET_M; ++i) {
      uint32_t o[8];
#pragma unroll
      for (int l = 0; l < 8; ++l) o[l] = z[8 * i + l];
      transpose8(o);
      store8<kVec>(out + static_cast<long long>(i) * n4, base, lane, n4, o);
    }
  }
}

template <bool kVec>
int launch_xornet(const uint32_t* x, uint32_t* out, long long n4,
                  cudaStream_t s) {
  const long long spans = (n4 + kSpan - 1) / kSpan;
  const long long blocks = (spans + kWarps - 1) / kWarps;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  xornet_kernel<kVec><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      x, out, n4);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// x [XORNET_K, n4] lanes; out [XORNET_M, n4]; n4 >= 1
int sweep_xornet(const void* x, void* out, long long n4, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const uint32_t*>(x);
  auto* oi = static_cast<uint32_t*>(out);
  if (n4 < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n4 % 4 == 0 && aligned16(x) && aligned16(out))
    return launch_xornet<true>(xi, oi, n4, s);
  return launch_xornet<false>(xi, oi, n4, s);
}

}  // extern "C"
