// The frame the port's wgmma kernels share: the lanes as wgmma's M, 64 a
// warpgroup a step; B staged in shared memory in wgmma's no-swizzle K-major
// layout and read through one descriptor form; the input words brought
// into a ring of shared-memory slots by cp.async; and the walk that hands
// each warpgroup its 64-lane sub-tiles.  prec_tf32.cuh (sweep_prec_tf32x3,
// sweep_prec_tf32) and dot_wgmma.cuh (the 4-dot and block-diagonal
// products) include it; cuda_gf.source_digest hashes it into
// sweep_kernels.cu's digest.
//
// Every K-step of a B operand here is 32 bytes a row (8 TF32, 16 bf16 or
// 32 int8 elements): two 16-byte core-matrix columns, LBO = 128 bytes
// apart, and 8-row groups SBO = 256 bytes apart, so one descriptor form
// serves every operand type.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSubLanes = 64;  // wgmma's M: lanes a warpgroup takes a step

// wgmma's shared-memory descriptor of a no-swizzle K-major operand: start
// address, LBO = 128 bytes (the two 16-byte K halves of a K-step), SBO =
// 256 bytes (8-row groups), all in 16-byte units; layout type 0
__device__ __forceinline__ uint64_t b_desc(const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>(128 >> 4) << 16 |
         static_cast<uint64_t>(256 >> 4) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// an accumulator read after wait_group: not before it
__device__ __forceinline__ void fence_acc(float& acc) {
  asm volatile("" : "+f"(acc)::"memory");
}
__device__ __forceinline__ void fence_acc(int& acc) {
  asm volatile("" : "+r"(acc)::"memory");
}

// registers of A fragments kept live up to this point
template <int P>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[P][4]) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[p][r])::"memory");
}

// sub-tiles a group keeps in flight: its ring of shared-memory slots
constexpr int kRing = 4;

// one cp.async of VEC lanes (16 or 4 bytes); bytes < 4 VEC zero-fill the
// rest
template <int VEC>
__device__ __forceinline__ void ring_copy(uint32_t* dst, const uint32_t* src,
                                          int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(bytes)
                 : "memory");
}

// A group's walk: 64-lane sub-tiles of tile tile; each block takes tiles
// blockIdx.x, + gridDim.x, ..., its groups the sub-tiles of a tile in turn
// (group g sub-tiles g, g + groups, ...).  lane0 and stop, the sub-tile's
// first lane and its tile's end, are kept, not recomputed at each use.
struct Walk {
  long long tile, lane0, stop;
  long long ntiles, n4;
  int T, groups;
  __device__ Walk(long long first, int group, long long n4_, int T_,
                  int groups_)
      : tile(first), ntiles((n4_ + T_ - 1) / T_), n4(n4_), T(T_),
        groups(groups_) {
    enter(group);
    settle(group);
  }
  __device__ bool done() const { return tile >= ntiles; }
  // the group's first sub-tile of tile
  __device__ void enter(int group) {
    lane0 = tile * T + kSubLanes * group;
    const long long end = lane0 - kSubLanes * group + T;
    stop = end < n4 ? end : n4;
  }
  // past sub-tiles that start beyond their tile
  __device__ void settle(int group) {
    while (!done() && lane0 >= stop) {
      tile += gridDim.x;
      enter(group);
    }
  }
  __device__ void next(int group) {
    lane0 += kSubLanes * groups;
    settle(group);
  }
};

// the k rows of a sub-tile into a ring slot [k][64] (zero past the tile or
// n4; nothing once the walk is done), one commit group either way
template <int VEC>
__device__ __forceinline__ void fetch(uint32_t* slot,
                                      const uint32_t* __restrict__ x, int k,
                                      const Walk& w, int tid) {
  constexpr int kPerRow = kSubLanes / VEC;
  const int chunks = w.done() ? 0 : k * kPerRow;
  const long long lane0 = w.lane0, stop = w.stop;
  for (int c = tid; c < chunks; c += 128) {
    const int j = c / kPerRow, q = c % kPerRow;
    const long long lane = lane0 + VEC * q;
    const long long left = stop - lane;
    const int bytes = left >= VEC ? 4 * VEC
                      : left > 0  ? 4 * static_cast<int>(left)
                                  : 0;
    ring_copy<VEC>(slot + j * kSubLanes + VEC * q,
                   bytes ? x + j * w.n4 + lane : x, bytes);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

}  // namespace
