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
//   xornet_network(x, z) for x[XORNET_K], one lane of each input row, and
//                        z[8 * XORNET_M] zeroed accumulators: for each input
//                        row j, for each bit s that some bit-row uses, the
//                        plane q = (x[j] >> s) & 0x01010101 (bit s of all four
//                        bytes at once) XORed into the accumulator of every
//                        bit-row whose support holds (j, s)
//
// Output row i's lane is the OR over l < 8 of z[8i + l] << l: bit l of byte
// b is the XOR of the bits of byte b in bit-row 8i + l's support.  No
// products, no table operand, no parity fold.  An all-zero bit-row leaves
// its accumulator 0.
//
// The network is emitted input-major (all planes of x[0], then of x[1], ...),
// so only the 8m accumulators and the one plane in hand stay live; the TPU
// kernel's order (all 8k planes first, then the rows) would keep 64 planes
// live per lane.
//
// Bound on the card: memory, (k + m) * n4 * 4 bytes at 3.35 TB/s.  The
// integer work per lane is one shift and one and per used plane, one XOR
// per 1 of the bitmatrix (fewer where nvcc fuses three-input XORs into
// LOP3), and one shift-or per bit-row: at reed_sol_van k=8 m=4 (854 ones)
// about 600-1000 operations per lane, against the 64 INT32 lanes a clock of
// each of 132 SMs.  Design: a persistent grid-stride walk; each thread takes
// VEC = 4 consecutive lanes with one 16-byte load per input row (all k loads
// in flight before the network runs), runs the network once per lane, and
// stores each output row with one 16-byte store.  A lane count that is no
// multiple of 4, or a pointer off the 16-byte grid, takes the one-lane form.
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
constexpr int kRows = 8 * XORNET_M;

template <int VEC>
__global__ void __launch_bounds__(kThreads)
xornet_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
              long long n4) {
  const long long groups = n4 / VEC;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long gi = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
       gi < groups; gi += step) {
    const long long lane0 = gi * VEC;
    uint32_t v[XORNET_K][VEC];
#pragma unroll
    for (int j = 0; j < XORNET_K; ++j) {
      const uint32_t* p = x + static_cast<long long>(j) * n4 + lane0;
      if constexpr (VEC == 4) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
        v[j][0] = q.x; v[j][1] = q.y; v[j][2] = q.z; v[j][3] = q.w;
      } else {
        v[j][0] = __ldg(p);
      }
    }
    uint32_t o[XORNET_M][VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      uint32_t xe[XORNET_K];
#pragma unroll
      for (int j = 0; j < XORNET_K; ++j) xe[j] = v[j][e];
      uint32_t z[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) z[r] = 0u;
      xornet_network(xe, z);
#pragma unroll
      for (int i = 0; i < XORNET_M; ++i) {
        uint32_t word = 0u;
#pragma unroll
        for (int l = 0; l < 8; ++l) word |= z[8 * i + l] << l;
        o[i][e] = word;
      }
    }
#pragma unroll
    for (int i = 0; i < XORNET_M; ++i) {
      uint32_t* dst = out + static_cast<long long>(i) * n4 + lane0;
      if constexpr (VEC == 4)
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(o[i][0], o[i][1], o[i][2], o[i][3]);
      else
        dst[0] = o[i][0];
    }
  }
}

template <int VEC>
int launch_xornet(const uint32_t* x, uint32_t* out, long long n4,
                  cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, xornet_kernel<VEC>, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long groups = n4 / VEC;
  const long long items = (groups + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * per_sm;
  const int blocks = static_cast<int>(items < most ? items : most);
  xornet_kernel<VEC><<<blocks, kThreads, 0, s>>>(x, out, n4);
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
    return launch_xornet<4>(xi, oi, n4, s);
  return launch_xornet<1>(xi, oi, n4, s);
}

}  // extern "C"
