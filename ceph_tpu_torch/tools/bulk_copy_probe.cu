// A TMA bulk-copy ring for sweep_copy's aligned copy (sm_90a): the other
// design measured for it, which ceph_tpu_torch/tools/split_probe.py times
// beside the register copy that csrc/sweep_kernels.cu ships and beside
// x[:m].clone().  Only the probe builds it.
//
// One thread a block keeps a ring of kBulkStages chunks of kBulkChunk bytes
// in flight from device memory to shared memory, each completing on an
// mbarrier, and stores each filled chunk back with one bulk store; the
// threads spend no registers or issue slots on the bytes.  It needs 16-byte
// aligned addresses and a total that is a multiple of 16 bytes.
//
// Interface: csrc/sweep_kernels.cu's sweep_copy (plain C, ctypes), for
// aligned operands only; others return cudaErrorInvalidValue.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// chunks a block keeps in flight, and the bytes of each
constexpr int kBulkStages = 8;
constexpr unsigned kBulkChunk = 8 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The bulk copy's PTX (sm_90): mbarriers that count one arrival and the
// bytes of a bulk load, bulk loads that complete on them, bulk stores in
// bulk groups.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

// make initialised mbarriers visible to the bulk copies
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wait until the phase of parity `parity` of *bar has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// bytes of device memory at src into shared memory at dst; *bar's phase
// completes when they have landed
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// bytes of shared memory at src to device memory at dst, as one bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until all but the newest bulk group have read their shared memory
__device__ __forceinline__ void bulk_wait_read_all_but_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

// wait until every bulk group has completed
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Chunk c of the copy is bytes [c * kBulkChunk, ...) of x; block b takes
// chunks b, b + gridDim.x, ...  Its thread 0 loads the first kBulkStages
// into the ring, then for each chunk in turn: waits for its load, stores it
// with one bulk store, and refills the stage of the chunk before it (whose
// store has finished reading shared memory) with the chunk kBulkStages
// later.  The other threads of the block issue nothing.
__global__ void __launch_bounds__(32)
bulk_copy_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                 long long nbytes) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) uint64_t full[kBulkStages];
  if (threadIdx.x != 0) return;
  const long long chunks = (nbytes + kBulkChunk - 1) / kBulkChunk;
  if (chunks <= blockIdx.x) return;
  const long long mine = (chunks - 1 - blockIdx.x) / gridDim.x + 1;
  for (int s = 0; s < kBulkStages; ++s) mbar_init(&full[s]);
  mbar_fence_init();

  auto offset = [&](long long i) {
    return (blockIdx.x + i * gridDim.x) * static_cast<long long>(kBulkChunk);
  };
  auto size = [&](long long off) {
    return static_cast<uint32_t>(
        nbytes - off < kBulkChunk ? nbytes - off : kBulkChunk);
  };
  auto load = [&](long long i) {
    const int s = static_cast<int>(i % kBulkStages);
    const long long off = offset(i);
    bulk_load(ring + s * kBulkChunk, x + off, size(off), &full[s]);
  };

  for (long long i = 0; i < mine && i < kBulkStages; ++i) load(i);
  for (long long i = 0; i < mine; ++i) {
    const int s = static_cast<int>(i % kBulkStages);
    mbar_wait(&full[s], static_cast<uint32_t>(i / kBulkStages) & 1u);
    const long long off = offset(i);
    bulk_store(out + off, ring + s * kBulkChunk, size(off));
    if (i >= 1 && i - 1 + kBulkStages < mine) {
      // the store of chunk i - 1 has read its stage: refill it
      bulk_wait_read_all_but_one();
      load(i - 1 + kBulkStages);
    }
  }
  bulk_wait_all();
}

int launch_bulk_copy(const void* x, void* out, long long nbytes,
                     cudaStream_t s) {
  constexpr size_t smem = static_cast<size_t>(kBulkStages) * kBulkChunk;
  cudaError_t e = cudaFuncSetAttribute(
      bulk_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bulk_copy_kernel, 32, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // as many blocks as fit on the card at once, and no more than chunks
  const long long chunks = (nbytes + kBulkChunk - 1) / kBulkChunk;
  const long long most = static_cast<long long>(sms) * per_sm;
  const int blocks = static_cast<int>(chunks < most ? chunks : most);
  bulk_copy_kernel<<<blocks, 32, smem, s>>>(static_cast<const uint8_t*>(x),
                                            static_cast<uint8_t*>(out),
                                            nbytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [>= m, n4] lanes; out [m, n4] = x[:m]
int sweep_copy(const void* x, void* out, int m, long long n4, void* stream) {
  const long long lanes = static_cast<long long>(m) * n4;
  if (lanes % 4 != 0 || (reinterpret_cast<uintptr_t>(x) & 15u) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0) return 0;
  return launch_bulk_copy(x, out, lanes * 4,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
