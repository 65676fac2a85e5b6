/* crc32c (Castagnoli) with Ceph's conventions, for the port's host path.
 *
 * Copy of the ec_crc32c body of the JAX package's native library: the
 * SSE4.2 path folds eight bytes an instruction (_mm_crc32_u64), and a
 * build without SSE4.2 takes the byte-table path.  Initial value is the
 * caller's (Ceph passes -1), there is no final xor-out, so
 * crc32c(b, crc32c(a)) == crc32c(a + b).  Reference: src/common/crc32c.cc
 * (HashInfo hashes through bufferlist::crc32c).
 *
 * Built by ceph_tpu_torch/native/gf_native.py with the host C compiler
 * and loaded with ctypes.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#else
static uint32_t table[256];

__attribute__((constructor)) static void crc32c_init_table(void) {
  for (uint32_t v = 0; v < 256; ++v) {
    uint32_t x = v;
    for (int b = 0; b < 8; ++b) x = (x >> 1) ^ ((x & 1) ? 0x82F63B78u : 0);
    table[v] = x;
  }
}
#endif

/* 1 when this build folds with SSE4.2, 0 for the table path. */
int crc32c_sse42_built(void) {
#if defined(__SSE4_2__)
  return 1;
#else
  return 0;
#endif
}

/* 1 when the running CPU has SSE4.2 (a build that needs it refuses to
 * load on a CPU without it). */
int crc32c_sse42_present(void) {
#if defined(__x86_64__) || defined(__i386__)
  __builtin_cpu_init();
  return __builtin_cpu_supports("sse4.2") ? 1 : 0;
#else
  return 0;
#endif
}

uint32_t ceph_crc32c(uint32_t crc, const uint8_t* data, size_t n) {
#if defined(__SSE4_2__)
  size_t i = 0;
  uint64_t c = crc;
  for (; i + 8 <= n; i += 8) {
    uint64_t v;
    memcpy(&v, data + i, 8);
    c = _mm_crc32_u64(c, v);
  }
  uint32_t c32 = (uint32_t)c;
  for (; i < n; ++i) c32 = _mm_crc32_u8(c32, data[i]);
  return c32;
#else
  uint32_t c = crc;
  for (size_t i = 0; i < n; ++i) c = table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c;
#endif
}
