// Native CPU codec kernels of ceph_tpu_torch (the host engine behind
// ``backend=native``; port of ceph_tpu/native/gf_kernels.cpp).
//
// Plays the role the jerasure/gf-complete and isa-l SIMD kernels play in the
// reference (reference: src/erasure-code/jerasure links libjerasure;
// src/erasure-code/isa/xor_op.cc hand-vectorized XOR; isa-l ec_encode_data):
// GF(2^8) region multiply via AVX2 vpshufb nibble tables (the gf-complete
// SPLIT w8/4 scheme), vectorized region XOR, full matrix/bitmatrix encode
// loops, and slice-by-8 + SSE4.2 crc32c.  Exposed with a C ABI consumed via
// ctypes (ceph_tpu_torch/native/gf_native.py) and built by
// ceph_tpu_torch/native/build.py.
//
// GF(2^8) polynomial is 0x11D to match ceph_tpu_torch.ops.gf and interoperate with
// jerasure/isa-l chunk formats.

#include <cstdint>
#include <cstring>
#include <cstddef>

#if defined(__AVX2__)
#include <immintrin.h>
#endif
#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

namespace {

constexpr unsigned kPoly = 0x11D;

uint8_t gf_mul_slow(uint8_t a, uint8_t b) {
  unsigned r = 0;
  unsigned aa = a;
  for (unsigned bb = b; bb; bb >>= 1) {
    if (bb & 1) r ^= aa;
    aa <<= 1;
    if (aa & 0x100) aa ^= kPoly;
  }
  return static_cast<uint8_t>(r);
}

struct MulTables {
  // full 256x256 product table plus per-constant nibble tables
  uint8_t full[256][256];
  uint8_t lo[256][16];   // lo[c][v] = c * v
  uint8_t hi[256][16];   // hi[c][v] = c * (v << 4)
  MulTables() {
    for (int c = 0; c < 256; ++c) {
      for (int v = 0; v < 256; ++v)
        full[c][v] = gf_mul_slow(static_cast<uint8_t>(c),
                                 static_cast<uint8_t>(v));
      for (int v = 0; v < 16; ++v) {
        lo[c][v] = full[c][v];
        hi[c][v] = full[c][v << 4];
      }
    }
  }
};

const MulTables& tables() {
  static MulTables t;
  return t;
}

// out ^= c * in  (accum) or out = c * in
void mul_region(uint8_t c, const uint8_t* in, uint8_t* out, size_t n,
                bool accum) {
  const MulTables& t = tables();
  if (c == 0) {
    if (!accum) std::memset(out, 0, n);
    return;
  }
  size_t i = 0;
#if defined(__AVX2__)
  if (c == 1) {
    for (; i + 32 <= n; i += 32) {
      __m256i x = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(in + i));
      if (accum) {
        __m256i o = _mm256_loadu_si256(reinterpret_cast<__m256i*>(out + i));
        x = _mm256_xor_si256(x, o);
      }
      _mm256_storeu_si256(reinterpret_cast<__m256i*>(out + i), x);
    }
  } else {
    const __m128i lo128 =
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(t.lo[c]));
    const __m128i hi128 =
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(t.hi[c]));
    const __m256i lotab = _mm256_broadcastsi128_si256(lo128);
    const __m256i hitab = _mm256_broadcastsi128_si256(hi128);
    const __m256i maskn = _mm256_set1_epi8(0x0F);
    for (; i + 32 <= n; i += 32) {
      __m256i x = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(in + i));
      __m256i xl = _mm256_and_si256(x, maskn);
      __m256i xh = _mm256_and_si256(_mm256_srli_epi16(x, 4), maskn);
      __m256i p = _mm256_xor_si256(_mm256_shuffle_epi8(lotab, xl),
                                   _mm256_shuffle_epi8(hitab, xh));
      if (accum) {
        __m256i o = _mm256_loadu_si256(reinterpret_cast<__m256i*>(out + i));
        p = _mm256_xor_si256(p, o);
      }
      _mm256_storeu_si256(reinterpret_cast<__m256i*>(out + i), p);
    }
  }
#endif
  const uint8_t* row = t.full[c];
  for (; i < n; ++i) {
    uint8_t v = row[in[i]];
    out[i] = accum ? static_cast<uint8_t>(out[i] ^ v) : v;
  }
}

}  // namespace

extern "C" {

// Runtime CPU feature probe (reference src/arch/probe.cc ceph_arch_probe
// + src/arch/intel.c: the reference fills ceph_arch_intel_* flags once
// and codecs pick kernels off them).  Bitmask: 1=sse4.2, 2=avx,
// 4=avx2, 8=avx512f.
int ec_arch_probe(void) {
  int f = 0;
#if defined(__x86_64__) || defined(__i386__)
  __builtin_cpu_init();
  if (__builtin_cpu_supports("sse4.2")) f |= 1;
  if (__builtin_cpu_supports("avx")) f |= 2;
  if (__builtin_cpu_supports("avx2")) f |= 4;
  if (__builtin_cpu_supports("avx512f")) f |= 8;
#endif
  return f;
}

// What THIS build was compiled to require (so a library copied onto an
// older machine is rejected at load instead of crashing mid-kernel).
int ec_arch_built(void) {
  int f = 0;
#if defined(__SSE4_2__)
  f |= 1;
#endif
#if defined(__AVX__)
  f |= 2;
#endif
#if defined(__AVX2__)
  f |= 4;
#endif
#if defined(__AVX512F__)
  f |= 8;
#endif
  return f;
}

// GF(2^8) region multiply-accumulate: out (^)= c * in over n bytes.
void ec_gf8_mul_region(uint8_t c, const uint8_t* in, uint8_t* out, size_t n,
                       int accum) {
  mul_region(c, in, out, n, accum != 0);
}

// region XOR of k sources into out (isa region_xor semantics).
void ec_region_xor(const uint8_t* const* srcs, int k, uint8_t* out, size_t n) {
  std::memcpy(out, srcs[0], n);
  for (int j = 1; j < k; ++j) {
    size_t i = 0;
#if defined(__AVX2__)
    for (; i + 32 <= n; i += 32) {
      __m256i a = _mm256_loadu_si256(reinterpret_cast<__m256i*>(out + i));
      __m256i b =
          _mm256_loadu_si256(reinterpret_cast<const __m256i*>(srcs[j] + i));
      _mm256_storeu_si256(reinterpret_cast<__m256i*>(out + i),
                          _mm256_xor_si256(a, b));
    }
#endif
    for (; i < n; ++i) out[i] ^= srcs[j][i];
  }
}

// matrix encode: coding[i] = XOR_j matrix[i*k+j] * data[j]; all regions n
// bytes, matrix row-major m x k, byte entries (GF(2^8)).
void ec_gf8_matrix_encode(const uint8_t* matrix, int k, int m,
                          const uint8_t* const* data, uint8_t* const* coding,
                          size_t n) {
  for (int i = 0; i < m; ++i) {
    bool first = true;
    for (int j = 0; j < k; ++j) {
      uint8_t c = matrix[i * k + j];
      if (c == 0) continue;
      mul_region(c, data[j], coding[i], n, !first);
      first = false;
    }
    if (first) std::memset(coding[i], 0, n);
  }
}

// packetized bitmatrix encode: rows [C] packet rows of n bytes each;
// out rows [R]; bitmat row-major R x C of 0/1 bytes.
void ec_bitmatrix_packet_encode(const uint8_t* bitmat, int r, int c,
                                const uint8_t* const* rows,
                                uint8_t* const* out, size_t n) {
  for (int i = 0; i < r; ++i) {
    const uint8_t* sel[256];
    int cnt = 0;
    for (int j = 0; j < c; ++j)
      if (bitmat[i * c + j]) sel[cnt++] = rows[j];
    if (cnt == 0) {
      std::memset(out[i], 0, n);
    } else {
      ec_region_xor(sel, cnt, out[i], n);
    }
  }
}

// crc32c (castagnoli), matching ceph_crc32c semantics (reference:
// src/common/crc32c.cc dispatch; HashInfo uses bufferlist::crc32c).
uint32_t ec_crc32c(uint32_t crc, const uint8_t* data, size_t n) {
#if defined(__SSE4_2__)
  size_t i = 0;
  uint64_t c = crc;
  for (; i + 8 <= n; i += 8) {
    uint64_t v;
    std::memcpy(&v, data + i, 8);
    c = _mm_crc32_u64(c, v);
  }
  uint32_t c32 = static_cast<uint32_t>(c);
  for (; i < n; ++i) c32 = _mm_crc32_u8(c32, data[i]);
  return c32;
#else
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t v = 0; v < 256; ++v) {
      uint32_t x = v;
      for (int b = 0; b < 8; ++b)
        x = (x >> 1) ^ ((x & 1) ? 0x82F63B78u : 0);
      table[v] = x;
    }
    init = true;
  }
  uint32_t c = crc;
  for (size_t i = 0; i < n; ++i) c = table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c;
#endif
}

}  // extern "C"
