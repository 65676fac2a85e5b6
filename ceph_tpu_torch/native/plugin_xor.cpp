// Native example plugin: libec_xor_native.so (k configurable, m=1 XOR).
//
// The native twin of the Python example plugin (reference fixture shape:
// src/test/erasure-code/ErasureCodePluginExample.cc); also the template for
// future native codec plugins.  Port of ceph_tpu/native/plugin_xor.cpp.

#include "ec_plugin.h"

#include <cstdlib>
#include <cstring>
#include <new>

extern "C" {
void ec_region_xor(const uint8_t *const *srcs, int k, uint8_t *out, size_t n);
}

namespace {

int xor_encode(ec_codec *self, const uint8_t *const *data,
               uint8_t *const *coding, size_t chunk_len) {
  ec_region_xor(data, self->k, coding[0], chunk_len);
  return 0;
}

int xor_decode(ec_codec *self, uint8_t *const *chunks, const int *erased,
               size_t chunk_len) {
  int nerased = 0;
  int eid = -1;
  for (int i = 0; erased[i] != -1; ++i) {
    eid = erased[i];
    ++nerased;
  }
  if (nerased == 0) return 0;
  if (nerased > 1) return -1;  // m=1
  const uint8_t *srcs[256];
  int cnt = 0;
  for (int i = 0; i < self->k + self->m; ++i)
    if (i != eid) srcs[cnt++] = chunks[i];
  ec_region_xor(srcs, cnt, chunks[eid], chunk_len);
  return 0;
}

void xor_destroy(ec_codec *self) { delete self; }

ec_codec *xor_factory(const char *const *profile) {
  int k = 2;
  for (int i = 0; profile && profile[i]; ++i) {
    if (std::strncmp(profile[i], "k=", 2) == 0)
      k = std::atoi(profile[i] + 2);
  }
  if (k < 2) return nullptr;
  ec_codec *c = new (std::nothrow) ec_codec();
  if (!c) return nullptr;
  c->k = k;
  c->m = 1;
  c->priv = nullptr;
  c->encode = xor_encode;
  c->decode = xor_decode;
  c->destroy = xor_destroy;
  return c;
}

ec_plugin g_plugin = {"xor_native", xor_factory};

}  // namespace

extern "C" {

const char *__erasure_code_version() { return CEPH_TPU_EC_VERSION; }

int __erasure_code_init(const char *name, const char *dir) {
  (void)dir;
  return ec_registry_add(name, &g_plugin);
}

}  // extern "C"
