// Native erasure-code plugin ABI + registry (C++ twin of the Python
// registry in ceph_tpu_torch/plugins/registry.py; port of
// ceph_tpu/native/ec_plugin.h).
//
// Mirrors the reference's dlopen plugin protocol (reference:
// src/erasure-code/ErasureCodePlugin.h:24-27 C entry points,
// ErasureCodePlugin.cc:126-184 load/version handshake): a plugin is a
// shared object named libec_<name>.so exposing
//
//   const char *__erasure_code_version();       // must equal ours (-EXDEV)
//   int __erasure_code_init(const char *name, const char *dir);
//                                               // must register (-EBADF)
//
// The registry is a process singleton guarded by a mutex; codecs are
// exposed through a plain C vtable so both C++ callers and Python (ctypes)
// can drive them.

#ifndef CEPH_TPU_EC_PLUGIN_H
#define CEPH_TPU_EC_PLUGIN_H

#include <cstddef>
#include <cstdint>

#define CEPH_TPU_EC_VERSION "0.1.0"

extern "C" {

// codec vtable: a plugin's factory fills this in
struct ec_codec {
  int k;
  int m;
  void *priv;
  // encode: data[k] chunk pointers, coding[m] outputs, chunk_len bytes each
  int (*encode)(struct ec_codec *self, const uint8_t *const *data,
                uint8_t *const *coding, size_t chunk_len);
  // decode: chunks[k+m] pointers (erased ones writable, present read-only),
  // erased[] = ids terminated by -1
  int (*decode)(struct ec_codec *self, uint8_t *const *chunks,
                const int *erased, size_t chunk_len);
  void (*destroy)(struct ec_codec *self);
};

struct ec_plugin {
  const char *name;
  // factory: profile as NULL-terminated array of "key=value" strings
  struct ec_codec *(*factory)(const char *const *profile);
};

// registry API (exported by libec_registry.so)
int ec_registry_add(const char *name, struct ec_plugin *plugin);
struct ec_plugin *ec_registry_get(const char *name);
// load resolves <dir>/libec_<name>.so; returns 0 or -errno
// (-EXDEV version mismatch, -ENOENT missing entry point/file,
//  -EBADF loaded but did not register)
int ec_registry_load(const char *name, const char *dir);

// watchdog load: -ETIMEDOUT when the plugin hangs in dlopen/init
// (the ErasureCodePluginHangs failure mode; the stuck worker thread is
// detached -- it cannot be cancelled safely)
int ec_registry_load_timeout(const char *name, const char *dir,
                             int timeout_ms);
struct ec_codec *ec_registry_factory(const char *name, const char *dir,
                                     const char *const *profile);
const char *ec_registry_last_error(void);

}  // extern "C"

#endif  // CEPH_TPU_EC_PLUGIN_H
