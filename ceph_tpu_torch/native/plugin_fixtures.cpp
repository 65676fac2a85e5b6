// Broken-plugin fixtures for registry failure-path tests (reference:
// src/test/erasure-code/ErasureCodePluginMissingEntryPoint.cc etc.).
// Compiled into several .so's selected by -D flags (native/build.py).
// Port of ceph_tpu/native/plugin_fixtures.cpp.

#include "ec_plugin.h"

#if defined(FIXTURE_MISSING_VERSION)
// no version symbol at all
extern "C" int __erasure_code_init(const char *, const char *) { return 0; }

#elif defined(FIXTURE_WRONG_VERSION)
extern "C" const char *__erasure_code_version() { return "an older version"; }
extern "C" int __erasure_code_init(const char *, const char *) { return 0; }

#elif defined(FIXTURE_MISSING_ENTRY_POINT)
extern "C" const char *__erasure_code_version() { return CEPH_TPU_EC_VERSION; }
// no init symbol

#elif defined(FIXTURE_FAIL_TO_INITIALIZE)
extern "C" const char *__erasure_code_version() { return CEPH_TPU_EC_VERSION; }
extern "C" int __erasure_code_init(const char *, const char *) { return -3; }

#elif defined(FIXTURE_FAIL_TO_REGISTER)
extern "C" const char *__erasure_code_version() { return CEPH_TPU_EC_VERSION; }
extern "C" int __erasure_code_init(const char *, const char *) { return 0; }

#elif defined(FIXTURE_HANGS)
// hangs inside the load path forever (the ErasureCodePluginHangs role:
// the reference's fixture sleeps in dlopen; hanging in init exercises
// the same watchdog contract)
#include <unistd.h>
extern "C" const char *__erasure_code_version() { return CEPH_TPU_EC_VERSION; }
extern "C" int __erasure_code_init(const char *, const char *) {
  for (;;) sleep(3600);
  return 0;
}
#endif
