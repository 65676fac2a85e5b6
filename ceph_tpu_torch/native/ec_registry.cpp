// Native plugin registry implementation (see ec_plugin.h).
//
// Reference behavior being mirrored: ErasureCodePluginRegistry::load
// (src/erasure-code/ErasureCodePlugin.cc:126-184): dlopen, version symbol
// check (mismatch -> -EXDEV), init entry point (missing -> -ENOENT, error
// propagates), registered-check (-EBADF), mutex-guarded singleton state.
//
// Port of ceph_tpu/native/ec_registry.cpp.  One difference: a plugin is
// opened with RTLD_DEEPBIND, so that its ec_registry_add (and, for the xor
// plugin, ec_region_xor) bind to the libraries it names in DT_NEEDED --
// this registry and its kernels, found through $ORIGIN -- before any
// library of the same symbols that another component loaded with
// RTLD_GLOBAL into the process.  With plain RTLD_NOW a plugin would
// register itself in whichever registry was first in the global scope.

#include "ec_plugin.h"

#include <dlfcn.h>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>

namespace {

std::mutex g_lock;
std::map<std::string, ec_plugin *> g_plugins;
thread_local std::string g_last_error;

void set_error(const std::string &msg) { g_last_error = msg; }

}  // namespace

extern "C" {

const char *ec_registry_last_error(void) { return g_last_error.c_str(); }

int ec_registry_add(const char *name, struct ec_plugin *plugin) {
  std::lock_guard<std::mutex> l(g_lock);
  if (g_plugins.count(name)) {
    set_error(std::string(name) + " already registered");
    return -EEXIST;
  }
  g_plugins[name] = plugin;
  return 0;
}

struct ec_plugin *ec_registry_get(const char *name) {
  std::lock_guard<std::mutex> l(g_lock);
  auto it = g_plugins.find(name);
  return it == g_plugins.end() ? nullptr : it->second;
}

int ec_registry_load(const char *name, const char *dir) {
  {
    std::lock_guard<std::mutex> l(g_lock);
    if (g_plugins.count(name)) return 0;
  }
  std::string path = std::string(dir) + "/libec_" + name + ".so";
  void *handle = dlopen(path.c_str(), RTLD_NOW | RTLD_DEEPBIND);
  if (!handle) {
    set_error(std::string("dlopen(") + path + "): " + dlerror());
    return -ENOENT;
  }
  using version_fn = const char *(*)();
  auto version =
      reinterpret_cast<version_fn>(dlsym(handle, "__erasure_code_version"));
  if (!version) {
    set_error(std::string(name) +
              " plugin has no version (loaded from an older version?)");
    dlclose(handle);
    return -EXDEV;
  }
  if (std::strcmp(version(), CEPH_TPU_EC_VERSION) != 0) {
    set_error(std::string(name) + " version " + version() +
              " != expected " CEPH_TPU_EC_VERSION);
    dlclose(handle);
    return -EXDEV;
  }
  using init_fn = int (*)(const char *, const char *);
  auto init =
      reinterpret_cast<init_fn>(dlsym(handle, "__erasure_code_init"));
  if (!init) {
    set_error(std::string(name) + " plugin is missing the entry point");
    dlclose(handle);
    return -ENOENT;
  }
  int r = init(name, dir);
  if (r < 0) {
    set_error(std::string(name) + " init failed");
    dlclose(handle);
    return r;
  }
  {
    std::lock_guard<std::mutex> l(g_lock);
    if (!g_plugins.count(name)) {
      set_error(std::string(name) +
                " initialized but did not register itself");
      dlclose(handle);
      return -EBADF;
    }
  }
  // handle intentionally kept open (disable_dlclose semantics: plugins
  // stay mapped for the process lifetime, reference ErasureCodePlugin.h:49)
  return 0;
}

int ec_registry_load_timeout(const char *name, const char *dir,
                             int timeout_ms) {
  // The reference's "plugin hangs in dlopen" failure mode
  // (src/test/erasure-code/ErasureCodePluginHangs.cc): a load that
  // never returns must not wedge the daemon.  Run the load on a worker
  // thread and give up at the deadline; the worker stays detached (a
  // thread stuck inside dlopen/init cannot be cancelled safely), the
  // caller treats the plugin as failed and carries on.
  struct State {
    std::mutex m;
    std::condition_variable cv;
    bool done = false;
    int rc = 0;
    std::string error;  // g_last_error is thread_local: the worker's
                        // message must travel back explicitly
  };
  auto st = std::make_shared<State>();
  std::string n = name, d = dir;
  std::thread([st, n, d]() {
    int r = ec_registry_load(n.c_str(), d.c_str());
    std::lock_guard<std::mutex> l(st->m);
    st->rc = r;
    st->error = g_last_error;
    st->done = true;
    st->cv.notify_all();
  }).detach();
  std::unique_lock<std::mutex> l(st->m);
  if (!st->cv.wait_for(l, std::chrono::milliseconds(timeout_ms),
                       [&] { return st->done; })) {
    set_error(std::string(name) + " load timed out (hung in dlopen/init)");
    return -ETIMEDOUT;
  }
  if (st->rc < 0) set_error(st->error);
  return st->rc;
}

struct ec_codec *ec_registry_factory(const char *name, const char *dir,
                                     const char *const *profile) {
  if (!ec_registry_get(name)) {
    int r = ec_registry_load(name, dir);
    if (r < 0) return nullptr;
  }
  ec_plugin *plugin = ec_registry_get(name);
  if (!plugin) return nullptr;
  return plugin->factory(profile);
}

}  // extern "C"
