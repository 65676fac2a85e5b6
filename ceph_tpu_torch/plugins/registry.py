"""Erasure-code plugin registry.

Mirrors the reference's dlopen-based singleton registry semantics
(reference: src/erasure-code/ErasureCodePlugin.{h,cc}):

* ``factory()`` loads a plugin once, instantiates a codec through it, and
  verifies the instance's profile equals the requested profile
  (ErasureCodePlugin.cc:92-120);
* ``load()`` resolves ``ec_<name>`` from a plugin directory (the analogue of
  dlopen("<dir>/libec_<name>.so")), checks the plugin's version string
  against ours (mismatch -> -EXDEV), then calls its entry point which must
  register itself (missing entry point -> -ENOENT, registers nothing ->
  -EBADF, init failure propagates);
* ``preload()`` loads a configured list at startup
  (ErasureCodePlugin.cc:186).

Built-in plugins ship as modules in this package; out-of-tree plugins are
python files ``ec_<name>.py`` in ``directory``.  Loading native
``libec_<name>.so`` plugins is not part of the port yet (ROADMAP.md queue
1 item 6).
"""

from __future__ import annotations

import errno as _errno
import importlib
import importlib.util
import os
import threading
from typing import Dict, Optional

from ceph_tpu_torch import __version__
from ceph_tpu_torch.plugins.interface import (
    ErasureCodeError,
    ErasureCodeInterface,
    ErasureCodeProfile,
)

#: entry-point names an out-of-tree plugin module must define
ENTRY_POINT = "__erasure_code_init__"
VERSION_POINT = "__erasure_code_version__"

#: built-in plugin name -> module path
_BUILTIN = {
    "jerasure": "ceph_tpu_torch.plugins.jerasure",
    "isa": "ceph_tpu_torch.plugins.isa",
    "shec": "ceph_tpu_torch.plugins.shec",
    "lrc": "ceph_tpu_torch.plugins.lrc",
    "cuda": "ceph_tpu_torch.plugins.cuda",
    "regen": "ceph_tpu_torch.plugins.regen",
    "example": "ceph_tpu_torch.plugins.example",
}

#: osd_erasure_code_plugins analogue: the card's plugin in the JAX
#: package's "tpu" slot
DEFAULT_PLUGINS = "jerasure lrc isa cuda"

class ErasureCodePlugin:
    """Base class every plugin registers an instance of."""

    def factory(
        self, directory: str, profile: ErasureCodeProfile
    ) -> ErasureCodeInterface:
        raise NotImplementedError


class ErasureCodePluginRegistry:
    """Process-wide singleton (reference ErasureCodePlugin.h:45)."""

    _instance: Optional["ErasureCodePluginRegistry"] = None
    _instance_lock = threading.Lock()
    #: registry currently executing a plugin entry point; lets plugin modules
    #: resolve `instance()` to the loader even in tests that use a private
    #: registry (the reference's C entry points hit the process singleton)
    _current_loading: Optional["ErasureCodePluginRegistry"] = None

    def __init__(self):
        self._lock = threading.RLock()
        self._plugins: Dict[str, ErasureCodePlugin] = {}

    @classmethod
    def instance(cls) -> "ErasureCodePluginRegistry":
        if cls._current_loading is not None:
            return cls._current_loading
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    # -- registration ------------------------------------------------------

    def add(self, name: str, plugin: ErasureCodePlugin) -> None:
        with self._lock:
            if name in self._plugins:
                raise ErasureCodeError(_errno.EEXIST, f"plugin {name} already registered")
            self._plugins[name] = plugin

    def get(self, name: str) -> Optional[ErasureCodePlugin]:
        with self._lock:
            return self._plugins.get(name)

    # -- loading -----------------------------------------------------------

    def load(self, plugin_name: str, directory: str = "") -> ErasureCodePlugin:
        """Resolve and initialize plugin code (analogue of dlopen+handshake)."""
        with self._lock:
            ErasureCodePluginRegistry._current_loading = self
            try:
                module = self._resolve(plugin_name, directory)
                version_fn = getattr(module, VERSION_POINT, None)
                if version_fn is None:
                    raise ErasureCodeError(
                        _errno.EXDEV,
                        f"{plugin_name} plugin has no version (loaded from an older version?)",
                    )
                version = version_fn()
                if version != __version__:
                    raise ErasureCodeError(
                        _errno.EXDEV,
                        f"{plugin_name} version {version} != expected {__version__}",
                    )
                init_fn = getattr(module, ENTRY_POINT, None)
                if init_fn is None:
                    raise ErasureCodeError(
                        _errno.ENOENT,
                        f"{plugin_name} plugin is missing the {ENTRY_POINT} entry point",
                    )
                rc = init_fn(plugin_name, directory)
                if isinstance(rc, int) and rc < 0:
                    raise ErasureCodeError(rc, f"{plugin_name} init returned {rc}")
                plugin = self._plugins.get(plugin_name)
                if plugin is None:
                    raise ErasureCodeError(
                        _errno.EBADF,
                        f"{plugin_name} initialized but did not register itself",
                    )
                return plugin
            finally:
                ErasureCodePluginRegistry._current_loading = None

    def _resolve(self, plugin_name: str, directory: str):
        if directory:
            path = os.path.join(directory, f"ec_{plugin_name}.py")
            if os.path.exists(path):
                spec = importlib.util.spec_from_file_location(
                    f"ec_{plugin_name}", path
                )
                module = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(module)
                return module
        modpath = _BUILTIN.get(plugin_name)
        if modpath is None:
            raise ErasureCodeError(
                _errno.ENOENT, f"no plugin {plugin_name} in directory {directory!r}"
            )
        return importlib.import_module(modpath)

    # -- the main entry point ---------------------------------------------

    def factory(
        self,
        plugin_name: str,
        profile: ErasureCodeProfile,
        directory: str = "",
    ) -> ErasureCodeInterface:
        plugin = self.get(plugin_name)
        if plugin is None:
            plugin = self.load(plugin_name, directory)
        ec = plugin.factory(directory, profile)
        if profile != ec.get_profile():
            raise ErasureCodeError(
                _errno.EINVAL,
                f"profile {profile} != get_profile() {ec.get_profile()}",
            )
        return ec

    def preload(self, plugins: str = DEFAULT_PLUGINS,
                directory: str = "") -> None:
        """Load a space/comma-separated plugin list at daemon start."""
        for name in plugins.replace(",", " ").split():
            if not self.get(name):
                self.load(name, directory)


def instance() -> ErasureCodePluginRegistry:
    return ErasureCodePluginRegistry.instance()
