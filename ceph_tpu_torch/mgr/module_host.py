"""Mgr python-module host (reference: src/mgr/PyModuleRegistry.cc +
ActivePyModules.cc + src/pybind/mgr/mgr_module.py).

The reference mgr is a *platform*: modules (prometheus, status, balancer,
dashboard...) subclass ``MgrModule``, are loaded by name from the
``mgr_modules`` config option, and talk to the cluster exclusively
through the host surface -- ``get(what)`` for cluster state, ``notify``
for event push, ``set_health_checks`` to raise module-owned health,
``handle_command`` for CLI verbs, and an optional long-running
``serve()`` loop.  Same contract here; third-party modules load from any
importable dotted path (the pybind/mgr sys.path role), builtin modules
from ``ceph_tpu_torch.mgr.mgr_modules.<name>``.  Each module's entry
point is a class named ``Module`` subclassing ``MgrModule``.

Port of ``ceph_tpu/mgr/module_host.py``.
"""

from __future__ import annotations

import asyncio
import importlib
from typing import Dict, List, Optional

from ceph_tpu_torch.mgr.mgr import ClusterState, health_checks

BUILTIN_PACKAGE = "ceph_tpu_torch.mgr.mgr_modules"


class MgrModule:
    """Base class every mgr module subclasses (mgr_module.py MgrModule)."""

    NAME = "module"

    def __init__(self, host: "PyModuleRegistry"):
        self._host = host
        self._health: Dict[str, dict] = {}

    # -- host surface ------------------------------------------------------

    def get(self, what: str):
        """Cluster state by key ("osd_stats", "pools", "health",
        "degraded_objects", "scrub_inconsistent", "dump" for everything)
        -- the ActivePyModules::get_python role."""
        return self._host.get(what)

    def get_config(self, key: str, default=None):
        return self._host.module_config.get(self.NAME, {}).get(key, default)

    def set_config(self, key: str, value) -> None:
        self._host.module_config.setdefault(self.NAME, {})[key] = value

    def set_health_checks(self, checks: Dict[str, dict]) -> None:
        """Module-owned health checks merged into the cluster health
        (MgrModule.set_health_checks)."""
        self._health = dict(checks)

    # -- module hooks ------------------------------------------------------

    def notify(self, what: str, ident) -> None:
        """Event push ("osd_map", "health", "pg_summary"...)."""

    def handle_command(self, cmd: dict):
        """CLI verb dispatch; return (retcode, out, status_string)."""
        return -22, "", f"module {self.NAME} has no commands"

    async def serve(self) -> None:
        """Optional long-running loop (dashboard/prometheus server role)."""

    def shutdown(self) -> None:
        """Called when the host stops."""


class PyModuleRegistry:
    """Loads, hosts and routes to mgr modules (PyModuleRegistry +
    ActivePyModules)."""

    def __init__(self, cluster, modules: Optional[List[str]] = None):
        self.state = ClusterState(cluster)
        self.module_config: Dict[str, dict] = {}
        self.modules: Dict[str, MgrModule] = {}
        self._serve_tasks: List[asyncio.Task] = []
        if modules is None:
            from ceph_tpu_torch.utils.config import get_config

            modules = str(get_config().get_val("mgr_modules")).split()
        for name in modules:
            self.load(name)

    # -- loading -----------------------------------------------------------

    def load(self, name: str) -> MgrModule:
        """Load a module by bare name (builtin) or dotted path
        (third-party); its ``Module`` class is instantiated against this
        host.  Raises ImportError/TypeError on a broken module -- the
        registry's error paths are testable like the EC plugin loader's."""
        target = name if "." in name else f"{BUILTIN_PACKAGE}.{name}"
        py = importlib.import_module(target)
        cls = getattr(py, "Module", None)
        if cls is None or not issubclass(cls, MgrModule):
            raise TypeError(
                f"mgr module {name!r} has no Module(MgrModule) class"
            )
        mod = cls(self)
        # NAME from the subclass itself; an inherited default means the
        # module didn't set one -> use the dotted-path tail
        mod.NAME = cls.__dict__.get("NAME") or name.rsplit(".", 1)[-1]
        self.modules[mod.NAME] = mod
        return mod

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        for mod in self.modules.values():
            self._serve_tasks.append(
                asyncio.get_event_loop().create_task(mod.serve())
            )

    async def stop(self) -> None:
        for t in self._serve_tasks:
            t.cancel()
        for t in self._serve_tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        self._serve_tasks.clear()
        for mod in self.modules.values():
            mod.shutdown()

    # -- host services -----------------------------------------------------

    def get(self, what: str):
        if what == "dump":
            return self.state.dump()
        if what == "osd_stats":
            return self.state.osd_stats()
        if what == "pools":
            return self.state.pool_stats()
        if what == "degraded_objects":
            return self.state.degraded_objects()
        if what == "scrub_inconsistent":
            return self.state.scrub_inconsistent()
        if what == "health":
            return self.gather_health()
        raise KeyError(what)

    def gather_health(self, dump: Optional[dict] = None) -> dict:
        """Cluster health = base checks merged with every module's
        raised checks (ClusterState::update + module health).  Pass an
        already-computed ``dump`` to avoid a second full state walk."""
        from ceph_tpu_torch.mgr.pgmap import fold_health

        base = health_checks(dump if dump is not None else self.state.dump())
        checks = dict(base["checks"])
        for mod in self.modules.values():
            checks.update(mod._health)
        return fold_health(checks)

    def notify_all(self, what: str, ident=None) -> None:
        for mod in self.modules.values():
            try:
                mod.notify(what, ident)
            except Exception:  # noqa: BLE001 -- a module crash must not
                pass          # take down the host (ActivePyModules)

    def handle_command(self, cmd: dict):
        """Route ``{"prefix": "<module> <verb>", ...}`` to its module."""
        prefix = cmd.get("prefix", "")
        mod_name = prefix.split(" ", 1)[0]
        mod = self.modules.get(mod_name)
        if mod is None:
            return -2, "", f"no mgr module {mod_name!r}"
        return mod.handle_command(cmd)
