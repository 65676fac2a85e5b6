"""Typed configuration schema + runtime config (options.cc / md_config_t
equivalents).

Port of ``ceph_tpu/utils/config.py``; the port keeps its own copy (its own
globals and its own environment prefix), so a process that imports both
packages does not cross-feed them.  The schema holds only the options the
port reads, under the reference's names, types, defaults and levels.

Reference: src/common/options.cc declares every option once with type,
default, level and description; src/common/config.cc layers conf-file /
env / CLI / runtime overrides with change observers.  Same shape here:
a single OPTIONS schema, a Config that validates against it, observer
callbacks on apply_changes, and typed get_val access.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Callable, Dict, List, Optional

LEVEL_BASIC = "basic"
LEVEL_ADVANCED = "advanced"
LEVEL_DEV = "dev"


@dataclasses.dataclass
class Option:
    name: str
    type: type
    default: Any
    level: str = LEVEL_ADVANCED
    description: str = ""
    see_also: tuple = ()


def _opt(name, typ, default, level=LEVEL_ADVANCED, desc="", see_also=()):
    return Option(name, typ, default, level, desc, see_also)


#: the schema: the options the port reads, each with the reference's name,
#: type, default and level (reference: src/common/options.cc).  A later
#: slice declares an option when it comes to read it.
OPTIONS: Dict[str, Option] = {
    o.name: o
    for o in [
        _opt("trace_mode", str, "sampled", LEVEL_ADVANCED,
             "end-to-end op tracing (utils/trace.py): 'off' mints no "
             "spans; 'sampled' traces one in trace_sample_every root "
             "ops; 'full' traces every op.  The sampling decision "
             "travels with the context, so a trace is always whole",
             see_also=("trace_sample_every", "trace_keep")),
        _opt("trace_sample_every", int, 64, LEVEL_ADVANCED,
             "in sampled trace_mode, one of this many root ops is "
             "traced (client ops and background batches roll "
             "independently)",
             see_also=("trace_mode",)),
        _opt("trace_keep", int, 256, LEVEL_ADVANCED,
             "finished spans retained in the bounded collector ring "
             "(oldest dropped and counted)",
             see_also=("trace_keep_slow",)),
        _opt("trace_keep_slow", int, 64, LEVEL_ADVANCED,
             "slowest finished root spans retained past ring churn "
             "(the optracker historic-slow discipline)",
             see_also=("trace_keep",)),
        _opt("profile_mode", str, "off", LEVEL_ADVANCED,
             "stage profiler (profiling/): 'off' (default -- "
             "instrumented seams cost one branch, allocate nothing) or "
             "'on' (stage cost ledger + event-loop/GC arms)"),
        _opt("ms_inject_socket_failures", int, 0, LEVEL_DEV,
             "inject a message drop roughly every N messages"),
        _opt("ms_inject_internal_delays", float, 0.0, LEVEL_DEV,
             "probability of injected message delay"),
    ]
}

#: environment layer: CEPH_TPU_TORCH_<NAME> (the JAX package reads
#: CEPH_TPU_<NAME>; the prefixes differ so an override meant for one
#: package does not reach the other)
ENV_PREFIX = "CEPH_TPU_TORCH_"


class Config:
    """Layered config with observers (md_config_t role)."""

    def __init__(self, overrides: Optional[Dict[str, Any]] = None):
        self._lock = threading.Lock()
        self._values: Dict[str, Any] = {}
        self._observers: List[Callable[[set], None]] = []
        for name, opt in OPTIONS.items():
            env = os.environ.get(ENV_PREFIX + name.upper())
            if env is not None:
                self._values[name] = self._coerce(opt, env)
        if overrides:
            for key, val in overrides.items():
                self.set_val(key, val)

    @staticmethod
    def _coerce(opt: Option, value: Any):
        if opt.type is bool and isinstance(value, str):
            return value.lower() in ("1", "true", "yes")
        return opt.type(value)

    def get_val(self, name: str):
        opt = OPTIONS.get(name)
        if opt is None:
            raise KeyError(f"no such option: {name}")
        with self._lock:
            return self._values.get(name, opt.default)

    def set_val(self, name: str, value) -> None:
        opt = OPTIONS.get(name)
        if opt is None:
            raise KeyError(f"no such option: {name}")
        with self._lock:
            self._values[name] = self._coerce(opt, value)

    def add_observer(self, fn: Callable[[set], None]) -> None:
        self._observers.append(fn)

    def apply_changes(self, changes: Dict[str, Any]) -> None:
        changed = set()
        for key, val in changes.items():
            self.set_val(key, val)
            changed.add(key)
        for fn in list(self._observers):  # snapshot: observers may
            fn(changed)                   # self-remove when their owner
                                          # was garbage-collected

    def show_config(self) -> Dict[str, Any]:
        return {name: self.get_val(name) for name in sorted(OPTIONS)}


_global: Optional[Config] = None
_global_lock = threading.Lock()


def get_config() -> Config:
    global _global
    with _global_lock:
        if _global is None:
            _global = Config()
        return _global
