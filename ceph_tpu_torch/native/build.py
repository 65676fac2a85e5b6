"""Build the port's native host libraries from the C++ sources beside it.

Port of the targets of ``ceph_tpu/native/Makefile``: ``libec_kernels.so``
(the GF(2^8) region kernels behind ``backend=native``),
``libec_registry.so`` (the dlopen plugin registry), the plugins
``libec_xor_native.so`` and ``libec_regen_native.so``, the six broken-plugin
fixtures (``plugin_fixtures.cpp`` under one ``-DFIXTURE_*`` flag each) and,
on demand, the CPython extension ``_ec_native`` (``py_ext.c``).

Everything is compiled with the host ``g++`` (``$CXX``, else ``g++`` or
``c++``) at first use into one directory, ``ceph_tpu_torch/build/
ec_native-<digest>/``, keyed by a digest of the sources, the flags, the
compiler and the host CPU (``-march=native`` makes a build for one CPU; a
host with another CPU builds its own copy).  A missing compiler or a failed
build raises: nothing falls back to numpy or to a prebuilt library.

The registry and the kernels carry the soname ``$ORIGIN/<file>``, so the
plugins that link them name them by that path in ``DT_NEEDED``.  The loader
expands it to this directory: a plugin always maps this build's registry
and kernels, never a library of the same file name that another component
already loaded (the loader matches a bare ``DT_NEEDED`` name against the
libraries in the process before it searches the rpath).  Both are linked
with ``-Bsymbolic``, so their own calls between exported functions stay
inside them.
"""

from __future__ import annotations

import hashlib
import os
import platform
import shutil
import subprocess
import sys
import sysconfig
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Tuple

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = SOURCE_DIR.parent / "build"
SOURCES = ("gf_kernels.cpp", "ec_plugin.h", "ec_registry.cpp",
           "plugin_xor.cpp", "plugin_regen.cpp", "plugin_fixtures.cpp",
           "py_ext.c")
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-march=native")

#: fixture plugin name -> the -D flag that selects it in plugin_fixtures.cpp
FIXTURES = {
    "missing_version_native": "FIXTURE_MISSING_VERSION",
    "wrong_version_native": "FIXTURE_WRONG_VERSION",
    "missing_entry_point_native": "FIXTURE_MISSING_ENTRY_POINT",
    "fail_to_initialize_native": "FIXTURE_FAIL_TO_INITIALIZE",
    "fail_to_register_native": "FIXTURE_FAIL_TO_REGISTER",
    "hangs_native": "FIXTURE_HANGS",
}

_lock = threading.Lock()


def compiler() -> str:
    """The host C++ compiler, or RuntimeError."""
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler found ($CXX, g++, c++): the native "
                       "libraries of ceph_tpu_torch cannot be built")


def _cpuinfo() -> dict:
    """The first processor's fields of ``/proc/cpuinfo`` (empty if none)."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                info.setdefault(key.strip(), val.strip())
    except OSError:
        pass
    return info


def cpu_model() -> str:
    """The host CPU's model name, or, where ``/proc/cpuinfo`` gives none
    (some virtualized hosts report ``unknown``), its vendor, family, model
    and clock."""
    info = _cpuinfo()
    name = info.get("model name", "")
    if name and name != "unknown":
        return name
    return (f"{info.get('vendor_id', platform.processor() or '?')} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')} "
            f"at {info.get('cpu MHz', '?')} MHz (model name "
            f"{name or 'absent'})")


def host_cpu() -> str:
    """The host CPU's identity and feature flags (not its clock, which
    varies): part of the build's key."""
    info = _cpuinfo()
    ident = " ".join(info.get(key, "?") for key in (
        "vendor_id", "cpu family", "model", "model name"))
    return f"{platform.machine()} | {ident} | {info.get('flags', '')}"


def digest(cxx: str) -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode() + b"\0" + (SOURCE_DIR / name).read_bytes())
    h.update(" ".join(CXXFLAGS).encode() + b"\0" + cxx.encode() + b"\0")
    h.update(host_cpu().encode())
    return h.hexdigest()[:16]


def _lib(name: str) -> str:
    return f"libec_{name}.so"


def commands(cxx: str) -> Tuple[List[List[str]], List[List[str]]]:
    """The two stages of compiler commands, run in the output directory:
    the kernels, the registry and the fixtures, then the plugins that link
    the first two."""
    src = {name: str(SOURCE_DIR / name) for name in SOURCES}
    base = [cxx, *CXXFLAGS, "-shared"]
    first = [
        base + ["-Wl,-soname,$ORIGIN/libec_kernels.so", "-Wl,-Bsymbolic",
                "-o", "libec_kernels.so", src["gf_kernels.cpp"]],
        base + ["-Wl,-soname,$ORIGIN/libec_registry.so", "-Wl,-Bsymbolic",
                "-o", "libec_registry.so", src["ec_registry.cpp"], "-ldl"],
        *(base + [f"-D{flag}", "-o", _lib(name), src["plugin_fixtures.cpp"]]
          for name, flag in FIXTURES.items()),
    ]
    # -rpath $ORIGIN as the reference's Makefile links them; the DT_NEEDED
    # entries are paths ($ORIGIN/...), which the loader takes as they are
    second = [
        base + ["-o", _lib("xor_native"), src["plugin_xor.cpp"], "-L.",
                "-l:libec_registry.so", "-l:libec_kernels.so",
                "-Wl,-rpath,$ORIGIN"],
        base + ["-o", _lib("regen_native"), src["plugin_regen.cpp"], "-L.",
                "-l:libec_registry.so", "-Wl,-rpath,$ORIGIN"],
    ]
    return first, second


def _run(cmd: List[str], cwd: Path) -> None:
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr}")


def native_dir() -> Path:
    """The built directory (built at the first call in a checkout)."""
    with _lock:
        cxx = compiler()
        out = BUILD_DIR / f"ec_native-{digest(cxx)}"
        if (out / _lib("xor_native")).exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / (f".{out.name}.{os.getpid()}."
                           f"{threading.get_ident()}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        try:
            for stage in commands(cxx):
                with ThreadPoolExecutor(len(stage)) as pool:
                    list(pool.map(lambda c: _run(c, tmp), stage))
            try:
                os.rename(tmp, out)
            except OSError:
                if not (out / _lib("xor_native")).exists():
                    raise
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return out


def library(name: str) -> Path:
    """Path of one built library: ``kernels``, ``registry``, a plugin or a
    fixture (``libec_<name>.so``)."""
    return native_dir() / _lib(name)


def py_ext() -> Path:
    """Build the CPython extension ``_ec_native`` (``py_ext.c`` with
    ``gf_kernels.cpp``) against this interpreter's headers, into the
    native directory, and return its path."""
    out = native_dir()
    suffix = sysconfig.get_config_var("EXT_SUFFIX")
    so = out / f"_ec_native{suffix}"
    with _lock:
        if so.exists():
            return so
        tmp = so.with_name(f".{so.name}.{os.getpid()}."
                           f"{threading.get_ident()}.tmp")
        _run([compiler(), *CXXFLAGS, "-shared", "-Wl,-Bsymbolic", "-o",
              str(tmp), str(SOURCE_DIR / "py_ext.c"),
              str(SOURCE_DIR / "gf_kernels.cpp"),
              f"-I{sysconfig.get_paths()['include']}"], out)
        os.replace(tmp, so)
        return so


if __name__ == "__main__":
    print(native_dir())
    if "--py-ext" in sys.argv[1:]:
        print(py_ext())
