"""The port's native dlopen plugin registry (``native/registry_native.py``
over ``libec_registry.so``, its plugins and fixtures, all built from
``ceph_tpu_torch/native/`` by ``native/build.py``).

Twin of ``tests/test_native_registry.py`` and of the native half of
``tests/test_regen.py``: the ``xor_native`` codec, the six failure codes of
the load handshake, the hang watchdog at the reference's 300 ms, and
``regen_native`` encoding and decoding bit for bit as the port's and the JAX
package's ``regen`` plugins on the same bytes (numpy, from a seed).  Last,
both packages' registries loaded into one process, in either order, each
registering its own plugins.
"""

import errno
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from ceph_tpu.plugins import registry as j_registry
from ceph_tpu_torch import __version__
from ceph_tpu_torch.native import build
from ceph_tpu_torch.native import registry_native as reg
from ceph_tpu_torch.plugins import registry

REPO = Path(__file__).resolve().parent.parent


def test_plugin_version_is_the_packages():
    header = (build.SOURCE_DIR / "ec_plugin.h").read_text()
    assert f'#define CEPH_TPU_EC_VERSION "{__version__}"' in header


def test_load_and_factory_xor():
    assert reg.load("xor_native") == 0
    codec = reg.factory("xor_native", {"k": "4"})
    assert codec.k == 4 and codec.m == 1
    rng = np.random.RandomState(0)
    data = [rng.randint(0, 256, 512).astype(np.uint8) for _ in range(4)]
    coding = codec.encode(data)
    assert np.array_equal(coding[0], data[0] ^ data[1] ^ data[2] ^ data[3])
    chunks = {i: d for i, d in enumerate(data)}
    chunks[4] = coding[0]
    del chunks[2]
    out = codec.decode(chunks, [2], 512)
    assert np.array_equal(out[2], data[2])
    with pytest.raises(RuntimeError, match="failed"):
        reg.factory("xor_native", {"k": "1"})


@pytest.mark.parametrize(
    "name,errno_expected",
    [
        ("missing_version_native", -errno.EXDEV),
        ("wrong_version_native", -errno.EXDEV),
        ("missing_entry_point_native", -errno.ENOENT),
        ("fail_to_initialize_native", -3),  # the fixture's own -ESRCH
        ("fail_to_register_native", -errno.EBADF),
        ("no_such_plugin_native", -errno.ENOENT),  # no file
    ],
)
def test_load_failures(name, errno_expected):
    rc = reg.load(name)
    assert rc == errno_expected, (name, rc, reg.last_error())
    assert name in reg.last_error()


def test_hanging_plugin_watchdog():
    """ErasureCodePluginHangs: a plugin that never returns from its load
    path reports -ETIMEDOUT at the deadline; the caller carries on."""
    t0 = time.monotonic()
    rc = reg.load_with_timeout("hangs_native", timeout_ms=300)
    took = time.monotonic() - t0
    assert rc == -errno.ETIMEDOUT, (rc, reg.last_error())
    assert 0.25 < took < 5.0
    assert "timed out" in reg.last_error()
    assert reg.load_with_timeout("xor_native", timeout_ms=5000) == 0


def _regen(reg_mod, **extra):
    return reg_mod.ErasureCodePluginRegistry().factory(
        "regen", {"k": "4", "m": "3", "technique": "product_matrix",
                  **extra})


def test_native_regen_matches_both_packages_regen():
    assert reg.load("regen_native") in (0, -errno.EEXIST)
    codec = reg.factory("regen_native", {"k": "4", "m": "3"})
    mine, theirs = _regen(registry, device="cpu"), _regen(j_registry)
    rng = np.random.default_rng(23)
    cs = mine.get_chunk_size(4000)
    assert cs == theirs.get_chunk_size(4000)
    data = [rng.integers(0, 256, cs, dtype=np.uint8) for _ in range(4)]
    stripe = np.concatenate(data).tobytes()
    port = mine.encode(set(range(7)), stripe)
    jax = theirs.encode(set(range(7)), stripe)
    native = codec.encode(data)
    for i in range(3):
        assert np.array_equal(native[i], port[4 + i]), i
        assert np.array_equal(native[i], jax[4 + i]), i
    chunks = {i: (data[i] if i < 4 else native[i - 4]) for i in range(7)}
    for lost in ([1, 4, 6], [0], [5, 6]):
        part = {i: c for i, c in chunks.items() if i not in lost}
        out = codec.decode(part, lost, cs)
        for g in lost:
            assert np.array_equal(out[g], chunks[g]), (lost, g)


@pytest.mark.parametrize("profile", [
    {"k": "4", "m": "3", "w": "16"},
    {"k": "4", "m": "2"},
    {"k": "1", "m": "3"},
    {"k": "4", "m": "3", "d": "5"},
    {"k": "4", "m": "3", "technique": "clay"},
])
def test_native_factory_refuses_bad_profiles(profile):
    assert reg.load("regen_native") in (0, -errno.EEXIST)
    with pytest.raises(RuntimeError):
        reg.factory("regen_native", profile)


_BOTH = r"""
import ctypes, sys
from ceph_tpu_torch.native import registry_native as reg
ref_dir = sys.argv[2]


def ref_load():
    # as ceph_tpu/native/registry_native.py loads its registry
    lib = ctypes.CDLL(ref_dir + "/libec_registry.so", mode=ctypes.RTLD_GLOBAL)
    lib.ec_registry_load.restype = ctypes.c_int
    lib.ec_registry_get.restype = ctypes.c_void_p
    assert lib.ec_registry_load(b"xor_native", ref_dir.encode()) == 0
    assert lib.ec_registry_get(b"xor_native")


def port_load():
    assert reg.load("xor_native") == 0, reg.last_error()
    assert reg.factory("xor_native", {"k": "3"}).k == 3
    assert reg.load("regen_native") == 0, reg.last_error()


for load in ([ref_load, port_load] if sys.argv[1] == "jax-first"
             else [port_load, ref_load]):
    load()
print("ok")
"""


@pytest.fixture(scope="module")
def jax_registry_build(tmp_path_factory):
    """The JAX package's registry, xor plugin and kernels, built by its own
    Makefile from its sources into a private directory."""
    out = tmp_path_factory.mktemp("jax_native")
    src = REPO / "ceph_tpu" / "native"
    for name in ("Makefile", "ec_plugin.h", "ec_registry.cpp",
                 "plugin_xor.cpp", "gf_kernels.cpp"):
        shutil.copy(src / name, out / name)
    subprocess.run(["make", "-C", str(out), "libec_kernels.so",
                    "libec_registry.so", "libec_xor_native.so"],
                   check=True, capture_output=True, timeout=300)
    return out


@pytest.mark.parametrize("order", ["jax-first", "port-first"])
def test_both_registries_in_one_process(order, jax_registry_build):
    """Each package's plugin registers in its own package's registry,
    whichever registry was loaded first (the port's stays out of the
    global symbol scope; its plugins bind to it first)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _BOTH, order, str(jax_registry_build)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"
