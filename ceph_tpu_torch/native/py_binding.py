"""Loader for the CPython C-API extension (the src/pybind role).

Port of ``ceph_tpu/native/py_binding.py``.  Builds ``_ec_native`` at first
use (``native/build.py``: ``py_ext.c`` with ``gf_kernels.cpp``, against
this interpreter's headers and extension suffix) and imports it from the
build directory; the module binds the native kernels through the C API
proper -- PyArg_Parse / buffer protocol / GIL release -- rather than
ctypes marshalling.
"""

from __future__ import annotations

import importlib.util

from ceph_tpu_torch.native import build as native_build


def load():
    so = native_build.py_ext()
    spec = importlib.util.spec_from_file_location("_ec_native", str(so))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
