"""Fixture: torch-recompile-hazard (presented under a ceph_tpu_torch/ops
path): compile and library-build work reachable per call."""
import ctypes
import functools

import torch

from ceph_tpu_torch.analysis import residency

_lib = None
_libs = {}


def _plain(x):
    return x ^ 1


_COMPILED = torch.compile(_plain)  # module level: once


def encode(x):
    fn = torch.compile(_plain)  # LINT: torch-recompile-hazard
    return fn(x)


def builder():
    return torch.compile(_plain)  # the caller caches the result: clean


class Engine:
    def __init__(self):
        self._fn = torch.compile(_plain)  # stored on the object: clean

    def run(self, x):
        return self._fn(x)


def lib():
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL("libgf.so")  # cache-miss guard: clean
        residency.note_library_build()
    return _lib


def load(key):
    if key not in _libs:
        _libs[key] = _open(key)  # the helper runs on a miss only
    return _libs[key]


def _open(key):
    residency.note_library_build()  # reached only from load()'s miss
    return ctypes.CDLL(key)


@functools.lru_cache(maxsize=None)
def cached(key):
    return ctypes.CDLL(key)  # an lru_cache'd builder: clean


def per_call(x, path):
    lib_ = ctypes.CDLL(path)  # LINT: torch-recompile-hazard
    residency.note_library_build()  # LINT: torch-recompile-hazard
    return lib_.run(x)
