"""ctypes harness for the port's native (dlopen) plugin registry.

Port of ``ceph_tpu/native/registry_native.py``.  Drives the port's
``libec_registry.so`` the way the reference's daemons drive
ErasureCodePluginRegistry: load plugins by name from a directory (by
default the port's build directory, ``native/build.py``), get a codec via a
profile, run encode/decode through the C vtable.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from ceph_tpu_torch.analysis import residency
from ceph_tpu_torch.native import build as native_build


class _CodecStruct(ctypes.Structure):
    _fields_ = [
        ("k", ctypes.c_int),
        ("m", ctypes.c_int),
        ("priv", ctypes.c_void_p),
        ("encode", ctypes.c_void_p),
        ("decode", ctypes.c_void_p),
        ("destroy", ctypes.c_void_p),
    ]


_ENCODE_T = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.POINTER(_CodecStruct),
    ctypes.POINTER(ctypes.c_void_p),
    ctypes.POINTER(ctypes.c_void_p),
    ctypes.c_size_t,
)
_DECODE_T = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.POINTER(_CodecStruct),
    ctypes.POINTER(ctypes.c_void_p),
    ctypes.POINTER(ctypes.c_int),
    ctypes.c_size_t,
)


def _load() -> ctypes.CDLL:
    # RTLD_LOCAL (the reference loads it RTLD_GLOBAL): the plugins reach
    # this registry through their $ORIGIN DT_NEEDED entry and bind to it
    # first (ec_registry.cpp opens them with RTLD_DEEPBIND), so its
    # symbols stay out of the process's global scope, where they would
    # take the place of another registry's of the same names
    lib = ctypes.CDLL(str(native_build.library("registry")))
    lib.ec_registry_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.ec_registry_load.restype = ctypes.c_int
    lib.ec_registry_load_timeout.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.ec_registry_load_timeout.restype = ctypes.c_int
    lib.ec_registry_factory.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_char_p),
    ]
    lib.ec_registry_factory.restype = ctypes.POINTER(_CodecStruct)
    lib.ec_registry_last_error.restype = ctypes.c_char_p
    return lib


_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load()
            residency.note_library_build()
        return _lib


def plugin_dir() -> str:
    """The directory the port's plugins and fixtures are built into."""
    return str(native_build.native_dir())


def load(name: str, directory: Optional[str] = None) -> int:
    """Returns 0 or -errno (mirrors ErasureCodePluginRegistry::load)."""
    return lib().ec_registry_load(name.encode(),
                                  (directory or plugin_dir()).encode())


def load_with_timeout(name: str, timeout_ms: int = 5000,
                      directory: Optional[str] = None) -> int:
    """Watchdog load: -ETIMEDOUT when the plugin hangs in dlopen/init
    (the ErasureCodePluginHangs failure mode)."""
    return lib().ec_registry_load_timeout(
        name.encode(), (directory or plugin_dir()).encode(), timeout_ms)


def last_error() -> str:
    return lib().ec_registry_last_error().decode()


class NativeCodec:
    def __init__(self, struct_ptr):
        self._ptr = struct_ptr
        self.k = struct_ptr.contents.k
        self.m = struct_ptr.contents.m
        self._encode = ctypes.cast(struct_ptr.contents.encode, _ENCODE_T)
        self._decode = ctypes.cast(struct_ptr.contents.decode, _DECODE_T)

    def encode(self, data: Sequence[np.ndarray]) -> List[np.ndarray]:
        n = len(data[0])
        coding = [np.zeros(n, dtype=np.uint8) for _ in range(self.m)]
        dptr = (ctypes.c_void_p * self.k)(
            *[d.ctypes.data_as(ctypes.c_void_p) for d in data]
        )
        cptr = (ctypes.c_void_p * self.m)(
            *[c.ctypes.data_as(ctypes.c_void_p) for c in coding]
        )
        rc = self._encode(self._ptr, dptr, cptr, n)
        if rc:
            raise RuntimeError(f"native encode failed: {rc}")
        return coding

    def decode(
        self, chunks: Dict[int, np.ndarray], erased: Sequence[int], n: int
    ) -> Dict[int, np.ndarray]:
        km = self.k + self.m
        bufs = []
        for i in range(km):
            if i in chunks:
                bufs.append(np.ascontiguousarray(chunks[i], dtype=np.uint8))
            else:
                bufs.append(np.zeros(n, dtype=np.uint8))
        cptr = (ctypes.c_void_p * km)(
            *[b.ctypes.data_as(ctypes.c_void_p) for b in bufs]
        )
        earr = (ctypes.c_int * (len(erased) + 1))(*erased, -1)
        rc = self._decode(self._ptr, cptr, earr, n)
        if rc:
            raise RuntimeError(f"native decode failed: {rc}")
        return {i: bufs[i] for i in range(km)}


def factory(
    name: str, profile: Dict[str, str], directory: Optional[str] = None
) -> NativeCodec:
    items = [f"{k}={v}".encode() for k, v in profile.items()]
    arr = (ctypes.c_char_p * (len(items) + 1))(*items, None)
    ptr = lib().ec_registry_factory(name.encode(),
                                    (directory or plugin_dir()).encode(), arr)
    if not ptr:
        raise RuntimeError(f"factory({name}) failed: {last_error()}")
    return NativeCodec(ptr)
