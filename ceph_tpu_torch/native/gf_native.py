"""crc32c for the port's host path: a small C library and its plain twin.

Port of the crc half of ``ceph_tpu/native/gf_native.py`` (``crc32c``,
``crc32c_rows``; C body ``ec_crc32c``).  The GF region operations of that
library are not part of the port: the codec runs on the card.

``crc32c.c`` beside this file is compiled with the host C compiler
(``$CC``, else ``cc``) at first use into ``ceph_tpu_torch/build/`` and
loaded with ctypes.  On x86 it is built with ``-msse4.2`` (eight bytes an
instruction); elsewhere it takes its byte-table path.  A failed build
raises: at 4 MiB objects the plain version would set the time of the
commit stage, so nothing falls back to it quietly.  :func:`crc32c_plain`
is the table algorithm in Python, which the tests and ``chip_smoke.py``
hold the library against.

Castagnoli polynomial, Ceph's initial value -1, no final xor-out, so
``crc32c(b, crc32c(a)) == crc32c(a + b)``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List

import numpy as np

from ceph_tpu_torch.analysis import residency

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "crc32c.c"
BUILD_DIR = _DIR.parent / "build"
CFLAGS = ("-O2", "-shared", "-fPIC") + (
    ("-msse4.2",) if platform.machine() in ("x86_64", "AMD64") else ())

_lock = threading.Lock()
_lib = None


def _compiler() -> str:
    for name in (os.environ.get("CC"), "cc", "gcc"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C compiler found: crc32c cannot be built")


def build() -> Path:
    """Compile ``crc32c.c`` into ``build/`` (keyed by the digest of the
    source and the flags) and return the library path."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(b"\0" + " ".join(CFLAGS).encode())
    lib = BUILD_DIR / f"libcrc32c-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(
        f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([_compiler(), *CFLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cc failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The built library, loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name in ("crc32c_sse42_built", "crc32c_sse42_present"):
                getattr(lib, name).restype = ctypes.c_int
                getattr(lib, name).argtypes = []
            if lib.crc32c_sse42_built() and not lib.crc32c_sse42_present():
                raise OSError("crc32c was built for SSE4.2, which this CPU "
                              "lacks")
            lib.ceph_crc32c.restype = ctypes.c_uint32
            lib.ceph_crc32c.argtypes = [ctypes.c_uint32, ctypes.c_void_p,
                                        ctypes.c_size_t]
            _lib = lib
            residency.note_library_build()
        return _lib


def sse42() -> bool:
    """True when the loaded build folds with SSE4.2."""
    return bool(library().crc32c_sse42_built())


def crc32c(data, crc: int = 0xFFFFFFFF) -> int:
    """crc32c-castagnoli of ``data`` (bytes, bytearray, memoryview or a
    numpy array), chained from ``crc``."""
    fn = library().ceph_crc32c
    if type(data) is bytes:
        return int(fn(crc, data, len(data)))
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytearray, memoryview)
    ) else np.ascontiguousarray(data, dtype=np.uint8)
    return int(fn(crc, arr.ctypes.data, arr.size))


def crc32c_rows(chunks, crcs) -> List[int]:
    """``[crc32c(c, v) for c, v in zip(chunks, crcs)]`` with the wrapper
    work hoisted out of the loop (the commit path crc's k+m chunks an
    object)."""
    fn = library().ceph_crc32c
    out = []
    for chunk, crc in zip(chunks, crcs):
        arr = chunk if isinstance(chunk, np.ndarray) else \
            np.frombuffer(chunk, dtype=np.uint8)
        if not arr.flags.c_contiguous:
            arr = np.ascontiguousarray(arr)
        out.append(int(fn(crc, arr.ctypes.data, arr.nbytes)))
    return out


def _table() -> List[int]:
    table = []
    for v in range(256):
        x = v
        for _ in range(8):
            x = (x >> 1) ^ (0x82F63B78 if x & 1 else 0)
        table.append(x)
    return table


_TABLE = _table()


def crc32c_plain(data, crc: int = 0xFFFFFFFF) -> int:
    """The plain version: the byte-table algorithm in Python (slow; for
    checks only)."""
    table = _TABLE
    c = crc & 0xFFFFFFFF
    for b in np.frombuffer(bytes(data), dtype=np.uint8).tolist():
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c
