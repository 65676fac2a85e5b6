"""The port's host libraries: crc32c, and the GF(2^8) region kernels.

Port of ``ceph_tpu/native/gf_native.py``.

crc32c (``crc32c``, ``crc32c_rows``): ``crc32c.c`` beside this file is
compiled with the host C compiler (``$CC``, else ``cc``) at first use into
``ceph_tpu_torch/build/`` and loaded with ctypes.  On x86 it is built with
``-msse4.2`` (eight bytes an instruction); elsewhere it takes its
byte-table path.  A failed build raises: at 4 MiB objects the plain version
would set the time of the commit stage, so nothing falls back to it
quietly.  :func:`crc32c_plain` is the table algorithm in Python, which the
tests and ``chip_smoke.py`` hold the library against.  Castagnoli
polynomial, Ceph's initial value -1, no final xor-out, so
``crc32c(b, crc32c(a)) == crc32c(a + b)``.

The region kernels (``cpu_features``, ``mul_region``, ``region_xor``,
``matrix_encode``, ``bitmatrix_packet_encode``) are ``libec_kernels.so``
from ``gf_kernels.cpp`` (AVX2 ``vpshufb`` nibble tables, the gf-complete
SPLIT w8/4 scheme), built by ``native/build.py`` with ``-march=native`` at
first use: the host engine behind ``backend=native``
(``ops/native_engine.py``).  A library whose built ISA the CPU lacks
raises ``OSError`` and is never used.
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
from ceph_tpu_torch.native import build as native_build

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


# -- the GF(2^8) region kernels (libec_kernels.so) ---------------------------

_kernels_lock = threading.Lock()
_kernels = None

#: ec_arch_probe / ec_arch_built bits
ARCH_FLAGS = {1: "sse4.2", 2: "avx", 4: "avx2", 8: "avx512f"}


def arch_gate(built: int, have: int) -> None:
    """Refuse a library built for ISA features (``built``) that the running
    CPU (``have``) lacks, instead of a SIGILL inside a kernel (the
    reference's ceph_arch_probe gate)."""
    if built & ~have:
        raise OSError(
            f"native EC library needs CPU features 0x{built:x}, CPU has "
            f"0x{have:x}: it was built for another CPU")


def kernels() -> ctypes.CDLL:
    """``libec_kernels.so``, built and loaded once per process."""
    global _kernels
    with _kernels_lock:
        if _kernels is None:
            lib = ctypes.CDLL(str(native_build.library("kernels")))
            lib.ec_arch_probe.restype = ctypes.c_int
            lib.ec_arch_built.restype = ctypes.c_int
            arch_gate(lib.ec_arch_built(), lib.ec_arch_probe())
            ptrs = ctypes.POINTER(ctypes.c_void_p)
            lib.ec_gf8_mul_region.argtypes = [
                ctypes.c_uint8, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_size_t, ctypes.c_int]
            lib.ec_region_xor.argtypes = [ptrs, ctypes.c_int,
                                          ctypes.c_void_p, ctypes.c_size_t]
            for fn in (lib.ec_gf8_matrix_encode,
                       lib.ec_bitmatrix_packet_encode):
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ptrs, ptrs, ctypes.c_size_t]
            _kernels = lib
            residency.note_library_build()
        return _kernels


def cpu_features() -> dict:
    """Decoded runtime and build ISA flags (the src/arch introspection)."""
    lib = kernels()
    have, built = lib.ec_arch_probe(), lib.ec_arch_built()
    return {"cpu": [n for b, n in ARCH_FLAGS.items() if have & b],
            "build": [n for b, n in ARCH_FLAGS.items() if built & b]}


def _ptr_array(arrays) -> "ctypes.Array":
    ptrs = (ctypes.c_void_p * len(arrays))()
    for i, a in enumerate(arrays):
        ptrs[i] = a.ctypes.data_as(ctypes.c_void_p)
    return ptrs


def mul_region(c: int, region: np.ndarray,
               accum: np.ndarray | None = None) -> np.ndarray:
    """GF(2^8) ``c * region``, or ``accum ^= c * region`` in place."""
    region = np.ascontiguousarray(region, dtype=np.uint8)
    out = accum if accum is not None else np.zeros_like(region)
    kernels().ec_gf8_mul_region(
        c, region.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p), region.size,
        1 if accum is not None else 0)
    return out


def region_xor(srcs: list) -> np.ndarray:
    """XOR of equal-length uint8 regions."""
    srcs = [np.ascontiguousarray(s, dtype=np.uint8) for s in srcs]
    n = srcs[0].size
    out = np.empty(n, dtype=np.uint8)
    kernels().ec_region_xor(_ptr_array(srcs), len(srcs),
                            out.ctypes.data_as(ctypes.c_void_p), n)
    return out


def matrix_encode(matrix: np.ndarray, data: np.ndarray,
                  w: int = 8) -> np.ndarray:
    """GF(2^8) only; the same bytes as ``cpu_engine.matrix_encode`` at
    w=8."""
    if w != 8:
        raise NotImplementedError("native path supports w=8")
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    m, k = matrix.shape
    n = data.shape[1]
    coding = np.zeros((m, n), dtype=np.uint8)
    kernels().ec_gf8_matrix_encode(
        matrix.ctypes.data_as(ctypes.c_void_p), k, m,
        _ptr_array([data[j] for j in range(k)]),
        _ptr_array([coding[i] for i in range(m)]), n)
    return coding


def bitmatrix_packet_encode(bitmatrix: np.ndarray,
                            rows: np.ndarray) -> np.ndarray:
    """Packet rows [c, n] through a 0/1 bitmatrix [r, c] -> [r, n]: each
    output row the XOR of the rows its bitmatrix row selects."""
    bitmatrix = np.ascontiguousarray(bitmatrix, dtype=np.uint8)
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    r, c = bitmatrix.shape
    n = rows.shape[1]
    out = np.zeros((r, n), dtype=np.uint8)
    kernels().ec_bitmatrix_packet_encode(
        bitmatrix.ctypes.data_as(ctypes.c_void_p), r, c,
        _ptr_array([rows[j] for j in range(c)]),
        _ptr_array([out[i] for i in range(r)]), n)
    return out
