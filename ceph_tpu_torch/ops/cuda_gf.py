"""The three GF(2) codec kernels: wrappers, launch counters, plain twins.

Port of ``ceph_tpu/ops/pallas_gf.py``.  Each TPU kernel there has a
counterpart written by hand in CUDA C++ for Hopper (``csrc/gf_kernels.cu``,
``sm_90a``), built with ``nvcc`` into a shared library at first use and
loaded with ctypes (:func:`build` and :func:`load` serve every ``.cu`` file
of ``csrc/``):

=================  ===========================================  ==========
wrapper            replaces                                     kernel
=================  ===========================================  ==========
matrix_encode_w8   pallas_gf._matrix_kernel (:57)               gf2_matrix_w8
matrix_encode_w16  pallas_gf._matrix_kernel_w16 (:153)          gf2_matrix_w16
packet_encode      pallas_gf._packet_kernel (:240)              gf2_packet
=================  ===========================================  ==========

Operands keep the TPU kernels' lane layout: data bytes ride int32 lanes of
four little-endian bytes (``LANE_BYTES``), ``[rows, n4]``.  The bitmatrix is
prepared on the host once per codec or decode matrix (``prep_*``), into the
form each kernel reads:

- ``prep_matrix_w8``: nibble tables ``[ceil(m/4), 32*k]`` int32, uint32
  entries ``[group][j][nibble][value]`` holding the bytes of four output
  rows (gf-complete's SPLIT 8/4, derived from the bitmatrix alone);
- ``prep_matrix_w16``: nibble tables ``[ceil(m/4), 128*k]`` int32, uint2
  entries ``[group][j][nibble][value]`` holding the 16-bit words of four
  output rows (SPLIT 16/4);
- ``prep_packet``: the ones of each output row, one int32 array
  ``[offsets (r+1) | input-row indices (nnz)]`` (a CSR list).

A wrapper launches its kernel for a CUDA tensor, or raises; for a CPU
tensor it runs the plain PyTorch version beside it (``*_plain``), which the
tests compare with the JAX package and ``chip_smoke.py`` compares with the
kernel on the card.  ``launches`` counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ceph_tpu_torch.analysis import residency

#: bytes per device lane of every kernel operand (int32 lanes)
LANE_BYTES = 4

#: kernel name -> launches made through its wrapper (plain ints; a run
#: zeroes them with :func:`reset_launches` and reads them after)
launches: Dict[str, int] = {
    "gf2_matrix_w8": 0, "gf2_matrix_w16": 0, "gf2_packet": 0,
}

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCE = CSRC / "gf_kernels.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: shared memory a block may take on Hopper with the opt-in attribute:
#: ``gf2_packet`` stages a tile of all its input rows there, at least 8
#: lanes (32 bytes) of each (the table kernels stage their tables in
#: slices of 48 KiB, so they take any k)
SMEM_LIMIT = 227 * 1024

_lib_lock = threading.Lock()
#: (source file name, build digest) -> its loaded library
_libs: Dict[Tuple[str, str], ctypes.CDLL] = {}
#: library file name -> nvcc's output (ptxas register, spill and
#: shared-memory report), kept beside each library as ``<library>.log``
build_logs: Dict[str, str] = {}
#: a header generated for one build: (file name, text).  The source
#: ``#include``\ s it; it is written to ``build/gen-<digest>/`` and that
#: directory is passed to nvcc with ``-I``
Generated = Optional[Tuple[str, str]]
#: (source file name, generated header) -> its build digest, hashed once a
#: process (a launch looks its library up here)
_digests: Dict[Tuple[str, Generated], str] = {}
#: argument types of the three entry points of ``gf_kernels.cu``
_SIGNATURES = dict.fromkeys(launches, (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p))


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _local_headers(text: str) -> list:
    """The headers of ``csrc/`` that a source includes by name, and those
    that they include in turn."""
    found, todo = set(), [text]
    while todo:
        for name in re.findall(r'^#include "([^"]+)"', todo.pop(), re.M):
            if name not in found and (CSRC / name).exists():
                found.add(name)
                todo.append((CSRC / name).read_text())
    return sorted(found)


def source_digest(source: str, generated: Generated = None) -> str:
    """sha256 over ``csrc/<source>``, the headers of ``csrc/`` it includes
    (``gf_w8_tables.cuh``; ``wgmma_walk.cuh`` through the headers that
    include it), the generated header (name and text) if there
    is one, and ``NVCC_FLAGS``: what a build depends on."""
    text = (CSRC / source).read_bytes()
    h = hashlib.sha256(text)
    for name in _local_headers(text.decode()):
        h.update(b"\0" + name.encode() + b"\0" + (CSRC / name).read_bytes())
    if generated is not None:
        name, text = generated
        h.update(b"\0" + name.encode() + b"\0" + text.encode())
    h.update(b"\0" + " ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _write_once(path: Path, text: str) -> None:
    """Write ``path`` unless it exists, atomically (builds may race)."""
    if path.exists():
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(
        f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def build(source: str = SOURCE.name, generated: Generated = None) -> Path:
    """Compile ``csrc/<source>`` into ``build/`` and return the library
    path.  The library is keyed by :func:`source_digest`, so an edited
    source, another generated header or other flags rebuild; builds of
    different sources may run at once.  A ``generated`` header is written
    to ``build/gen-<digest>/`` and found there through ``-I``."""
    path = CSRC / source
    digest = source_digest(source, generated)
    lib = BUILD_DIR / f"lib{path.stem}-{digest[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        if log.exists():
            build_logs[lib.name] = log.read_text()
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    include = []
    if generated is not None:
        gen_dir = BUILD_DIR / f"gen-{digest}"
        _write_once(gen_dir / generated[0], generated[1])
        include = ["-I", str(gen_dir)]
    tmp = lib.with_name(
        f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, *include, "-o", str(tmp), str(path)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {path}:\n{proc.stderr}")
    build_logs[lib.name] = proc.stdout + proc.stderr
    log.write_text(build_logs[lib.name])
    os.replace(tmp, lib)
    return lib


def build_copy(directory: Path, name: str, text: str,
               headers: Optional[Dict[str, str]] = None) -> Path:
    """Compile ``text``, an edited copy of ``csrc/<name>``, with the port's
    flags into ``directory`` (``headers``: edited copies of headers it
    includes, written beside it, where they shadow ``csrc/``'s) and return
    the library path (nvcc's report beside it, ``<library>.log``).  The
    probe tools build their settings with it."""
    directory.mkdir(parents=True, exist_ok=True)
    src = directory / name
    src.write_text(text)
    for header, header_text in (headers or {}).items():
        (directory / header).write_text(header_text)
    lib = directory / f"lib{Path(name).stem}.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
                           str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    return lib


def load(source: str, signatures: Dict[str, tuple],
         generated: Generated = None) -> ctypes.CDLL:
    """The library built from ``csrc/<source>`` (and ``generated``),
    loaded once per process and build digest, with ``signatures`` (entry
    point -> ctypes argument types) applied; every entry point returns a
    CUDA error code."""
    with _lib_lock:
        digest = _digests.get((source, generated))
        if digest is None:
            digest = _digests[(source, generated)] = source_digest(
                source, generated)
        key = (source, digest)
        lib = _libs.get(key)
        if lib is None:
            path = build(source, generated)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                # not an OSError: up the stack an IOError reads as a
                # missing object, and a read would carry on with zeros
                raise RuntimeError(f"cannot load {path}: {e}") from None
            residency.note_library_build()
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _libs[key] = lib
        return lib


def launch(source: str, signatures: Dict[str, tuple],
           counts: Dict[str, int], name: str, device: torch.device,
           *args, generated: Generated = None) -> None:
    """Launch entry point ``name`` of ``csrc/<source>`` (built with
    ``generated``) with ``args`` on ``device``'s current stream, raise on a
    CUDA error, and count the launch in ``counts``."""
    fn = getattr(load(source, signatures, generated), name)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    counts[name] += 1


def _launch(name: str, x: torch.Tensor, operand: torch.Tensor,
            out: torch.Tensor, a: int, b: int) -> None:
    launch(SOURCE.name, _SIGNATURES, launches, name, x.device, x.data_ptr(),
           operand.data_ptr(), out.data_ptr(), a, b, x.shape[1])


# ---------------------------------------------------------------------------
# host prep: bitmatrix -> each kernel's operand
# ---------------------------------------------------------------------------


def prep_matrix_w8(bitmatrix: np.ndarray, k: int) -> np.ndarray:
    """[m*8, k*8] jerasure bitmatrix -> nibble tables [ceil(m/4), 32*k]
    int32: uint32 entry (g, j, p, v) holds T_ijp[v] for the output rows
    i = 4g .. 4g+3 in its bytes 0 .. 3, where T_ijp[v] is the XOR over the
    bits s of v of column 8j + 4p + s of bit-rows 8i .. 8i+7, as a byte
    (bit t from bit-row 8i + t).  So output byte i of input bytes x_j is
    the XOR over j of T_ij0[x_j & 15] ^ T_ij1[x_j >> 4].  Bytes of rows
    past m are zero."""
    R = bitmatrix.shape[0]
    groups = -(-R // 32)
    B = np.zeros((groups * 32, k * 8), dtype=np.uint32)
    B[:R] = np.asarray(bitmatrix) != 0
    # col[i, j, p, s]: column 8j + 4p + s of output row i's 8 bit-rows
    bits = B.reshape(groups * 4, 8, k, 2, 4)
    col = (bits << np.arange(8, dtype=np.uint32)[:, None, None, None]).sum(
        1, dtype=np.uint32)
    v = np.arange(16)
    tab = np.zeros((groups * 4, k, 2, 16), dtype=np.uint32)
    for s in range(4):
        tab ^= col[..., s, None] * ((v >> s) & 1).astype(np.uint32)
    tab = tab.reshape(groups, 4, k, 2, 16)
    entries = tab[:, 0] | tab[:, 1] << 8 | tab[:, 2] << 16 | tab[:, 3] << 24
    return np.ascontiguousarray(entries.reshape(groups, k * 32)).view(
        np.int32)


def prep_matrix_w16(bitmatrix: np.ndarray, k: int) -> np.ndarray:
    """[m*16, k*16] jerasure bitmatrix -> nibble tables [ceil(m/4), 128*k]
    int32: uint2 entry (g, j, p, v) holds T_ijp[v] for the output words i =
    4g .. 4g+3, 16 bits each (i = 4g in the low half of the first int32),
    where T_ijp[v] is the XOR over the bits s of v of column 16j + 4p + s
    of rows 16i .. 16i+15.  Words of rows past m are zero."""
    R = bitmatrix.shape[0]
    groups = -(-R // 64)
    B = np.zeros((groups * 64, k * 16), dtype=np.uint32)
    B[:R] = np.asarray(bitmatrix) != 0
    # col[i, j, p, s]: column 16j + 4p + s of output word i's 16 rows
    bits = B.reshape(groups * 4, 16, k, 4, 4)
    col = (bits << np.arange(16, dtype=np.uint32)[:, None, None, None]).sum(
        1, dtype=np.uint32)
    v = np.arange(16)
    tab = np.zeros((groups * 4, k, 4, 16), dtype=np.uint32)
    for s in range(4):
        tab ^= col[..., s, None] * ((v >> s) & 1).astype(np.uint32)
    tab = tab.reshape(groups, 4, k, 4, 16)
    pairs = np.stack([tab[:, 0] | tab[:, 1] << 16, tab[:, 2] | tab[:, 3] << 16],
                     axis=-1)
    return np.ascontiguousarray(pairs.reshape(groups, k * 128)).view(np.int32)


def prep_packet(bitmatrix: np.ndarray) -> np.ndarray:
    """[R, C] 0/1 matrix -> int32 [R+1 offsets | nnz input-row indices]:
    output row i is the XOR of the input rows ``idx[off[i]:off[i+1]]``
    (``idx`` in ascending order; a row of zeros has an empty list)."""
    B = np.asarray(bitmatrix) != 0
    off = np.zeros(B.shape[0] + 1, dtype=np.int32)
    np.cumsum(B.sum(1), out=off[1:])
    return np.concatenate([off, np.nonzero(B)[1].astype(np.int32)])


# ---------------------------------------------------------------------------
# plain PyTorch versions (same contract as the kernels)
# ---------------------------------------------------------------------------


def matrix_encode_w8_plain(tables: torch.Tensor, d32: torch.Tensor,
                           k: int, m: int) -> torch.Tensor:
    """Through the nibble tables: the 4-byte entries of 4 output rows are
    XORed over the input bytes j and their nibbles p, then unpacked to
    rows (byte r of a group's entry is output row 4g + r's byte)."""
    t = tables.view(tables.shape[0], k, 2, 16)
    u = d32.view(torch.uint8)  # [k, 4*n4] input bytes
    acc = torch.zeros((t.shape[0], u.shape[1]), dtype=torch.int32,
                      device=d32.device)
    for j in range(k):
        for p in range(2):
            nib = ((u[j] >> (4 * p)) & 15).long()
            acc ^= t[:, j, p, :][:, nib]
    groups, width = t.shape[0], u.shape[1]
    rows = acc.view(torch.uint8).view(groups, width, 4).permute(0, 2, 1)
    out = torch.empty((m, d32.shape[1]), dtype=torch.int32, device=d32.device)
    out.view(torch.uint8).copy_(rows.reshape(groups * 4, width)[:m])
    return out


def _xor_rows(t: torch.Tensor) -> torch.Tensor:
    """XOR of the rows of ``t`` [n, ...] (zeros for n = 0), by halving."""
    if t.shape[0] == 0:
        return torch.zeros(t.shape[1:], dtype=t.dtype, device=t.device)
    while t.shape[0] > 1:
        half = t.shape[0] // 2
        folded = t[:half] ^ t[half:2 * half]
        t = torch.cat([folded, t[2 * half:]]) if t.shape[0] % 2 else folded
    return t[0]


def matrix_encode_w16_plain(tables: torch.Tensor, d32: torch.Tensor,
                            k: int, m: int) -> torch.Tensor:
    """Through the nibble tables: each output word is the XOR over the
    input words j and their nibbles p of the entry the nibble selects."""
    t = tables.view(-1, k, 4, 16, 2)
    # words[i, j, p, v]: the 16-bit word of output row i
    words = torch.stack([t[..., 0] & 0xFFFF, (t[..., 0] >> 16) & 0xFFFF,
                         t[..., 1] & 0xFFFF, (t[..., 1] >> 16) & 0xFFFF],
                        dim=1).reshape(-1, k, 4, 16)[:m]
    u = d32.view(torch.int16).to(torch.int32) & 0xFFFF  # [k, 2*n4] words
    out = torch.zeros((m, u.shape[1]), dtype=torch.int32, device=d32.device)
    for j in range(k):
        for p in range(4):
            nib = ((u[j] >> (4 * p)) & 15).long()
            out ^= words[:, j, p, :][:, nib]
    # 16-bit words as int16 (two's complement), two to an int32 lane
    return (out - ((out & 0x8000) << 1)).to(torch.int16).view(torch.int32)


def packet_encode_plain(lists: torch.Tensor, rows32: torch.Tensor,
                        r: int) -> torch.Tensor:
    """Through the lists: output row i is the XOR of its listed rows."""
    off = lists[:r + 1].tolist()
    idx = lists[r + 1:].long()
    out = torch.empty((r, rows32.shape[1]), dtype=torch.int32,
                      device=rows32.device)
    for i in range(r):
        out[i] = _xor_rows(rows32[idx[off[i]:off[i + 1]]])
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(name: str, operand: torch.Tensor, x: torch.Tensor,
           operand_dim: int, x_rows: int) -> None:
    for what, t, dim in (("operand", operand, operand_dim), ("lanes", x, 2)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {what} must be int32, got {t.dtype}")
        if t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous {dim}-D "
                             "tensor")
    if x.shape[0] != x_rows:
        raise ValueError(f"{name}: lanes have {x.shape[0]} rows, want {x_rows}")
    if operand.device != x.device:
        raise ValueError(f"{name}: operand on {operand.device}, lanes on "
                         f"{x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _check_shape(name: str, operand: torch.Tensor, shape) -> None:
    if tuple(operand.shape) != tuple(shape):
        raise ValueError(f"{name}: operand shape {tuple(operand.shape)} != "
                         f"{tuple(shape)}")


def matrix_encode_w8(tables: torch.Tensor, d32: torch.Tensor,
                     k: int, m: int) -> torch.Tensor:
    """nibble tables [ceil(m/4), 32*k] (``prep_matrix_w8``) x data lanes
    [k, n4] int32 -> parity lanes [m, n4] int32.  Any k and m: the kernel
    stages its tables in slices."""
    _check("gf2_matrix_w8", tables, d32, 2, k)
    _check_shape("gf2_matrix_w8", tables, (-(-m // 4), 32 * k))
    if d32.device.type == "cpu":
        return matrix_encode_w8_plain(tables, d32, k, m)
    out = torch.empty((m, d32.shape[1]), dtype=torch.int32, device=d32.device)
    if out.numel():
        _launch("gf2_matrix_w8", d32, tables, out, k, m)
    return out


def matrix_encode_w16(tables: torch.Tensor, d32: torch.Tensor,
                      k: int, m: int) -> torch.Tensor:
    """nibble tables [ceil(m/4), 128*k] (``prep_matrix_w16``) x data lanes
    [k, n4] int32 of two LE uint16 words each -> parity lanes [m, n4]
    int32.  Any k and m: the kernel stages its tables in slices."""
    _check("gf2_matrix_w16", tables, d32, 2, k)
    _check_shape("gf2_matrix_w16", tables, (-(-m // 4), 128 * k))
    if d32.device.type == "cpu":
        return matrix_encode_w16_plain(tables, d32, k, m)
    out = torch.empty((m, d32.shape[1]), dtype=torch.int32, device=d32.device)
    if out.numel():
        _launch("gf2_matrix_w16", d32, tables, out, k, m)
    return out


def packet_encode(lists: torch.Tensor, rows32: torch.Tensor,
                  r: int) -> torch.Tensor:
    """lists [r+1+nnz] (``prep_packet``) x packet-row lanes [C, n4] int32 ->
    [r, n4] int32 XOR combinations."""
    c = rows32.shape[0] if rows32.dim() == 2 else -1
    _check("gf2_packet", lists, rows32, 1, c)
    if not r + 1 <= lists.shape[0] <= r + 1 + r * c:
        raise ValueError(f"gf2_packet: {lists.shape[0]} list entries for "
                         f"{r} rows of {c} inputs")
    if 32 * c > SMEM_LIMIT:
        raise ValueError(f"gf2_packet: a tile of {c} rows x 8 lanes takes "
                         f"{32 * c} bytes, over the kernel's {SMEM_LIMIT} "
                         "bytes of shared memory")
    if rows32.device.type == "cpu":
        return packet_encode_plain(lists, rows32, r)
    out = torch.empty((r, rows32.shape[1]), dtype=torch.int32,
                      device=rows32.device)
    if out.numel():
        _launch("gf2_packet", rows32, lists, out, c, r)
    return out
