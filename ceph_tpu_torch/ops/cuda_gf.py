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
prepared on the host once per codec (``prep_*``) into int32 lane masks,
``[bit-rows, input rows]``, the form the kernels AND against the lanes.

A wrapper launches its kernel for a CUDA tensor, or raises; for a CPU
tensor it runs the plain PyTorch version beside it (``*_plain``), which the
tests compare with the JAX package and ``chip_smoke.py`` compares with the
kernel on the card.  ``launches`` counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ceph_tpu_torch.ops import torch_gf

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
#: shared memory a block may take on Hopper with the opt-in attribute; a
#: codec kernel stages one output group's masks ([G, C] int32) there at a
#: time
SMEM_LIMIT = 227 * 1024
#: bit-rows per output group of each kernel (``G`` in ``gf_kernels.cu``)
_GROUP_ROWS = {"gf2_matrix_w8": 8, "gf2_matrix_w16": 16, "gf2_packet": 8}

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


def source_digest(source: str, generated: Generated = None) -> str:
    """sha256 over ``csrc/<source>``, the generated header (name and text)
    if there is one, and ``NVCC_FLAGS``: what a build depends on."""
    h = hashlib.sha256((CSRC / source).read_bytes())
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
            lib = ctypes.CDLL(str(build(source, generated)))
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


def _launch(name: str, x: torch.Tensor, masks: torch.Tensor,
            out: torch.Tensor, a: int, b: int) -> None:
    launch(SOURCE.name, _SIGNATURES, launches, name, x.device, x.data_ptr(),
           masks.data_ptr(), out.data_ptr(), a, b, x.shape[1])


# ---------------------------------------------------------------------------
# host prep: bitmatrix -> int32 lane masks
# ---------------------------------------------------------------------------


def _word_masks(bitmatrix: np.ndarray, k: int, w: int) -> np.ndarray:
    """[R, k*w] bitmatrix -> [R, k] masks, bit s of mask (r, j) =
    bitmatrix[r, j*w + s], replicated to every w-bit field of a lane."""
    R = bitmatrix.shape[0]
    bits = np.asarray(bitmatrix, np.uint32).reshape(R, k, w)
    mask = (bits << np.arange(w, dtype=np.uint32)).sum(-1, dtype=np.uint32)
    fields = np.uint32(0x01010101 if w == 8 else 0x00010001)
    return np.ascontiguousarray(mask * fields).view(np.int32)


def prep_matrix_w8(bitmatrix: np.ndarray, k: int) -> np.ndarray:
    """[m*8, k*8] jerasure bitmatrix -> [m*8, k] byte masks * 0x01010101."""
    return _word_masks(bitmatrix, k, 8)


def prep_matrix_w16(bitmatrix: np.ndarray, k: int) -> np.ndarray:
    """[m*16, k*16] jerasure bitmatrix -> [m*16, k] word masks * 0x00010001."""
    return _word_masks(bitmatrix, k, 16)


def prep_packet(bitmatrix: np.ndarray) -> np.ndarray:
    """[R, C] 0/1 matrix -> [ceil(R/8)*8, C] masks of 0 or 0xFFFFFFFF (the
    kernel works in groups of 8 output rows; padding rows are zero)."""
    R, C = bitmatrix.shape
    out = np.zeros((-(-R // 8) * 8, C), dtype=np.int32)
    out[:R] = np.where(np.asarray(bitmatrix) != 0, -1, 0)
    return out


# ---------------------------------------------------------------------------
# plain PyTorch versions (same contract as the kernels)
# ---------------------------------------------------------------------------


def _mask_bitmatrix(masks: torch.Tensor, w: int) -> torch.Tensor:
    """Inverse of :func:`_word_masks`: [R, k] masks -> [R, k*w] 0/1."""
    shifts = torch.arange(w, dtype=torch.int32, device=masks.device)
    bits = (masks.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(masks.shape[0], -1).to(torch.uint8)


def matrix_encode_w8_plain(masks: torch.Tensor, d32: torch.Tensor,
                           k: int, m: int) -> torch.Tensor:
    B = _mask_bitmatrix(masks, 8)
    return torch_gf._encode_words(B, d32.view(torch.uint8), 8).view(
        torch.int32)


def matrix_encode_w16_plain(masks: torch.Tensor, d32: torch.Tensor,
                            k: int, m: int) -> torch.Tensor:
    B = _mask_bitmatrix(masks, 16)
    return torch_gf._encode_words(B, d32.view(torch.uint8), 16).view(
        torch.int32)


def packet_encode_plain(masks: torch.Tensor, rows32: torch.Tensor,
                        r: int) -> torch.Tensor:
    B = (masks[:r] != 0).to(torch.uint8)
    return torch_gf._encode_packet_bits(B, rows32.view(torch.uint8)).view(
        torch.int32)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(name: str, masks: torch.Tensor, x: torch.Tensor,
           mask_shape, x_rows: int) -> None:
    for what, t in (("masks", masks), ("lanes", x)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {what} must be int32, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous 2-D tensor")
    if tuple(masks.shape) != tuple(mask_shape):
        raise ValueError(f"{name}: masks shape {tuple(masks.shape)} != "
                         f"{tuple(mask_shape)}")
    if x.shape[0] != x_rows:
        raise ValueError(f"{name}: lanes have {x.shape[0]} rows, want {x_rows}")
    if masks.device != x.device:
        raise ValueError(f"{name}: masks on {masks.device}, lanes on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    group_bytes = _GROUP_ROWS[name] * masks.shape[1] * 4
    if group_bytes > SMEM_LIMIT:
        raise ValueError(f"{name}: a group of {masks.shape[1]}-wide masks "
                         f"takes {group_bytes} bytes, over the kernel's "
                         f"{SMEM_LIMIT}-byte shared-memory table")


def matrix_encode_w8(masks: torch.Tensor, d32: torch.Tensor,
                     k: int, m: int) -> torch.Tensor:
    """masks [m*8, k] (``prep_matrix_w8``) x data lanes [k, n4] int32 ->
    parity lanes [m, n4] int32."""
    _check("gf2_matrix_w8", masks, d32, (m * 8, k), k)
    if d32.device.type == "cpu":
        return matrix_encode_w8_plain(masks, d32, k, m)
    out = torch.empty((m, d32.shape[1]), dtype=torch.int32, device=d32.device)
    if d32.shape[1]:
        _launch("gf2_matrix_w8", d32, masks, out, k, m)
    return out


def matrix_encode_w16(masks: torch.Tensor, d32: torch.Tensor,
                      k: int, m: int) -> torch.Tensor:
    """masks [m*16, k] (``prep_matrix_w16``) x data lanes [k, n4] int32 of
    two LE uint16 words each -> parity lanes [m, n4] int32."""
    _check("gf2_matrix_w16", masks, d32, (m * 16, k), k)
    if d32.device.type == "cpu":
        return matrix_encode_w16_plain(masks, d32, k, m)
    out = torch.empty((m, d32.shape[1]), dtype=torch.int32, device=d32.device)
    if d32.shape[1]:
        _launch("gf2_matrix_w16", d32, masks, out, k, m)
    return out


def packet_encode(masks: torch.Tensor, rows32: torch.Tensor,
                  r: int) -> torch.Tensor:
    """masks [ceil(r/8)*8, C] (``prep_packet``) x packet-row lanes [C, n4]
    int32 -> [r, n4] int32 XOR combinations."""
    c = rows32.shape[0] if rows32.dim() == 2 else -1
    _check("gf2_packet", masks, rows32, (-(-r // 8) * 8, c), c)
    if rows32.device.type == "cpu":
        return packet_encode_plain(masks, rows32, r)
    out = torch.empty((r, rows32.shape[1]), dtype=torch.int32,
                      device=rows32.device)
    if rows32.shape[1]:
        _launch("gf2_packet", rows32, masks, out, c, r)
    return out
