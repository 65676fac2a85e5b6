"""The kernel sweep's four kernels: wrappers, launch counters, plain twins.

Port of the TPU kernels that ``tools/ec_kernel_sweep.py`` and
``experiments/kernel_r4.py`` time beside the production w=8 product.  Each
has a counterpart written by hand in CUDA C++ for Hopper
(``csrc/sweep_kernels.cu``, ``sm_90a``), built and loaded like the codec
kernels (:func:`cuda_gf.load`):

==================  ==============================================  =========
wrapper             replaces                                        kernel
==================  ==============================================  =========
copy_rows           ec_kernel_sweep._copy_kernel (:117)             sweep_copy
extract_rows        ec_kernel_sweep._extract_only_kernel (:121)     sweep_extract
pipelined_w8        ec_kernel_sweep._pipelined_call (:76)           sweep_pipelined_w8
int8_4dot           kernel_r4._kernel_int8_4dot (:76)               sweep_int8_4dot
==================  ==============================================  =========

Operands are int32 lanes of four little-endian bytes, ``[rows, n4]``, as in
:mod:`cuda_gf`.  ``pipelined_w8`` takes the lane masks of
``cuda_gf.prep_matrix_w8``; ``int8_4dot`` takes the shift-major 0/1
bitmatrix of :func:`prep_shift_major_w8` as int8.

A wrapper launches its kernel for a CUDA tensor, or raises; for a CPU
tensor it runs the plain PyTorch version beside it (``*_plain``), in exact
integer or float64 arithmetic.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from ceph_tpu_torch.ops import cuda_gf

SOURCE = "sweep_kernels.cu"

#: kernel name -> launches made through its wrapper (plain ints; a run
#: zeroes them with :func:`reset_launches` and reads them after)
launches: Dict[str, int] = {
    "sweep_copy": 0, "sweep_extract": 0, "sweep_pipelined_w8": 0,
    "sweep_int8_4dot": 0,
}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: entry point -> ctypes argument types (``csrc/sweep_kernels.cu``)
_SIGNATURES = {
    "sweep_copy": (_P, _P, _I, _L, _P),
    "sweep_extract": (_P, _P, _I, _L, _P),
    "sweep_pipelined_w8": (_P, _P, _P, _I, _I, _L, _I, _P),
    "sweep_int8_4dot": (_P, _P, _P, _I, _I, _L, _P),
}

#: the fields the extraction probe keeps of each shifted lane
_FIELDS = 0x00010001
#: lanes per stage of ``pipelined_w8`` unless the caller picks another
DEFAULT_TILE = 1024
#: the widest code ``int8_4dot`` takes: its kernel keeps Bp's fragments in
#: registers, ceil(k/4) by ceil(m/2) of them
INT8_MAX_K, INT8_MAX_M = 16, 8


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _launch(name: str, device: torch.device, *args) -> None:
    cuda_gf.launch(SOURCE, _SIGNATURES, launches, name, device, *args)


# ---------------------------------------------------------------------------
# host prep
# ---------------------------------------------------------------------------


def prep_shift_major_w8(bitmatrix: np.ndarray, k: int) -> np.ndarray:
    """[R, k*8] jerasure bitmatrix -> [R, 8k] float32, columns in
    shift-major order: column ``s*k + j`` is bitmatrix column ``j*8 + s``
    (bit plane s of chunk j).  A copy of ``pallas_gf.prep_matrix_w8``; the
    port's ``cuda_gf.prep_matrix_w8`` is the lane-mask layout instead."""
    R = bitmatrix.shape[0]
    cols = np.asarray(bitmatrix, np.float32).reshape(R, k, 8)
    return np.ascontiguousarray(cols.transpose(0, 2, 1).reshape(R, 8 * k))


# ---------------------------------------------------------------------------
# plain PyTorch versions (same contract as the kernels)
# ---------------------------------------------------------------------------


def copy_plain(x: torch.Tensor, m: int) -> torch.Tensor:
    """out = x[:m]."""
    return x[:m].clone()


def extract_plain(x: torch.Tensor, m: int) -> torch.Tensor:
    """Sum over s < 8 of ((x >> s) & 0x00010001) + ((x >> (8+s)) &
    0x00010001) on rows < m, in int32 (each 16-bit field collects at most
    16, so the sum equals the TPU kernel's f32 sum cast to int32)."""
    x = x[:m]
    acc = torch.zeros_like(x)
    for s in range(8):
        acc += (x >> s) & _FIELDS
        acc += (x >> (8 + s)) & _FIELDS
    return acc


#: the production w=8 product: the pipelined kernel changes only how its
#: operands reach the card's shared memory
pipelined_w8_plain = cuda_gf.matrix_encode_w8_plain


def int8_4dot_plain(bp: torch.Tensor, x: torch.Tensor,
                    k: int, m: int) -> torch.Tensor:
    """For each byte position b < 4: planes[s*k + j] = (x[j] >> (8b+s)) &
    1; acc = bp @ planes; bit l of byte b of output row i = acc[8i+l] & 1.
    The product runs in float64 (sums <= 8k, exact)."""
    B = bp.to(torch.float64)
    n4 = x.shape[1]
    shifts = torch.arange(8, dtype=torch.int32, device=x.device)
    out = torch.empty((m, n4, cuda_gf.LANE_BYTES), dtype=torch.uint8,
                      device=x.device)
    for b in range(cuda_gf.LANE_BYTES):
        # [8, k, n4] -> [8k, n4], row s*k + j
        planes = (x.unsqueeze(0) >> (8 * b + shifts).view(8, 1, 1)) & 1
        acc = B @ planes.reshape(8 * k, n4).to(torch.float64)
        bits = (acc.to(torch.int32) & 1).view(m, 8, n4)
        out[:, :, b] = (bits << shifts.view(1, 8, 1)).sum(1).to(torch.uint8)
    return out.view(m, n4 * cuda_gf.LANE_BYTES).view(torch.int32)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(name: str, **operands) -> torch.device:
    devices = set()
    for what, (t, dtype) in operands.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous 2-D tensor")
        devices.add(t.device)
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on {sorted(map(str, devices))}")
    (device,) = devices
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    return device


def _rows(name: str, x: torch.Tensor, m: int) -> torch.device:
    device = _check(name, lanes=(x, torch.int32))
    if not 0 < m <= x.shape[0]:
        raise ValueError(f"{name}: m={m} rows of a {x.shape[0]}-row input")
    return device


def copy_rows(x: torch.Tensor, m: int) -> torch.Tensor:
    """Lanes [k, n4] int32 -> x[:m], [m, n4] (the sweep's copy control)."""
    if _rows("sweep_copy", x, m).type == "cpu":
        return copy_plain(x, m)
    out = torch.empty((m, x.shape[1]), dtype=torch.int32, device=x.device)
    if x.shape[1]:
        _launch("sweep_copy", x.device, x.data_ptr(), out.data_ptr(), m,
                x.shape[1])
    return out


def extract_rows(x: torch.Tensor, m: int) -> torch.Tensor:
    """Lanes [k, n4] int32 -> the 16 shifted field sums of rows < m,
    [m, n4] (the sweep's extraction probe)."""
    if _rows("sweep_extract", x, m).type == "cpu":
        return extract_plain(x, m)
    out = torch.empty((m, x.shape[1]), dtype=torch.int32, device=x.device)
    if x.shape[1]:
        _launch("sweep_extract", x.device, x.data_ptr(), out.data_ptr(), m,
                x.shape[1])
    return out


def pipelined_smem_bytes(k: int, m: int, tile: int) -> int:
    """Shared memory of one ``sweep_pipelined_w8`` block: the mask table
    (padded to 16 bytes) and two stages of [k, tile] lanes."""
    return (-(-(m * 8 * k) // 4) * 4 + 2 * k * tile) * 4


def pipelined_w8(masks: torch.Tensor, x: torch.Tensor, k: int, m: int,
                 tile: int = DEFAULT_TILE) -> torch.Tensor:
    """masks [m*8, k] (``cuda_gf.prep_matrix_w8``) x lanes [k, n4] ->
    parity lanes [m, n4], staged ``tile`` lanes at a time."""
    device = _check("sweep_pipelined_w8", masks=(masks, torch.int32),
                    lanes=(x, torch.int32))
    if tuple(masks.shape) != (m * 8, k) or x.shape[0] != k:
        raise ValueError(f"sweep_pipelined_w8: masks {tuple(masks.shape)} "
                         f"and lanes {tuple(x.shape)} do not fit k={k} m={m}")
    if tile <= 0 or tile % 4:
        raise ValueError(f"sweep_pipelined_w8: tile {tile} is not a positive "
                         "multiple of 4 lanes")
    smem = pipelined_smem_bytes(k, m, tile)
    if smem > cuda_gf.SMEM_LIMIT:
        raise ValueError(f"sweep_pipelined_w8: tile {tile} needs {smem} bytes "
                         f"of shared memory, over {cuda_gf.SMEM_LIMIT}")
    if device.type == "cpu":
        return pipelined_w8_plain(masks, x, k, m)
    out = torch.empty((m, x.shape[1]), dtype=torch.int32, device=device)
    if x.shape[1]:
        _launch("sweep_pipelined_w8", device, x.data_ptr(), masks.data_ptr(),
                out.data_ptr(), k, m, x.shape[1], tile)
    return out


def int8_4dot(bp: torch.Tensor, x: torch.Tensor, k: int,
              m: int) -> torch.Tensor:
    """bp [8m, 8k] int8 0/1 (``prep_shift_major_w8``) x lanes [k, n4] ->
    parity lanes [m, n4], on the int8 tensor cores."""
    device = _check("sweep_int8_4dot", bp=(bp, torch.int8),
                    lanes=(x, torch.int32))
    if tuple(bp.shape) != (8 * m, 8 * k) or x.shape[0] != k:
        raise ValueError(f"sweep_int8_4dot: bitmatrix {tuple(bp.shape)} and "
                         f"lanes {tuple(x.shape)} do not fit k={k} m={m}")
    if not (1 <= k <= INT8_MAX_K and 1 <= m <= INT8_MAX_M):
        raise ValueError(f"sweep_int8_4dot: k={k} m={m}; the kernel takes "
                         f"k <= {INT8_MAX_K} and m <= {INT8_MAX_M}")
    if device.type == "cpu":
        return int8_4dot_plain(bp, x, k, m)
    out = torch.empty((m, x.shape[1]), dtype=torch.int32, device=device)
    if x.shape[1]:
        _launch("sweep_int8_4dot", device, x.data_ptr(), bp.data_ptr(),
                out.data_ptr(), k, m, x.shape[1])
    return out
