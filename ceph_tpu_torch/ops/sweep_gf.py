"""The kernel sweep's fourteen kernels: wrappers, launch counters, plain
twins.

Port of the TPU kernels that ``tools/ec_kernel_sweep.py``,
``experiments/kernel_r4.py``, ``experiments/kernel_r4_split.py`` and
``experiments/kernel_r4_probe.py`` time beside the production w=8 product.
Each has a counterpart written by hand in CUDA C++ for Hopper (``sm_90a``),
built and loaded like the codec kernels (:func:`cuda_gf.load`):

==================  ==============================================  =========
wrapper             replaces                                        kernel
==================  ==============================================  =========
copy_rows           ec_kernel_sweep._copy_kernel (:117)             sweep_copy
extract_rows        ec_kernel_sweep._extract_only_kernel (:121)     sweep_extract
pipelined_w8        ec_kernel_sweep._pipelined_call (:76)           sweep_pipelined_w8
int8_4dot           kernel_r4._kernel_int8_4dot (:76)               sweep_int8_4dot
bf16_4dot           kernel_r4._kernel_bf16_4dot (:52), bfloat16     sweep_bf16_4dot
f32_4dot            kernel_r4._kernel_bf16_4dot (:52), float32      sweep_f32_4dot
bf16_blockdiag      kernel_r4._kernel_bf16_blockdiag (:100)         sweep_bf16_blockdiag
make_xornet(...)    kernel_r4._make_xornet_kernel (:129)            sweep_xornet
prec_product        kernel_r4._kernel_prec (:315), HIGHEST          sweep_prec_f32
prec_product        kernel_r4._kernel_prec (:315), HIGH             sweep_prec_tf32x3
prec_product        kernel_r4._kernel_prec (:315), DEFAULT          sweep_prec_tf32
split_product       kernel_r4_split._kernel_split (:51), HIGHEST    sweep_split_f32
extract_fold        kernel_r4_probe._extract_kernel (:38)           sweep_extract_fold
planes_product      kernel_r4_probe._mxu_kernel (:54)               sweep_planes_f32
==================  ==============================================  =========

``sweep_xornet`` lives in ``csrc/xornet_kernel.cu``, a frame that includes
a network generated per bitmatrix (:func:`xornet_source`); the others in
``csrc/sweep_kernels.cu`` (``sweep_split_f32``'s kernel in the header
``csrc/split_f32.cuh`` it includes).

Operands are int32 lanes of four little-endian bytes, ``[rows, n4]``, as in
:mod:`cuda_gf`.  ``pipelined_w8`` takes the nibble tables of
``cuda_gf.prep_matrix_w8``; ``int8_4dot``, ``bf16_4dot`` and ``f32_4dot``
take the shift-major 0/1 bitmatrix of :func:`prep_shift_major_w8` in their
product's operand type (int8, bfloat16, float32), and ``prec_product``,
``split_product`` and ``planes_product`` take it as float32
(``planes_product`` with float32 planes [2, 8k, n4] of
:func:`field_planes` in place of lanes); ``bf16_blockdiag`` takes the block-diagonal table of
:func:`prep_blockdiag_w8` as bfloat16; ``make_xornet`` takes the jerasure
bitmatrix itself and compiles it into its kernel.

A wrapper launches its kernel for a CUDA tensor, or raises; for a CPU
tensor it runs the plain PyTorch version beside it (``*_plain``), in exact
integer or float64 arithmetic.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict

import numpy as np
import torch

from ceph_tpu_torch.ops import cuda_gf

SOURCE = "sweep_kernels.cu"

#: kernel name -> launches made through its wrapper (plain ints; a run
#: zeroes them with :func:`reset_launches` and reads them after)
launches: Dict[str, int] = {
    "sweep_copy": 0, "sweep_extract": 0, "sweep_pipelined_w8": 0,
    "sweep_int8_4dot": 0, "sweep_bf16_4dot": 0, "sweep_f32_4dot": 0,
    "sweep_bf16_blockdiag": 0, "sweep_xornet": 0, "sweep_prec_f32": 0,
    "sweep_prec_tf32x3": 0, "sweep_prec_tf32": 0, "sweep_split_f32": 0,
    "sweep_extract_fold": 0, "sweep_planes_f32": 0,
}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: entry point -> ctypes argument types (``csrc/sweep_kernels.cu``)
_SIGNATURES = {
    "sweep_copy": (_P, _P, _I, _L, _P),
    "sweep_extract": (_P, _P, _I, _L, _P),
    "sweep_pipelined_w8": (_P, _P, _P, _I, _I, _L, _I, _P),
    "sweep_int8_4dot": (_P, _P, _P, _I, _I, _L, _P),
    "sweep_bf16_4dot": (_P, _P, _P, _I, _I, _L, _P),
    "sweep_f32_4dot": (_P, _P, _P, _I, _I, _L, _P),
    "sweep_bf16_blockdiag": (_P, _P, _P, _I, _I, _L, _P),
    "sweep_prec_f32": (_P, _P, _P, _I, _I, _L, _I, _P),
    "sweep_prec_tf32x3": (_P, _P, _P, _I, _I, _L, _I, _P),
    "sweep_prec_tf32": (_P, _P, _P, _I, _I, _L, _I, _P),
    "sweep_split_f32": (_P, _P, _P, _I, _I, _L, _I, _I, _P),
    "sweep_extract_fold": (_P, _P, _I, _I, _L, _P),
    "sweep_planes_f32": (_P, _P, _P, _I, _I, _L, _I, _P),
}

#: the static XOR network's frame, and the header it includes
XORNET_SOURCE = "xornet_kernel.cu"
XORNET_HEADER = "xornet_net.h"
_XORNET_SIGNATURES = {"sweep_xornet": (_P, _P, _L, _P)}
#: the widest code whose network ``sweep_xornet`` builds: a thread keeps
#: one lane of 4 lanes of each input row and the 8m accumulators in
#: registers
XORNET_MAX_K, XORNET_MAX_M = 16, 8

#: JAX precision name -> the kernel that computes ``_kernel_prec`` at it
PREC_KERNELS = {"HIGHEST": "sweep_prec_f32", "HIGH": "sweep_prec_tf32x3",
                "DEFAULT": "sweep_prec_tf32"}
#: precision kernel -> (the widest k, the widest m): the FFMA kernel keeps
#: 16m accumulators a thread and stages Bp in shared memory; the TF32
#: kernels keep Bp's fragments in registers as ``sweep_f32_4dot`` does
PREC_LIMITS = {"sweep_prec_f32": (16, 8), "sweep_prec_tf32x3": (8, 4),
               "sweep_prec_tf32": (8, 4)}
#: the JAX tool's tiles (``main_prec``): lanes a block takes per step
PREC_TILES = (4096, 16384)
#: ``_kernel_split``'s column chunks a tile is cut into; above 1 only at
#: HIGHEST (``sweep_split_f32``: FFMA, the limits of ``sweep_prec_f32``)
SPLIT_PARTS = (1, 2, 4, 8)
#: the widest m ``sweep_extract_fold`` takes: it keeps m accumulators a
#: lane, indexed at compile time
FOLD_MAX_M = 8

#: the fields the extraction probe and the precision product keep of each
#: shifted lane
_FIELDS = 0x00010001
#: bit 0 of each byte of a lane: one bit plane of the XOR network
_BYTE_BIT0 = 0x01010101
#: lanes per stage of ``pipelined_w8`` unless the caller picks another
DEFAULT_TILE = 1024
#: single-plane product kernel -> (its table's dtype, the widest k, the
#: widest m): each kernel keeps Bp's fragments in registers, at most 64 of
#: them a thread
DOT_KERNELS = {
    "sweep_int8_4dot": (torch.int8, 16, 8),
    "sweep_bf16_4dot": (torch.bfloat16, 16, 4),
    "sweep_f32_4dot": (torch.float32, 8, 4),
}
#: the widest m ``bf16_blockdiag`` takes: a thread keeps the accumulators
#: of all 2m row tiles of four 8-lane groups, 32m floats
BLOCKDIAG_MAX_M = 4


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
    port's ``cuda_gf.prep_matrix_w8`` makes nibble tables instead."""
    R = bitmatrix.shape[0]
    cols = np.asarray(bitmatrix, np.float32).reshape(R, k, 8)
    return np.ascontiguousarray(cols.transpose(0, 2, 1).reshape(R, 8 * k))


def prep_blockdiag_w8(bitmatrix: np.ndarray, k: int, m: int) -> np.ndarray:
    """[m*8, k*8] jerasure bitmatrix -> [32m, 32k] float32 block-diagonal
    table: block b < 4 (rows b*8m.., columns b*8k..) is
    :func:`prep_shift_major_w8`, the rest zero.  A copy of the table
    ``kernel_r4.build_variants`` builds inline."""
    bp = prep_shift_major_w8(bitmatrix, k)
    blk = np.zeros((4 * 8 * m, 4 * 8 * k), np.float32)
    for b in range(cuda_gf.LANE_BYTES):
        blk[b * 8 * m:(b + 1) * 8 * m, b * 8 * k:(b + 1) * 8 * k] = bp
    return blk


def _support(bitmatrix: np.ndarray, k: int, m: int) -> np.ndarray:
    """[8m, 8k] 0/1 bool of a w=8 jerasure bitmatrix (column j*8 + s is
    bit s of input row j), or ValueError."""
    bits = np.asarray(bitmatrix)
    if bits.shape != (8 * m, 8 * k):
        raise ValueError(f"bitmatrix {bits.shape} does not fit k={k} m={m} "
                         f"w=8 ({8 * m}, {8 * k})")
    if not np.isin(bits, (0, 1)).all():
        raise ValueError("bitmatrix entries must be 0 or 1")
    return bits.astype(bool)


def xornet_source(bitmatrix: np.ndarray, k: int, m: int) -> str:
    """The header ``csrc/xornet_kernel.cu`` includes for one [8m, 8k]
    bitmatrix: ``XORNET_K``, ``XORNET_M`` and ``xornet_network``, the
    static XOR network as straight-line statements, input-major: for each
    input row j and each bit s that some bit-row uses, the plane
    ``(x[j] >> s) & 0x01010101`` XORed into those bit-rows' accumulators.
    Deterministic: the same bitmatrix gives the same text (and library)."""
    B = _support(bitmatrix, k, m)
    lines = [
        "// Generated by ceph_tpu_torch.ops.sweep_gf.xornet_source from one",
        f"// [{8 * m}, {8 * k}] w=8 bitmatrix ({int(B.sum())} ones); the "
        "static XOR",
        "// network that csrc/xornet_kernel.cu runs.  Do not edit.",
        "#pragma once",
        f"#define XORNET_K {k}",
        f"#define XORNET_M {m}",
        "__device__ __forceinline__ void xornet_network(",
        "    const uint32_t (&x)[XORNET_K], uint32_t (&z)[8 * XORNET_M]) {",
    ]
    body = []
    for j in range(k):
        for s in range(8):
            rows = np.flatnonzero(B[:, j * 8 + s])
            if rows.size:
                body.append(f"  q = (x[{j}] >> {s}) & 0x01010101u;")
                body.append("  " + " ".join(f"z[{r}] ^= q;" for r in rows))
    if body:
        lines += ["  uint32_t q;", *body]
    else:
        lines.append("  (void)x; (void)z;")
    return "\n".join([*lines, "}", ""])


def blockdiag_smem_bytes(k: int, m: int) -> int:
    """Shared memory of one ``sweep_bf16_blockdiag`` block: the table's 32m
    rows, each 128 ceil(k/4) bf16 (its columns in the kernel's K order)
    and 16 bytes of padding."""
    return 32 * m * (128 * -(-k // 4) + 8) * 2


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


#: the production w=8 product, through the same nibble tables: the
#: pipelined kernel changes only how its inputs reach the card's shared
#: memory
pipelined_w8_plain = cuda_gf.matrix_encode_w8_plain


def _pack_parity(acc: torch.Tensor, m: int) -> torch.Tensor:
    """acc [4, 8m, n4] float64 sums, row 8i + l of byte position b ->
    lanes [m, n4] whose bit l of byte b of row i is acc[b, 8i + l] & 1."""
    n4 = acc.shape[-1]
    shifts = torch.arange(8, dtype=torch.int32, device=acc.device)
    bits = (acc.to(torch.int32) & 1).view(4, m, 8, n4)
    bytes_ = (bits << shifts.view(1, 1, 8, 1)).sum(2).to(torch.uint8)
    return bytes_.permute(1, 2, 0).contiguous().view(
        m, n4 * cuda_gf.LANE_BYTES).view(torch.int32)


def _planes(x: torch.Tensor, b: int) -> torch.Tensor:
    """[8k, n4] float64 planes of byte position b: row s*k + j is
    (x[j] >> (8b + s)) & 1."""
    shifts = torch.arange(8, dtype=torch.int32, device=x.device)
    planes = (x.unsqueeze(0) >> (8 * b + shifts).view(8, 1, 1)) & 1
    return planes.reshape(8 * x.shape[0], x.shape[1]).to(torch.float64)


def int8_4dot_plain(bp: torch.Tensor, x: torch.Tensor,
                    k: int, m: int) -> torch.Tensor:
    """For each byte position b < 4: planes[s*k + j] = (x[j] >> (8b+s)) &
    1; acc = bp @ planes; bit l of byte b of output row i = acc[8i+l] & 1.
    The product runs in float64 (sums <= 8k, exact), whatever bp's type."""
    B = bp.to(torch.float64)
    return _pack_parity(torch.stack(
        [B @ _planes(x, b) for b in range(cuda_gf.LANE_BYTES)]), m)


#: the bf16 and f32 rows compute the int8 row's function with other
#: operand types; in float64 the three are one computation
bf16_4dot_plain = f32_4dot_plain = int8_4dot_plain


def bf16_blockdiag_plain(bblk: torch.Tensor, x: torch.Tensor,
                         k: int, m: int) -> torch.Tensor:
    """All 32k plane rows at once, row b*8k + s*k + j = (x[j] >> (8b+s)) &
    1; acc = bblk @ planes, [32m, n4]; bit l of byte b of output row i =
    acc[b*8m + 8i + l] & 1.  In float64 (sums <= 8k, exact)."""
    planes = torch.cat([_planes(x, b) for b in range(cuda_gf.LANE_BYTES)])
    acc = bblk.to(torch.float64) @ planes
    return _pack_parity(acc.view(4, 8 * m, x.shape[1]), m)


def xornet_plain(bitmatrix: np.ndarray, x: torch.Tensor, k: int,
                 m: int) -> torch.Tensor:
    """Bit-row (i, l) = XOR over the support (j, s) of bitmatrix row 8i +
    l of the planes (x[j] >> s) & 0x01010101; output row i = OR over l of
    bit-row (i, l) << l.  Int32 throughout, one plane at a time."""
    B = _support(bitmatrix, k, m)
    out = torch.zeros((m, x.shape[1]), dtype=torch.int32, device=x.device)
    for i in range(m):
        for l in range(8):
            z = torch.zeros_like(out[0])
            for col in np.flatnonzero(B[8 * i + l]):
                j, s = divmod(int(col), 8)
                z ^= (x[j] >> s) & _BYTE_BIT0
            out[i] |= z << l
    return out


def _tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """float32 ``v`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds: 65537 -> 65536."""
    bits = v.to(torch.float32).view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def field_planes(x: torch.Tensor, k: int) -> torch.Tensor:
    """Lanes [k, n4] int32 -> float32 planes [2, 8k, n4] on ``x``'s device:
    [0, s*k + j] = (x[j] >> s) & 0x00010001 and [1, s*k + j] = (x[j] >> (8
    + s)) & 0x00010001, the operand ``planes_product`` takes (the host loop
    of ``kernel_r4_probe.main``, :132-139)."""
    if x.dim() != 2 or x.shape[0] != k:
        raise ValueError(f"field_planes: lanes {tuple(x.shape)} do not fit "
                         f"k={k}")
    planes = torch.empty((2, 8 * k, x.shape[1]), dtype=torch.float32,
                         device=x.device)
    for half in range(2):
        for s in range(8):
            planes[half, s * k:(s + 1) * k] = (x >> (8 * half + s)) & _FIELDS
    return planes


def extract_fold_plain(x: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """``_extract_kernel``'s function: every plane row r = s*k + j of all k
    rows, lo[r] + hi[r] (the fields of :func:`field_planes`), summed over r
    = i (mod m) into output row i, in int32 (m divides 8k; each 16-bit
    field collects at most 16k/m counts, so the sum equals the TPU's exact
    f32 sum cast to int32)."""
    shifts = torch.arange(8, dtype=torch.int32, device=x.device).view(8, 1, 1)
    lanes = x.unsqueeze(0)
    sums = ((lanes >> shifts) & _FIELDS) + ((lanes >> (8 + shifts)) & _FIELDS)
    return sums.view(8 * k // m, m, x.shape[1]).sum(0, dtype=torch.int32)


def _field_product(bp: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   m: int) -> torch.Tensor:
    """accL = bp @ lo, accH = bp @ hi over float32 planes [8k, n4], in
    float64; z = accL + (accH << 8); bit l of byte b of output row i = bit
    8b of z[8i + l]."""
    B = bp.to(torch.float64)
    # sums <= 8k * 65537 < 2^24 (k <= 16): exact in float32 too; z is
    # wanted mod 2^32, where each byte holds one field's count
    accL, accH = ((B @ p.to(torch.float64)).to(torch.int32) for p in (lo, hi))
    n4 = lo.shape[1]
    pb = ((accL + (accH << 8)) & _BYTE_BIT0).view(m, 8, n4)
    out = torch.zeros((m, n4), dtype=torch.int32, device=lo.device)
    for l in range(8):
        out |= pb[:, l] << l
    return out


def planes_plain(bp: torch.Tensor, planes: torch.Tensor, k: int,
                 m: int) -> torch.Tensor:
    """``_mxu_kernel``'s function: ``_kernel_prec``'s two HIGHEST products
    and epilogue over planes [2, 8k, n4] made beforehand
    (:func:`field_planes`)."""
    return _field_product(bp, planes[0], planes[1], m)


def prec_plain(bp: torch.Tensor, x: torch.Tensor, k: int, m: int,
               precision: str) -> torch.Tensor:
    """``_kernel_prec``'s function: planes lo[s*k + j] = (x[j] >> s) &
    0x00010001 and hi[s*k + j] = (x[j] >> (8 + s)) & 0x00010001 (values 0,
    1, 65536, 65537), accL = bp @ lo, accH = bp @ hi, z = accL + (accH <<
    8), bit l of byte b of output row i = bit 8b of z[8i + l].  In float64;
    at ``"DEFAULT"`` the planes are first rounded to TF32 (one pass of a
    reduced-precision product: 65537 becomes 65536), at ``"HIGHEST"`` and
    ``"HIGH"`` they stay exact."""
    if precision not in PREC_KERNELS:
        raise ValueError(f"precision {precision!r} is not one of "
                         f"{', '.join(PREC_KERNELS)}")
    shifts = torch.arange(8, dtype=torch.int32, device=x.device).view(8, 1, 1)
    planes = []
    for base in (0, 8):
        p = ((x.unsqueeze(0) >> (base + shifts)) & _FIELDS).reshape(
            8 * k, x.shape[1]).to(torch.float32)
        planes.append(_tf32_rna(p) if precision == "DEFAULT" else p)
    return _field_product(bp, *planes, m)


def split_plain(bp: torch.Tensor, x: torch.Tensor, k: int, m: int,
                parts: int) -> torch.Tensor:
    """``_kernel_split``'s function at HIGHEST: ``parts`` cuts each tile
    into column chunks, which changes the schedule and not the function,
    so every ``parts`` gives ``prec_plain``'s HIGHEST result."""
    _split_parts("split_plain", parts)
    return prec_plain(bp, x, k, m, "HIGHEST")


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
    """Shared memory of one ``sweep_pipelined_w8`` block: two stages of
    [k, tile] lanes, and the nibble tables (128 k bytes per group of 4
    output rows) where they fit beside them in ``cuda_gf.SMEM_LIMIT``
    (otherwise the kernel reads them through the read-only cache)."""
    stages = 2 * k * tile * 4
    tables = 128 * k * -(-m // 4)
    return stages + tables if stages + tables <= cuda_gf.SMEM_LIMIT \
        else stages


def pipelined_w8(tables: torch.Tensor, x: torch.Tensor, k: int, m: int,
                 tile: int = DEFAULT_TILE) -> torch.Tensor:
    """nibble tables [ceil(m/4), 32*k] (``cuda_gf.prep_matrix_w8``) x
    lanes [k, n4] -> parity lanes [m, n4], staged ``tile`` lanes at a
    time: any positive multiple of 4 whose two stages fit in
    ``cuda_gf.SMEM_LIMIT``."""
    device = _check("sweep_pipelined_w8", tables=(tables, torch.int32),
                    lanes=(x, torch.int32))
    if tuple(tables.shape) != (-(-m // 4), 32 * k) or x.shape[0] != k:
        raise ValueError(f"sweep_pipelined_w8: tables {tuple(tables.shape)} "
                         f"and lanes {tuple(x.shape)} do not fit k={k} m={m}")
    if tile <= 0 or tile % 4:
        raise ValueError(f"sweep_pipelined_w8: tile {tile} is not a positive "
                         "multiple of 4 lanes")
    smem = pipelined_smem_bytes(k, m, tile)
    if smem > cuda_gf.SMEM_LIMIT:
        raise ValueError(f"sweep_pipelined_w8: tile {tile} needs {smem} bytes "
                         f"of shared memory, over {cuda_gf.SMEM_LIMIT}")
    if device.type == "cpu":
        return pipelined_w8_plain(tables, x, k, m)
    out = torch.empty((m, x.shape[1]), dtype=torch.int32, device=device)
    if out.numel():
        _launch("sweep_pipelined_w8", device, x.data_ptr(), tables.data_ptr(),
                out.data_ptr(), k, m, x.shape[1], tile)
    return out


def _dot_operands(name: str, table: torch.Tensor, dtype: torch.dtype,
                  table_shape: tuple, x: torch.Tensor, k: int,
                  m: int) -> torch.device:
    device = _check(name, table=(table, dtype), lanes=(x, torch.int32))
    if tuple(table.shape) != table_shape or x.shape[0] != k:
        raise ValueError(f"{name}: table {tuple(table.shape)} and lanes "
                         f"{tuple(x.shape)} do not fit k={k} m={m}")
    return device


def _dot_run(name: str, device: torch.device, table: torch.Tensor,
             x: torch.Tensor, k: int, m: int, plain) -> torch.Tensor:
    """The product's kernel on the card, its plain version on the CPU."""
    if device.type == "cpu":
        return plain(table, x, k, m)
    out = torch.empty((m, x.shape[1]), dtype=torch.int32, device=device)
    if x.shape[1]:
        _launch(name, device, x.data_ptr(), table.data_ptr(), out.data_ptr(),
                k, m, x.shape[1])
    return out


def _single_plane(name: str, bp: torch.Tensor, x: torch.Tensor, k: int,
                  m: int, plain) -> torch.Tensor:
    dtype, max_k, max_m = DOT_KERNELS[name]
    device = _dot_operands(name, bp, dtype, (8 * m, 8 * k), x, k, m)
    if not (1 <= k <= max_k and 1 <= m <= max_m):
        raise ValueError(f"{name}: k={k} m={m}; the kernel takes "
                         f"k <= {max_k} and m <= {max_m}")
    return _dot_run(name, device, bp, x, k, m, plain)


def int8_4dot(bp: torch.Tensor, x: torch.Tensor, k: int,
              m: int) -> torch.Tensor:
    """bp [8m, 8k] int8 0/1 (``prep_shift_major_w8``) x lanes [k, n4] ->
    parity lanes [m, n4], on the int8 tensor cores."""
    return _single_plane("sweep_int8_4dot", bp, x, k, m, int8_4dot_plain)


def bf16_4dot(bp: torch.Tensor, x: torch.Tensor, k: int,
              m: int) -> torch.Tensor:
    """bp [8m, 8k] bfloat16 0/1 x lanes [k, n4] -> parity lanes [m, n4], on
    the bf16 tensor cores (float32 accumulators)."""
    return _single_plane("sweep_bf16_4dot", bp, x, k, m, bf16_4dot_plain)


def f32_4dot(bp: torch.Tensor, x: torch.Tensor, k: int,
             m: int) -> torch.Tensor:
    """bp [8m, 8k] float32 0/1 x lanes [k, n4] -> parity lanes [m, n4], on
    the TF32 tensor cores (float32 accumulators)."""
    return _single_plane("sweep_f32_4dot", bp, x, k, m, f32_4dot_plain)


def bf16_blockdiag(bblk: torch.Tensor, x: torch.Tensor, k: int,
                   m: int) -> torch.Tensor:
    """bblk [32m, 32k] bfloat16 (``prep_blockdiag_w8``) x lanes [k, n4] ->
    parity lanes [m, n4]: one dense bf16 product over the four byte
    positions, its table staged in shared memory."""
    name = "sweep_bf16_blockdiag"
    device = _dot_operands(name, bblk, torch.bfloat16, (32 * m, 32 * k), x,
                           k, m)
    if not (k >= 1 and 1 <= m <= BLOCKDIAG_MAX_M):
        raise ValueError(f"{name}: k={k} m={m}; the kernel takes "
                         f"m <= {BLOCKDIAG_MAX_M}")
    smem = blockdiag_smem_bytes(k, m)
    if smem > cuda_gf.SMEM_LIMIT:
        raise ValueError(f"{name}: k={k} m={m} stages {smem} bytes of "
                         f"table, over {cuda_gf.SMEM_LIMIT}")
    return _dot_run(name, device, bblk, x, k, m, bf16_blockdiag_plain)


def make_xornet(bitmatrix: np.ndarray, k: int, m: int):
    """The static XOR network of one [8m, 8k] w=8 jerasure bitmatrix:
    ``fn(x)`` maps lanes [k, n4] int32 to parity lanes [m, n4].  On a CUDA
    tensor it launches ``sweep_xornet`` from the library built for this
    bitmatrix (:func:`xornet_source`; built at first use, one library per
    bitmatrix); on a CPU tensor it runs :func:`xornet_plain`."""
    name = "sweep_xornet"
    if not (1 <= k <= XORNET_MAX_K and 1 <= m <= XORNET_MAX_M):
        raise ValueError(f"{name}: k={k} m={m}; the network is built for "
                         f"k <= {XORNET_MAX_K} and m <= {XORNET_MAX_M}")
    bits = _support(bitmatrix, k, m).astype(np.uint8)
    generated = (XORNET_HEADER, xornet_source(bits, k, m))

    def xornet(x: torch.Tensor) -> torch.Tensor:
        device = _check(name, lanes=(x, torch.int32))
        if x.shape[0] != k:
            raise ValueError(f"{name}: lanes {tuple(x.shape)} do not fit "
                             f"k={k}")
        if device.type == "cpu":
            return xornet_plain(bits, x, k, m)
        out = torch.empty((m, x.shape[1]), dtype=torch.int32, device=device)
        if x.shape[1]:
            cuda_gf.launch(XORNET_SOURCE, _XORNET_SIGNATURES, launches, name,
                           device, x.data_ptr(), out.data_ptr(), x.shape[1],
                           generated=generated)
        return out

    xornet.generated = generated
    return xornet


#: id of a float32 table found to hold only 0 and 1 -> (a weak reference
#: to it, its version then): checked once, outside any CUDA graph capture
_binary_tables: Dict[int, tuple] = {}


def _check_binary(name: str, bp: torch.Tensor) -> None:
    """Raise unless ``bp`` holds only 0 and 1, which the TF32 kernels need
    (Bp exact in TF32, so the split product may skip Bp_small).  Read on
    the host once per table and version."""
    seen = _binary_tables.get(id(bp))
    if seen is not None and seen[0]() is bp and seen[1] == bp._version:
        return
    if not bool(((bp == 0) | (bp == 1)).all()):
        raise ValueError(f"{name}: the table must hold only 0 and 1")
    _binary_tables[id(bp)] = (weakref.ref(bp), bp._version)


def prec_product(bp: torch.Tensor, x: torch.Tensor, k: int, m: int,
                 precision: str, tile: int = PREC_TILES[0]) -> torch.Tensor:
    """bp [8m, 8k] float32 0/1 (``prep_shift_major_w8``) x lanes [k, n4] ->
    parity lanes [m, n4]: ``_kernel_prec``'s field-sum product at JAX
    ``precision`` "HIGHEST" (``sweep_prec_f32``, FFMA), "HIGH"
    (``sweep_prec_tf32x3``, split TF32) or "DEFAULT" (``sweep_prec_tf32``,
    one TF32 pass, which rounds the plane value 65537 to 65536 as the TPU's
    one bf16 pass does).  A block takes ``tile`` lanes (a positive multiple
    of 32) per step of its walk."""
    if precision not in PREC_KERNELS:
        raise ValueError(f"precision {precision!r} is not one of "
                         f"{', '.join(PREC_KERNELS)}")
    name = PREC_KERNELS[precision]
    device = _dot_operands(name, bp, torch.float32, (8 * m, 8 * k), x, k, m)
    max_k, max_m = PREC_LIMITS[name]
    if not (1 <= k <= max_k and 1 <= m <= max_m):
        raise ValueError(f"{name}: k={k} m={m}; the kernel takes "
                         f"k <= {max_k} and m <= {max_m}")
    if tile <= 0 or tile % 32:
        raise ValueError(f"{name}: tile {tile} is not a positive multiple "
                         "of 32 lanes")
    _check_binary(name, bp)
    if device.type == "cpu":
        return prec_plain(bp, x, k, m, precision)
    out = torch.empty((m, x.shape[1]), dtype=torch.int32, device=device)
    if x.shape[1]:
        _launch(name, device, x.data_ptr(), bp.data_ptr(), out.data_ptr(),
                k, m, x.shape[1], tile)
    return out


def _split_parts(name: str, parts: int) -> None:
    if parts not in SPLIT_PARTS:
        raise ValueError(f"{name}: parts {parts} is not one of "
                         f"{', '.join(map(str, SPLIT_PARTS))}")


def split_product(bp: torch.Tensor, x: torch.Tensor, k: int, m: int,
                  precision: str, parts: int,
                  tile: int = PREC_TILES[1]) -> torch.Tensor:
    """``_kernel_split``: bp [8m, 8k] float32 0/1 x lanes [k, n4] -> parity
    lanes [m, n4], each tile of ``tile`` lanes cut into ``parts`` column
    chunks.  At parts 1 the function is ``_kernel_prec``'s, so it is
    :func:`prec_product` at any precision; parts 2, 4 and 8 run at
    "HIGHEST" only (``sweep_split_f32``: a warp takes one chunk, a thread
    one lane), with ``tile`` a positive multiple of 32 * parts."""
    name = "sweep_split_f32"
    _split_parts(name, parts)
    if parts == 1:
        return prec_product(bp, x, k, m, precision, tile)
    if precision != "HIGHEST":
        raise ValueError(f"{name}: parts {parts} at precision {precision!r}; "
                         "parts > 1 runs at HIGHEST only")
    device = _dot_operands(name, bp, torch.float32, (8 * m, 8 * k), x, k, m)
    max_k, max_m = PREC_LIMITS["sweep_prec_f32"]
    if not (1 <= k <= max_k and 1 <= m <= max_m):
        raise ValueError(f"{name}: k={k} m={m}; the kernel takes "
                         f"k <= {max_k} and m <= {max_m}")
    if tile <= 0 or tile % (32 * parts):
        raise ValueError(f"{name}: tile {tile} is not a positive multiple "
                         f"of 32 * parts = {32 * parts} lanes")
    _check_binary(name, bp)
    if device.type == "cpu":
        return split_plain(bp, x, k, m, parts)
    out = torch.empty((m, x.shape[1]), dtype=torch.int32, device=device)
    if x.shape[1]:
        _launch(name, device, x.data_ptr(), bp.data_ptr(), out.data_ptr(),
                k, m, x.shape[1], tile, parts)
    return out


def extract_fold(x: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """``_extract_kernel``: lanes [k, n4] int32 -> [m, n4], the planes of
    all k rows folded into m rows (:func:`extract_fold_plain`).  Takes m <=
    ``FOLD_MAX_M`` dividing 8k, and refuses 16k/m * 65537 >= 2^24, where the
    TPU's f32 sum is no longer exact."""
    name = "sweep_extract_fold"
    device = _check(name, lanes=(x, torch.int32))
    if x.shape[0] != k:
        raise ValueError(f"{name}: lanes {tuple(x.shape)} do not fit k={k}")
    if not (k >= 1 and 1 <= m <= FOLD_MAX_M):
        raise ValueError(f"{name}: k={k} m={m}; the kernel takes "
                         f"m <= {FOLD_MAX_M}")
    if (8 * k) % m:
        raise ValueError(f"{name}: m={m} does not divide 8k={8 * k}")
    if 16 * k // m * 65537 >= 1 << 24:
        raise ValueError(f"{name}: 16k/m={16 * k // m} fields of up to 65537 "
                         "reach 2^24, where a float32 sum is not exact")
    if device.type == "cpu":
        return extract_fold_plain(x, k, m)
    out = torch.empty((m, x.shape[1]), dtype=torch.int32, device=device)
    if x.shape[1]:
        _launch(name, device, x.data_ptr(), out.data_ptr(), k, m, x.shape[1])
    return out


def planes_product(bp: torch.Tensor, planes: torch.Tensor, k: int, m: int,
                   tile: int = PREC_TILES[0]) -> torch.Tensor:
    """``_mxu_kernel``: bp [8m, 8k] float32 0/1 x planes [2, 8k, n4]
    float32 (:func:`field_planes`) -> parity lanes [m, n4], the HIGHEST
    product and epilogue of ``prec_product`` without the extraction
    (``sweep_planes_f32``).  A block takes ``tile`` lanes (a positive
    multiple of 32) per step of its walk."""
    name = "sweep_planes_f32"
    if planes.dtype != torch.float32:
        raise TypeError(f"{name}: planes must be torch.float32, got "
                        f"{planes.dtype}")
    if (planes.dim() != 3 or tuple(planes.shape[:2]) != (2, 8 * k)
            or not planes.is_contiguous()):
        raise ValueError(f"{name}: planes must be a contiguous [2, {8 * k}, "
                         f"n4] tensor, got {tuple(planes.shape)}")
    device = _check(name, table=(bp, torch.float32),
                    planes=(planes.view(16 * k, planes.shape[2]),
                            torch.float32))
    if tuple(bp.shape) != (8 * m, 8 * k):
        raise ValueError(f"{name}: table {tuple(bp.shape)} does not fit k={k} "
                         f"m={m}")
    max_k, max_m = PREC_LIMITS["sweep_prec_f32"]
    if not (1 <= k <= max_k and 1 <= m <= max_m):
        raise ValueError(f"{name}: k={k} m={m}; the kernel takes "
                         f"k <= {max_k} and m <= {max_m}")
    if tile <= 0 or tile % 32:
        raise ValueError(f"{name}: tile {tile} is not a positive multiple "
                         "of 32 lanes")
    _check_binary(name, bp)
    if device.type == "cpu":
        return planes_plain(bp, planes, k, m)
    n4 = planes.shape[2]
    out = torch.empty((m, n4), dtype=torch.int32, device=device)
    if n4:
        _launch(name, device, planes.data_ptr(), bp.data_ptr(),
                out.data_ptr(), k, m, n4, tile)
    return out
