#!/usr/bin/env python
"""Hopper EC kernel sweep: the port of ``tools/ec_kernel_sweep.py``.

Times the w=8 GF(2) product's kernel variants and the two split-cost
probes on one card, each gated bit-exactly before it is timed, for
reed_sol_van k=8 m=4 w=8 over ``--size-mib`` MiB chunks (lanes
[8, size/4]):

  variants  base (the production ``gf2_matrix_w8``), pipelined
            (``sweep_pipelined_w8``: the same nibble-table product with
            double-buffered ``cp.async`` staging),
            and one tensor-core product per byte position in three operand
            types: int8_4dot (``sweep_int8_4dot``), bf16_4dot
            (``sweep_bf16_4dot``) and f32_4dot (``sweep_f32_4dot``, TF32);
            bf16_blockdiag (``sweep_bf16_blockdiag``: one dense bf16
            product with the block-diagonal [32m, 32k] table); xornet
            (``sweep_xornet``: a static XOR network with the bitmatrix
            compiled in, built once per bitmatrix); each gated against
            ``gf2_matrix_w8``'s output
  precision the production product's f32 field sums (``_kernel_prec``)
            at JAX precision HIGHEST (``sweep_prec_f32``, FFMA), HIGH
            (``sweep_prec_tf32x3``, split TF32) and DEFAULT
            (``sweep_prec_tf32``, one TF32 pass), each at tile 4096 and
            16384 (lanes a block takes per step); each row is gated against
            its own plain version (``prec_plain``), then compared with
            ``gf2_matrix_w8``: HIGHEST and HIGH must be bit-exact, DEFAULT
            is expected to MISMATCH (one reduced-precision pass rounds the
            plane value 65537 to 65536, as the TPU's one bf16 pass does)
  split     copy_control (``sweep_copy``: rows < m copied) and
            extract_only (``sweep_extract``: the bit-plane extraction
            alone), each gated against its plain PyTorch version

Each row prints the payload rate (k * chunk bytes over the mean time,
GiB/s, the JAX tool's unit), the mean ms, the least time an H100 SXM could
take for the same work (bytes, or the product's operations at its
operand type's rate) and the share of it reached.  Times are
CUDA events around ``--iters`` back-to-back launches (one CUDA graph)
after one warm launch; at the default 8 MiB the 64 MiB input is larger
than the card's 50 MB L2.

Run:
    python -m ceph_tpu_torch.tools.ec_kernel_sweep [--size-mib 8]
        [--iters 512] [--tile 1024] [--stage variants,precision,split]
        [--only base,pipelined] [--device cuda]

The card is the default and the tool raises without one.  ``--device cpu``
runs the plain versions at a shrunk size and says that its numbers are
not the card's.  A row that differs from its oracle exits with code 1 (a
DEFAULT precision row only if it differs from its own plain version); an
unknown stage or row, or a bad ``--tile``, exits with code 2.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.matrices import reed_sol
from ceph_tpu_torch.matrices.bitmatrix import matrix_to_bitmatrix
from ceph_tpu_torch.ops import cuda_gf, sweep_gf

K, M, W = 8, 4, 8

#: H100 SXM published rates (NVIDIA data sheet; dense tensor-core rates,
#: and float32 on the CUDA cores) at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12
FP32_OPS_PER_S = 67e12
#: product kernel -> (its operand type, the card's rate for it)
OP_RATES = {
    "sweep_int8_4dot": ("int8", INT8_OPS_PER_S),
    "sweep_bf16_4dot": ("bf16", BF16_OPS_PER_S),
    "sweep_f32_4dot": ("tf32", TF32_OPS_PER_S),
    "sweep_bf16_blockdiag": ("bf16", BF16_OPS_PER_S),
    "sweep_prec_f32": ("fp32", FP32_OPS_PER_S),
    "sweep_prec_tf32x3": ("tf32", TF32_OPS_PER_S),
    "sweep_prec_tf32": ("tf32", TF32_OPS_PER_S),
    "sweep_split_f32": ("fp32", FP32_OPS_PER_S),
    "sweep_planes_f32": ("fp32", FP32_OPS_PER_S),
}
#: [8m, 8k] x [8k, n4] products the function of each product kernel needs:
#: one per byte position, or lo and hi field planes
PRODUCTS = {**dict.fromkeys(("sweep_int8_4dot", "sweep_bf16_4dot",
                             "sweep_f32_4dot", "sweep_bf16_blockdiag"), 4),
            **dict.fromkeys((*sweep_gf.PREC_KERNELS.values(),
                             "sweep_split_f32", "sweep_planes_f32"), 2)}

#: chunk bytes of a ``--device cpu`` run, whatever ``--size-mib`` says
CPU_CHUNK = 256 << 10

#: row -> the kernel it times
VARIANTS = {"base": "gf2_matrix_w8", "pipelined": "sweep_pipelined_w8",
            "int8_4dot": "sweep_int8_4dot", "bf16_4dot": "sweep_bf16_4dot",
            "f32_4dot": "sweep_f32_4dot",
            "bf16_blockdiag": "sweep_bf16_blockdiag", "xornet": "sweep_xornet"}
PROBES = {"copy_control": "sweep_copy", "extract_only": "sweep_extract"}
#: precision stage rows, in the JAX tool's order: (precision, tile)
PRECISION_ROWS = tuple((p, t) for p in sweep_gf.PREC_KERNELS
                       for t in sweep_gf.PREC_TILES)
STAGES = ("variants", "precision", "split")


def work(kernel: str, k: int, m: int, n4: int,
         table_bytes: int = 0) -> tuple[int, int]:
    """(bytes, operations) one call of ``kernel`` must move and do over
    lanes [k, n4]: each input byte read once, each output byte written
    once; for a product kernel, the operations the function needs, its
    ``PRODUCTS`` [8m, 8k] x [8k, n4] products with each multiply-add
    counted twice, whatever more a kernel chooses to do (the block-diagonal
    product's zero blocks).  The bit-sliced kernels and the XOR network
    count no operations: the data sheet gives no rate for bitwise integer
    work.  ``sweep_extract_fold`` reads all k rows; ``sweep_planes_f32``
    reads 2 * 8k rows of float32 planes in place of the k rows of lanes."""
    lane_row = n4 * cuda_gf.LANE_BYTES
    if kernel in ("sweep_copy", "sweep_extract"):
        return 2 * m * lane_row, 0
    if kernel == "sweep_extract_fold":
        return (k + m) * lane_row, 0
    ops = 2 * PRODUCTS.get(kernel, 0) * (8 * m) * (8 * k) * n4
    rows_in = 2 * 8 * k if kernel == "sweep_planes_f32" else k
    return (rows_in + m) * lane_row + table_bytes, ops


def bound_ms(nbytes: int, ops: int = 0,
             ops_per_s: float = INT8_OPS_PER_S) -> tuple[float, str]:
    """Least time on an H100 SXM, ms, and what sets it ("bytes" or
    "operations"): the larger of bytes over the memory rate and operations
    over the card's rate for their type (int8 tensor cores unless named)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes, "bytes")


def kernel_bound_ms(kernel: str, k: int, m: int, n4: int,
                    table_bytes: int = 0) -> tuple[float, str, int, int]:
    """(bound ms, what sets it, bytes, operations) of one call of
    ``kernel``, its operations priced at its operand type's rate."""
    nbytes, ops = work(kernel, k, m, n4, table_bytes)
    rate = OP_RATES.get(kernel, ("int8", INT8_OPS_PER_S))[1]
    return (*bound_ms(nbytes, ops, rate), nbytes, ops)


def time_ms(fn, iters: int, device: torch.device) -> float:
    """Mean ms of ``fn`` over ``iters`` back-to-back calls after one warm
    call.  On the card: CUDA events around one replay of a CUDA graph that
    holds the ``iters`` launches, so the host's cost of a launch (tens of
    microseconds through a Python wrapper, as long as the copy itself)
    stays out of the time, as the JAX tool's ``lax.scan`` chain keeps
    dispatch out of its.  On the CPU: the host clock."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    # relaxed: a wrapper's first launch in a process sets kernel
    # attributes, which the default capture mode refuses
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()  # warm: uploads the graph
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


#: clock cycles of the spin kernel before each flushed launch (about 1 ms)
SPIN_CYCLES = 2_000_000


def flushed_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each timed with
    CUDA events after the 50 MB L2 cache is overwritten by zeroing
    ``flush`` (the main path streams granules larger than L2, so its
    kernels find it cold).  A spin kernel holds the card after the flush
    while the host enqueues the events and ``fn``'s launches, so the
    host's time in a Python wrapper stays out of the device time."""
    fn()  # warm
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def sweep_data(size_mib: int, device_name: str):
    """(device, bitmatrix, data bytes [k, chunk] uint8, their lanes [k,
    chunk/4] int32 on the device) of a run of the port's sweep tools:
    reed_sol_van k=8 m=4 w=8 over ``size_mib`` MiB chunks of bytes seeded
    as the JAX tools seed them.  Prints the device; on the CPU the chunk
    shrinks to ``CPU_CHUNK`` and the line says the numbers are not the
    card's."""
    device = resolve_device(device_name)
    if device.type == "cuda":
        chunk = size_mib << 20
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    else:
        chunk = min(size_mib << 20, CPU_CHUNK)
        print(f"device: cpu  (NOT the card -- plain versions at {chunk} B "
              "chunks; the numbers are smoke-test only)", flush=True)
    bits = matrix_to_bitmatrix(reed_sol.vandermonde_coding_matrix(K, M, W), W)
    rng = np.random.RandomState(0)
    data_np = rng.randint(0, 256, size=(K, chunk), dtype=np.uint8)
    d32 = torch.from_numpy(data_np.view(np.int32)).to(device)
    return device, bits, data_np, d32


def row_timer(iters: int, device: torch.device, payload_bytes: int,
              n4: int):
    """``timed(label, verdict, kernel, fn, table_bytes)``: time ``fn`` over
    ``iters`` calls (:func:`time_ms`) and print one row: the payload rate
    (``payload_bytes`` over the mean time, the JAX tools' unit), the mean
    ms and, on the card, the kernel's bound over lanes [K, n4] and the share
    of it reached."""
    on_card = device.type == "cuda"

    def timed(label, verdict, kernel, fn, table_bytes) -> None:
        bound, by, _, _ = kernel_bound_ms(kernel, K, M, n4, table_bytes)
        ms = time_ms(fn, iters, device)
        gibs = payload_bytes / (ms / 1e3) / 2**30
        # the bound is the card's: a CPU row does not stand beside it
        against = (f"  bound {bound:.4f} ms ({by})  {bound / ms:7.1%} of "
                   "bound" if on_card else "  (cpu)")
        print(f"{label} {verdict} {gibs:9.2f} GiB/s  {ms:.4f} ms{against}",
              flush=True)

    return timed


def tool_parser(description: str) -> argparse.ArgumentParser:
    """The arguments of every sweep tool (this one, ``kernel_r4_split``,
    ``kernel_r4_probe``): ``--size-mib``, ``--iters``, ``--device``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--size-mib", type=int, default=8,
                    help="chunk MiB per data row (default 8: lanes "
                         "[8, 2097152])")
    ap.add_argument("--iters", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions, smoke "
                         "test only)")
    return ap


def _parse(argv):
    ap = tool_parser(__doc__.splitlines()[0])
    ap.add_argument("--tile", type=int, default=sweep_gf.DEFAULT_TILE,
                    help="lanes per shared-memory stage of the pipelined "
                         "kernel (a multiple of 4)")
    ap.add_argument("--stage", default=",".join(STAGES),
                    help=f"comma-separated stages (default all: "
                         f"{', '.join(STAGES)})")
    ap.add_argument("--only", default="",
                    help=f"comma-separated variant and probe rows to run "
                         f"(default all: {', '.join([*VARIANTS, *PROBES])}); "
                         "naming any skips the precision stage")
    return ap.parse_args(argv)


def _refused(stages, only, tile) -> str:
    for name in stages:
        if name not in STAGES:
            return f"no stage {name!r} (stages: {', '.join(STAGES)})"
    for name in only:
        if name not in VARIANTS and name not in PROBES:
            return (f"no row {name!r} (rows: "
                    f"{', '.join([*VARIANTS, *PROBES])})")
    if tile <= 0 or tile % 4 or (sweep_gf.pipelined_smem_bytes(K, M, tile)
                                 > cuda_gf.SMEM_LIMIT):
        return (f"--tile {tile} is not a positive multiple of 4 whose two "
                "stages fit in shared memory")
    return ""


def _precision_row(prec, tile, bp32, d32, plain, ref, timed) -> int:
    """One row of the precision stage: the kernel against its plain
    version (a difference exits 1), then against ``gf2_matrix_w8`` (a
    difference exits 1 at HIGHEST and HIGH; at DEFAULT it is the expected
    result), then timed."""
    label = f"{'prec=' + prec:12s} {'tile=' + str(tile):10s}"
    kernel = sweep_gf.PREC_KERNELS[prec]

    def fn():
        return sweep_gf.prec_product(bp32, d32, K, M, prec, tile)

    if not torch.equal(fn(), plain):
        print(f"{label} {kernel} differs from prec_plain", flush=True)
        return 1
    exact = torch.equal(plain, ref)
    timed(label, "bit-exact" if exact else "MISMATCH ", kernel, fn,
          bp32.nbytes)
    return 0 if exact or prec == "DEFAULT" else 1


def main(argv=None) -> int:
    args = _parse(argv)
    stages = [s for s in args.stage.split(",") if s]
    only = [n for n in args.only.split(",") if n]
    refused = _refused(stages, only, args.tile)
    if refused:
        print(f"ec_kernel_sweep: {refused}", file=sys.stderr)
        return 2
    device, bits, data_np, d32 = sweep_data(args.size_mib, args.device)
    n4 = d32.shape[1]
    w8_tables = torch.from_numpy(cuda_gf.prep_matrix_w8(bits, K)).to(device)
    bp32 = torch.from_numpy(sweep_gf.prep_shift_major_w8(bits, K)).to(device)
    bp = bp32.to(torch.int8)
    bp16 = bp32.to(torch.bfloat16)
    bblk = torch.from_numpy(sweep_gf.prep_blockdiag_w8(bits, K, M)).to(
        device, torch.bfloat16)
    xornet = sweep_gf.make_xornet(bits, K, M)
    # row -> its coding table, made once outside the timed calls
    tables = {"base": w8_tables, "pipelined": w8_tables, "int8_4dot": bp,
              "bf16_4dot": bp16, "f32_4dot": bp32, "bf16_blockdiag": bblk}
    print(f"reed_sol_van k={K} m={M} w={W}, lanes [{K}, {n4}], "
          f"{args.iters} iters, tile {args.tile}", flush=True)
    timed = row_timer(args.iters, device, data_np.nbytes, n4)

    def row(name, fn, want, oracle) -> int:
        if not torch.equal(fn(), want):
            print(f"{name:14s} MISMATCH against {oracle}", flush=True)
            return 1
        table = tables.get(name)
        timed(f"{name:14s}", "bit-exact", {**VARIANTS, **PROBES}[name], fn,
              0 if table is None else table.nbytes)
        return 0

    rc = 0
    keep = set(only) or {*VARIANTS, *PROBES}
    if "variants" in stages and keep & set(VARIANTS):
        print("== variants (bit-exact-gated against gf2_matrix_w8) ==",
              flush=True)
        ref = cuda_gf.matrix_encode_w8(w8_tables, d32, K, M)
        calls = {
            "base": lambda: cuda_gf.matrix_encode_w8(w8_tables, d32, K, M),
            "pipelined": lambda: sweep_gf.pipelined_w8(w8_tables, d32, K, M,
                                                       args.tile),
            "int8_4dot": lambda: sweep_gf.int8_4dot(bp, d32, K, M),
            "bf16_4dot": lambda: sweep_gf.bf16_4dot(bp16, d32, K, M),
            "f32_4dot": lambda: sweep_gf.f32_4dot(bp32, d32, K, M),
            "bf16_blockdiag": lambda: sweep_gf.bf16_blockdiag(bblk, d32, K,
                                                              M),
            "xornet": lambda: xornet(d32),
        }
        for name, fn in calls.items():
            if name in keep:
                rc |= row(name, fn, ref, "gf2_matrix_w8")
    if "precision" in stages and not only:
        print("== precision x tile (gated against prec_plain, then compared "
              "with gf2_matrix_w8) ==", flush=True)
        ref = cuda_gf.matrix_encode_w8(w8_tables, d32, K, M)
        for prec in sweep_gf.PREC_KERNELS:
            plain = sweep_gf.prec_plain(bp32, d32, K, M, prec)
            for tile in sweep_gf.PREC_TILES:
                rc |= _precision_row(prec, tile, bp32, d32, plain, ref, timed)
            del plain
    if "split" in stages and keep & set(PROBES):
        print("== split-cost probes (gated against their plain versions) ==",
              flush=True)
        probes = {
            "copy_control": (lambda: sweep_gf.copy_rows(d32, M),
                             sweep_gf.copy_plain(d32, M), "copy_plain"),
            "extract_only": (lambda: sweep_gf.extract_rows(d32, M),
                             sweep_gf.extract_plain(d32, M), "extract_plain"),
        }
        for name, (fn, want, oracle) in probes.items():
            if name in keep:
                rc |= row(name, fn, want, oracle)
    return rc


if __name__ == "__main__":
    sys.exit(main())
