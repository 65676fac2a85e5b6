#!/usr/bin/env python
"""Where ``sweep_split_f32``'s and ``sweep_copy``'s time goes on the card.

At the kernel sweep's shape -- reed_sol_van k=8 m=4 w=8, lanes [8,
2097152] (8 MiB chunks) -- the rows are:

``sweep_split_f32``, each at the split-chain probe's three settings
(parts 2 tile 8192, parts 4 and 8 tile 16384):

  kernel          as shipped (``csrc/sweep_kernels.cu``): Bp staged in
                  shared memory and read as broadcast LDS.128
  ffma alone      input words made from the lane index, not loaded: the
                  conversions, products and epilogue (not checked)
  no products     the products replaced by one FADD per field: the loads,
                  conversions and epilogue (not checked)
  256 threads     256 threads a block, not 512
  constant bank   the other coefficient route: Bp a ``__grid_constant__``
                  kernel parameter (packed on the host, :func:`split_params`)
                  read as constant-bank operands of the FFMA, with k and m
                  compile-time constants (:func:`param_frame`)

``sweep_copy`` (out = x[:4]), beside ``x[:4].clone()``:

  kernel          as shipped: the register copy, 4 16-byte elements a
                  thread
  register x<u>   the same at <u> 16-byte elements a thread
  bulk <s> x <c> KiB
                  the TMA bulk-copy ring of ``bulk_copy_probe.cu`` (the
                  other design measured), <s> stages of <c> KiB
  grid-stride     the grid-stride map the register copy replaced

While the split rows run, ``nvidia-smi`` samples the SM clock and the
power draw every 200 ms; their range is printed after the rows.

Each row is first checked against its plain version (the split's two
probe rows excepted), then timed back to back, as the port's kernel sweep
times its rows (``ec_kernel_sweep.time_ms``: one CUDA graph of ``--iters``
launches), and flushed (``ec_kernel_sweep.flushed_ms``: L2 overwritten
before each of 20 launches), beside the kernel's bound; the copy rows and
the clone in ``--repeats`` turns.  The split's edited rows are copies of
``csrc/split_f32.cuh`` with statements replaced, each built into
``build/split-probe-<n>/`` with a small frame that launches it at m=4
(:func:`param_frame` for the constant bank); the copy's are copies of
``csrc/sweep_kernels.cu`` with constants or statements replaced, and
``bulk_copy_probe.cu``.  All build at once with the port's nvcc flags.

Run (needs an NVIDIA card and nvcc):
    python -m ceph_tpu_torch.tools.split_probe [--iters 200] [--repeats 5]
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ceph_tpu_torch.ops import cuda_gf, sweep_gf
from ceph_tpu_torch.tools import ec_kernel_sweep
from ceph_tpu_torch.tools.ec_kernel_sweep import K, M

HEADER = "split_f32.cuh"
#: the split-chain probe's rows: (parts, tile)
SPLIT_ROWS = ((2, 8192), (4, 16384), (8, 16384))
#: the split frame's file name
FRAME = "split_probe.cu"

#: the header's statements a split row replaces, as they stand
THREADS = "  return M <= 4 ? 512 : 256;\n"
LOAD = ("    return l < stop ? __ldg(x + static_cast<long long>(j) * n4 + l) "
        ": 0u;\n")
NO_LOAD = ("    return l < stop ? static_cast<uint32_t>(l) * 0x9E3779B9u + j "
           ": 0u;\n")
PRODUCTS = "    for (int q = 0; q < 2 * M; ++q) {\n"
NO_PRODUCTS = ("    accL[s] += lo;\n    accH[s] += hi;\n"
               "    for (int q = 0; q < 0; ++q) {\n")
#: the constant bank: (statement, its replacement), in the header's order
PARAM_EDITS = (
    ("                       const float* __restrict__ bp,\n",
     "                       const __grid_constant__ SplitParam bp,\n"),
    ("  __shared__ __align__(16) float sbp[16 * 8 * 8 * M];\n"
     "  stage_bp_t(bp, k, 8 * M, sbp);\n  __syncthreads();\n",
     "  const float* sbp = bp.v;\n  k = SPLIT_K;  // unrolls the rows\n"),
    ("#pragma unroll 1\n    for (int j = 0; j < k; ++j) {\n",
     "#pragma unroll\n    for (int j = 0; j < k; ++j) {\n"),
    ("      const float4 b = col[q];\n",
     "      const float* c = reinterpret_cast<const float*>(col + q);\n"
     "      const float4 b = make_float4(c[0], c[1], c[2], c[3]);\n"),
    ("static_cast<const float*>(bp)",
     "*static_cast<const SplitParam*>(bp)"),
)

#: sweep_copy's constant a register row replaces
COPY_UNROLL = "constexpr int kCopyUnroll = {};"
COPY_SHIPPED_UNROLL = 4
#: the bulk ring's constants a bulk row replaces, and the shipped values
BULK_SOURCE = "bulk_copy_probe.cu"
BULK_CONSTANTS = ("constexpr int kBulkStages = {};",
                  "constexpr unsigned kBulkChunk = {} * 1024;")
BULK_SHIPPED = (8, 8)
#: copy rows beside the shipped one: label -> (source name, settings)
COPY_SETTINGS = {
    **{f"register x{u}": ("register", u) for u in (2, 8)},
    **{f"bulk {s} x {c} KiB": ("bulk", (s, c))
       for s, c in ((8, 8), (16, 4))},
    "grid-stride (earlier design)": ("grid-stride", None),
}
#: the copy entry's first line, and the grid-stride map of the design
#: the register copy replaced (sweep_extract's loop)
COPY_ENTRY = ("int sweep_copy(const void* x, void* out, int m, long long n4, "
              "void* stream) {\n")
GRID_STRIDE = "  return launch_rows<CopyOp>(x, out, m, n4, stream);\n"
COPY_OP = ("struct CopyOp {\n  __device__ __forceinline__ uint32_t "
           "operator()(uint32_t v) const { return v; }\n};\n\n")
EXTRACT_OP = "struct ExtractOp {\n"


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"{old!r} is not in the source exactly once")
    return text.replace(old, new)


def _read(name: str) -> str:
    return (cuda_gf.CSRC / name).read_text()


def split_params(bp: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """Bp [8m, 8k] -> float32 [8k * 8m] on the CPU, the constant bank's
    kernel parameter: Bp transposed, row j*8 + s holding column s*k + j
    (input row j's bit plane s) of all 8m bit-rows, as ``stage_bp_t``
    stages it in shared memory."""
    t = bp.detach().to("cpu", torch.float32).view(8 * m, 8, k)
    return t.permute(2, 1, 0).contiguous().view(-1)


def param_frame(k: int, m: int) -> str:
    """The frame of the split rows: ``sweep_split_f32`` at m (the shipped
    entry point's signature) over the header beside it.  For the constant
    bank it also fixes k and declares the kernel parameter's type: nothing
    of any bitmatrix, which arrives with each launch."""
    return "\n".join([
        "// Generated by ceph_tpu_torch.tools.split_probe: the split kernel",
        f"// at k={k} m={m}.",
        "#include <cuda_runtime.h>",
        "#include <stdint.h>",
        "",
        f"#define SPLIT_K {k}",
        "// Bp transposed, [8k][8m], as stage_bp_t stages it",
        f"struct SplitParam {{ float v[64 * SPLIT_K * {m}]; }};",
        "",
        f'#include "{HEADER}"',
        "",
        'extern "C" int sweep_split_f32(const void* x, const void* bp,',
        "                               void* out, int k, int m, long long n4,",
        "                               int T, int parts, void* stream) {",
        f"  if (k != SPLIT_K || m != {m} || !split_shape_ok(k, n4, T, parts))",
        "    return static_cast<int>(cudaErrorInvalidValue);",
        f"  return launch_split_f32<{m}>(x, bp, out, k, n4, T, parts,",
        "                              static_cast<cudaStream_t>(stream));",
        "}",
        ""])


def split_builds() -> dict:
    """split row -> the header's text, for the rows built here (the
    shipped kernel is loaded as the port loads it)."""
    header = _read(HEADER)
    param = header
    for old, new in PARAM_EDITS:
        param = _replace(param, old, new)
    return {
        "ffma alone": _replace(header, LOAD, NO_LOAD),
        "no products": _replace(header, PRODUCTS, NO_PRODUCTS),
        "256 threads": _replace(header, THREADS, "  return 256;\n"),
        "constant bank": param,
    }


def copy_builds() -> dict:
    """copy row -> (source file name, its text), for the rows built here."""
    out = {}
    for label, (kind, value) in COPY_SETTINGS.items():
        if kind == "register":
            out[label] = (sweep_gf.SOURCE, _replace(
                _read(sweep_gf.SOURCE),
                COPY_UNROLL.format(COPY_SHIPPED_UNROLL),
                COPY_UNROLL.format(value)))
        elif kind == "bulk":
            text = (Path(__file__).parent / BULK_SOURCE).read_text()
            for const, old, new in zip(BULK_CONSTANTS, BULK_SHIPPED, value):
                text = _replace(text, const.format(old), const.format(new))
            out[label] = (BULK_SOURCE, text)
        else:
            text = _replace(_read(sweep_gf.SOURCE), EXTRACT_OP,
                            COPY_OP + EXTRACT_OP)
            out[label] = (sweep_gf.SOURCE,
                          _replace(text, COPY_ENTRY, COPY_ENTRY + GRID_STRIDE))
    return out


def _build(n: int, name: str, text: str, headers: dict,
           entry: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(cuda_gf.build_copy(
        cuda_gf.BUILD_DIR / f"split-probe-{n}", name, text, headers)))
    fn = getattr(lib, entry)
    fn.argtypes = list(sweep_gf._SIGNATURES[entry])
    fn.restype = ctypes.c_int
    return lib


def _stream(dev: torch.device) -> int:
    """The current stream, read at each launch: a CUDA graph captures on a
    stream of its own."""
    return torch.cuda.current_stream(dev).cuda_stream


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def _spread(values) -> str:
    return (f"median {statistics.median(values):.4f} ms (min "
            f"{min(values):.4f}, max {max(values):.4f}, n {len(values)})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=5,
                    help="turns of the copy and clone timings")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("split_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    frame = param_frame(K, M)
    jobs = [(FRAME, frame, {HEADER: header}, "sweep_split_f32")
            for header in split_builds().values()]
    jobs += [(name, text, {}, "sweep_copy")
             for name, text in copy_builds().values()]
    with ThreadPoolExecutor(len(jobs) + 1) as pool:
        shipped = pool.submit(cuda_gf.load, sweep_gf.SOURCE,
                              sweep_gf._SIGNATURES)
        libs = list(pool.map(lambda item: _build(item[0], *item[1]),
                             enumerate(jobs)))
        shipped = shipped.result()
    split_libs = {"kernel": shipped,
                  **dict(zip(split_builds(), libs[:len(split_builds())]))}
    copy_libs = {"kernel": shipped,
                 **dict(zip(COPY_SETTINGS, libs[len(split_builds()):]))}

    _, bits, _, x = ec_kernel_sweep.sweep_data(8, "cuda")
    n4 = x.shape[1]
    bp = torch.from_numpy(sweep_gf.prep_shift_major_w8(bits, K)).to(dev)
    params = split_params(bp, K, M)
    out = torch.empty((M, n4), dtype=torch.int32, device=dev)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    bad = 0

    want = sweep_gf.split_plain(bp, x, K, M, 2)
    bound, by, _, _ = ec_kernel_sweep.kernel_bound_ms(
        "sweep_split_f32", K, M, n4, bp.nbytes)
    print(f"== sweep_split_f32, lanes [{K}, {n4}]: back to back ({args.iters}"
          f" launches a graph) and flushed; bound {bound:.4f} ms ({by}) ==",
          flush=True)
    smi = subprocess.Popen(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "200"],
        stdout=subprocess.PIPE, text=True)
    for name, lib in split_libs.items():
        table = params if name == "constant bank" else bp
        for parts, tile in SPLIT_ROWS:
            def launch(lib=lib, table=table, parts=parts, tile=tile):
                _check(lib.sweep_split_f32(
                    x.data_ptr(), table.data_ptr(), out.data_ptr(), K, M, n4,
                    tile, parts, _stream(dev)), name)
            out.fill_(-1)
            launch()
            torch.cuda.synchronize(dev)
            verdict = "n/a (probe)"
            if name not in ("ffma alone", "no products"):
                ok = torch.equal(out, want)
                verdict = "bit-exact" if ok else "MISMATCH"
                bad += not ok
            ms = ec_kernel_sweep.time_ms(launch, args.iters, dev)
            cold = ec_kernel_sweep.flushed_ms(launch, 20, flush)
            label = f"{name}, parts {parts} tile {tile}"
            print(f"{label:42s} {verdict:12s} back to back {ms:.4f} ms "
                  f"({bound / ms:6.1%} of bound); flushed {cold:.4f} ms "
                  f"({bound / cold:6.1%})", flush=True)
    smi.terminate()
    samples = [tuple(map(float, line.split(",")))
               for line in smi.communicate()[0].splitlines() if line.strip()]
    clocks, watts = zip(*samples) if samples else ((), ())
    if samples:
        print(f"SM clock during the split rows {min(clocks):.0f}-"
              f"{max(clocks):.0f} MHz (median {statistics.median(clocks):.0f}"
              f"), power {min(watts):.1f}-{max(watts):.1f} W, "
              f"{len(samples)} samples", flush=True)
    del want

    want = sweep_gf.copy_plain(x, M)
    bound, by, _, _ = ec_kernel_sweep.kernel_bound_ms("sweep_copy", K, M, n4)
    print(f"== sweep_copy, lanes [{K}, {n4}] -> [{M}, {n4}]: back to back "
          f"and flushed in {args.repeats} turns; bound {bound:.4f} ms ({by}) "
          "==", flush=True)
    rows = {"x[:4].clone()": lambda: x[:M].clone()}
    for name, lib in copy_libs.items():
        def launch(lib=lib, name=name):
            _check(lib.sweep_copy(x.data_ptr(), out.data_ptr(), M, n4,
                                  _stream(dev)), name)
        out.fill_(-1)
        launch()
        torch.cuda.synchronize(dev)
        if not torch.equal(out, want):
            print(f"{name:34s} MISMATCH", flush=True)
            bad += 1
        rows[name] = launch
    graph = {name: [] for name in rows}
    flushed = {name: [] for name in rows}
    for rep in range(args.repeats):
        # in turns, the order reversed every other turn
        order = list(rows) if rep % 2 == 0 else list(rows)[::-1]
        for name in order:
            graph[name].append(ec_kernel_sweep.time_ms(rows[name],
                                                       args.iters, dev))
            flushed[name].append(ec_kernel_sweep.flushed_ms(rows[name], 20,
                                                            flush))
    for name in rows:
        verdict = "library" if name == "x[:4].clone()" else "bit-exact"
        print(f"{name:34s} {verdict:12s} back to back "
              f"{_spread(graph[name])}; flushed {_spread(flushed[name])}; "
              f"{bound / statistics.median(flushed[name]):6.1%} of bound "
              "flushed", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
