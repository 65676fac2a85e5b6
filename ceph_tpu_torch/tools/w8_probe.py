#!/usr/bin/env python
"""Where ``gf2_matrix_w8``'s time goes on the card, and its other settings.

At the main path's shape -- reed_sol_van k=8 m=4 w=8, lanes [8, 2097152]
(8 x 8 MiB stripes fused), 4 output rows -- the rows are:

  kernel          ``csrc/gf_kernels.cu`` as the port builds it
  loads+stores    a build whose lookups XOR the lanes themselves into the
                  accumulators: every input lane loaded and every output
                  lane stored, no table lookup (its output is not checked)
  lookups+stores  a build whose lanes are made from the lane index instead
                  of loaded: the lookups, transposes and stores, no input
                  read (its output is not checked)
  <setting>       a build with other ``kBatch``, thread and VEC constants
                  (``SETTINGS``), bit-exact against the plain version

Each is timed as the port's kernel sweep times its rows
(``ec_kernel_sweep.time_ms``: one CUDA graph of ``--iters`` launches,
back to back) beside the kernel's byte bound (inputs read once, outputs
written once, the tables read once).  Each build is a copy of
``gf_kernels.cu`` and ``gf_w8_tables.cuh`` with constants or one statement
replaced, compiled with the port's nvcc flags into
``build/w8-probe-<n>/``, all at once.

Run (needs an NVIDIA card and nvcc):
    python -m ceph_tpu_torch.tools.w8_probe [--iters 200]
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ceph_tpu_torch.matrices import reed_sol
from ceph_tpu_torch.matrices.bitmatrix import matrix_to_bitmatrix
from ceph_tpu_torch.ops import cuda_gf
from ceph_tpu_torch.tools import ec_kernel_sweep

HEADER = "gf_w8_tables.cuh"
#: the constants of ``gf_kernels.cu`` a setting replaces, as they stand
CONSTANTS = {
    "batch": "constexpr int kBatch = {};",
    "threads": "constexpr int kThreads = {};",
    "vec": "constexpr int kW8Vec = {};",
}
#: the shipped values of CONSTANTS
SHIPPED = {"batch": 4, "threads": 256, "vec": 4}
#: settings timed beside the shipped one: (input rows loaded ahead,
#: threads a block, lanes a thread)
SETTINGS = ((1, 256, 4), (2, 256, 4), (8, 256, 4), (4, 128, 4),
            (4, 512, 4), (4, 256, 2), (4, 256, 8), (2, 256, 8))
#: the lookup body's first line, and what the loads+stores build puts
#: before it: XOR the lane into every accumulator and return
LOOKUP_ANCHOR = ("  // low nibbles times 4 in a4, high nibbles times 4 in b4, "
                 "a byte each\n")
NO_LOOKUP = ("#pragma unroll\n  for (int gg = 0; gg < GP; ++gg)\n"
             "#pragma unroll\n"
             "    for (int b = 0; b < 4; ++b) acc[gg][b] ^= x;\n"
             "  return;\n")
#: the table kernel's input load, and what the lookups+stores build does
#: instead: lanes made from the lane index and the input row
LOAD = ("              load_lanes<VEC>(x + (j0 + jl + b) * n4 + lane0, "
        "xv[b]);\n")
NO_LOAD = ("              for (int v = 0; v < VEC; ++v)\n"
           "                xv[b][v] = static_cast<uint32_t>(lane0 + v) * "
           "0x9E3779B9u + (j0 + jl + b);\n")
K, M = 8, 4
N4 = (8 << 20) // cuda_gf.LANE_BYTES  # 8 stripes of 1 MiB chunks fused


def _replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"no {old!r} in the source")
    return text.replace(old, new)


def setting_source(batch: int, threads: int, vec: int) -> str:
    """``gf_kernels.cu`` with the table kernel's constants replaced."""
    text = cuda_gf.SOURCE.read_text()
    for key, value in zip(CONSTANTS, (batch, threads, vec)):
        text = _replace(text, CONSTANTS[key].format(SHIPPED[key]),
                        CONSTANTS[key].format(value))
    return text


def no_lookup_header() -> str:
    """``gf_w8_tables.cuh`` whose lookup XORs the lane in and returns."""
    return _replace((cuda_gf.CSRC / HEADER).read_text(), LOOKUP_ANCHOR,
                    NO_LOOKUP + LOOKUP_ANCHOR)


def no_load_source() -> str:
    """``gf_kernels.cu`` whose table kernel makes its lanes, not loads
    them."""
    return _replace(cuda_gf.SOURCE.read_text(), LOAD, NO_LOAD)


def builds() -> dict:
    """row -> (kernel source, header source), the shipped build first."""
    source = cuda_gf.SOURCE.read_text()
    header = (cuda_gf.CSRC / HEADER).read_text()
    out = {"kernel": (source, header),
           "loads+stores": (source, no_lookup_header()),
           "lookups+stores": (no_load_source(), header)}
    for s in SETTINGS:
        out["batch={} threads={} vec={}".format(*s)] = (setting_source(*s),
                                                        header)
    return out


def _build(n: int, source: str, header: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(cuda_gf.build_copy(
        cuda_gf.BUILD_DIR / f"w8-probe-{n}", cuda_gf.SOURCE.name, source,
        {HEADER: header})))
    lib.gf2_matrix_w8.argtypes = list(cuda_gf._SIGNATURES["gf2_matrix_w8"])
    lib.gf2_matrix_w8.restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("w8_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    rows = builds()
    with ThreadPoolExecutor(len(rows)) as pool:
        libs = dict(zip(rows, pool.map(
            lambda item: _build(item[0], *item[1][1]),
            enumerate(rows.items()))))

    B = matrix_to_bitmatrix(reed_sol.vandermonde_coding_matrix(K, M, 8), 8)
    tables = torch.from_numpy(cuda_gf.prep_matrix_w8(B, K)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, 256, (K, N4 * 4), dtype=torch.uint8, device=dev,
                      generator=gen).view(torch.int32)
    out = torch.empty((M, N4), dtype=torch.int32, device=dev)
    want = cuda_gf.matrix_encode_w8_plain(tables, x, K, M)
    nbytes = (K + M) * N4 * 4 + tables.numel() * 4
    bound = nbytes / ec_kernel_sweep.HBM_BYTES_PER_S * 1e3

    def launch(lib):
        rc = lib.gf2_matrix_w8(x.data_ptr(), tables.data_ptr(),
                               out.data_ptr(), K, M, N4,
                               torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"gf2_matrix_w8 launch failed: CUDA error {rc}")

    bad = 0
    for name, lib in libs.items():
        launch(lib)
        torch.cuda.synchronize(dev)
        verdict = "n/a (probe)"
        if name not in ("loads+stores", "lookups+stores"):
            ok = torch.equal(out, want)
            verdict = "bit-exact" if ok else "MISMATCH"
            bad += not ok
        ms = ec_kernel_sweep.time_ms(lambda: launch(lib), args.iters, dev)
        print(f"{name:30s} {verdict:12s} {ms:.4f} ms  bound {bound:.4f} ms "
              f"(bytes)  {bound / ms:6.1%} of bound", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
