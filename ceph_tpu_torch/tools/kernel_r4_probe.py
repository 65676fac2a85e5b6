#!/usr/bin/env python
"""Split-cost probes on Hopper: the port of ``experiments/kernel_r4_probe.py``.

Where does the production w=8 product's time go?  For reed_sol_van k=8
m=4 w=8 over ``--size-mib`` MiB chunks (lanes [8, size/4]), the JAX
script's rows:

  full                            the production kernel, ``gf2_matrix_w8``
  extract-only                    every bit plane of all k rows, folded
                                  into m rows without a product
                                  (``sweep_extract_fold``)
  mxu-only (per data-byte equiv)  the HIGHEST products and epilogue over
                                  float32 planes [2, 8k, n4] made
                                  beforehand (``field_planes``), without
                                  the extraction (``sweep_planes_f32``)

Each row is gated against its plain version (a difference exits 1); the
mxu-only row must also be bit-exact against ``gf2_matrix_w8``.  Then each
is timed as the port's kernel sweep times its rows
(``ec_kernel_sweep.time_ms``: one CUDA graph of ``--iters`` launches) and
prints the rate in payload bytes (k * chunk) over the mean time, the JAX
script's unit for every row (the planes are 64 times as many bytes), the
mean ms, the bound and the share of it reached.

The JAX script also sweeps the production kernel's tile (2048 to 16384
lanes).  That sweep has no counterpart: ``gf2_matrix_w8`` runs a
persistent grid with no tile, and ``sweep_pipelined_w8``, the one w=8
product that stages a tile, fits its two stages in shared memory only up
to about 3,600 lanes at k=8.

Run:
    python -m ceph_tpu_torch.tools.kernel_r4_probe [--size-mib 8]
        [--iters 512] [--device cuda]

The card is the default and the tool raises without one; ``--device cpu``
runs the plain versions at ``ec_kernel_sweep.CPU_CHUNK`` bytes a chunk and
says so.
"""

from __future__ import annotations

import sys

import torch

from ceph_tpu_torch.ops import cuda_gf, sweep_gf
from ceph_tpu_torch.tools import ec_kernel_sweep
from ceph_tpu_torch.tools.ec_kernel_sweep import K, M

#: row -> the kernel it times, in the JAX script's order
ROWS = {"full": "gf2_matrix_w8", "extract-only": "sweep_extract_fold",
        "mxu-only (per data-byte equiv)": "sweep_planes_f32"}
#: lanes a block of ``sweep_planes_f32`` takes per step: the JAX script's
#: tile
PLANES_TILE = 4096


def main(argv=None) -> int:
    args = ec_kernel_sweep.tool_parser(__doc__.splitlines()[0]).parse_args(
        argv)
    device, bits, data_np, d32 = ec_kernel_sweep.sweep_data(args.size_mib,
                                                            args.device)
    n4 = d32.shape[1]
    w8_tables = torch.from_numpy(cuda_gf.prep_matrix_w8(bits, K)).to(device)
    bp32 = torch.from_numpy(sweep_gf.prep_shift_major_w8(bits, K)).to(device)
    print(f"reed_sol_van k={K} m={M} w=8, lanes [{K}, {n4}], {args.iters} "
          "iters", flush=True)
    timed = ec_kernel_sweep.row_timer(args.iters, device, data_np.nbytes, n4)

    def row(label, fn, plain, oracle, table_bytes, ref=None) -> int:
        got = fn()
        if not torch.equal(got, plain):
            print(f"{label:30s} MISMATCH against {oracle}", flush=True)
            return 1
        if ref is not None and not torch.equal(got, ref):
            print(f"{label:30s} MISMATCH against gf2_matrix_w8", flush=True)
            return 1
        timed(f"{label:30s}", "bit-exact", ROWS[label], fn, table_bytes)
        return 0

    rc = row("full", lambda: cuda_gf.matrix_encode_w8(w8_tables, d32, K, M),
             cuda_gf.matrix_encode_w8_plain(w8_tables, d32, K, M),
             "matrix_encode_w8_plain", w8_tables.nbytes)
    print("(no tile sweep of the production kernel: gf2_matrix_w8 runs a "
          "persistent grid with no tile, and sweep_pipelined_w8's two "
          "stages fit shared memory only up to about 3,600 lanes at k=8)",
          flush=True)
    rc |= row("extract-only", lambda: sweep_gf.extract_fold(d32, K, M),
              sweep_gf.extract_fold_plain(d32, K, M), "extract_fold_plain", 0)
    ref = cuda_gf.matrix_encode_w8(w8_tables, d32, K, M)
    planes = sweep_gf.field_planes(d32, K)
    rc |= row("mxu-only (per data-byte equiv)",
              lambda: sweep_gf.planes_product(bp32, planes, K, M,
                                              PLANES_TILE),
              sweep_gf.planes_plain(bp32, planes, K, M), "planes_plain",
              bp32.nbytes, ref)
    del planes
    return rc


if __name__ == "__main__":
    sys.exit(main())
