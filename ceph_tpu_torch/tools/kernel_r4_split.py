#!/usr/bin/env python
"""Split-chain probe on Hopper: the port of ``experiments/kernel_r4_split.py``.

The production product's f32 field sums (``_kernel_prec``) with each tile
cut into ``parts`` independent column chunks (``_kernel_split``), for
reed_sol_van k=8 m=4 w=8 over ``--size-mib`` MiB chunks (lanes [8,
size/4]).  The JAX script's four rows:

  split2 tile=8192 HIGHEST    ``sweep_split_f32``, parts 2
  split4 tile=16384 HIGHEST   ``sweep_split_f32``, parts 4
  split8 tile=16384 HIGHEST   ``sweep_split_f32``, parts 8
  split1 tile=16384 DEFAULT   ``sweep_prec_tf32`` (at parts 1 the function
                              is ``_kernel_prec``'s, one TF32 pass)

On this card an independent chain is a warp: a warp of
``sweep_split_f32`` takes one chunk, a thread one lane of it.  Each row is
first gated against its own plain version (``split_plain``, or
``prec_plain`` at DEFAULT; a difference exits 1), then compared with
``gf2_matrix_w8``: the HIGHEST rows must be bit-exact (else exit 1), the
DEFAULT row is expected to MISMATCH, as the JAX script's docstring says
(the field value 65537 is not representable in one reduced-precision
pass).  Then each row is timed as the port's kernel sweep times its rows
(``ec_kernel_sweep.time_ms``: one CUDA graph of ``--iters`` launches) and
prints the payload GiB/s, the mean ms, the bound and the share of it
reached.

Run:
    python -m ceph_tpu_torch.tools.kernel_r4_split [--size-mib 8]
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

#: the JAX script's rows, in its order: (parts, tile, precision)
ROWS = ((2, 8192, "HIGHEST"), (4, 16384, "HIGHEST"), (8, 16384, "HIGHEST"),
        (1, 16384, "DEFAULT"))


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
    ref = cuda_gf.matrix_encode_w8(w8_tables, d32, K, M)
    rc = 0
    for parts, tile, prec in ROWS:
        name = f"{f'split{parts} tile={tile} {prec}':28s}"
        # at parts 1 the function is _kernel_prec's: the precision kernel
        kernel = ("sweep_split_f32" if parts > 1
                  else sweep_gf.PREC_KERNELS[prec])

        def fn(parts=parts, tile=tile, prec=prec):
            return sweep_gf.split_product(bp32, d32, K, M, prec, parts, tile)

        plain = (sweep_gf.split_plain(bp32, d32, K, M, parts)
                 if prec == "HIGHEST"
                 else sweep_gf.prec_plain(bp32, d32, K, M, prec))
        if not torch.equal(fn(), plain):
            print(f"{name} {kernel} differs from its plain version",
                  flush=True)
            rc = 1
            continue
        exact = torch.equal(plain, ref)
        del plain
        timed(name, "bit-exact" if exact else "MISMATCH ", kernel, fn,
              bp32.nbytes)
        if not exact and prec == "HIGHEST":
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
