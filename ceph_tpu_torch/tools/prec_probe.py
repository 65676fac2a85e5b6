#!/usr/bin/env python
"""Where ``sweep_prec_tf32x3``'s time goes on the card.

At the kernel sweep's shape -- reed_sol_van k=8 m=4 w=8, lanes [8,
2097152] (8 MiB chunks) -- at the JAX tool's two tiles (4096, 16384), the
rows are:

  kernel            as shipped (``csrc/prec_tf32.cuh``): the A fragments
                    extracted from the words, two wgmma passes (big, small)
  products alone    the A fragments constant: no loads, no extraction; the
                    wgmma, the epilogue and the stores (not checked)
  extraction alone  each wgmma replaced by an XOR of its A fragments into
                    an accumulator: the loads, the extraction, the epilogue
                    and the stores (not checked)
  one pass          the small pass's wgmma left out: half the tensor work
                    (not checked)
  AND, OR fields    each field masked, then 2^23's exponent ORed in, as the
                    compiler emits field_float: the form plane_float's one
                    LOP3 replaced
  products alone, two steps in flight
                    products alone, waiting for the K-step before last
                    (wait_group 1), not the last (not checked)
  2 warpgroups, 3 warpgroups
                    blocks of 2 or 3 warpgroups, not 4
  DEFAULT kernel    ``sweep_prec_tf32`` as shipped (one pass, its own
                    extraction), checked against ``prec_plain(...,
                    "DEFAULT")``

Each row is first checked against its plain version where it computes the
function, then timed back to back, as the port's kernel sweep times its
rows (``ec_kernel_sweep.time_ms``: one CUDA graph of ``--iters``
launches), and flushed (``ec_kernel_sweep.flushed_ms``: L2 overwritten
before each of 20 launches), beside the kernel's bound.  The edited rows
are copies of ``csrc/prec_tf32.cuh`` with statements replaced, each built
with a small frame (:func:`frame`) into ``build/prec-probe-<n>/``, all at
once with the port's nvcc flags.

Run (needs an NVIDIA card and nvcc):
    python -m ceph_tpu_torch.tools.prec_probe [--iters 200]
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ceph_tpu_torch.ops import cuda_gf, sweep_gf
from ceph_tpu_torch.tools import ec_kernel_sweep
from ceph_tpu_torch.tools.ec_kernel_sweep import K, M

HEADER = "prec_tf32.cuh"
FRAME = "prec_probe.cu"
ENTRY = "sweep_prec_tf32x3"

#: the header's statements a row replaces, as they stand
BUILD_A = ("    const uint32_t v = ((r & 1 ? w1 : w0) >> t) >> 4 * (r >> 1);\n"
           "    uint32_t a[Prec::kPasses], b[Prec::kPasses];\n"
           "    Prec::split(plane_float(v), a);\n"
           "    Prec::split(plane_float(v >> 8), b);\n")
CONSTANT_A = ("    uint32_t a[Prec::kPasses], b[Prec::kPasses];\n"
              "    Prec::split(1.0f, a);\n"
              "    Prec::split(65537.0f, b);\n")
WGMMA = "  asm volatile(\n      \"{\\n.reg .pred p;"
XOR_A = ("  d[0] = __uint_as_float(__float_as_uint(d[0]) ^ a[0] ^ a[1] ^ a[2] ^ "
         "a[3]);\n  (void)desc;\n  (void)scale_d;\n  if (0)\n" + WGMMA)
FIELDS = ("    Prec::split(plane_float(v), a);\n"
          "    Prec::split(plane_float(v >> 8), b);\n")
AND_OR_FIELDS = ("    Prec::split(field_float(v & 0x00010001u), a);\n"
                 "    Prec::split(field_float((v >> 8) & 0x00010001u), b);\n")
PASSES = "        for (int p = 0; p < P; ++p)\n"
GROUPS = "  return NB == 1 ? 4 : 2;\n"
#: the end of a K-step, and of the K-steps
STEP_WAIT = "        wgmma_wait<0>();\n        fence_regs(lo[j % 2]);\n"
STEPS_END = "    float accL[NB][16], accH[NB][16];\n"


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"{old!r} is not in the source exactly once")
    return text.replace(old, new)


def frame() -> str:
    """The edited rows' frame: ``sweep_prec_tf32x3`` (the shipped entry
    point's signature) at k <= 8, m <= 4 and 16-byte rows over the header
    beside it."""
    return "\n".join([
        "// Generated by ceph_tpu_torch.tools.prec_probe: the wgmma",
        "// precision kernel at k <= 8, m <= 4, 16-byte rows.",
        "#include <cuda_runtime.h>",
        "#include <stdint.h>",
        "",
        f'#include "{HEADER}"',
        "",
        f'extern "C" int {ENTRY}(const void* x, const void* bp, void* out,',
        "                         int k, int m, long long n4, int T,",
        "                         void* stream) {",
        "  if (T <= 0 || T % 32 != 0 || k < 1 || k > 8 || m < 1 || m > 4 ||",
        "      n4 % 4 != 0 || (reinterpret_cast<uintptr_t>(x) & 15) != 0)",
        "    return static_cast<int>(cudaErrorInvalidValue);",
        "  return launch_prec_tf32<1, PrecTf32x3, 4>(",
        "      x, bp, out, k, m, n4, T, static_cast<cudaStream_t>(stream));",
        "}",
        ""])


def prec_builds() -> dict:
    """row -> the header's text, for the rows built here (the shipped
    kernels are loaded as the port loads them)."""
    header = (cuda_gf.CSRC / HEADER).read_text()
    products = _replace(header, BUILD_A, CONSTANT_A)
    deeper = _replace(products, STEP_WAIT, STEP_WAIT.replace("<0>", "<1>"))
    return {
        "products alone": products,
        "products alone, two steps in flight": _replace(
            deeper, STEPS_END, "    wgmma_wait<0>();\n" + STEPS_END),
        "extraction alone": _replace(header, WGMMA, XOR_A),
        "AND, OR fields": _replace(header, FIELDS, AND_OR_FIELDS),
        "one pass": _replace(header, PASSES,
                             "        for (int p = 0; p < 1; ++p)\n"),
        "2 warpgroups": _replace(header, GROUPS, "  return 2;\n"),
        "3 warpgroups": _replace(header, GROUPS, "  return NB == 1 ? 3 : 2;\n"),
    }


def _build(n: int, text: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(cuda_gf.build_copy(
        cuda_gf.BUILD_DIR / f"prec-probe-{n}", FRAME, frame(),
        {HEADER: text})))
    fn = getattr(lib, ENTRY)
    fn.argtypes = list(sweep_gf._SIGNATURES[ENTRY])
    fn.restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prec_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    builds = prec_builds()
    with ThreadPoolExecutor(len(builds) + 1) as pool:
        shipped = pool.submit(cuda_gf.load, sweep_gf.SOURCE,
                              sweep_gf._SIGNATURES)
        libs = list(pool.map(lambda item: _build(*item),
                             enumerate(builds.values())))
        shipped = shipped.result()
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {smi.strip()}", flush=True)

    _, bits, _, x = ec_kernel_sweep.sweep_data(8, "cuda")
    n4 = x.shape[1]
    bp = torch.from_numpy(sweep_gf.prep_shift_major_w8(bits, K)).to(dev)
    out = torch.empty((M, n4), dtype=torch.int32, device=dev)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    want = {prec: sweep_gf.prec_plain(bp, x, K, M, prec)
            for prec in ("HIGH", "DEFAULT")}
    rows = {"kernel": (shipped.sweep_prec_tf32x3, "HIGH"),
            **{name: (getattr(lib, ENTRY),
                      "HIGH" if name.endswith(("warpgroups", "fields"))
                      else None)
               for name, lib in zip(builds, libs)},
            "DEFAULT kernel": (shipped.sweep_prec_tf32, "DEFAULT")}
    bound, by, _, _ = ec_kernel_sweep.kernel_bound_ms(ENTRY, K, M, n4,
                                                      bp.nbytes)
    print(f"== {ENTRY}, lanes [{K}, {n4}]: back to back ({args.iters} "
          f"launches a graph) and flushed; bound {bound:.4f} ms ({by}; "
          f"two passes: {2 * bound:.4f}) ==", flush=True)
    bad = 0
    for name, (fn, prec) in rows.items():
        for tile in sweep_gf.PREC_TILES:
            def launch(fn=fn, tile=tile):
                rc = fn(x.data_ptr(), bp.data_ptr(), out.data_ptr(), K, M,
                        n4, tile, torch.cuda.current_stream(dev).cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name} launch failed: CUDA error "
                                       f"{rc}")
            out.fill_(-1)
            launch()
            torch.cuda.synchronize(dev)
            verdict = "n/a (probe)"
            if prec is not None:
                ok = torch.equal(out, want[prec])
                verdict = "bit-exact" if ok else "MISMATCH"
                bad += not ok
            ms = ec_kernel_sweep.time_ms(launch, args.iters, dev)
            cold = ec_kernel_sweep.flushed_ms(launch, 20, flush)
            label = f"{name}, tile {tile}"
            print(f"{label:47s} {verdict:12s} back to back {ms:.4f} ms "
                  f"({bound / ms:6.1%} of bound); flushed {cold:.4f} ms "
                  f"({bound / cold:6.1%})", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
