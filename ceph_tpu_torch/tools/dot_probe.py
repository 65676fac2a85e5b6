#!/usr/bin/env python
"""Where the single-bit-plane products' time goes on the card.

``sweep_int8_4dot``, ``sweep_bf16_4dot``, ``sweep_f32_4dot`` and
``sweep_bf16_blockdiag`` are one wgmma kernel template
(``csrc/dot_wgmma.cuh``).  At the kernel sweep's shape -- reed_sol_van k=8
m=4 w=8, lanes [8, 2097152] (8 MiB chunks) -- each of the four runs as:

  kernel            as shipped: A built from the words, four wgmma a K-step
  products alone    the A fragments constant: no loads of words into
                    registers, no extraction; the wgmma, the ring's copies,
                    the epilogue and the stores (not checked)
  extraction alone  each wgmma replaced by an XOR of its A fragments into
                    an accumulator: the copies, the loads, the extraction,
                    the epilogue and the stores (not checked)
  copies and epilogue alone
                    both edits: the ring's copies, the epilogue and the
                    stores, with neither products nor extraction (not
                    checked)
  2 warpgroups, 3 warpgroups
                    blocks of 2 or 3 warpgroups, not 4 (checked)

Each row is first checked against its plain version where it computes the
function, then timed back to back (``ec_kernel_sweep.time_ms``: one CUDA
graph of ``--iters`` launches) and flushed (``ec_kernel_sweep.flushed_ms``:
L2 overwritten before each of 20 launches), beside the row's bound (and
the block-diagonal product's dense operations).  The edited rows are
copies of ``csrc/dot_wgmma.cuh`` with statements replaced, each built with
a small frame (:func:`frame`) into ``build/dot-probe-<n>/``, all at once
with the port's nvcc flags.

Run (needs an NVIDIA card and nvcc):
    python -m ceph_tpu_torch.tools.dot_probe [--iters 200]
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

HEADER = "dot_wgmma.cuh"
FRAME = "dot_probe.cu"
#: entry point -> what the frame's entry point calls
ENTRIES = {
    "sweep_int8_4dot": "run_4dot<Int8Dot>",
    "sweep_bf16_4dot": "run_4dot<Bf16Dot>",
    "sweep_f32_4dot": "run_4dot<Tf32Dot>",
    "sweep_bf16_blockdiag": "run_blockdiag",
}

#: the header's statements a row replaces, as they stand
BUILD_A = ("      a[b][r] = Op::frag((r & 1 ? w1 : w0) >> (8 * b + 4 * (r >> "
           "1)));\n")
CONSTANT_A = "      a[b][r] = Op::frag(1u);\n"
ASM = ("#define DOT_ASM(INSTR, D, SUFFIX, ...)                                "
       "    \\\n  asm volatile(")
MIX = """// the probe's stand-in for a wgmma: its A fragments XORed into d[0]
__device__ __forceinline__ void dot_mix(float* d, const uint32_t (&a)[4]) {
  d[0] = __uint_as_float(__float_as_uint(d[0]) ^ a[0] ^ a[1] ^ a[2] ^ a[3]);
}
__device__ __forceinline__ void dot_mix(int* d, const uint32_t (&a)[4]) {
  d[0] ^= static_cast<int>(a[0] ^ a[1] ^ a[2] ^ a[3]);
}

#define DOT_ASM(INSTR, D, SUFFIX, ...) \\
  {                                    \\
    dot_mix(d, a);                     \\
    (void)desc;                        \\
    (void)scale_d;                     \\
  }                                    \\
  if (0) asm volatile("""
GROUPS = "  return nacc <= 64 ? 4 : 2;\n"


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"{old!r} is not in the source exactly once")
    return text.replace(old, new)


def frame() -> str:
    """The edited rows' frame: the four entry points (the shipped
    signatures and limits) over the header beside it."""
    lines = [
        "// Generated by ceph_tpu_torch.tools.dot_probe: the wgmma product",
        "// kernels' four entry points.",
        "#include <cuda_runtime.h>",
        "#include <stdint.h>",
        "",
        f'#include "{HEADER}"',
        "",
    ]
    for entry, call in ENTRIES.items():
        lines += [
            f'extern "C" int {entry}(const void* x, const void* table,',
            "                        void* out, int k, int m, long long n4,",
            "                        void* stream) {",
            f"  return {call}(x, table, out, k, m, n4, stream);",
            "}",
            ""]
    return "\n".join(lines)


def dot_builds() -> dict:
    """row -> the header's text, for the rows built here (the shipped
    kernels are loaded as the port loads them)."""
    header = (cuda_gf.CSRC / HEADER).read_text()
    products = _replace(header, BUILD_A, CONSTANT_A)
    return {
        "products alone": products,
        "extraction alone": _replace(header, ASM, MIX),
        "copies and epilogue alone": _replace(products, ASM, MIX),
        "2 warpgroups": _replace(header, GROUPS, "  return 2;\n"),
        "3 warpgroups": _replace(header, GROUPS,
                                 "  return nacc <= 64 ? 3 : 2;\n"),
    }


def _build(n: int, text: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(cuda_gf.build_copy(
        cuda_gf.BUILD_DIR / f"dot-probe-{n}", FRAME, frame(),
        {HEADER: text})))
    for entry in ENTRIES:
        fn = getattr(lib, entry)
        fn.argtypes = list(sweep_gf._SIGNATURES[entry])
        fn.restype = ctypes.c_int
    return lib


def _tables(bits, dev) -> dict:
    """entry -> its table on the card, as the sweep makes it."""
    bp = torch.from_numpy(sweep_gf.prep_shift_major_w8(bits, K)).to(dev)
    bblk = torch.from_numpy(sweep_gf.prep_blockdiag_w8(bits, K, M)).to(
        dev, torch.bfloat16)
    return {"sweep_int8_4dot": bp.to(torch.int8),
            "sweep_bf16_4dot": bp.to(torch.bfloat16),
            "sweep_f32_4dot": bp, "sweep_bf16_blockdiag": bblk}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dot_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    builds = dot_builds()
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
    out = torch.empty((M, n4), dtype=torch.int32, device=dev)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    want = sweep_gf.int8_4dot_plain(
        torch.from_numpy(sweep_gf.prep_shift_major_w8(bits, K)).to(dev), x,
        K, M)
    bad = 0
    for entry, table in _tables(bits, dev).items():
        bound, by, _, ops = ec_kernel_sweep.kernel_bound_ms(
            entry, K, M, n4, table.nbytes)
        note = f"bound {bound:.4f} ms ({by})"
        if entry == "sweep_bf16_blockdiag":
            dense = 4 * ops / ec_kernel_sweep.BF16_OPS_PER_S * 1e3
            note += f"; the dense product's operations {dense:.4f} ms"
        print(f"== {entry}, lanes [{K}, {n4}]: back to back ({args.iters} "
              f"launches a graph) and flushed; {note} ==", flush=True)
        rows = {"kernel": (getattr(shipped, entry), True),
                **{name: (getattr(lib, entry), name.endswith("warpgroups"))
                   for name, lib in zip(builds, libs)}}
        for name, (fn, checked) in rows.items():
            def launch(fn=fn, table=table):
                rc = fn(x.data_ptr(), table.data_ptr(), out.data_ptr(), K, M,
                        n4, torch.cuda.current_stream(dev).cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{entry} {name} launch failed: CUDA "
                                       f"error {rc}")
            out.fill_(-1)
            launch()
            torch.cuda.synchronize(dev)
            verdict = "n/a (probe)"
            if checked:
                ok = torch.equal(out, want)
                verdict = "bit-exact" if ok else "MISMATCH"
                bad += not ok
            ms = ec_kernel_sweep.time_ms(launch, args.iters, dev)
            cold = ec_kernel_sweep.flushed_ms(launch, 20, flush)
            print(f"{name:26s} {verdict:12s} back to back {ms:.4f} ms "
                  f"({bound / ms:6.1%} of bound); flushed {cold:.4f} ms "
                  f"({bound / cold:6.1%})", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
