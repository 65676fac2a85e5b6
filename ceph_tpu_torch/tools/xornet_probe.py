#!/usr/bin/env python
"""Where ``sweep_xornet``'s time goes on the card.

``sweep_xornet`` (``csrc/xornet_kernel.cu``) runs the static XOR network
of one bitmatrix over transposed 32-bit planes.  At the kernel sweep's
shape -- reed_sol_van k=8 m=4 w=8, lanes [8, 2097152] (8 MiB chunks) --
the rows are:

  kernel            as shipped (and for cauchy_good k=8 m=4: its own
                    library)
  loads and stores alone
                    no transposes and no network: each row's words XORed
                    into 8 accumulators, stored untransposed (not checked)
  loads, transposes and stores
                    every transpose, no network: each row's planes XORed
                    into 8 accumulators (not checked)
  plane per lane    the network of the form this kernel replaced, run once
                    per lane on (x >> s) & 0x01010101 planes and packed with
                    shift-ors, 4 lanes a thread, in this kernel's frame
  4 lanes a thread  one uint4 a row: 16 useful bits a plane
  persistent grid   the grid capped at the blocks the card holds at once,
                    each warp walking spans, as before this design

Each row is first checked against ``xornet_plain`` where it computes the
function, then timed flushed (``ec_kernel_sweep.flushed_ms``: L2
overwritten before each of 20 launches) and back to back
(``ec_kernel_sweep.time_ms``: one CUDA graph of ``--iters`` launches),
beside the kernel's bound.  The edited rows are copies of
``csrc/xornet_kernel.cu`` with statements replaced (:func:`xornet_builds`),
each built with the reed_sol_van network into ``build/xornet-probe-<n>/``,
all at once with the port's nvcc flags.  The ptxas report (registers and
spills) is printed for every build and for the shipped kernel at k=8 m=4
and k=16 m=8, and each network's XORs as generated and after greedy
pair elimination (:func:`greedy_xor_count`, counted on the host).

Run (needs an NVIDIA card and nvcc):
    python -m ceph_tpu_torch.tools.xornet_probe [--iters 200]
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ceph_tpu_torch.matrices import cauchy, reed_sol
from ceph_tpu_torch.matrices.bitmatrix import matrix_to_bitmatrix
from ceph_tpu_torch.ops import cuda_gf, sweep_gf
from ceph_tpu_torch.tools import ec_kernel_sweep
from ceph_tpu_torch.tools.ec_kernel_sweep import K, M

SOURCE = sweep_gf.XORNET_SOURCE
ENTRY = "sweep_xornet"

#: the frame's statements a row replaces, as they stand
NET = "    transpose8(w[J - J0]);\n    xornet_row<J>(w[J - J0], z);\n"
MIX = ("#pragma unroll\n"
       "    for (int s = 0; s < 8; ++s) z[8 * (J % XORNET_M) + s] ^= "
       "w[J - J0][s];\n")
OUT_TRANSPOSE = "      transpose8(o);\n"
QUADS = "constexpr int kQuads = 2;\n"
BODY = """    uint32_t z[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) z[r] = 0u;
    batch_rows<0, kVec>(x, base, lane, n4, z);
#pragma unroll
    for (int i = 0; i < XORNET_M; ++i) {
      uint32_t o[8];
#pragma unroll
      for (int l = 0; l < 8; ++l) o[l] = z[8 * i + l];
      transpose8(o);
      store8<kVec>(out + static_cast<long long>(i) * n4, base, lane, n4, o);
    }
"""
#: the replaced form's body: every row's words loaded, then for each lane the network on
#: (x >> s) & 0x01010101 planes (``lane_network_source``) and a shift-or
#: pack of each output row
LANE_BODY = """    uint32_t v[XORNET_K][8];
#pragma unroll
    for (int j = 0; j < XORNET_K; ++j)
      load8<kVec>(x + static_cast<long long>(j) * n4, base, lane, n4, v[j]);
    uint32_t o[XORNET_M][8];
#pragma unroll
    for (int e = 0; e < kWords; ++e) {
      uint32_t xe[XORNET_K];
#pragma unroll
      for (int j = 0; j < XORNET_K; ++j) xe[j] = v[j][e];
      uint32_t zl[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) zl[r] = 0u;
      xornet_network(xe, zl);
#pragma unroll
      for (int i = 0; i < XORNET_M; ++i) {
        uint32_t word = 0u;
#pragma unroll
        for (int l = 0; l < 8; ++l) word |= zl[8 * i + l] << l;
        o[i][e] = word;
      }
    }
#pragma unroll
    for (int i = 0; i < XORNET_M; ++i)
      store8<kVec>(out + static_cast<long long>(i) * n4, base, lane, n4,
                   o[i]);
"""
GRID = "  const long long blocks = (spans + kWarps - 1) / kWarps;\n"
PERSISTENT_GRID = """  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, xornet_kernel<kVec>, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long work = (spans + kWarps - 1) / kWarps;
  const long long most = static_cast<long long>(sms) * per_sm;
  const long long blocks = work < most ? work : most;
"""


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"{old!r} is not in the source exactly once")
    return text.replace(old, new)


def lane_network_source(bitmatrix: np.ndarray, k: int, m: int) -> str:
    """``xornet_network(x, z)`` of the replaced form: for one lane of each
    input row, the plane ``(x[j] >> s) & 0x01010101`` (bit s of four
    bytes) of every used (j, s), XORed into its bit-rows' accumulators.
    Appended to the generated header of the plane-per-lane row."""
    B = sweep_gf._support(bitmatrix, k, m)
    lines = ["__device__ __forceinline__ void xornet_network(",
             "    const uint32_t (&x)[XORNET_K], "
             "uint32_t (&z)[8 * XORNET_M]) {",
             "  uint32_t q;"]
    for j in range(k):
        for s in range(8):
            rows = np.flatnonzero(B[:, j * 8 + s])
            if rows.size:
                lines.append(f"  q = (x[{j}] >> {s}) & 0x01010101u;")
                lines.append("  " + " ".join(f"z[{r}] ^= q;" for r in rows))
    return "\n".join([*lines, "}", ""])


def xornet_builds(bits: np.ndarray) -> dict:
    """row -> (the frame's text, the header's text) for the rows built
    here, over the network of ``bits`` (the shipped kernel is loaded as
    the port loads it)."""
    frame = (cuda_gf.CSRC / SOURCE).read_text()
    header = sweep_gf.xornet_source(bits, K, M)
    lane_header = header + lane_network_source(bits, K, M)
    no_net = _replace(frame, NET, MIX)
    return {
        "loads and stores alone": (_replace(no_net, OUT_TRANSPOSE, ""),
                                   header),
        "loads, transposes and stores": (
            _replace(frame, NET, "    transpose8(w[J - J0]);\n" + MIX),
            header),
        "plane per lane": (
            _replace(_replace(frame, BODY, LANE_BODY), QUADS,
                     "constexpr int kQuads = 1;\n"), lane_header),
        "4 lanes a thread": (
            _replace(frame, QUADS, "constexpr int kQuads = 1;\n"), header),
        "persistent grid": (_replace(frame, GRID, PERSISTENT_GRID), header),
    }


def greedy_xor_count(bitmatrix: np.ndarray) -> int:
    """XORs of the network of a 0/1 bitmatrix after greedy pair
    elimination (Paar): while some pair of signals occurs together in two
    or more bit-rows, the most frequent pair (the first on a tie) becomes
    one new signal, its XOR computed once.  The network as generated takes
    ones - nonzero rows XORs."""
    rows = np.asarray(bitmatrix, dtype=np.int64)
    rows = rows[rows.any(1)]
    made = 0
    while True:
        pairs = np.triu(rows.T @ rows, 1)
        a, b = np.unravel_index(np.argmax(pairs), pairs.shape)
        if pairs[a, b] < 2:
            return made + int(rows.sum() - len(rows))
        both = rows[:, a] & rows[:, b]
        rows[:, a] -= both
        rows[:, b] -= both
        rows = np.concatenate([rows, both[:, None]], axis=1)
        made += 1


#: rows that compute the function, and are checked
CHECKED = ("plane per lane", "4 lanes a thread", "persistent grid")


def ptxas_report(log: str) -> list:
    """'<kernel>: <n> registers, <s> bytes spill stores, <l> bytes spill
    loads' for each ``xornet_kernel`` instance in an nvcc ``-Xptxas -v``
    report (form: 16-byte or one-word)."""
    rows, name, spills = [], None, None
    for line in log.splitlines():
        found = re.search(r"Function properties for (\S+)", line)
        if found:
            name, spills = found.group(1), None
            continue
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if found and name:
            spills = found.groups()
            continue
        found = re.search(r"Used (\d+) registers", line)
        if found and name and "xornet_kernel" in name:
            form = "16-byte" if "ILb1E" in name else "one-word"
            stores, loads = spills or ("?", "?")
            rows.append(f"xornet_kernel ({form} form): {found.group(1)} "
                        f"registers, {stores} bytes spill stores, {loads} "
                        "bytes spill loads")
            name = None
    return rows


def _code_bits(code: str, k: int, m: int) -> np.ndarray:
    coding = {"reed_sol_van": reed_sol.vandermonde_coding_matrix,
              "cauchy_good": cauchy.good_general_coding_matrix}[code]
    return matrix_to_bitmatrix(coding(k, m, 8), 8)


def _build(n: int, texts) -> tuple:
    frame, header = texts
    path = cuda_gf.build_copy(cuda_gf.BUILD_DIR / f"xornet-probe-{n}", SOURCE,
                              frame, {sweep_gf.XORNET_HEADER: header})
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, ENTRY)
    fn.argtypes = list(sweep_gf._XORNET_SIGNATURES[ENTRY])
    fn.restype = ctypes.c_int
    return fn, path.with_suffix(".log").read_text()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("xornet_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    codes = {"reed_sol_van k=8 m=4": _code_bits("reed_sol_van", K, M),
             "cauchy_good k=8 m=4": _code_bits("cauchy_good", K, M)}
    wide = sweep_gf.make_xornet(_code_bits("reed_sol_van", 16, 8), 16, 8)
    shipped = {label: sweep_gf.make_xornet(bits, K, M)
               for label, bits in codes.items()}
    builds = xornet_builds(codes["reed_sol_van k=8 m=4"])
    with ThreadPoolExecutor(len(builds) + 3) as pool:
        libs = [pool.submit(cuda_gf.build, SOURCE, fn.generated)
                for fn in (*shipped.values(), wide)]
        edited = list(pool.map(lambda item: _build(*item),
                               enumerate(builds.values())))
        libs = [lib.result() for lib in libs]
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {smi.strip()}", flush=True)
    for label, lib in zip((*shipped, "reed_sol_van k=16 m=8"), libs):
        for line in ptxas_report(cuda_gf.build_logs.get(lib.name, "")):
            print(f"ptxas, shipped, {label}: {line}", flush=True)
    for name, (_, log) in zip(builds, edited):
        for line in ptxas_report(log):
            print(f"ptxas, {name}: {line}", flush=True)
    for label, bits in codes.items():
        ones, rows = int(bits.sum()), int(bits.any(1).sum())
        print(f"network, {label}: {ones} ones, {ones - rows} XORs as "
              f"generated, {greedy_xor_count(bits)} after greedy pair "
              "elimination (not built)", flush=True)

    _, _, _, x = ec_kernel_sweep.sweep_data(8, "cuda")
    n4 = x.shape[1]
    out = torch.empty((M, n4), dtype=torch.int32, device=dev)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    bound, by, nbytes, _ = ec_kernel_sweep.kernel_bound_ms(ENTRY, K, M, n4)
    print(f"== {ENTRY}, lanes [{K}, {n4}]: flushed (mean of 20) and back to "
          f"back ({args.iters} launches a graph); bound {bound:.4f} ms ({by}; "
          f"{nbytes} bytes) ==", flush=True)
    rows = {}
    for label, fn in shipped.items():
        rows[f"kernel, {label}"] = (fn, codes[label], True)
    bits = codes["reed_sol_van k=8 m=4"]
    for name, (fn, _) in zip(builds, edited):
        def launch(fn=fn, name=name):
            rc = fn(x.data_ptr(), out.data_ptr(), n4,
                    torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{ENTRY} {name} launch failed: CUDA "
                                   f"error {rc}")
            return out
        rows[name] = (launch, bits, name in CHECKED)
    bad = 0
    for name, (fn, row_bits, checked) in rows.items():
        out.fill_(-1)
        got = fn(x) if name.startswith("kernel") else fn()
        torch.cuda.synchronize(dev)
        verdict = "n/a (probe)"
        if checked:
            ok = torch.equal(got, sweep_gf.xornet_plain(row_bits, x, K, M))
            verdict = "bit-exact" if ok else "MISMATCH"
            bad += not ok
        call = ((lambda fn=fn: fn(x)) if name.startswith("kernel") else fn)
        cold = ec_kernel_sweep.flushed_ms(call, 20, flush)
        ms = ec_kernel_sweep.time_ms(call, args.iters, dev)
        print(f"{name:32s} {verdict:12s} flushed {cold:.4f} ms "
              f"({bound / cold:6.1%} of bound); back to back {ms:.4f} ms "
              f"({bound / ms:6.1%})", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
