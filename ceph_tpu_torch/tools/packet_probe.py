#!/usr/bin/env python
"""Where ``gf2_packet``'s time goes on the card, and its other settings.

At the main path's shape -- cauchy_good k=8 m=4 w=8, packet rows [64,
131072] (4 x 8 MiB stripes fused), 32 output rows -- the rows are:

  kernel        ``csrc/gf_kernels.cu`` as the port builds it
  copy+store    the same library with every list emptied: it stages every
                tile and stores zero rows, with no XOR
  xor+store     a build without the tile copies: the XORs and stores over
                whatever shared memory holds (its output is not checked)
  <setting>     a build with other block, stage, ring and chunk constants
                (``SETTINGS``), bit-exact against the plain version

Each is timed as the port's kernel sweep times its rows
(``ec_kernel_sweep.time_ms``: one CUDA graph of ``--iters`` launches,
back to back) beside the kernel's byte bound (inputs read once, outputs
written once, the list read once).  Each build is a copy of the source
with constants replaced, compiled with the port's nvcc flags into
``build/packet-probe-<name>/``, all at once.

Run (needs an NVIDIA card and nvcc):
    python -m ceph_tpu_torch.tools.packet_probe [--iters 200]
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ceph_tpu_torch.matrices import cauchy
from ceph_tpu_torch.matrices.bitmatrix import matrix_to_bitmatrix
from ceph_tpu_torch.ops import cuda_gf
from ceph_tpu_torch.tools import ec_kernel_sweep

#: the constants of ``gf_kernels.cu`` a setting replaces, as they stand
CONSTANTS = {
    "threads": "constexpr int kPacketThreads = {};",
    "stage_kib": "constexpr size_t kStageBytes = {} * 1024;",
    "stages": "constexpr int kMaxStages = {};",
    "chunks": "constexpr int kChunks = {};",
}
#: the shipped values of CONSTANTS
SHIPPED = {"threads": 512, "stage_kib": 64, "stages": 2, "chunks": 2}
#: settings timed beside the shipped one: (threads, stage KiB, stages,
#: chunks a thread)
SETTINGS = ((256, 64, 2, 1), (256, 32, 2, 1), (256, 16, 4, 1),
            (512, 32, 4, 1), (512, 64, 2, 1), (256, 64, 2, 2),
            (1024, 64, 2, 2))
#: the tile copy's guard, and what replaces it in the xor+store build
COPY_GUARD = ("        if (base + lane < n4)\n          cp_async_lanes",
              "        if (false)\n          cp_async_lanes")
K, M, W = 8, 4, 8
N4 = 131072


def _replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"gf_kernels.cu has no {old!r}")
    return text.replace(old, new)


def setting_source(threads: int, stage_kib: int, stages: int,
                   chunks: int) -> str:
    """``gf_kernels.cu`` with the packet kernel's constants replaced."""
    text = cuda_gf.SOURCE.read_text()
    for key, value in zip(CONSTANTS, (threads, stage_kib, stages, chunks)):
        text = _replace(text, CONSTANTS[key].format(SHIPPED[key]),
                        CONSTANTS[key].format(value))
    return text


def no_copy_source() -> str:
    """``gf_kernels.cu`` without the packet kernel's tile copies."""
    return _replace(cuda_gf.SOURCE.read_text(), *COPY_GUARD)


def _build(name: str, text: str) -> ctypes.CDLL:
    dll = ctypes.CDLL(str(cuda_gf.build_copy(
        cuda_gf.BUILD_DIR / f"packet-probe-{name}", cuda_gf.SOURCE.name,
        text)))
    dll.gf2_packet.argtypes = list(cuda_gf._SIGNATURES["gf2_packet"])
    dll.gf2_packet.restype = ctypes.c_int
    return dll


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("packet_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    builds = {"kernel": cuda_gf.SOURCE.read_text(),
              "xor+store": no_copy_source()}
    for s in SETTINGS:
        builds["threads={} stage={}KiB stages={} chunks={}".format(*s)] = \
            setting_source(*s)
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = dict(zip(builds, pool.map(
            lambda item: _build(f"b{item[0]}", item[1][1]),
            enumerate(builds.items()))))

    B = matrix_to_bitmatrix(cauchy.good_general_coding_matrix(K, M, W), W)
    r, c = B.shape
    lists = torch.from_numpy(cuda_gf.prep_packet(B)).to(dev)
    empty = torch.zeros(r + 1, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, 256, (c, N4 * 4), dtype=torch.uint8, device=dev,
                      generator=gen).view(torch.int32)
    out = torch.empty((r, N4), dtype=torch.int32, device=dev)
    want = cuda_gf.packet_encode_plain(lists, x, r)
    nbytes = (r + c) * N4 * 4 + lists.numel() * 4
    bound = nbytes / ec_kernel_sweep.HBM_BYTES_PER_S * 1e3

    def launch(lib, operand):
        rc = lib.gf2_packet(x.data_ptr(), operand.data_ptr(),
                            out.data_ptr(), c, r, N4,
                            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"gf2_packet launch failed: CUDA error {rc}")

    rows = [("kernel", libs["kernel"], lists, True),
            ("copy+store", libs["kernel"], empty, False),
            ("xor+store", libs["xor+store"], lists, False)]
    rows += [(name, libs[name], lists, True) for name in builds
             if name not in ("kernel", "xor+store")]
    bad = 0
    for name, lib, operand, checked in rows:
        launch(lib, operand)
        torch.cuda.synchronize(dev)
        verdict = "n/a (probe)"
        if checked:
            ok = torch.equal(out, want)
            verdict = "bit-exact" if ok else "MISMATCH"
            bad += not ok
        ms = ec_kernel_sweep.time_ms(lambda: launch(lib, operand),
                                     args.iters, dev)
        print(f"{name:42s} {verdict:12s} {ms:.4f} ms  bound {bound:.4f} ms "
              f"(bytes)  {bound / ms:6.1%} of bound", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
