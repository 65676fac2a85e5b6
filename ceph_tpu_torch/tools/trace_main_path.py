#!/usr/bin/env python
"""Where the main path's time goes on the card.

Runs the flagship profile (``cuda`` plugin, reed_sol_van k=8 m=4, 8 distinct
random 8 MiB stripes) through ``encode_batch``, ``encode_shard_major_batch``
(the same stripes already split into chunks, so the pipeline alone) and
``decode_batch`` (chunks 1 and 6 erased) under ``torch.profiler`` and prints
one JSON line per call:
host wall time, device time of the GF(2) kernels, of host-to-device and
device-to-host copies and of other device work, and the device's busy and
idle shares of the wall time.

    python -m ceph_tpu_torch.tools.trace_main_path [--trace DIR]

``--trace`` also writes each call's Chrome trace into DIR.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ceph_tpu_torch.plugins import registry

STRIPE = 8 << 20
BATCH = 8
ERASED = (1, 6)


#: the codec kernels' names in ``csrc/gf_kernels.cu``, as the profiler
#: reports them (template instances)
CODEC_KERNELS = ("gf2_tables_kernel", "gf2_packet_kernel")


def _classify(name: str) -> str:
    if any(kernel in name for kernel in CODEC_KERNELS):
        return "gf2_kernels"
    if "HtoD" in name:
        return "h2d"
    if "DtoH" in name:
        return "d2h"
    return "other_device"


def _busy_ms(intervals) -> float:
    """Length of the union of [start, end) device intervals, in ms."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def traced(label: str, fn, trace_dir: str | None) -> dict:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind: dict = {}
    intervals = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = _classify(ev.name)
        start, end = ev.time_range.start, ev.time_range.end  # us
        by_kind[kind] = by_kind.get(kind, 0.0) + (end - start) / 1e3
        intervals.append((start, end))
    busy = _busy_ms(intervals)
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"{label}.json"))
    return {"call": label, "wall_ms": wall_ms,
            "GiBs": BATCH * STRIPE / 2**30 / (wall_ms / 1e3),
            "device_ms": by_kind, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall_ms}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trace", default=None,
                   help="directory for the Chrome traces")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_main_path: CUDA is not available", file=sys.stderr)
        return 2
    ec = registry.instance().factory(
        "cuda", {"technique": "reed_sol_van", "k": "8", "m": "4"})
    rs = np.random.RandomState(args.seed)
    stripes = [np.frombuffer(rs.bytes(STRIPE), dtype=np.uint8)
               for _ in range(BATCH)]
    enc = ec.encode_batch(stripes)  # warm
    maps = [{c: a for c, a in e.items() if c not in ERASED} for e in enc]
    ec.decode_batch(maps)  # warm
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    # encode_batch = host prep (split + pad into chunks, stack) + the
    # pipeline; the shard-major lane takes prepared blocks, so timing both
    # separates the two
    t0 = time.perf_counter()
    blocks = [np.stack([p[j] for j in range(8)])
              for p in (ec.encode_prepare(s) for s in stripes)]
    prep_ms = (time.perf_counter() - t0) * 1e3
    ec.encode_shard_major_batch(blocks)  # warm
    print(json.dumps({"call": "encode_prepare+stack (host only)",
                      "wall_ms": prep_ms, "card": card}), flush=True)
    for label, fn in (
            ("encode_batch", lambda: ec.encode_batch(stripes)),
            ("encode_shard_major_batch",
             lambda: ec.encode_shard_major_batch(blocks)),
            ("decode_batch", lambda: ec.decode_batch(maps))):
        row = traced(label, fn, args.trace)
        row["card"] = card
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
