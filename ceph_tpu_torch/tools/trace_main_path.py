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

With ``--storage-path`` it traces the storage path instead
(``osd/storage_bench.py``, the same profile): one coalesced write pass of
64 objects of 4 MiB with 8 writers, then one degraded read of them (2
erasures), each after an untimed warm pass, printing the same breakdown
and the pass's host stage times.  Then it splits the host time of both
modes, per-op and coalesced: each write and read pass runs again under
``cProfile`` with the stage profiler on (the coalescer's dispatch time),
both modes' passes alternate for ``ROUNDS`` rounds without a profiler
(the mode that goes first alternates too), and one batch of ``WRITERS`` objects is timed as one fused dispatch and
as one dispatch per object, the read's ``decode_batch`` apart from its
``ecutil._reassemble``.

    python -m ceph_tpu_torch.tools.trace_main_path [--storage-path]
        [--trace DIR]

``--trace`` also writes each call's Chrome trace into DIR.
"""

from __future__ import annotations

import argparse
import asyncio
import cProfile
import json
import os
import pstats
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ceph_tpu_torch import profiling
from ceph_tpu_torch.osd import ecutil, storage_bench
from ceph_tpu_torch.plugins import registry

STRIPE = 8 << 20
BATCH = 8
ERASED = (1, 6)
#: the storage path's pass: objects of RBD's default size, writers
OBJECTS = 64
OBJECT = 4 << 20
WRITERS = 8
#: functions listed per profiled pass, repeats of a timed batch, and
#: rounds of the per-op / coalesced comparison
TOP = 14
REPEATS = 5
ROUNDS = 6


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


def traced(label: str, fn, trace_dir: str | None,
           nbytes: int = BATCH * STRIPE) -> dict:
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
            "GiBs": nbytes / 2**30 / (wall_ms / 1e3),
            "device_ms": by_kind, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall_ms}


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def storage_path(ec, seed: int, trace_dir: str | None) -> None:
    """One coalesced write pass and one degraded read pass of the storage
    path under the profiler, each after an untimed warm pass."""
    h = storage_bench.StoragePathHarness(ec, erasures=2)
    payloads = storage_bench.make_payloads(OBJECTS, OBJECT, seed)
    sizes = [len(p) for p in payloads]
    card = _card()
    loop = asyncio.new_event_loop()

    def write(stages):
        return loop.run_until_complete(h.write_pass(
            payloads, coalesce=True, writers=WRITERS, stages=stages))

    def read(stages):
        return loop.run_until_complete(h.read_pass(
            store, OBJECTS, sizes, coalesce=True, readers=WRITERS,
            stages=stages))

    try:
        store = write({})  # warm, and the store the read pass reads
        for label, run in (("storage_path_write_coalesced", write),
                           ("storage_path_read_coalesced", read)):
            run({})  # warm
            stages: dict = {}
            row = traced(label, lambda: run(stages), trace_dir,
                         OBJECTS * OBJECT)
            row.update(stages_s=stages, objects=OBJECTS, obj_bytes=OBJECT,
                       writers=WRITERS, card=card)
            print(json.dumps(row), flush=True)
        for coalesce in (False, True):
            for kind in ("write", "read"):
                row = profiled_pass(h, loop, payloads, store, kind,
                                    coalesce)
                print(json.dumps(dict(row, card=card)), flush=True)
        print(json.dumps(dict(alternating_passes(h, loop, payloads, store),
                              card=card)), flush=True)
        for row in batch_split(ec, h, payloads, store):
            print(json.dumps(dict(row, card=card)), flush=True)
    finally:
        loop.close()


def profiled_pass(h, loop, payloads, store, kind: str,
                  coalesce: bool) -> dict:
    """One write or degraded-read pass under cProfile, after an untimed
    warm pass, with the stage profiler on: the wall, the stage sums, the
    coalescer's dispatch time and the functions that took most time."""
    sizes = [len(p) for p in payloads]

    def run(stages):
        if kind == "write":
            return loop.run_until_complete(h.write_pass(
                payloads, coalesce=coalesce, writers=WRITERS,
                stages=stages))
        return loop.run_until_complete(h.read_pass(
            store, OBJECTS, sizes, coalesce=coalesce, readers=WRITERS,
            stages=stages))

    run({})  # warm
    profiling.configure("on")
    profiling.reset()
    stages: dict = {}
    prof = cProfile.Profile()
    try:
        t0 = time.perf_counter()
        prof.enable()
        run(stages)
        prof.disable()
        wall_s = time.perf_counter() - t0
        snap = profiling.snapshot()
    finally:
        profiling.configure("off")
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:TOP]
    top = [{"fn": f"{os.path.basename(f)}:{line}:{name}", "calls": nc,
            "tottime_s": tt, "cumtime_s": ct}
           for (f, line, name), (_cc, nc, tt, ct, _callers) in rows]
    dispatch = snap["stages"].get("coalescer.dispatch", {})
    return {"call": f"storage_path_{kind}_"
                    f"{'coalesced' if coalesce else 'per_op'}_cprofile",
            "wall_s": wall_s, "GiBs": OBJECTS * OBJECT / 2**30 / wall_s,
            "stages_s": stages,
            "coalescer_dispatch_s": dispatch.get("ns", 0) / 1e9,
            "coalescer_dispatches": dispatch.get("calls", 0),
            "loop": {k: v for k, v in (snap.get("loop") or {}).items()
                     if not isinstance(v, (dict, list))},
            "top_tottime": top}


def alternating_passes(h, loop, payloads, store) -> dict:
    """Write and degraded-read GiB/s of both modes, ROUNDS rounds of
    per-op and coalesced passes in turns, the first mode alternating."""
    sizes = [len(p) for p in payloads]
    nbytes = OBJECTS * OBJECT
    out = {m: {"write_GiBs": [], "read_GiBs": []}
           for m in ("per_op", "coalesced")}
    for r in range(ROUNDS):
        order = (False, True) if r % 2 == 0 else (True, False)
        for coalesce in order:
            rates = out["coalesced" if coalesce else "per_op"]
            t0 = time.perf_counter()
            loop.run_until_complete(h.write_pass(
                payloads, coalesce=coalesce, writers=WRITERS))
            rates["write_GiBs"].append(
                nbytes / 2**30 / (time.perf_counter() - t0))
            t0 = time.perf_counter()
            loop.run_until_complete(h.read_pass(
                store, OBJECTS, sizes, coalesce=coalesce,
                readers=WRITERS))
            rates["read_GiBs"].append(
                nbytes / 2**30 / (time.perf_counter() - t0))
    return {"call": "storage_path_alternating_passes", "rounds": ROUNDS,
            **out,
            "coalesced_over_per_op_median": {
                kind: statistics.median(out["coalesced"][kind]) /
                statistics.median(out["per_op"][kind])
                for kind in ("write_GiBs", "read_GiBs")}}


def _median_ms(fn) -> float:
    times = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def batch_split(ec, h, payloads, store) -> list:
    """One batch of WRITERS objects: the write's dispatch fused and one
    per object, the read's decode fused and per object, and the read's
    reassembly apart from its decode (median of REPEATS, ms)."""
    km = h.km
    blocks = []
    for data in payloads[:WRITERS]:
        buf = np.zeros(h.sinfo.logical_to_next_stripe_offset(len(data)),
                       dtype=np.uint8)
        buf[:len(data)] = np.frombuffer(data, dtype=np.uint8)
        blocks.append(ecutil.to_shard_major(h.sinfo, h.k, buf))
    maps = [{s: np.frombuffer(store[f"obj{i}@{s}"], dtype=np.uint8)
             for s in range(km) if s not in h.erased}
            for i in range(WRITERS)]

    def encode_fused():
        ecutil.encode_shard_major_many(ec, blocks, range(km))

    def encode_each():
        for b in blocks:
            ecutil.encode_shard_major_many(ec, [b], range(km))

    def decode_fused():
        ec.decode_batch(maps)

    def decode_each():
        for mp in maps:
            ec.decode_batch([mp])

    outs = ec.decode_batch(maps)

    def reassemble():
        for out in outs:
            ecutil._reassemble(h.sinfo, ec, out)

    encode_fused(), encode_each(), decode_fused(), decode_each()  # warm
    return [{"call": f"storage_path_batch_{label}", "objects": WRITERS,
             "obj_bytes": OBJECT, "ms": _median_ms(fn)}
            for label, fn in (("encode_fused", encode_fused),
                              ("encode_per_object", encode_each),
                              ("decode_fused", decode_fused),
                              ("decode_per_object", decode_each),
                              ("reassemble", reassemble))]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trace", default=None,
                   help="directory for the Chrome traces")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--storage-path", action="store_true",
                   help="trace the storage path's coalesced write and "
                        "degraded read passes instead")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_main_path: CUDA is not available", file=sys.stderr)
        return 2
    ec = registry.instance().factory(
        "cuda", {"technique": "reed_sol_van", "k": "8", "m": "4"})
    if args.storage_path:
        storage_path(ec, args.seed, args.trace)
        return 0
    rs = np.random.RandomState(args.seed)
    stripes = [np.frombuffer(rs.bytes(STRIPE), dtype=np.uint8)
               for _ in range(BATCH)]
    enc = ec.encode_batch(stripes)  # warm
    maps = [{c: a for c, a in e.items() if c not in ERASED} for e in enc]
    ec.decode_batch(maps)  # warm
    card = _card()
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
