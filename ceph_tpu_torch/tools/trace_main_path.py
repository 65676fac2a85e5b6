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
and the pass's host stage times.  Before them, one write pass of each mode
is split for the coalesced write's loss: pinned host allocations (the
caching host allocator's counters, and ``cudaHostAlloc`` calls and their
time in a profiler trace), minor page faults, and the commit's crc and
copy per object.  Then it splits the host time of both
modes, per-op and coalesced: each write and read pass runs again under
``cProfile`` with the stage profiler on (the coalescer's dispatch time),
both modes' passes alternate for ``ROUNDS`` rounds without a profiler
(the mode that goes first alternates too), and one batch of ``WRITERS`` objects is timed as one fused dispatch and
as one dispatch per object, the read's ``decode_batch`` apart from its
``ecutil._reassemble``.

With ``--cluster-path`` it traces the EC cluster instead
(``osd/cluster.py`` with the ``cuda`` plugin, 16 OSDs, the same profile):
after an untimed write of 64 objects of 4 MiB with 8 client tasks, one
write pass of them runs under the profiler (the device's busy and idle
shares) and again under ``cProfile``, whose time is split by layer
(:data:`LAYERS`: the objecter, the primary's ECBackend / PG / coalescer,
the codec, the shard op queue and QoS, the commit, the messenger, the
event loop).  Then, twice on a fresh cluster of the same objects (so
that no background tick of an earlier recovery runs), an OSD is killed,
a quarter of the objects is overwritten, the OSD revives and auto
recovery runs until the cluster is clean: the first recovery under the
profiler, the second under ``cProfile``.

    python -m ceph_tpu_torch.tools.trace_main_path [--storage-path |
        --cluster-path] [--trace DIR]

``--trace`` also writes each call's Chrome trace into DIR.
"""

from __future__ import annotations

import argparse
import asyncio
import cProfile
import json
import os
import pstats
import resource
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ceph_tpu_torch import profiling
from ceph_tpu_torch.osd import cluster_bench, ecutil, storage_bench
from ceph_tpu_torch.osd.coalescer import BatchCoalescer
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
ROUNDS = 12
#: the cluster path: OSDs, and every CLUSTER_OVERWRITE-th object written
#: while an OSD is down
CLUSTER_OSDS = 16
CLUSTER_OVERWRITE = 4
#: host layers of the cluster path, by the port's source file (the rest of
#: the time is "other": numpy, torch and the standard library outside the
#: event loop)
LAYERS = {
    "objecter": ("osd/objecter.py",),
    "primary": ("osd/ecbackend.py", "osd/pg.py", "osd/coalescer.py",
                "osd/ectransaction.py", "osd/extent_cache.py",
                "osd/recovery.py", "osd/placement.py", "crush/"),
    "codec": ("osd/ecutil.py", "plugins/", "ops/", "matrices/"),
    "shard_op_queue": ("osd/shard.py", "osd/opqueue.py", "osd/qos.py",
                       "utils/optracker.py", "osd/hitset.py"),
    "commit": ("osd/memstore.py", "osd/types.py", "osd/pglog.py",
               "native/"),
    "messenger": ("osd/messenger.py", "msg/"),
    "event_loop": ("asyncio/",),
}


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


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def traced(label: str, fn, trace_dir: str | None,
           nbytes: int = BATCH * STRIPE) -> dict:
    _sync()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        _sync()
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
        for coalesce in (False, True):
            print(json.dumps(dict(write_split(h, loop, payloads, coalesce),
                                  card=card)), flush=True)
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


def _host_alloc_stats() -> dict:
    """The caching host allocator's numeric counters, flattened (empty
    where this PyTorch has no ``torch.cuda.host_memory_stats``)."""
    try:
        stats = torch.cuda.host_memory_stats()
    except (AttributeError, RuntimeError):
        return {}
    flat = {}
    for key, val in stats.items():
        if isinstance(val, dict):
            flat.update({f"{key}.{k}": v for k, v in val.items()
                         if isinstance(v, (int, float))})
        elif isinstance(val, (int, float)):
            flat[key] = val
    return flat


async def _split_write_pass(h, payloads, coalesce: bool, commit: list):
    """``StoragePathHarness.write_pass`` with its commit split in two:
    appends (crc seconds, copy seconds) per object to ``commit``."""
    sinfo, k, km, ec = h.sinfo, h.k, h.km, h.ec
    coal = BatchCoalescer(
        lambda blocks: ecutil.encode_shard_major_many(ec, blocks, range(km))
    ) if coalesce else None
    store: dict = {}
    queue = list(enumerate(payloads))

    async def writer():
        while queue:
            idx, data = queue.pop()
            buf = np.zeros(sinfo.logical_to_next_stripe_offset(len(data)),
                           dtype=np.uint8)
            buf[:len(data)] = np.frombuffer(data, dtype=np.uint8)
            sm = ecutil.to_shard_major(sinfo, k, buf)
            if coal is not None:
                enc = await coal.submit(sm, sm.nbytes)
            else:
                enc = ecutil.encode_shard_major_many(ec, [sm], range(km))[0]
            t0 = time.perf_counter()
            ecutil.HashInfo(km).append(0, enc)
            t1 = time.perf_counter()
            for s in range(km):
                store[f"obj{idx}@{s}"] = enc[s].tobytes()
            commit.append((t1 - t0, time.perf_counter() - t1))

    await asyncio.gather(*(writer() for _ in range(WRITERS)))
    return store


def write_split(h, loop, payloads, coalesce: bool) -> dict:
    """One write pass of one mode, after an untimed warm one, split for
    the coalesced write's loss: pinned host allocations (the caching host
    allocator's counters, and ``cudaHostAlloc`` calls and their time in a
    ``torch.profiler`` trace of a second pass), minor page faults, and the
    commit's crc and copy per object."""
    def run(commit):
        return loop.run_until_complete(
            _split_write_pass(h, payloads, coalesce, commit))

    run([])  # warm
    _sync()
    host0, flt0 = _host_alloc_stats(), \
        resource.getrusage(resource.RUSAGE_SELF).ru_minflt
    commit: list = []
    t0 = time.perf_counter()
    run(commit)
    _sync()
    wall_s = time.perf_counter() - t0
    flt = resource.getrusage(resource.RUSAGE_SELF).ru_minflt - flt0
    host1 = _host_alloc_stats()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        run([])
        _sync()
    allocs: dict = {}
    for ev in prof.events():
        if any(api in ev.name for api in ("cudaHostAlloc", "cudaMallocHost",
                                          "cudaHostRegister", "cudaFreeHost",
                                          "cudaHostUnregister")):
            n, us = allocs.get(ev.name, (0, 0.0))
            allocs[ev.name] = (n + 1, us + ev.time_range.elapsed_us())
    crc = [c for c, _ in commit]
    copy = [c for _, c in commit]
    return {"call": "storage_path_write_split_"
                    f"{'coalesced' if coalesce else 'per_op'}",
            "objects": OBJECTS, "obj_bytes": OBJECT, "writers": WRITERS,
            "wall_s": wall_s, "GiBs": OBJECTS * OBJECT / 2**30 / wall_s,
            "minor_faults": flt,
            "minor_faults_per_object": flt / OBJECTS,
            "host_allocator_delta": {key: host1[key] - host0.get(key, 0)
                                     for key in host1
                                     if host1[key] != host0.get(key, 0)},
            "host_alloc_calls_traced": {
                name: {"calls": n, "ms": us / 1e3}
                for name, (n, us) in allocs.items()},
            "commit_crc_ms_per_object": {
                "median": statistics.median(crc) * 1e3,
                "sum_s": sum(crc)},
            "commit_copy_ms_per_object": {
                "median": statistics.median(copy) * 1e3,
                "sum_s": sum(copy)}}


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


def _layer(path: str) -> str:
    path = path.replace(os.sep, "/")
    for layer, parts in LAYERS.items():
        if any(f"/{part}" in path for part in parts):
            return layer
    return "other"


def _file_layer(f: str) -> str | None:
    if "ceph_tpu_torch" in f or "asyncio" in f:
        return _layer(f)
    return None


def host_split(prof: cProfile.Profile, wall_s: float) -> dict:
    """cProfile's own time (tottime) summed by host layer, and the
    functions that took most of it.  The time of a function outside the
    port and asyncio (builtins, numpy, torch) goes to its direct callers'
    layers in proportion to the time each caller spent in it."""
    st = pstats.Stats(prof)
    layers: dict = {}
    for (f, _line, _name), (_cc, _nc, tt, _ct, callers) in \
            st.stats.items():
        layer = _file_layer(f)
        if layer is not None:
            layers[layer] = layers.get(layer, 0.0) + tt
            continue
        share = sum(c[2] for c in callers.values())
        for (cf, _cl, _cn), c in callers.items():
            owner = _file_layer(cf) or "other"
            part = tt * c[2] / share if share > 0 else tt / len(callers)
            layers[owner] = layers.get(owner, 0.0) + part
        if not callers:
            layers["other"] = layers.get("other", 0.0) + tt
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:TOP]
    return {"wall_s": wall_s, "layers_s": layers,
            "layers_share": {k: v / wall_s for k, v in layers.items()},
            "top_tottime": [
                {"fn": f"{os.path.basename(f)}:{line}:{name}",
                 "calls": nc, "tottime_s": tt, "cumtime_s": ct}
                for (f, line, name), (_cc, nc, tt, ct, _callers) in rows]}


def cluster_path(profile_kv: dict, n_objects: int, obj_bytes: int,
                 seed: int, trace_dir: str | None, card: str) -> list:
    """The cluster's write pass and recovery, each once under the
    profiler and once under cProfile (module docstring).  Returns the
    rows it prints."""
    from ceph_tpu_torch.osd.cluster import ECCluster

    payloads = cluster_bench.make_payloads(n_objects, obj_bytes, seed)
    overwrites = cluster_bench.make_overwrites(payloads, CLUSTER_OVERWRITE,
                                               seed + 1)
    nbytes = n_objects * obj_bytes
    loop = asyncio.new_event_loop()
    rows = []

    async def build():
        return ECCluster(CLUSTER_OSDS, dict(profile_kv), plugin="cuda")

    def write_pass(cluster, items):
        async def go():
            return await cluster_bench.client_ops(
                items, lambda oid, data: cluster.write(oid, data), WRITERS)
        return loop.run_until_complete(go())

    def degraded(cluster):
        """Write every object, kill an OSD, overwrite a quarter, revive:
        returns the recovery to time (wait until clean)."""
        write_pass(cluster, payloads.items())
        victim = cluster.backend.acting_set(next(iter(payloads)))[0]
        cluster.kill_osd(victim)
        write_pass(cluster, overwrites.items())
        cluster.revive_osd(victim)

        def wait_clean():
            async def go():
                cluster.start_auto_recovery(interval=0.05)
                while await cluster.degraded_report():
                    await asyncio.sleep(0.05)
            loop.run_until_complete(go())
        return wait_clean

    def emit(row):
        row["card"] = card
        rows.append(row)
        print(json.dumps(row), flush=True)

    def profiled(fn, call):
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        fn()
        prof.disable()
        emit(dict(host_split(prof, time.perf_counter() - t0), call=call))

    clusters = []
    try:
        cluster = loop.run_until_complete(build())
        clusters.append(cluster)
        write_pass(cluster, payloads.items())  # warm: tables, buffers
        row = traced("cluster_path_write", lambda: write_pass(
            cluster, payloads.items()), trace_dir, nbytes)
        emit(dict(row, objects=n_objects, obj_bytes=obj_bytes,
                  osds=CLUSTER_OSDS, writers=WRITERS))
        profiled(lambda: write_pass(cluster, payloads.items()),
                 "cluster_path_write_cprofile")
        for call in ("cluster_path_recovery",
                     "cluster_path_recovery_cprofile"):
            cluster = loop.run_until_complete(build())
            clusters.append(cluster)
            wait_clean = degraded(cluster)
            if call.endswith("cprofile"):
                profiled(wait_clean, call)
            else:
                emit(traced(call, wait_clean, trace_dir,
                            nbytes // CLUSTER_OVERWRITE))
    finally:
        for cluster in clusters:
            loop.run_until_complete(cluster.shutdown())
        loop.close()
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trace", default=None,
                   help="directory for the Chrome traces")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--storage-path", action="store_true",
                   help="trace the storage path's coalesced write and "
                        "degraded read passes instead")
    p.add_argument("--cluster-path", action="store_true",
                   help="trace the EC cluster's write pass and recovery "
                        "instead")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_main_path: CUDA is not available", file=sys.stderr)
        return 2
    ec = registry.instance().factory(
        "cuda", {"technique": "reed_sol_van", "k": "8", "m": "4"})
    if args.storage_path:
        storage_path(ec, args.seed, args.trace)
        return 0
    if args.cluster_path:
        cluster_path({"technique": "reed_sol_van", "k": "8", "m": "4"},
                     OBJECTS, OBJECT, args.seed, args.trace, _card())
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
