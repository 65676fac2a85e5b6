#!/usr/bin/env python
"""ceph_erasure_code_benchmark-compatible CLI for the port's plugins.

Port of the ``encode``, ``decode``, ``storage-path``, ``recovery-path``,
``repair-path``, ``tier-path``, ``elastic-path``, ``cluster-path`` and
``mesh-path`` workloads of ``tools/ec_benchmark.py``
(reference: src/test/erasure-code/ceph_erasure_code_benchmark.cc:39-137 setup,
:150-188 encode, :253-327 decode): encode and decode print
``<elapsed_seconds>\\t<KiB>`` where KiB = iterations * size / 1024 (times
the batch size with ``--batch``), so throughput = KiB / seconds.
``storage-path`` runs ``osd/storage_bench.py`` (``--objects`` objects of
``--size`` bytes, ``--writers`` concurrent writers, best of
``--iterations`` timed cycles) and prints its result as one JSON line, or
with ``--profile`` the transfer-ledger cut of it, the JSON keys of the
reference's with ``steady_library_builds`` in place of
``steady_jit_retraces`` (see ``osd/storage_bench.py``).
``recovery-path`` runs ``osd/recovery_bench.py`` (two wiped OSDs of an
8-OSD cluster rebuilt per object and batched under a client load,
``--objects`` objects of ``--size`` bytes) and prints its result as one
JSON line.  Its profile is fixed (k=4 m=2, the ``cuda`` plugin), so it
needs no ``-P k``/``-P m``; ``-P`` entries overlay it (``-P device=cpu``).
``repair-path`` runs ``osd/repair_bench.py`` (a wiped OSD of an 8-OSD
product-matrix MSR pool, plugin ``regen`` k=4 m=3, rebuilt through the
beta-fractional repair lane and the classic full-stripe gather,
``--objects`` objects of ``--size`` bytes, or 8 x 6 KiB with ``--smoke``);
its profile is fixed the same way, and it prints one JSON line.
``tier-path`` runs ``tier/tier_bench.py`` (``--objects`` objects of
``--size`` bytes resident in the device cache tier: hot reads from the
resident block against cold reads that decode with ``--erasures`` data
shards withheld, best of ``--iterations``, bit-exactness gated before
timing) and prints its result as one JSON line.
``elastic-path`` runs ``osd/elastic_bench.py`` (a mon-backed 10-OSD pool,
k=2 m=1 on the ``cuda`` plugin: a +2-OSD expansion under 24 clients, then
a backfill target killed mid-migration, a live primary removed and an
add-then-remove flap, every step committed through the mons' paxos; 72 +
16 objects of 12 KiB, or 24 + 8 of 4 KiB with ``--smoke``); its profile
is fixed like recovery-path's, its gates (moved bytes <= 1.25x the
theoretical minimum, <= 2 misplaced upticks, client p99 <= 2000 ms,
HEALTH_OK from the mgr's fold after each stage, bit-exact reads and an
exactly-once audit) raise before anything is printed, and it prints one
JSON line and a summary on stderr.
``cluster-path`` runs ``msg/cluster_bench.py`` (k+m OSD daemons, each an
``OSDShard`` on its own ``TCPMessenger`` on localhost, and a client
``Objecter``: ``--objects`` objects of ``--size`` bytes with
``--writers`` writers, per-message against corked frames, best of
``--iterations``, then the messenger-level wire stage) and prints the JAX
tool's JSON line, with ``"wire_codec": "python"`` and the transfer
ledger of each pass besides.  ``mesh-path`` runs ``msg/mesh_bench.py``
(the same TCP cluster with the mesh data plane off, then spanning each
of ``--mesh-sizes`` device slots; k and m from ``-P``, default 2 and 2,
other ``-P`` entries overlay the ``cuda`` profile) and prints one JSON
line; its slots are every card present, or the first card named once
per slot of the largest size where there are fewer.  Both run the
Python wire codec (``osd_wire_codec_native=false``); the native one is
ROADMAP.md queue 1 item 16b.

Examples:
    python -m ceph_tpu_torch.tools.ec_benchmark -p cuda -w encode \\
        -s 8388608 -i 3 -b 8 -P k=8 -P m=4
    python -m ceph_tpu_torch.tools.ec_benchmark -p cuda -w decode \\
        -s 8388608 -i 3 -b 8 --erased 1 --erased 6 -P k=8 -P m=4
    python -m ceph_tpu_torch.tools.ec_benchmark -w storage-path \\
        --objects 64 -s 4194304 --profile -P k=8 -P m=4
    python -m ceph_tpu_torch.tools.ec_benchmark -w recovery-path \\
        --objects 32 -s 4194304
    python -m ceph_tpu_torch.tools.ec_benchmark -w repair-path \\
        --objects 32 -s 4194304
    python -m ceph_tpu_torch.tools.ec_benchmark -w tier-path \\
        --objects 64 -s 4194304 -i 2 -e 2 -P k=8 -P m=4
    python -m ceph_tpu_torch.tools.ec_benchmark -w elastic-path
    python -m ceph_tpu_torch.tools.ec_benchmark -w cluster-path \
        --objects 64 -s 4194304 -P k=8 -P m=4
    python -m ceph_tpu_torch.tools.ec_benchmark -w mesh-path \
        --objects 32 -s 4194304 -P k=8 -P m=4 --mesh-sizes 1,2,4,8

The default plugin is ``cuda``, which runs on the card and raises where
there is none; ``-P device=cpu`` runs it on the CPU, and ``-p jerasure``
times the numpy plugin on the host.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time

import numpy as np

from ceph_tpu_torch.plugins import registry as registry_mod


def parse_args(argv):
    p = argparse.ArgumentParser(description="erasure code benchmark")
    p.add_argument("-s", "--size", type=int, default=1024 * 1024,
                   help="size of the buffer to be encoded")
    p.add_argument("-i", "--iterations", type=int, default=1,
                   help="number of encode/decode runs")
    p.add_argument("-p", "--plugin", default="cuda",
                   help="erasure code plugin name (default: cuda, on the "
                        "card)")
    p.add_argument("-w", "--workload", default="encode",
                   choices=["encode", "decode", "storage-path",
                            "recovery-path", "repair-path", "tier-path",
                            "elastic-path", "cluster-path", "mesh-path"])
    p.add_argument("--mesh-sizes", default="1,2,4,8",
                   help="mesh-path only: comma-separated mesh device "
                        "counts to sweep")
    p.add_argument("-e", "--erasures", type=int, default=1,
                   help="number of erasures when decoding")
    p.add_argument("--erased", type=int, action="append", default=[],
                   help="erased chunk (repeatable)")
    p.add_argument("-E", "--erasures-generation", default="random",
                   choices=["random", "exhaustive"])
    p.add_argument("-P", "--parameter", action="append", default=[],
                   help="add a parameter to the erasure code profile")
    p.add_argument("-b", "--batch", type=int, default=0,
                   help="stripes per iteration through the batched plugin "
                        "API (encode_batch/decode_batch); bytes processed "
                        "scale by the batch size. 0 = reference per-call "
                        "loop")
    p.add_argument("--writers", type=int, default=8,
                   help="concurrent writers for --workload storage-path")
    p.add_argument("--objects", type=int, default=64,
                   help="objects per storage-path pass, rebuilt by "
                        "recovery-path, or resident for tier-path")
    p.add_argument("--profile", action="store_true",
                   help="storage-path only: print the per-stage transfer "
                        "ledger (h2d/d2h ops+bytes, library builds, "
                        "granules, h2d-per-granule) as one JSON object "
                        "instead of the full result.  Exits nonzero on any "
                        "steady-state library build (the harness gate)")
    p.add_argument("--smoke", action="store_true",
                   help="repair-path and elastic-path only: the tiny CI "
                        "shape (repair: 8 OSDs, 8 objects of 6 KiB; "
                        "elastic: 24 + 8 objects of 4 KiB, 8 clients)")
    p.add_argument("--payload", default="X", choices=["X", "random"],
                   help="payload contents: 'X' matches the reference tool "
                        "(ceph_erasure_code_benchmark.cc:173); 'random' "
                        "is seeded random bytes")
    return p.parse_args(argv)


def display_chunks(chunks, chunk_count):
    out = "chunks "
    for c in range(chunk_count):
        out += f"({c})  " if c not in chunks else f" {c}  "
    print(out + "(X) is an erased chunk")


def decode_erasures(all_chunks, chunks, i, want_erasures, ec):
    """Recursive exhaustive erasure enumeration (reference :205-252)."""
    if want_erasures == 0:
        want_to_read = set(range(ec.get_chunk_count())) - set(chunks.keys())
        decoded = ec.decode(want_to_read, chunks)
        for chunk in want_to_read:
            if not np.array_equal(all_chunks[chunk], decoded[chunk]):
                print(
                    f"chunk {chunk} content and recovered content are different",
                    file=sys.stderr,
                )
                return -1
        return 0
    for j in range(i, ec.get_chunk_count()):
        one_less = dict(chunks)
        one_less.pop(j, None)
        code = decode_erasures(all_chunks, one_less, j + 1,
                               want_erasures - 1, ec)
        if code:
            return code
    return 0


def _erase_random(chunks, erasures, chunk_count, rng):
    chunks = dict(chunks)
    for _ in range(erasures):
        while True:
            erasure = rng.randrange(chunk_count)
            if erasure in chunks:
                break
        del chunks[erasure]
    return chunks


def main(argv=None) -> int:
    args = parse_args(argv if argv is not None else sys.argv[1:])
    profile = {}
    for param in args.parameter:
        if param.count("=") != 1:
            print(f"--parameter {param} ignored (needs exactly one =)",
                  file=sys.stderr)
            continue
        key, val = param.split("=")
        profile[key] = val

    if args.workload == "recovery-path":
        return _recovery_path(args, profile)
    if args.workload == "repair-path":
        return _repair_path(args, profile)
    if args.workload == "elastic-path":
        return _elastic_path(args, profile)
    if args.workload == "mesh-path":
        return _mesh_path(args, profile)

    k = int(profile.get("k", "0"))
    m = int(profile.get("m", "0"))
    if k <= 0:
        print(f"parameter k is {k}. But k needs to be > 0.")
        return -22
    if m < 0:
        print(f"parameter m is {m}. But m needs to be >= 0.")
        return -22

    ec = registry_mod.instance().factory(args.plugin, profile)

    if (
        ec.get_data_chunk_count() != k
        or ec.get_chunk_count() - ec.get_data_chunk_count() != m
    ):
        print(
            f"parameter k is {k}/m is {m}. But data chunk count is "
            f"{ec.get_data_chunk_count()}/parity chunk count is "
            f"{ec.get_chunk_count() - ec.get_data_chunk_count()}"
        )
        return -22

    if args.workload == "storage-path":
        return _storage_path(args, ec)
    if args.workload == "tier-path":
        return _tier_path(args, ec)
    if args.workload == "cluster-path":
        return _cluster_path(args, ec)

    if args.payload == "random":
        payload = np.random.RandomState(42).randint(
            0, 256, size=args.size, dtype=np.uint8
        )
    else:
        payload = np.full(args.size, ord("X"), dtype=np.uint8)
    want = set(range(ec.get_chunk_count()))

    if args.batch and not hasattr(ec, "encode_batch"):
        print(f"plugin {args.plugin} has no batched API; ignoring --batch",
              file=sys.stderr)
        args.batch = 0

    if args.workload == "encode" and args.batch:
        stripes = [payload] * args.batch
        ec.encode_batch(stripes[:1])  # warm: kernel build + matrix upload
        begin = time.perf_counter()
        for _ in range(args.iterations):
            ec.encode_batch(stripes)
        elapsed = time.perf_counter() - begin
        print(f"{elapsed:.6f}\t{args.iterations * args.batch * (args.size // 1024)}")
        return 0
    if args.workload == "decode" and args.batch:
        encoded = ec.encode(want, payload)
        if args.erased:
            erased = dict(encoded)
            for e in args.erased:
                erased.pop(e, None)
            display_chunks(erased, ec.get_chunk_count())
            maps = [erased] * args.batch
        else:
            rng = random.Random(7)
            maps = [_erase_random(encoded, args.erasures,
                                  ec.get_chunk_count(), rng)
                    for _ in range(args.batch)]
        ec.decode_batch(maps[:1])  # warm
        begin = time.perf_counter()
        for _ in range(args.iterations):
            ec.decode_batch(maps)
        elapsed = time.perf_counter() - begin
        print(f"{elapsed:.6f}\t{args.iterations * args.batch * (args.size // 1024)}")
        return 0

    if args.workload == "encode":
        # one untimed call first: kernel build and matrix upload are the
        # one-time setup the reference codec does in prepare()
        ec.encode(want, payload)
        begin = time.perf_counter()
        for _ in range(args.iterations):
            ec.encode(want, payload)
        elapsed = time.perf_counter() - begin
    else:
        encoded = ec.encode(want, payload)
        if args.erased:
            for e in args.erased:
                encoded.pop(e, None)
            display_chunks(encoded, ec.get_chunk_count())
        rng = random.Random()
        begin = time.perf_counter()
        for _ in range(args.iterations):
            if args.erasures_generation == "exhaustive":
                code = decode_erasures(encoded, encoded, 0, args.erasures,
                                       ec)
                if code:
                    return code
            elif args.erased:
                ec.decode(want, encoded)
            else:
                ec.decode(want, _erase_random(encoded, args.erasures,
                                              ec.get_chunk_count(), rng))
        elapsed = time.perf_counter() - begin

    print(f"{elapsed:.6f}\t{args.iterations * (args.size // 1024)}")
    return 0


def _storage_path(args, ec) -> int:
    """The host OSD storage path: assemble -> transpose -> encode ->
    commit (+ signature-grouped degraded decode) with concurrent writers,
    coalescing on and off, bit-exactness gated before timing."""
    from ceph_tpu_torch.osd.storage_bench import run_storage_path_bench

    result = run_storage_path_bench(
        ec, n_objects=args.objects, obj_bytes=args.size,
        writers=args.writers, iters=max(1, args.iterations),
    )
    if args.profile:
        # the transfer-ledger cut of the result (a steady-state library
        # build already raised inside the harness -> nonzero exit)
        print(json.dumps({
            "workload": "storage-path",
            "k": result["k"], "m": result["m"],
            "n_objects": result["n_objects"],
            "obj_bytes": result["obj_bytes"],
            "bit_exact": result["bit_exact"],
            "steady_library_builds": result["steady_library_builds"],
            "ledger": {
                mode: result[mode]["residency"]
                for mode in ("per_op", "coalesced")
            },
            "write_h2d_per_granule": (
                result["coalesced"]["residency"]["write"]
                ["h2d_per_granule"]),
        }))
        return 0
    print(json.dumps(result))
    print(
        f"storage-path k={result['k']} m={result['m']} "
        f"{args.objects}x{args.size}B x{args.writers} writers: "
        f"coalesced write {result['coalesced']['write_GiBs']:.4f} "
        f"GiB/s ({result['write_speedup']}x per-op), read "
        f"{result['coalesced']['read_GiBs']:.4f} GiB/s "
        f"({result['read_speedup']}x)", file=sys.stderr,
    )
    return 0


def _tier_path(args, ec) -> int:
    """Device cache tier: hot tier-resident read (one D2H + transpose
    from the shard-major device block) vs the cold miss path (frombuffer
    ingest + degraded decode), bit-exactness gated before timing."""
    from ceph_tpu_torch.tier.tier_bench import run_tier_path_bench

    result = run_tier_path_bench(
        ec, n_objects=args.objects, obj_bytes=args.size,
        iters=max(1, args.iterations), erasures=args.erasures,
    )
    print(json.dumps(result))
    print(
        f"tier-path k={result['k']} m={result['m']} "
        f"{args.objects}x{args.size}B: hot read "
        f"{result['hot_read_GiBs']:.4f} GiB/s vs cold decode "
        f"{result['cold_read_GiBs']:.4f} GiB/s "
        f"({result['read_speedup']}x), "
        f"{result['resident_bytes']} bytes resident",
        file=sys.stderr,
    )
    return 0


def _recovery_path(args, overlay) -> int:
    """Background data plane: rebuild two wiped OSDs' shards through the
    batched recovery coalescer and the per-object windowed path, with a
    concurrent client load on the mClock queues; bit-exactness,
    cross-mode shard bytes and the client-p99 bound are gated before
    anything is printed."""
    from ceph_tpu_torch.osd.recovery_bench import (PROFILE,
                                                   run_recovery_path_bench)

    result = run_recovery_path_bench(
        n_objects=args.objects, obj_bytes=args.size,
        profile=dict(PROFILE, **overlay))
    print(json.dumps(result))
    print(
        f"recovery-path {args.objects}x{args.size}B: batched "
        f"time-to-clean {result['batched']['time_to_clean_s']:.3f}s "
        f"({result['rebuild_speedup']}x per-object), client p99 "
        f"{result['batched']['client_p99_ms']}ms during rebuild, "
        f"{result['batched']['counters']['recovery_ops_batched']} "
        f"objects through the batched lane",
        file=sys.stderr,
    )
    return 0


def _repair_path(args, overlay) -> int:
    """Regenerating repair: rebuild a wiped OSD of a product-matrix MSR
    pool (plugin regen, k=4 m=3, d=2k-2=6) through the beta-fractional
    repair lane vs the classic full-stripe gather on the SAME pool.
    Chaos sequence (wipe -> degraded peak -> monotone drain -> clean),
    bit-exactness, cross-mode shard bytes, measured gather-bytes ratio
    <= 0.75 and time-to-clean no worse are all gated before anything is
    printed."""
    from ceph_tpu_torch.osd.repair_bench import (PROFILE,
                                                 run_repair_path_bench)

    profile = dict(PROFILE, **overlay)
    if args.smoke:
        result = run_repair_path_bench(
            n_osds=8, n_objects=8, obj_bytes=6 << 10, profile=profile)
    else:
        result = run_repair_path_bench(
            n_objects=args.objects, obj_bytes=args.size, profile=profile)
    print(json.dumps(result))
    print(
        f"repair-path {result['n_objects']}x{result['obj_bytes']}B:"
        f" gather ratio {result['repair_bytes_ratio']} "
        f"(gate 0.75), time-to-clean ratio "
        f"{result['time_to_clean_ratio']}, "
        f"{result['bytes_saved']} repair bytes saved, "
        f"{result['fractional']['counters']['regen_helpers_served']}"
        " helper symbols served",
        file=sys.stderr,
    )
    return 0


def _elastic_path(args, overlay) -> int:
    """Elastic membership: a +2-OSD online expansion under client load
    (moved bytes <= 1.25x the theoretical minimum, misplaced peak then
    a monotone drain, HEALTH_OK, bounded client p99), then three chaos
    arms on the same cluster: the backfill target killed mid-migration,
    a live primary removed under load, and an add-then-remove flap.
    Bit-exact reads and an exactly-once write audit gate every stage
    before any number is printed."""
    from ceph_tpu_torch.osd.elastic_bench import (PROFILE,
                                                  run_elastic_path_bench)

    result = run_elastic_path_bench(smoke=args.smoke,
                                    profile=dict(PROFILE, **overlay))
    print(json.dumps(result))
    print(
        f"elastic-path {result['n_osds']}osd "
        f"{result['n_objects']}x{result['obj_bytes']}B "
        f"{result['n_clients']}cl: moved ratio "
        f"{result['data_moved_ratio']} (gate 1.25), "
        f"time-to-clean {result['time_to_clean_s']}s, "
        f"client p99 {result['client_p99_during_expansion_ms']}ms, "
        f"misplaced peak {result['misplaced_peak']} "
        f"({result['misplaced_upticks']} upticks), chaos "
        f"kill/rm/flap rounds "
        f"{result['chaos']['target_kill']['rounds']}/"
        f"{result['chaos']['primary_rm']['rounds']}/"
        f"{result['chaos']['flap']['rounds']}",
        file=sys.stderr,
    )
    return 0


def _cluster_path(args, ec) -> int:
    """Client Objecter -> primary OSD -> k+m sub-op fan-out over real
    localhost TCP, per-message wire against corked/zero-copy wire
    (piggybacked acks), bit-exactness gated before timing, plus the
    messenger-level wire stage and its wire-shape counters."""
    from ceph_tpu_torch.msg.cluster_bench import run_cluster_path_bench

    result = run_cluster_path_bench(
        ec, n_objects=args.objects, obj_bytes=args.size,
        writers=args.writers, iters=max(1, args.iterations),
    )
    print(json.dumps(result))
    wc = result["wire_corked"]["counters"]
    print(
        f"cluster-path k={result['k']} m={result['m']} "
        f"{args.objects}x{args.size}B x{args.writers} writers over "
        f"TCP: corked write {result['corked']['write_MiBs']:.3f} "
        f"MiB/s ({result['write_speedup']}x per-message), wire "
        f"stage {result['wire_write_speedup']}x "
        f"({wc['frames_per_burst']} frames/burst, "
        f"{wc['ack_piggyback_ratio']} acks piggybacked)",
        file=sys.stderr,
    )
    return 0


def _mesh_path(args, overlay) -> int:
    """The full TCP cluster path and the PG-sliced encode dispatch swept
    over mesh device counts (osd_mesh_data_plane on) against the
    TCP-only baseline; bit-exact read-back, identical shards across
    configurations, monotone wire-bytes-avoided and no library build in
    the timed pass are gated inside the harness."""
    import torch

    from ceph_tpu_torch import parallel
    from ceph_tpu_torch.msg.mesh_bench import run_mesh_path_bench

    overlay = dict(overlay)
    k = int(overlay.pop("k", "2"))
    m = int(overlay.pop("m", "2"))
    sizes = tuple(int(t) for t in args.mesh_sizes.split(",") if t) \
        or (1, 2, 4, 8)
    dev = torch.device(overlay.get("device", "cuda"))
    prior = parallel.configured_devices()
    if dev.type == "cpu":
        parallel.configure_devices([dev] * max(sizes))
    elif torch.cuda.device_count() < max(sizes):
        parallel.configure_devices([torch.device("cuda", 0)] * max(sizes))
    try:
        result = run_mesh_path_bench(
            n_objects=args.objects, obj_bytes=args.size,
            writers=args.writers, iters=max(1, args.iterations),
            mesh_sizes=sizes, k=k, m=m, profile=overlay)
    finally:
        parallel.configure_devices(prior)
    print(json.dumps(result))
    print(
        f"mesh-path k={result['k']} m={result['m']} "
        f"{args.objects}x{args.size}B over TCP: speedup vs mesh_1 "
        f"{result['speedup_vs_mesh1']}, wire bytes avoided "
        f"{result['wire_bytes_avoided']}, encode GiB/s "
        f"{result['encode_GiBs']}", file=sys.stderr,
    )
    return 1 if result["steady_library_builds"] else 0


if __name__ == "__main__":
    sys.exit(main())
