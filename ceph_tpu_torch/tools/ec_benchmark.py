#!/usr/bin/env python
"""ceph_erasure_code_benchmark-compatible CLI for the port's plugins.

Port of the ``encode``, ``decode`` and ``storage-path`` workloads of
``tools/ec_benchmark.py`` (reference:
src/test/erasure-code/ceph_erasure_code_benchmark.cc:39-137 setup,
:150-188 encode, :253-327 decode): encode and decode print
``<elapsed_seconds>\\t<KiB>`` where KiB = iterations * size / 1024 (times
the batch size with ``--batch``), so throughput = KiB / seconds.
``storage-path`` runs ``osd/storage_bench.py`` (``--objects`` objects of
``--size`` bytes, ``--writers`` concurrent writers, best of
``--iterations`` timed cycles) and prints its result as one JSON line, or
with ``--profile`` the transfer-ledger cut of it, the JSON keys of the
reference's with ``steady_library_builds`` in place of
``steady_jit_retraces`` (see ``osd/storage_bench.py``).

Examples:
    python -m ceph_tpu_torch.tools.ec_benchmark -p cuda -w encode \\
        -s 8388608 -i 3 -b 8 -P k=8 -P m=4
    python -m ceph_tpu_torch.tools.ec_benchmark -p cuda -w decode \\
        -s 8388608 -i 3 -b 8 --erased 1 --erased 6 -P k=8 -P m=4
    python -m ceph_tpu_torch.tools.ec_benchmark -w storage-path \\
        --objects 64 -s 4194304 --profile -P k=8 -P m=4

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
                   choices=["encode", "decode", "storage-path"])
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
                   help="objects per storage-path pass")
    p.add_argument("--profile", action="store_true",
                   help="storage-path only: print the per-stage transfer "
                        "ledger (h2d/d2h ops+bytes, library builds, "
                        "granules, h2d-per-granule) as one JSON object "
                        "instead of the full result.  Exits nonzero on any "
                        "steady-state library build (the harness gate)")
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


if __name__ == "__main__":
    sys.exit(main())
