#!/usr/bin/env python
"""Parameter-sweep benchmark (qa/workunits/erasure-code/bench.sh analogue).

Port of ``tools/ec_bench_sweep.py`` over the port's registry.  Sweeps
plugins x techniques x k/m like the reference harness (reference:
qa/workunits/erasure-code/bench.sh:50-130: k in {2,3,4,6,10}, m per k-map,
vandermonde+cauchy for isa/jerasure, TOTAL_SIZE/SIZE iterations, cauchy
packetsize heuristic) and emits one JSON line per cell:
{"plugin":…, "technique":…, "k":…, "m":…, "workload":…, "gibps":…}.

The JAX package's ``tpu`` plugin is the port's ``cuda`` plugin, and
``--backend`` takes ``cpu``, ``native`` (the host's AVX2 kernels) or
``cuda`` (the card).  A cell whose codec runs on a device (the ``cuda``
plugin, or ``--backend cuda``) also reports ``h2d_ops``: the uploads its
timed encodes issued (the residency ledger's count).  The payload is
constant and every iteration a one-shot ``encode``, so the ``cuda``
plugin's upload cache elides the uploads after the warm-up.  ``--device``
(for example ``cpu``) sets the ``device`` of those profiles; by default
they run on the card.

    python -m ceph_tpu_torch.tools.ec_bench_sweep --plugins cuda,jerasure,isa \\
        --backend cuda
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ceph_tpu_torch.analysis import residency
from ceph_tpu_torch.plugins import registry as registry_mod

KS = [2, 3, 4, 6, 10]
M_MAP = {2: [1, 2], 3: [2], 4: [2, 3], 6: [3], 10: [4]}


def packetsize_heuristic(size: int, k: int, w: int = 8, wordsize: int = 4) -> int:
    """bench.sh:92-101 cauchy packetsize heuristic, capped at 3100."""
    ps = (size // k // w // wordsize) * wordsize
    return max(4, min(ps, 3100))


def on_device(plugin: str, backend: str) -> bool:
    """Whether the cell's codec runs on a device (and so uploads)."""
    return plugin == "cuda" or backend == "cuda"


def bench_cell(plugin, technique, k, m, size, total, backend, device=""):
    """One cell: (GiB/s of the timed encodes, their H2D uploads)."""
    profile = {"k": str(k), "m": str(m), "technique": technique}
    if backend:
        profile["backend"] = backend
    if device and on_device(plugin, backend):
        profile["device"] = device
    if technique in ("cauchy_good", "cauchy_orig"):
        profile["packetsize"] = str(packetsize_heuristic(size, k))
    ec = registry_mod.instance().factory(plugin, profile)
    payload = np.full(size, ord("X"), dtype=np.uint8)
    want = set(range(ec.get_chunk_count()))
    iterations = max(1, total // size)
    ec.encode(want, payload)  # warmup (kernel builds etc.)
    h2d = residency.counters().h2d_ops
    t0 = time.perf_counter()
    for _ in range(iterations):
        ec.encode(want, payload)
    dt = time.perf_counter() - t0
    return iterations * size / dt / (1 << 30), \
        residency.counters().h2d_ops - h2d


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=1 << 20)
    p.add_argument("--total-size", type=int, default=16 << 20)
    p.add_argument("--plugins", default="jerasure,isa")
    p.add_argument("--backend", default="", help="cpu|native|cuda")
    p.add_argument("--device", default="",
                   help="device of the cells that run on one (default: "
                        "the profile's, the card)")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])

    techniques = {
        "jerasure": ["reed_sol_van", "cauchy_good"],
        "isa": ["reed_sol_van", "cauchy"],
        "cuda": ["reed_sol_van", "cauchy_good"],
    }
    for plugin in args.plugins.split(","):
        for technique in techniques.get(plugin, ["reed_sol_van"]):
            for k in KS:
                for m in M_MAP[k]:
                    if plugin == "isa" and technique == "reed_sol_van" and m > 4:
                        continue
                    try:
                        gibps, h2d = bench_cell(
                            plugin, technique, k, m,
                            args.size, args.total_size, args.backend,
                            args.device,
                        )
                        row = {
                            "plugin": plugin, "technique": technique,
                            "k": k, "m": m, "workload": "encode",
                            "gibps": round(gibps, 3),
                        }
                        if on_device(plugin, args.backend):
                            row["h2d_ops"] = h2d
                        print(json.dumps(row))
                    except Exception as e:  # guard-railed combos
                        print(json.dumps({
                            "plugin": plugin, "technique": technique,
                            "k": k, "m": m, "error": str(e)[:80],
                        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
