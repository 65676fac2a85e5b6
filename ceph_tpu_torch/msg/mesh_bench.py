"""Mesh-path benchmark: cluster-path scaling vs mesh shard count.

Port of ``ceph_tpu/msg/mesh_bench.py`` over the port's
``parallel/mesh_plane.py``, with the pool on the port's ``cuda`` plugin
where the JAX package's names ``tpu`` (``profile`` overlays it:
``{"device": "cpu"}`` on the CPU) and the Python wire codec
(``"wire_codec": "python"``).  The plane's slots are the devices of
``parallel.local_devices()``; the caller sets them
(``parallel.configure_devices``) where the process has fewer cards than
the largest mesh size.  The JAX package's gate of zero steady retraces is
the port's ``steady_library_builds == 0``: no kernel library (or the
crc library) built or first loaded in a timed write pass.

The cluster-path bench (``msg/cluster_bench.py``) measures the wire
architecture at a fixed topology; this stage measures how the SAME full-stack path (client Objecter ->
primary OSD -> k+m sub-op fan-out over real localhost TCP) scales as
the OSD data plane is sharded over a growing device mesh
(``osd_mesh_data_plane``, ``ceph_tpu_torch/parallel/mesh_plane.py``):

* ``tcp_only``   -- the A/B baseline: plane off, every chunk payload
  serialized through the corked TCP messenger;
* ``mesh_N``     -- the plane spans N devices, the first N OSDs are
  mesh-bound: their coalesced encode batches ride ONE PG-sliced SPMD
  dispatch and chunk payloads destined for them cross as delivery-board
  references (tiny frames) instead of serialized bytes.

As N grows, more of the fan-out's payload bytes leave the wire --
``wire_bytes_avoided`` (board claims) rises and the messengers'
``bytes_sent`` falls -- the per-op host/wire gap of the cluster path
("Understanding System Characteristics of Online Erasure Coding": the
wire fan-out, not the codec, dominates online EC).  A separate encode-only stage times the
PG-sliced SPMD dispatch itself at each mesh size.

Correctness-gated like every bench stage: every cycle round-trips every
payload bit-exactly, stored shard bytes must be identical across every
configuration, wire-bytes-avoided must be monotone in N, and the timed
write pass must build no library (the encode ladder is pre-warmed, so
a build in the timed region means a shape or codec went unwarmed).

Used by ``ceph_tpu_torch/tools/ec_benchmark.py --workload mesh-path``,
phase 3j of ``chip_smoke.py`` and tests/test_torch_cluster_path.py.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ceph_tpu_torch.msg.cluster_bench import (WIRE_CODEC, ClusterHarness,
                                              make_payloads,
                                              python_wire_codec)


def _warm_encode_buckets(plane, ec, chunk_bytes: int) -> None:
    """Run the encode ladder OUTSIDE the timed region --
    both dispatch lanes (fused for balanced batches, per-slot for
    partial ones), every pow2 rows bucket, every slot -- so the
    steady-state pass builds nothing (the gate below)."""
    k = ec.get_data_chunk_count()
    for rows in (1, 2, 4, 8):
        # fused lane: every slot occupied at this rows bucket
        n = plane.n_devices * rows
        blocks = [np.zeros((k, chunk_bytes), np.uint8) for _ in range(n)]
        plane.encode_shard_major_many(ec, blocks, list(range(n)))
        # slot lane: each slot alone (its own tables on its device)
        for slot in range(plane.n_devices):
            blocks = [np.zeros((k, chunk_bytes), np.uint8)
                      for _ in range(rows)]
            plane.encode_shard_major_many(ec, blocks, [slot] * rows)


async def _one_cycle(ec, n_osds: int, payloads: Dict[str, bytes],
                     writers: int, plane) -> dict:
    """One full-stack write+read cycle over real TCP; returns walls,
    wire counters, stored shard bytes, and the library builds of the
    timed write pass."""
    from ceph_tpu_torch.analysis import residency

    h = ClusterHarness(ec, n_osds, cork=True)
    await h.start()
    try:
        for oid in payloads:
            h.objecter.acting_set(oid)  # placement outside the timing
        if plane is not None:
            chunk = len(next(iter(payloads.values()))) \
                // ec.get_data_chunk_count()
            _warm_encode_buckets(plane, ec, chunk)
        # warm pass: connections, handshakes, and every kernel library
        await h.run_writes(dict(payloads), writers)
        before = residency.counters().snapshot()
        write_s = await h.run_writes(dict(payloads), writers)
        after = residency.counters().snapshot()
        read_s, got = await h.run_reads(payloads, writers)
        for oid, data in payloads.items():
            if got.get(oid) != data:
                raise AssertionError(
                    f"mesh-path: read-back of {oid} mismatched")
        counters = h.wire_counters()
        shards = h.shard_bytes()
    finally:
        await h.shutdown()
    nbytes = sum(len(p) for p in payloads.values())
    return {
        "wall_write_s": round(write_s, 6),
        "wall_read_s": round(read_s, 6),
        "write_MiBs": round(nbytes / write_s / (1 << 20), 3),
        "wire_bytes_sent": counters.get("bytes_sent", 0),
        "wire_msgs_sent": counters.get("msgs_sent", 0),
        "steady_library_builds":
            after["library_builds"] - before["library_builds"],
        "_shards": shards,
    }


def _encode_stage(ec, plane, n_stripes: int, chunk_bytes: int,
                  iters: int) -> float:
    """PG-sliced SPMD encode throughput (GiB/s) at this mesh size: the
    coalescer's fused dispatch isolated from the wire."""
    k = ec.get_data_chunk_count()
    rng = np.random.RandomState(7)
    blocks = [rng.randint(0, 256, size=(k, chunk_bytes), dtype=np.uint8)
              for _ in range(n_stripes)]
    pgids = list(range(n_stripes))
    plane.encode_shard_major_many(ec, blocks, pgids)  # warm
    nbytes = sum(b.nbytes for b in blocks)
    t0 = time.perf_counter()
    for _ in range(iters):
        plane.encode_shard_major_many(ec, blocks, pgids)
    dt = time.perf_counter() - t0
    return iters * nbytes / dt / (1 << 30)


def run_mesh_path_bench(
    *, n_objects: int = 48, obj_bytes: int = 32 << 10, writers: int = 8,
    mesh_sizes: Sequence[int] = (1, 2, 4, 8), iters: int = 1,
    k: int = 2, m: int = 2, seed: int = 1717,
    encode_stripes: int = 32, profile: Optional[Dict[str, str]] = None,
    keep_shards: bool = False,
) -> dict:
    """Sweep the mesh shard count over the full TCP cluster path and
    the encode-only dispatch; returns the JSON-ready dict.  Raises on
    any correctness-gate violation (bit-exactness, cross-config shard
    bytes, wire-avoided monotonicity, steady library builds).
    ``keep_shards`` adds the ``tcp_only`` stored shard bytes under
    ``"_shards"``."""
    with python_wire_codec():
        return _run_mesh_path_bench(
            n_objects=n_objects, obj_bytes=obj_bytes, writers=writers,
            mesh_sizes=mesh_sizes, iters=iters, k=k, m=m, seed=seed,
            encode_stripes=encode_stripes, profile=profile or {},
            keep_shards=keep_shards)


def _run_mesh_path_bench(*, n_objects, obj_bytes, writers, mesh_sizes,
                         iters, k, m, seed, encode_stripes, profile,
                         keep_shards) -> dict:
    from ceph_tpu_torch.osd.elastic_bench import warm_codec
    from ceph_tpu_torch.parallel import mesh_plane
    from ceph_tpu_torch.plugins import registry as registry_mod
    from ceph_tpu_torch.utils.config import get_config

    cfg = get_config()
    prior_gate = bool(cfg.get_val("osd_mesh_data_plane"))
    n_osds = k + m
    payloads = make_payloads(n_objects, obj_bytes, seed)
    chunk_bytes = obj_bytes // k

    def _fresh_ec():
        ec = registry_mod.instance().factory(
            "cuda", dict({"technique": "reed_sol_van",
                          "k": str(k), "m": str(m)}, **profile), "")
        warm_codec(ec)
        return ec

    results: Dict[str, dict] = {}
    avoided: Dict[str, int] = {}
    encode_gibps: Dict[str, Optional[float]] = {}
    shards: Dict[str, dict] = {}
    try:
        # -- A/B baseline: plane off, every byte over TCP --------------
        cfg.set_val("osd_mesh_data_plane", False)
        mesh_plane.reset()
        loop = asyncio.new_event_loop()
        try:
            best = None
            for _ in range(max(1, iters)):
                r = loop.run_until_complete(_one_cycle(
                    _fresh_ec(), n_osds, payloads, writers, None))
                shards["tcp_only"] = r.pop("_shards")
                if best is None or r["wall_write_s"] < best["wall_write_s"]:
                    best = r
            results["tcp_only"] = best
            avoided["tcp_only"] = 0
        finally:
            loop.close()

        # -- mesh sweep ------------------------------------------------
        cfg.set_val("osd_mesh_data_plane", True)
        for n in mesh_sizes:
            plane = mesh_plane.configure(n)
            name = f"mesh_{n}"
            loop = asyncio.new_event_loop()
            try:
                best = None
                for _ in range(max(1, iters)):
                    r = loop.run_until_complete(_one_cycle(
                        _fresh_ec(), n_osds, payloads, writers, plane))
                    shards[name] = r.pop("_shards")
                    if best is None or \
                            r["wall_write_s"] < best["wall_write_s"]:
                        best = r
                results[name] = best
            finally:
                loop.close()
            avoided[name] = plane.counters["mesh_wire_bytes_avoided"]
            encode_gibps[name] = _encode_stage(
                _fresh_ec(), plane, encode_stripes, chunk_bytes,
                max(1, iters))
            results[name]["sharding_builds"] = plane.sharding_builds
            results[name]["board"] = plane.board.stats()
    finally:
        cfg.set_val("osd_mesh_data_plane", prior_gate)
        mesh_plane.reset()

    # -- gates ---------------------------------------------------------
    base_key = "tcp_only"
    for name, stored in shards.items():
        if set(stored) != set(shards[base_key]):
            raise AssertionError(
                f"mesh-path: shard sets differ ({name} vs {base_key})")
        for key in stored:
            if stored[key] != shards[base_key][key]:
                raise AssertionError(
                    f"mesh-path: shard {key} differs between {name} "
                    f"and {base_key}")
    last = -1
    for n in mesh_sizes:
        cur = avoided[f"mesh_{n}"]
        if cur < last:
            raise AssertionError(
                "mesh-path: wire_bytes_avoided not monotone in mesh "
                f"size (mesh_{n}: {cur} < {last})")
        last = cur
    steady = sum(r.get("steady_library_builds", 0)
                 for r in results.values())
    if steady:
        raise AssertionError(
            f"mesh-path: {steady} library builds in the timed write "
            "pass (the warm pass must have built every library)")

    walls = {name: r["wall_write_s"] for name, r in results.items()}
    sizes = list(mesh_sizes)
    first, biggest = f"mesh_{sizes[0]}", f"mesh_{max(sizes)}"
    speedup_vs_first = {
        f"mesh_{n}": round(walls[first] / walls[f"mesh_{n}"], 3)
        for n in sizes if walls.get(f"mesh_{n}")
    }
    out = {
        "n_objects": n_objects,
        "obj_bytes": obj_bytes,
        "writers": writers,
        "k": k,
        "m": m,
        "mesh_sizes": sizes,
        "bit_exact": True,  # the gates raised otherwise
        "results": results,
        "wire_bytes_avoided": avoided,
        "wire_bytes_sent": {
            name: r["wire_bytes_sent"] for name, r in results.items()},
        "encode_GiBs": encode_gibps,
        "write_MiBs": {
            name: r["write_MiBs"] for name, r in results.items()},
        "speedup_vs_mesh1": speedup_vs_first,
        "speedup_4x": speedup_vs_first.get("mesh_4"),
        "speedup_max": round(walls[first] / walls[biggest], 3)
        if walls.get(biggest) else None,
        "tcp_only_vs_mesh_max": round(
            walls["tcp_only"] / walls[biggest], 3)
        if walls.get(biggest) else None,
        "steady_library_builds": steady,
        "wire_codec": WIRE_CODEC,
    }
    if keep_shards:
        out["_shards"] = shards[base_key]
    return out
