"""Tracing-overhead benchmark stage + slow-op forensics proof.

Port of ``ceph_tpu/osd/trace_bench.py`` with the JAX package's gates and
default limits, over the port's pool (the caller's ``ec``: the ``cuda``
plugin on the card, ``device=cpu`` in the tests) and its default wire
codec (the native one).

The trace subsystem (utils/trace.py, utils/optracker.py) is
only shippable if leaving it ON costs nothing measurable: this stage
runs the SAME workload under ``trace_mode`` off / sampled / full and
gates sampled-mode throughput within ``overhead_limit_pct`` of off --
on both measured paths:

* **storage_path**: the coalesced host encode/decode cycle
  (``osd/storage_bench.py`` harness) -- covers the coalescer's span
  capture and batch fan-in bookkeeping;
* **cluster_path**: the full client->primary->k+m fan-out over real
  localhost TCP (``msg/cluster_bench.py`` harness) -- covers the
  Objecter/OSDShard TrackedOps, the wire trace field, the per-stage
  histograms and the ack-lag observer.

Correctness is gated alongside the timing:

* in full mode one write's trace must stitch client -> primary ->
  sub-writes with the batch_encode fan-in span, and its op timeline's
  segments must sum to the span's end-to-end duration (tolerance
  ``SUM_TOLERANCE``);
* with ``osd_op_complaint_time`` shrunk to ~0, ops must be DETECTED as
  slow (counter + ``dump_historic_slow_ops``) -- the forensics lane
  fires end to end;
* after quiescing, ZERO started-but-unfinished spans may remain.

Used by ``ceph_tpu_torch/tools/ec_benchmark.py --workload trace-path``,
phase 3k of ``chip_smoke.py``, tests/test_torch_trace_path.py and
``python -m ceph_tpu_torch.osd.trace_bench [--smoke] [--device cpu]``.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, List

from ceph_tpu_torch.utils import trace

#: op-timeline segments must sum to end-to-end within this fraction
SUM_TOLERANCE = 0.02
_MODES = ("off", "sampled", "full")


def _restore(prior: Dict[str, object]) -> None:
    from ceph_tpu_torch.utils.config import get_config

    cfg = get_config()
    for key, val in prior.items():
        cfg.set_val(key, val)
    trace.configure()  # reload the cached knobs


def _snapshot_knobs() -> Dict[str, object]:
    from ceph_tpu_torch.utils.config import get_config

    cfg = get_config()
    return {k: cfg.get_val(k)
            for k in ("trace_mode", "trace_sample_every",
                      "osd_op_complaint_time")}


async def _storage_cycle(harness, payloads: List[bytes],
                         writers: int) -> float:
    t0 = time.perf_counter()
    store = await harness.write_pass(payloads, coalesce=True,
                                     writers=writers)
    await harness.read_pass(store, len(payloads),
                            [len(p) for p in payloads], coalesce=True,
                            readers=writers)
    return time.perf_counter() - t0


async def _cluster_cycle(harness, payloads: Dict[str, bytes],
                         writers: int) -> float:
    write_s = await harness.run_writes(payloads, writers)
    read_s, got = await harness.run_reads(payloads, writers)
    for oid, data in payloads.items():
        if got.get(oid) != data:
            raise AssertionError(f"trace-path: read-back of {oid} "
                                 "mismatched")
    return write_s + read_s


def _verify_stitched_trace() -> dict:
    """The full-mode correctness gate: one trace stitches across the
    daemons and its op timeline sums to the measured end-to-end."""
    spans = trace.dump()
    primary = next((s for s in reversed(spans)
                    if s["name"] == "osd:write"), None)
    if primary is None:
        raise AssertionError("trace-path: no osd:write span collected "
                             "in full mode")
    fam = [s for s in spans if s["trace_id"] == primary["trace_id"]]
    names = [s["name"] for s in fam]
    if "client:write" not in names:
        raise AssertionError("trace-path: client root span missing "
                             f"from trace (got {sorted(set(names))})")
    subs = [s for s in fam if s["name"].endswith(":sub_write")]
    if not subs:
        raise AssertionError("trace-path: no sub_write spans stitched")
    tl = trace.op_timeline(primary["span_id"])
    seg_sum = sum(s["ms"] for s in tl["segments"])
    total = tl["total_ms"]
    if total and abs(seg_sum - total) > max(0.5, SUM_TOLERANCE * total):
        raise AssertionError(
            f"trace-path: timeline segments sum to {seg_sum:.3f}ms but "
            f"the op took {total:.3f}ms")
    batch = next((s for s in fam if s["name"] == "batch_encode"), None)
    return {
        "trace_id": primary["trace_id"],
        "spans": len(fam),
        "sub_writes": len(subs),
        "timeline_total_ms": total,
        "timeline_segment_sum_ms": round(seg_sum, 6),
        "batch_encode_amortized_over":
            batch["amortized_over"] if batch else None,
    }


async def _slow_op_probe(cluster) -> dict:
    """Shrink the complaint time so ordinary ops read as slow: the
    detection lane (counter, warning, historic-slow retention with a
    decomposed timeline) must fire."""
    from ceph_tpu_torch.utils.config import get_config

    cfg = get_config()
    prior = cfg.get_val("osd_op_complaint_time")
    cfg.set_val("osd_op_complaint_time", 1e-6)
    try:
        await cluster.objecter.write("slowprobe", b"s" * 4096)
        await cluster.objecter.read("slowprobe")
    finally:
        cfg.set_val("osd_op_complaint_time", prior)
    detected = sum(o.optracker.slow_ops for o in cluster.osds)
    detected += cluster.objecter.optracker.slow_ops
    dumps = [o.optracker.dump_historic_slow_ops() for o in cluster.osds]
    returned = sum(d["num_ops"] for d in dumps)
    timelined = any(
        op.get("timeline", {}).get("segments")
        for d in dumps for op in d["ops"]
    )
    if not detected:
        raise AssertionError("trace-path: no slow ops detected with "
                             "complaint_time ~0")
    if not returned:
        raise AssertionError("trace-path: dump_historic_slow_ops "
                             "returned nothing")
    return {"slow_ops_detected": detected,
            "historic_slow_returned": returned,
            "decomposed_timeline_present": bool(timelined)}


def run_trace_overhead_bench(ec, *, n_objects: int = 48,
                             obj_bytes: int = 16 << 10, writers: int = 8,
                             iters: int = 2, seed: int = 77,
                             overhead_limit_pct: float = 3.0,
                             retries: int = 3,
                             n_osds=None, keep_shards: bool = False) -> dict:
    """Off / sampled / full comparison on storage_path + cluster_path,
    correctness-gated (stitched trace, timeline sums, slow-op
    detection, zero unfinished spans); raises if sampled-mode overhead
    stays above ``overhead_limit_pct`` across ``retries`` attempts.
    ``keep_shards`` adds the cluster's stored shard bytes under
    ``"_shards"`` (``(osd, "<oid>@<shard>")`` -> bytes)."""
    from ceph_tpu_torch.msg.cluster_bench import ClusterHarness
    from ceph_tpu_torch.msg.cluster_bench import make_payloads as mk_cluster
    from ceph_tpu_torch.osd.storage_bench import StoragePathHarness
    from ceph_tpu_torch.osd.storage_bench import make_payloads as mk_storage

    if n_osds is None:
        n_osds = ec.get_chunk_count()
    prior = _snapshot_knobs()
    sp = StoragePathHarness(ec)
    sp_payloads = mk_storage(n_objects, obj_bytes, seed)
    cl_payloads = mk_cluster(n_objects, obj_bytes, seed + 1)
    loop = asyncio.new_event_loop()
    best: Dict[str, Dict[str, float]] = {m: {} for m in _MODES}
    extras: Dict[str, object] = {}
    try:
        harness = ClusterHarness(ec, n_osds, cork=True,
                                 pool="tracepool")
        loop.run_until_complete(harness.start())
        for oid in cl_payloads:
            harness.objecter.acting_set(oid)
        try:
            # warm both paths (codec tables, TCP sessions) off-trace
            trace.configure(mode="off")
            loop.run_until_complete(_storage_cycle(sp, sp_payloads,
                                                   writers))
            loop.run_until_complete(_cluster_cycle(harness, cl_payloads,
                                                   writers))
            attempts = 0
            # per-block overhead RATIOS: each iteration measures the
            # three modes back to back, so a ratio compares walls taken
            # seconds apart -- slow machine drift (noisy neighbors,
            # thermal) cancels, where a global best-wall comparison
            # would pin one mode to a quiet window and another to a
            # loud one.  The gate takes the MIN ratio: one quiet block
            # proving the overhead within bound is evidence enough.
            ratios: Dict[str, List[float]] = {"sampled": [], "full": []}
            while True:
                attempts += 1
                for _ in range(max(1, iters)):
                    walls = {}
                    for mode in _MODES:
                        trace.configure(mode=mode)
                        sp_s = loop.run_until_complete(
                            _storage_cycle(sp, sp_payloads, writers))
                        cl_s = loop.run_until_complete(
                            _cluster_cycle(harness, cl_payloads,
                                           writers))
                        walls[mode] = sp_s + cl_s
                        cur = best[mode]
                        if "storage_s" not in cur or \
                                sp_s < cur["storage_s"]:
                            cur["storage_s"] = sp_s
                        if "cluster_s" not in cur or \
                                cl_s < cur["cluster_s"]:
                            cur["cluster_s"] = cl_s
                    for m in ("sampled", "full"):
                        ratios[m].append(walls[m] / walls["off"])
                overhead = {m: (min(ratios[m]) - 1) * 100
                            for m in ("sampled", "full")}
                if overhead["sampled"] <= overhead_limit_pct or \
                        attempts >= max(1, retries):
                    break
            if overhead["sampled"] > overhead_limit_pct:
                raise AssertionError(
                    f"trace-path: sampled-mode overhead "
                    f"{overhead['sampled']:.2f}% exceeds the "
                    f"{overhead_limit_pct}% gate after {attempts} "
                    "attempts")
            # correctness gates, in full mode on the SAME cluster
            trace.configure(mode="full")
            loop.run_until_complete(
                harness.objecter.write("stitchprobe", b"p" * obj_bytes))
            extras["stitched"] = _verify_stitched_trace()
            extras.update(loop.run_until_complete(
                _slow_op_probe(harness)))
            if keep_shards:
                extras["_shards"] = harness.shard_bytes()
        finally:
            loop.run_until_complete(harness.shutdown())
        # quiesced: nothing may still hold an unfinished span
        unfinished = trace.unfinished_count()
        if unfinished:
            raise AssertionError(
                f"trace-path: {unfinished} unfinished span(s) after "
                f"quiesce: {trace.unfinished_names()}")
        extras["unfinished_spans"] = 0
    finally:
        loop.close()
        _restore(prior)
    nbytes = n_objects * obj_bytes * 2  # write + read, per path
    modes_out = {}
    for m in _MODES:
        modes_out[m] = {
            "storage_wall_s": round(best[m]["storage_s"], 6),
            "cluster_wall_s": round(best[m]["cluster_s"], 6),
            "storage_MiBs": round(
                nbytes / best[m]["storage_s"] / (1 << 20), 3),
            "cluster_MiBs": round(
                nbytes / best[m]["cluster_s"] / (1 << 20), 3),
        }
    return dict({
        "n_objects": n_objects,
        "obj_bytes": obj_bytes,
        "writers": writers,
        "overhead_limit_pct": overhead_limit_pct,
        "modes": modes_out,
        "trace_overhead_pct_sampled": round(overhead["sampled"], 3),
        "trace_overhead_pct_full": round(overhead["full"], 3),
        "attempts": attempts,
    }, **extras)


def main(argv=None) -> int:
    """``python -m ceph_tpu_torch.osd.trace_bench [--smoke] [--device
    cpu]``: one traced op end to end, failing on unfinished spans,
    missing stitching, or (non-smoke) overhead regression, on the
    ``cuda`` plugin at reed_sol_van k=4 m=2."""
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes + a loose overhead gate")
    ap.add_argument("--device", default="cuda",
                    help="the cuda plugin's device (default: the card)")
    args = ap.parse_args(argv)
    from ceph_tpu_torch.plugins import registry as registry_mod

    ec = registry_mod.instance().factory(
        "cuda", {"k": "4", "m": "2", "technique": "reed_sol_van",
                 "device": args.device})
    if args.smoke:
        result = run_trace_overhead_bench(
            ec, n_objects=8, obj_bytes=4096, writers=4, iters=1,
            overhead_limit_pct=50.0)
    else:
        result = run_trace_overhead_bench(ec)
    print(json.dumps(result, indent=2), file=sys.stderr)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
