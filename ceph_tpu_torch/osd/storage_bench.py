"""Host storage-path benchmark stage (port of
``ceph_tpu/osd/storage_bench.py``).

Drives the real ECUtil write cycle on HOST data -- assemble (pad the
logical payload), transpose (logical -> shard-major), encode (codec
dispatch), commit (per-shard bytes + cumulative crc32c into a store) --
with N concurrent asyncio writers, in two modes:

* ``coalesce=False``: one synchronous codec dispatch per op (the
  pre-round-6 ECBackend behavior);
* ``coalesce=True``: concurrent ops gather into batched dispatches
  through ``ceph_tpu_torch.osd.coalescer.BatchCoalescer`` + the plugin's
  ``encode_shard_major_batch`` pipeline (granule fusing, bounded depth).

A degraded-read cycle (drop shards -> signature-grouped batched decode ->
logical reassembly) is measured the same way.  With the ``cuda`` plugin
the codec runs on the card (``gf2_matrix_w8``, ``gf2_matrix_w16`` or
``gf2_packet`` by technique); everything else is host work, as in the
reference.  A dispatch runs synchronously on the event loop and waits for
its result to land on the host.

Bit-exactness is gated BEFORE timing: both modes run over identical
payloads into separate stores and every shard byte must match, and the
decode output must round-trip the payloads.  Per-stage times are
cumulative across ops (writers overlap, so stage sums can exceed the
wall time; the throughput numbers are wall-clock).

The steady-state gate differs from the reference's in one name.  The
reference raises on ``jit_retraces`` in the last timed cycle: a JAX
program is compiled once per shape, and a retrace there is setup work
leaking onto the hot path.  A CUDA library is built once per source, not
per shape, so the port counts library builds (``residency``'s
``library_builds``: a kernel library or the crc32c library built or first
loaded in the process) and raises on any in the last timed cycle.  The
result reports ``steady_library_builds`` where the reference reports
``steady_jit_retraces``.

Used by ``ceph_tpu_torch/tools/ec_benchmark.py --workload storage-path``
and ``chip_smoke.py``.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Optional

import numpy as np

from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.osd.coalescer import BatchCoalescer


def make_payloads(n_objects: int, obj_bytes: int, seed: int = 0
                  ) -> List[bytes]:
    rng = np.random.RandomState(seed)
    return [
        rng.randint(0, 256, size=obj_bytes, dtype=np.uint8).tobytes()
        for _ in range(n_objects)
    ]


class StoragePathHarness:
    """One codec + stripe geometry; runs timed write / degraded-read
    passes over a payload set."""

    def __init__(self, ec, erasures: int = 2):
        self.ec = ec
        self.k = ec.get_data_chunk_count()
        self.km = ec.get_chunk_count()
        self.m = self.km - self.k
        self.sinfo = ecutil.StripeInfo(self.k, self.k * ec.get_chunk_size(1))
        # fixed erasure signature: the first min(m, erasures) data shards
        # are dropped and rebuilt from the remaining data + parity
        self.erased = list(range(min(self.m, erasures)))

    # -- write cycle -------------------------------------------------------

    async def write_pass(self, payloads: List[bytes], *, coalesce: bool,
                         writers: int = 8,
                         stages: Optional[Dict[str, float]] = None,
                         ) -> Dict[str, bytes]:
        """Run every payload through assemble/transpose/encode/commit;
        returns the committed store {oid@shard: bytes}."""
        sinfo, k, km = self.sinfo, self.k, self.km
        ec = self.ec
        coal = None
        if coalesce:
            coal = BatchCoalescer(
                lambda blocks: ecutil.encode_shard_major_many(
                    ec, blocks, range(km)
                )
            )
        store: Dict[str, bytes] = {}
        queue = list(enumerate(payloads))
        stage = stages if stages is not None else {}
        for name in ("assemble", "transpose", "encode", "commit"):
            stage.setdefault(name, 0.0)

        async def writer():
            while queue:
                idx, data = queue.pop()
                t0 = time.perf_counter()
                padded = sinfo.logical_to_next_stripe_offset(len(data))
                buf = np.zeros(padded, dtype=np.uint8)
                buf[: len(data)] = np.frombuffer(data, dtype=np.uint8)
                t1 = time.perf_counter()
                sm = ecutil.to_shard_major(sinfo, k, buf)
                t2 = time.perf_counter()
                if coal is not None:
                    enc = await coal.submit(sm, sm.nbytes)
                else:
                    enc = ecutil.encode_shard_major_many(
                        ec, [sm], range(km)
                    )[0]
                t3 = time.perf_counter()
                hinfo = ecutil.HashInfo(km)
                hinfo.append(0, enc)
                for s in range(km):
                    store[f"obj{idx}@{s}"] = enc[s].tobytes()
                t4 = time.perf_counter()
                stage["assemble"] += t1 - t0
                stage["transpose"] += t2 - t1
                stage["encode"] += t3 - t2
                stage["commit"] += t4 - t3

        await asyncio.gather(*(writer() for _ in range(max(1, writers))))
        return store

    # -- degraded-read cycle -----------------------------------------------

    async def read_pass(self, store: Dict[str, bytes], n_objects: int,
                        sizes: List[int], *, coalesce: bool,
                        readers: int = 8,
                        stages: Optional[Dict[str, float]] = None,
                        ) -> List[bytes]:
        """Degraded read of every object: the ``self.erased`` shards are
        withheld, the rest decode (one fused dispatch per erasure
        signature when coalesced)."""
        sinfo, km = self.sinfo, self.km
        ec = self.ec
        coal = None
        if coalesce:
            coal = BatchCoalescer(
                lambda maps: ecutil.decode_concat_many(sinfo, ec, maps)
            )
        out: List[Optional[bytes]] = [None] * n_objects
        queue = list(range(n_objects))
        stage = stages if stages is not None else {}
        stage.setdefault("decode", 0.0)

        async def reader():
            while queue:
                idx = queue.pop()
                chunks = {
                    s: np.frombuffer(store[f"obj{idx}@{s}"], dtype=np.uint8)
                    for s in range(km)
                    if s not in self.erased
                }
                t0 = time.perf_counter()
                if coal is not None:
                    data = await coal.submit(
                        chunks, sum(c.nbytes for c in chunks.values())
                    )
                else:
                    data = ecutil.decode_concat(sinfo, ec, chunks)
                stage["decode"] += time.perf_counter() - t0
                out[idx] = bytes(data[: sizes[idx]])

        await asyncio.gather(*(reader() for _ in range(max(1, readers))))
        return out  # type: ignore[return-value]


def _ledger_snapshot() -> Dict[str, int]:
    """Process transfer/library-build/granule counters (the residency
    ledger plus the pipeline's fused-dispatch denominator)."""
    from ceph_tpu_torch.analysis import residency
    from ceph_tpu_torch.ops import pipeline

    snap = dict(residency.counters().snapshot())
    snap["granules"] = pipeline.granules_dispatched()
    return snap


def _ledger_delta(before: Dict[str, int],
                  after: Dict[str, int]) -> Dict[str, int]:
    d = {k: after[k] - before[k] for k in before}
    g = d.get("granules", 0)
    # the headline number: H2D ops per fused granule (<= 1 means the
    # packed upload is the ONLY bus crossing on the way in -- no matrix
    # re-uploads, no per-stripe transfers)
    d["h2d_per_granule"] = round(d["h2d_ops"] / g, 3) if g else None
    return d


async def _timed_cycle(h: StoragePathHarness, payloads: List[bytes], *,
                       coalesce: bool, writers: int) -> dict:
    stages: Dict[str, float] = {}
    nbytes = sum(len(p) for p in payloads)
    l0 = _ledger_snapshot()
    t0 = time.perf_counter()
    store = await h.write_pass(payloads, coalesce=coalesce,
                               writers=writers, stages=stages)
    write_s = time.perf_counter() - t0
    l1 = _ledger_snapshot()
    t0 = time.perf_counter()
    await h.read_pass(store, len(payloads), [len(p) for p in payloads],
                      coalesce=coalesce, readers=writers, stages=stages)
    read_s = time.perf_counter() - t0
    l2 = _ledger_snapshot()
    return {
        "write_GiBs": nbytes / write_s / (1 << 30),
        "read_GiBs": nbytes / read_s / (1 << 30),
        "wall_write_s": write_s,
        "wall_read_s": read_s,
        "stages_s": {k: round(v, 6) for k, v in stages.items()},
        # per-pass transfer ledger: h2d/d2h ops+bytes, library builds,
        # granules -- the residency proof for exactly this cycle
        "residency": {"write": _ledger_delta(l0, l1),
                      "read": _ledger_delta(l1, l2)},
    }


async def _bit_exactness_gate(h: StoragePathHarness,
                              payloads: List[bytes], writers: int) -> None:
    """Coalesced and per-op paths must produce byte-identical shards and
    round-trip the payloads -- gated before any timing."""
    seq = await h.write_pass(payloads, coalesce=False, writers=writers)
    coa = await h.write_pass(payloads, coalesce=True, writers=writers)
    if set(seq) != set(coa):
        raise AssertionError("storage-path: shard sets differ")
    for soid in seq:
        if seq[soid] != coa[soid]:
            raise AssertionError(f"storage-path: shard {soid} differs "
                                 f"between coalesced and per-op encode")
    sizes = [len(p) for p in payloads]
    got = await h.read_pass(coa, len(payloads), sizes, coalesce=True,
                            readers=writers)
    for idx, (data, payload) in enumerate(zip(got, payloads)):
        if data != payload:
            raise AssertionError(
                f"storage-path: degraded decode of obj{idx} mismatched"
            )


def run_storage_path_bench(ec, *, n_objects: int = 64,
                           obj_bytes: int = 1 << 16, writers: int = 8,
                           iters: int = 2, seed: int = 1234,
                           erasures: int = 2) -> dict:
    """Full comparison: bit-exactness gate, then timed per-op vs
    coalesced cycles (best of ``iters``); returns the JSON-ready dict."""
    h = StoragePathHarness(ec, erasures=erasures)
    payloads = make_payloads(n_objects, obj_bytes, seed)
    loop = asyncio.new_event_loop()
    steady_builds: Dict[str, int] = {}
    try:
        loop.run_until_complete(_bit_exactness_gate(h, payloads, writers))
        best: Dict[str, dict] = {}
        for mode, coalesce in (("per_op", False), ("coalesced", True)):
            # one untimed warm pass per mode: library builds / matrix
            # upload happen outside the timed region (bench honesty
            # rule #1)
            loop.run_until_complete(_timed_cycle(
                h, payloads, coalesce=coalesce, writers=writers))
            last = None
            for _ in range(max(1, iters)):
                r = loop.run_until_complete(_timed_cycle(
                    h, payloads, coalesce=coalesce, writers=writers))
                last = r
                if mode not in best or r["write_GiBs"] > \
                        best[mode]["write_GiBs"]:
                    best[mode] = r
            # the steady-state setup gate: by the LAST timed cycle every
            # kernel library has been built and loaded -- a build here
            # is setup work leaking onto the hot path, and the stage must
            # FAIL, not shrug
            res = last["residency"]
            steady = (res["write"]["library_builds"] +
                      res["read"]["library_builds"])
            steady_builds[mode] = steady
            # steady-state ledger beats best-throughput ledger: report
            # the last cycle's residency with the best cycle's timing
            best[mode] = dict(best[mode], residency=res)
            if steady:
                raise AssertionError(
                    f"storage-path: {steady} steady-state library "
                    f"build(s) in mode {mode} -- setup work on the hot "
                    f"path")
    finally:
        loop.close()
    per_op, coalesced = best["per_op"], best["coalesced"]
    return {
        "n_objects": n_objects,
        "obj_bytes": obj_bytes,
        "writers": writers,
        "k": h.k,
        "m": h.m,
        "erasures": len(h.erased),
        "bit_exact": True,  # the gate raised otherwise
        "steady_library_builds": steady_builds,  # gated == 0
        "per_op": per_op,
        "coalesced": coalesced,
        "write_speedup": round(
            coalesced["write_GiBs"] / per_op["write_GiBs"], 3
        ) if per_op["write_GiBs"] else None,
        "read_speedup": round(
            coalesced["read_GiBs"] / per_op["read_GiBs"], 3
        ) if per_op["read_GiBs"] else None,
    }
