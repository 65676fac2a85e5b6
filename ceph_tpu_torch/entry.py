"""Entry points: the flagship encode and a multi-device dry run (port of
``__graft_entry__.py``).

* :func:`entry` returns the flagship forward step -- ``gf2_matrix_w8``
  (k=8, m=4 reed_sol_van, GF(2^8) through nibble tables) -- and its
  arguments on the card.
* :func:`dryrun_multichip` builds an n-slot (data, shard, sub) grid over
  ``parallel.local_devices()``, runs the FULL EC step on it (encode ->
  parity scrub -> degraded-read reconstruct, the write, deep-scrub and
  recovery roles of the reference's ECBackend) on tiny shapes, then the
  mesh data plane's stage and, unless ``fast``, a ``mesh_shard`` storage
  cycle and a replicated pool's cycle.

Run it as ``python -m ceph_tpu_torch.entry [N] [--fast] [--device
cpu|cuda]``: N slots (default: every card) over the cards in turn, a
card repeating when the process sees fewer than N (one stream per slot;
see ``parallel/__init__.py``); ``--device cpu`` runs N CPU slots.
"""

from __future__ import annotations

import argparse
import asyncio
import sys
import time

import numpy as np
import torch


def entry(device="cuda"):
    from ceph_tpu_torch.device import resolve_device
    from ceph_tpu_torch.matrices import reed_sol
    from ceph_tpu_torch.matrices.bitmatrix import matrix_to_bitmatrix
    from ceph_tpu_torch.ops import cuda_gf

    dev = resolve_device(device)
    k, m, w = 8, 4, 8
    M = reed_sol.vandermonde_coding_matrix(k, m, w)
    tables = torch.from_numpy(
        cuda_gf.prep_matrix_w8(matrix_to_bitmatrix(M, w), k)).to(dev)
    rng = np.random.RandomState(0)
    words = torch.from_numpy(
        rng.randint(0, 256, size=(k, 64 * 1024)).astype(np.uint8)).to(dev)

    def fn(tables, words):
        lanes = words.view(torch.int32)
        return cuda_gf.matrix_encode_w8(tables, lanes, k, m).view(
            torch.uint8)

    return fn, (tables, words)


def _mesh_factors(n: int) -> tuple[int, int, int]:
    """Split n devices into (data, shard, sub); shard must divide k=8."""
    shard = 1
    for cand in (4, 2):
        if n % cand == 0:
            shard = cand
            break
    rest = n // shard
    sub = 2 if rest % 2 == 0 else 1
    data = rest // sub
    assert data * shard * sub == n
    return data, shard, sub


def _device_type() -> str:
    from ceph_tpu_torch import parallel

    return parallel.local_devices()[0].type


def _mesh_plane_stage(n_devices: int) -> str:
    """Mesh-scaling stage: the OSD mesh data plane's PG-sliced encode
    swept over mesh sizes, bit-exactness gated at every size, steady
    state gated at ZERO library builds and placement builds, plus one
    in-process cluster cycle proving in-collective delivery moves chunk
    bytes off the wire.  Returns the summary fragment for the dry run's
    last line."""
    from ceph_tpu_torch.analysis import residency
    from ceph_tpu_torch.osd.cluster import ECCluster
    from ceph_tpu_torch.parallel import mesh_plane
    from ceph_tpu_torch.plugins import registry as registry_mod
    from ceph_tpu_torch.utils.config import get_config

    dev_type = _device_type()
    cfg = get_config()
    prior = bool(cfg.get_val("osd_mesh_data_plane"))
    cfg.set_val("osd_mesh_data_plane", True)
    k, m = 2, 2
    profile = {"technique": "reed_sol_van", "k": str(k), "m": str(m)}
    sizes = [n for n in (1, 2, 4, 8) if n <= n_devices]
    gibps = {}
    try:
        rng = np.random.RandomState(3)
        blocks = [rng.randint(0, 256, size=(k, 16384), dtype=np.uint8)
                  for _ in range(16)]
        oracle = registry_mod.instance().factory("jerasure", dict(profile))
        expect = [oracle.encode(set(range(k + m)), b.reshape(-1))
                  for b in blocks]
        for n in sizes:
            plane = mesh_plane.configure(n)
            ec = registry_mod.instance().factory(
                "cuda", dict(profile, device=dev_type))
            pgids = list(range(len(blocks)))
            plane.encode_shard_major_many(ec, blocks, pgids)  # warm
            before = residency.counters().snapshot()
            placements = plane.sharding_builds
            t0 = time.perf_counter()
            iters = 4
            for _ in range(iters):
                encs = plane.encode_shard_major_many(ec, blocks, pgids)
            dt = time.perf_counter() - t0
            after = residency.counters().snapshot()
            builds = after["library_builds"] - before["library_builds"]
            assert builds == 0, \
                f"mesh stage: {builds} steady library builds at n={n}"
            assert plane.sharding_builds == placements, \
                f"mesh stage: steady placement builds at n={n}"
            for enc, ref in zip(encs, expect):
                for c in range(k + m):
                    assert np.array_equal(enc[c], ref[c]), \
                        f"mesh stage: chunk {c} mismatch at n={n}"
            nbytes = iters * sum(b.nbytes for b in blocks)
            gibps[n] = round(nbytes / dt / (1 << 30), 3)

        # in-collective delivery proof: one in-process cluster cycle at
        # the full mesh -- chunk payloads to mesh-bound OSDs must ride
        # the board, and every read must round-trip bit-exactly
        plane = mesh_plane.configure(n_devices)
        payloads = {f"mp{i}": rng.bytes(12_000 + 71 * i) for i in range(4)}

        async def cycle():
            c = ECCluster(k + m, dict(profile, device=dev_type),
                          plugin="cuda")
            for oid, p in payloads.items():
                await c.write(oid, p)
            for oid, p in payloads.items():
                assert await c.read(oid) == p, f"mesh cycle read {oid}"
            await c.shutdown()

        asyncio.run(cycle())
        avoided = plane.counters["mesh_wire_bytes_avoided"]
        assert avoided > 0, "mesh cycle delivered nothing in-collective"
        assert plane.board.stats()["misses"] == 0
    finally:
        cfg.set_val("osd_mesh_data_plane", prior)
        mesh_plane.reset()
    return (f"mesh-plane stage ok: encode GiB/s by mesh size {gibps}, "
            f"wire bytes avoided {avoided}, 0 steady library builds")


def dryrun_multichip(n_devices: int, fast: bool = False) -> None:
    """The dry run over the first ``n_devices`` of
    ``parallel.local_devices()`` (``parallel.configure_devices`` names
    CPU slots, or one card several times)."""
    from ceph_tpu_torch import parallel
    from ceph_tpu_torch.matrices import reed_sol
    from ceph_tpu_torch.ops import cpu_engine
    from ceph_tpu_torch.ops.gf import gf
    from ceph_tpu_torch.osd.cluster import ECCluster
    from ceph_tpu_torch.parallel.distributed import (DistributedCodec,
                                                     make_mesh)

    devices = parallel.local_devices()
    if len(devices) < n_devices:
        raise RuntimeError(
            f"dryrun_multichip needs {n_devices} devices, have "
            f"{len(devices)}"
        )
    dev_type = devices[0].type

    k, m, w = 8, 4, 8
    F = gf(w)
    n_data, n_shard, n_sub = _mesh_factors(n_devices)
    mesh = make_mesh(n_data=n_data, n_shard=n_shard, n_sub=n_sub,
                     devices=devices)
    M = reed_sol.vandermonde_coding_matrix(k, m, w)
    codec = DistributedCodec(M, w, mesh)

    batch = 2 * max(1, n_data)
    n = 128 * max(1, n_sub)
    rng = np.random.RandomState(0)
    data = rng.randint(0, 256, size=(batch, k, n)).astype(np.uint8)

    # decode rows for a 2-erasure degraded read (host-side matrix prep)
    erased = [1, 6]
    sel = [i for i in range(k + m) if i not in erased][:k]
    A = np.zeros((k, k), dtype=np.uint32)
    for r, cid in enumerate(sel):
        if cid < k:
            A[r, cid] = 1
        else:
            A[r, :] = M[cid - k, :]
    rows = F.mat_invert(A)[erased, :]

    parity = codec.encode(data)                         # write path
    ok = codec.verify(data, parity).all()               # deep scrub
    stripe = np.concatenate([data, parity], axis=1)
    survivors = stripe[:, sel, :]                       # degraded read
    rec = codec.reconstruct(rows, survivors)            # recovery decode

    # cross-check one stripe against the CPU oracle
    expect = cpu_engine.matrix_encode(M, data[0], w)
    assert np.array_equal(parity[0], expect), "parity mismatch"
    assert bool(ok), "scrub failed"
    assert np.array_equal(rec[0, 0], data[0, erased[0]])
    assert np.array_equal(rec[0, 1], data[0, erased[1]])

    # -- the OSD mesh data plane: PG-sliced encode scaling + in-collective
    # delivery, correctness and steady-state gated
    mesh_line = _mesh_plane_stage(n_devices)

    if fast:
        # smoke mode: the grid checks and the mesh-plane stage (with its
        # steady-state gate) already ran; the storage/replicated cluster
        # cycles are the slow half
        print(
            f"dryrun_multichip ok (fast): mesh(data={n_data}, "
            f"shard={n_shard}, sub={n_sub}), batch={batch}, n={n}; "
            f"{mesh_line}"
        )
        return

    # -- the same grid through the STORAGE engine: a pool whose profile
    # splits the codec over the grid, driven through write -> kill ->
    # degraded read -> revive -> background recovery.
    sk = n_shard if 4 % n_shard == 0 else 1  # pool k=4 must split evenly

    async def storage_cycle():
        c = ECCluster(
            8,
            {"technique": "reed_sol_van", "k": "4", "m": "2",
             "mesh_shard": str(sk), "mesh_sub": str(n_sub),
             "device": dev_type},
            plugin="cuda",
        )
        payloads = {f"obj{i}": rng.bytes(16_000 + 97 * i) for i in range(3)}
        for oid, p in payloads.items():
            await c.write(oid, p)
        victim = c.backend.acting_set("obj0")[0]
        c.kill_osd(victim)
        # writes DURING degradation: the victim's shards go stale, so the
        # recovery phase below has real work to do
        for oid in payloads:
            payloads[oid] = rng.bytes(18_000)
            await c.write(oid, payloads[oid])
        for oid, p in payloads.items():
            assert await c.read(oid) == p, "degraded read mismatch"
        c.revive_osd(victim)
        c.start_auto_recovery(interval=0.05)
        assert await c.degraded_report(), "expected stale shards to recover"
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 30.0
        while await c.degraded_report():
            if loop.time() > deadline:
                raise AssertionError("recovery never converged")
            await asyncio.sleep(0.1)
        for oid, p in payloads.items():
            assert await c.read(oid) == p, "post-recovery read mismatch"
        await c.shutdown()

    asyncio.run(storage_cycle())

    # -- a co-hosted REPLICATED pool on the same daemons (the
    # TYPE_REPLICATED seam)
    async def replicated_cycle():
        c = ECCluster(8, {"size": "3"}, pool_type="replicated")
        await c.write("robj", b"replicated dryrun " * 100)
        victim = c.backend.acting_set("robj")[0]
        c.kill_osd(victim)
        await c.write("robj", b"degraded write " * 100)
        assert await c.read("robj") == b"degraded write " * 100
        c.revive_osd(victim)
        await c.primary_backend("robj").peering_pass(backfill=True)
        assert await c.degraded_report() == []
        await c.shutdown()

    asyncio.run(replicated_cycle())

    print(
        f"dryrun_multichip ok: mesh(data={n_data}, shard={n_shard}, "
        f"sub={n_sub}), batch={batch}, n={n}; storage cycle "
        f"(write/degraded-read/auto-recover) ok on mesh_shard={sk}; "
        "replicated-pool cycle (write/kill/degraded/revive/peer) ok; "
        f"{mesh_line}"
    )


def main(argv=None) -> int:
    from ceph_tpu_torch import parallel

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_devices", type=int, nargs="?", default=0,
                   help="slots (default: every card; 4 on the CPU)")
    p.add_argument("--fast", action="store_true",
                   help="skip the storage and replicated cluster cycles")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.device == "cpu":
        n = args.n_devices or 4
        devices = [torch.device("cpu")] * n
    else:
        if not torch.cuda.is_available():
            print("entry: CUDA is not available (--device cpu runs CPU "
                  "slots)", file=sys.stderr)
            return 2
        cards = torch.cuda.device_count()
        n = args.n_devices or cards
        devices = [torch.device("cuda", i % cards) for i in range(n)]
    parallel.configure_devices(devices)
    print(f"entry: {n} slots on {', '.join(str(d) for d in devices)}",
          flush=True)
    if args.device == "cuda":
        fn, fargs = entry()
        out = fn(*fargs)
        torch.cuda.synchronize()
        print(f"entry: flagship encode -> parity {tuple(out.shape)} "
              f"{out.dtype} on {out.device}", flush=True)
    dryrun_multichip(n, fast=args.fast)
    return 0


if __name__ == "__main__":
    sys.exit(main())
