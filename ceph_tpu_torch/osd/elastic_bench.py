"""Elastic-membership benchmark stage (bench.py ``elastic_path``).

Port of ``ceph_tpu/osd/elastic_bench.py``: the same stages, gates and
result, on the ``cuda`` plugin (the JAX package's profile names
``jerasure``, on the host); ``profile=dict(PROFILE, device="cpu")`` runs
it on the CPU.  Before anything is timed the pool's codec encodes and
decodes one stripe, so the kernel library is built before the cycle;
the result adds ``steady_library_builds``, the libraries built or first
loaded after that warm-up (0 when nothing on the timed path builds).

Online expansion and contraction end-to-end, under concurrent client
load, with every step of the control plane live: ``osd add`` / ``osd
rm`` / ``osd out`` are mon commands that commit paxos osdmap
incrementals whose broadcasts drive CRUSH growth through
``apply_map_view``'s epoch gate -- data only moves once the committed
map says so.

The measured sequence is a +2-OSD expansion: the movement set (the
diff of the pg->acting snapshots around the map change) must stay
within ``moved_ratio_bound`` of the theoretical minimum for the weight
change (straw2's minimal-movement contract), the misplaced census must
peak at map-commit time and drain monotonically (at most
``uptick_bound`` transient upticks -- primary-handoff double counts),
and the cluster must reach HEALTH_OK on a fresh mgr fold with every
object reading back bit-exact.

Three chaos stages then gate the same convergence contract under
churn:

* ``target_kill`` -- a freshly added backfill TARGET dies
  mid-migration; the mon outs it, movement re-plans, and an
  exactly-once write audit must stay exact (no lost or phantom acks).
* ``primary_rm`` -- ``osd rm`` of a LIVE primary under client load:
  graceful drain, zero client-visible errors, the daemon retires only
  after its PGs hand off.
* ``flap`` -- add-then-immediately-rm before any backfill ran: the
  epoch gate resolves the race and no misplaced residue sticks.

Used by ``ceph_tpu_torch/tools/ec_benchmark.py --workload
elastic-path`` and ``chip_smoke.py`` phase 3i; tests/test_torch_elastic.py
runs the smoke shape in both packages.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Optional

import numpy as np

#: k=2/m=1 at 10 OSDs / 128 PGs: a shape whose measured pg-level
#: movement ratio for a +2 expansion sits comfortably under the 1.25x
#: gate (EC positions re-draw independently, so per-position movement
#: compounds above the per-draw straw2 minimum on small clusters)
PROFILE = {"k": "2", "m": "1", "plugin": "cuda"}
N_OSDS = 10


def _pct(samples: List[float], q: float) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(len(s) - 1, int(q * len(s)))]


def _upticks(timeline: List[int]) -> int:
    """Transient increases after the census peak -- the monotone-drain
    gate tolerates a couple (primary handoff re-marks an object on the
    new primary one pass before the old primary's entry drains)."""
    if not timeline:
        return 0
    peak_at = timeline.index(max(timeline))
    return sum(
        1 for i in range(peak_at + 1, len(timeline))
        if timeline[i] > timeline[i - 1]
    )


class _Harness:
    """One booted mon-backed cluster + client load + mgr fold loop."""

    def __init__(self, cluster, payload_bytes: int):
        from ceph_tpu_torch.mgr.pgmap import PGMap

        self.cluster = cluster
        self.payload_bytes = payload_bytes
        self.pgmap = PGMap(expected=[o.name for o in cluster.osds])
        self._seq = 0
        self.read_lat: List[float] = []
        self.client_errors: List[str] = []
        #: exactly-once audit ledger: oid -> last ACKED payload
        self.acked: Dict[str, bytes] = {}
        self._stop = asyncio.Event()
        self._tasks: List[asyncio.Task] = []

    # -- mgr fold ----------------------------------------------------------

    def fold_reports(self) -> None:
        """Fold a fresh MgrReport from every live daemon (the in-process
        stand-in for the daemons' report ticks)."""
        from ceph_tpu_torch.mgr.report import MgrReport

        self._seq += 1
        for osd in self.cluster.osds:
            if self.cluster.messenger.is_down(osd.name):
                continue
            if osd.name not in self.pgmap.expected:
                continue  # retired daemon: no longer part of the map
            self.pgmap.apply(MgrReport(
                osd.name, self._seq, 1.0, osd.mgr_report_stats(),
                lag_ms=0.0,
            ))

    def forget_daemon(self, name: str) -> None:
        """Drop a RETIRED daemon from the mgr view (the reference purges
        rm'd osds from the osdmap; a stale entry would read as OSD_DOWN
        forever)."""
        self.pgmap.expected.discard(name)
        self.pgmap.daemons.pop(name, None)
        for by_daemon in self.pgmap.pgs.values():
            by_daemon.pop(name, None)

    def health_status(self) -> str:
        self.fold_reports()
        return self.pgmap.health()["status"]

    # -- ground truth ------------------------------------------------------

    def misplaced_total(self) -> int:
        return sum(
            len(b.pg_stats.misplaced)
            for osd in self.cluster.osds
            for b in osd.pools.values()
        )

    def backfill_bytes(self) -> int:
        return sum(
            osd.perf.snapshot().get("recovery_backfill_bytes", 0)
            for osd in self.cluster.osds
        )

    # -- client load -------------------------------------------------------

    def start_load(self, hot: List[str], payloads: Dict[str, bytes],
                   n_clients: int, writer_oids: List[str]) -> None:
        cluster = self.cluster

        async def reader(idx: int):
            i = idx
            while not self._stop.is_set():
                oid = hot[i % len(hot)]
                t0 = time.perf_counter()
                try:
                    got = await cluster.read(oid)
                    if got != payloads[oid]:
                        self.client_errors.append(f"read {oid}: mismatch")
                except Exception as exc:  # noqa: BLE001
                    self.client_errors.append(f"read {oid}: {exc}")
                self.read_lat.append(time.perf_counter() - t0)
                i += n_clients
                await asyncio.sleep(0)

        async def writer():
            rng = np.random.RandomState(4242)
            i = 0
            while not self._stop.is_set():
                oid = writer_oids[i % len(writer_oids)]
                data = rng.randint(
                    0, 256, size=self.payload_bytes, dtype=np.uint8
                ).tobytes()
                try:
                    await cluster.write(oid, data)
                    # the ack ledger records only COMMITTED payloads:
                    # after any chaos, each oid must read back as
                    # exactly its last acked write (exactly-once audit)
                    self.acked[oid] = data
                except Exception as exc:  # noqa: BLE001
                    self.client_errors.append(f"write {oid}: {exc}")
                i += 1
                await asyncio.sleep(0)

        loop = asyncio.get_event_loop()
        self._tasks = [
            loop.create_task(reader(i)) for i in range(n_clients)
        ]
        if writer_oids:
            self._tasks.append(loop.create_task(writer()))

    async def stop_load(self) -> None:
        self._stop.set()
        for t in self._tasks:
            await t
        self._tasks = []

    # -- convergence -------------------------------------------------------

    async def converge(self, max_rounds: int = 40,
                       mid_round_hook=None) -> Dict:
        """Drive peering to clean: rounds of per-engine passes until two
        consecutive rounds report zero actions AND zero misplaced.  The
        misplaced timeline is sampled after every engine pass (plus the
        census value going in) for the monotone-drain gate.

        ``mid_round_hook()`` fires after each engine pass until it
        returns True -- the chaos stages use it to kill a backfill
        target literally mid-migration (it watches the moved-bytes
        counter, since the batched recovery lane absorbs its actions
        and reports them through counters, not the pass return)."""
        cluster = self.cluster
        timeline = [self.misplaced_total()]
        zero = 0
        rounds = 0
        while rounds < max_rounds:
            n = 0
            for osd in list(cluster.osds):
                if cluster.messenger.is_down(osd.name):
                    continue
                for backend in osd.pools.values():
                    n += await backend.peering_pass()
                timeline.append(self.misplaced_total())
                if mid_round_hook is not None and mid_round_hook():
                    mid_round_hook = None  # fired: re-census sample
                    timeline.append(self.misplaced_total())
            rounds += 1
            if n == 0 and timeline[-1] == 0:
                zero += 1
                if zero >= 2:
                    break
            else:
                zero = 0
        return {
            "rounds": rounds,
            "timeline": timeline,
            "peak": max(timeline),
            "upticks": _upticks(timeline),
            "final": timeline[-1],
        }


def _gate(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(f"elastic-path: {msg}")


def warm_codec(ec, nbytes: int = 4096) -> None:
    """One encode and one decode (the first data chunk erased) through
    ``ec`` and one crc32c, so its kernel library and the crc library are
    built or loaded before a timed stage: a build takes seconds and would
    land in a client's latency."""
    from ceph_tpu_torch.native.gf_native import crc32c

    crc32c(b"warm")
    km = ec.get_chunk_count()
    data = np.arange(nbytes, dtype=np.uint32).astype(np.uint8).tobytes()
    chunks = ec.encode(set(range(km)), data)
    lost = ec.chunk_index(0)
    ec.decode({lost}, {i: c for i, c in chunks.items() if i != lost})


async def _run(*, n_objects: int, obj_bytes: int, n_hot: int,
               n_clients: int, moved_ratio_bound: float,
               uptick_bound: int, client_p99_bound_ms: float,
               seed: int, profile: Dict[str, str] = PROFILE) -> Dict:
    from ceph_tpu_torch.analysis import residency
    from ceph_tpu_torch.native import gf_native
    from ceph_tpu_torch.osd.cluster import ECCluster
    from ceph_tpu_torch.osd.placement import theoretical_min_moved
    from ceph_tpu_torch.utils.perf import PerfCounters

    PerfCounters.reset_all()
    rng = np.random.RandomState(seed)

    def payload() -> bytes:
        return rng.randint(0, 256, size=obj_bytes, dtype=np.uint8).tobytes()

    cluster = await ECCluster.create_with_mons(
        N_OSDS, dict(profile), pool="elastic",
    )
    h: Optional[_Harness] = None
    try:
        warm_codec(cluster.ec)
        gf_native.crc32c(b"warm")
        builds_mark = residency.counters().snapshot()["library_builds"]
        km = cluster.backend.km
        payloads: Dict[str, bytes] = {}
        cold = [f"eo{i}" for i in range(n_objects)]
        hot = [f"hot{i}" for i in range(n_hot)]
        for oid in cold + hot:
            payloads[oid] = payload()
            await cluster.write(oid, payloads[oid])
        shard_bytes = cluster.primary_backend(
            cold[0]
        )._shard_bytes_total(obj_bytes)

        h = _Harness(cluster, obj_bytes)
        writer_oids = [f"cw{i}" for i in range(4)]
        h.start_load(hot, payloads, n_clients, writer_oids)

        async def wait_weight(osd_id: int, nonzero: bool) -> None:
            for _ in range(200):
                w = (cluster.placement.weights[osd_id]
                     if osd_id < len(cluster.placement.weights) else 0)
                if bool(w) == nonzero:
                    return
                await asyncio.sleep(0.02)
            raise AssertionError(
                f"elastic-path: broadcast for osd.{osd_id} never applied")

        # ---- stage 1: measured +2 expansion under load ------------------
        weights_before = list(cluster.placement.weights)
        n_pre_objects = len(payloads)  # all writes before the map change
        new_ids = []
        for _ in range(2):
            osd_id = cluster.add_osd(update_placement=False)
            h.pgmap.expected.add(f"osd.{osd_id}")
            new_ids.append(osd_id)
            rc, out = await cluster.mon_command(
                {"prefix": "osd add", "osd": osd_id})
            _gate(rc == 0, f"osd add {osd_id} failed: {out}")
        for osd_id in new_ids:
            await wait_weight(osd_id, True)
        weights_after = list(cluster.placement.weights)

        t0 = time.perf_counter()
        lat_mark = len(h.read_lat)
        expansion = await h.converge()
        time_to_clean = time.perf_counter() - t0
        expansion_lat = h.read_lat[lat_mark:]

        moved_bytes = h.backfill_bytes()
        min_bytes = theoretical_min_moved(
            weights_before, weights_after, n_pre_objects * km,
        ) * shard_bytes
        ratio = moved_bytes / max(min_bytes, 1.0)
        _gate(expansion["peak"] > 0,
              "expansion produced no misplaced peak (census regressed)")
        _gate(expansion["final"] == 0,
              f"misplaced residue after expansion: {expansion['final']}")
        _gate(expansion["upticks"] <= uptick_bound,
              f"misplaced drained non-monotonically "
              f"({expansion['upticks']} upticks > {uptick_bound}): "
              f"{expansion['timeline']}")
        _gate(moved_bytes > 0, "expansion moved no bytes")
        _gate(ratio <= moved_ratio_bound,
              f"expansion moved {ratio:.3f}x the theoretical minimum "
              f"(bound {moved_ratio_bound}x): {moved_bytes}B vs "
              f"{min_bytes:.0f}B")
        _gate(h.health_status() == "HEALTH_OK",
              f"not HEALTH_OK after expansion: {h.pgmap.health()}")
        p99_ms = _pct(expansion_lat, 0.99) * 1e3
        _gate(p99_ms <= client_p99_bound_ms,
              f"client p99 {p99_ms:.1f}ms breached the "
              f"{client_p99_bound_ms}ms bound during expansion")

        # ---- stage 2: chaos -- kill the backfill target mid-migration ---
        target = cluster.add_osd(update_placement=False)
        h.pgmap.expected.add(f"osd.{target}")
        rc, out = await cluster.mon_command(
            {"prefix": "osd add", "osd": target})
        _gate(rc == 0, f"osd add {target} failed: {out}")
        await wait_weight(target, True)
        killed = {}
        bytes_mark = h.backfill_bytes()

        def kill_target() -> bool:
            moved = h.backfill_bytes() - bytes_mark
            if moved <= 0:
                return False
            # migration toward the new target is in flight RIGHT NOW
            cluster.kill_osd(target)
            killed["at_bytes"] = moved
            return True

        # bounded: with the target dead its objects cannot finish --
        # convergence is gated AFTER the mon outs it and movement
        # re-plans
        chaos_a = await h.converge(max_rounds=2,
                                   mid_round_hook=kill_target)
        # the mon outs the dead target: movement re-plans off it
        rc, out = await cluster.mon_command(
            {"prefix": "osd out", "osd": target})
        _gate(rc == 0, f"osd out {target} failed: {out}")
        await wait_weight(target, False)
        # back up but still OUT (weight 0): its engine rejoins peering
        # -- the forced backfill pass on the new epoch drains the stale
        # misplaced entries it accumulated as a primary before dying
        cluster.revive_osd(target)
        chaos_a2 = await h.converge()
        _gate(killed.get("at_bytes", 0) > 0,
              "target-kill chaos never caught a migration in flight")
        _gate(chaos_a2["final"] == 0,
              f"misplaced residue after target-kill re-plan: "
              f"{chaos_a2['final']}")
        _gate(chaos_a2["upticks"] <= uptick_bound,
              f"non-monotone drain after target-kill: "
              f"{chaos_a2['timeline']}")
        _gate(h.health_status() == "HEALTH_OK",
              f"not HEALTH_OK after target-kill: {h.pgmap.health()}")

        # ---- stage 3: chaos -- osd rm of a live primary under load ------
        victim = cluster.placement.acting(hot[0])[0]
        _gate(victim is not None, "hot primary unmapped")
        rc, out = await cluster.mon_command(
            {"prefix": "osd rm", "osd": victim})
        _gate(rc == 0, f"osd rm {victim} failed: {out}")
        await wait_weight(victim, False)
        chaos_b = await h.converge()
        _gate(chaos_b["peak"] > 0,
              "primary-rm produced no misplaced peak")
        _gate(chaos_b["final"] == 0,
              f"misplaced residue after primary rm: {chaos_b['final']}")
        _gate(chaos_b["upticks"] <= uptick_bound,
              f"non-monotone drain after primary rm: "
              f"{chaos_b['timeline']}")
        # drained clean: NOW the daemon may retire (graceful contraction)
        cluster.retire_osd(victim)
        h.forget_daemon(f"osd.{victim}")
        _gate(h.health_status() == "HEALTH_OK",
              f"not HEALTH_OK after primary rm: {h.pgmap.health()}")

        # ---- stage 4: chaos -- add-then-immediately-rm flap -------------
        flap = cluster.add_osd(update_placement=False)
        h.pgmap.expected.add(f"osd.{flap}")
        rc, out = await cluster.mon_command(
            {"prefix": "osd add", "osd": flap})
        _gate(rc == 0, f"osd add {flap} failed: {out}")
        rc, out = await cluster.mon_command(
            {"prefix": "osd rm", "osd": flap})
        _gate(rc == 0, f"osd rm {flap} failed: {out}")
        # both broadcasts (add epoch, then rm epoch) must land before
        # the residue check means anything; the epoch gate orders them
        await asyncio.sleep(0.3)
        await wait_weight(flap, False)
        chaos_c = await h.converge()
        _gate(chaos_c["final"] == 0,
              f"flap left stuck misplaced residue: {chaos_c['timeline']}")
        _gate(h.health_status() == "HEALTH_OK",
              f"not HEALTH_OK after flap: {h.pgmap.health()}")

        # ---- final audits -----------------------------------------------
        await h.stop_load()
        _gate(not h.client_errors,
              f"{len(h.client_errors)} client-visible errors: "
              f"{h.client_errors[:5]}")
        for oid, data in payloads.items():
            got = await cluster.read(oid)
            _gate(got == data, f"{oid} not bit-exact after the run")
        # exactly-once: every acked write reads back as its LAST ack
        for oid, data in h.acked.items():
            got = await cluster.read(oid)
            _gate(got == data,
                  f"exactly-once audit: {oid} diverged from last ack")

        steady_builds = (residency.counters().snapshot()["library_builds"]
                         - builds_mark)
        return {
            "n_osds": N_OSDS,
            "n_objects": n_objects,
            "obj_bytes": obj_bytes,
            "n_clients": n_clients,
            "data_moved_ratio": round(ratio, 4),
            "data_moved_bytes": moved_bytes,
            "theoretical_min_bytes": round(min_bytes),
            "time_to_clean_s": round(time_to_clean, 4),
            "client_p99_during_expansion_ms": round(p99_ms, 3),
            "client_ops_total": len(h.read_lat),
            "misplaced_peak": expansion["peak"],
            "misplaced_upticks": expansion["upticks"],
            "expansion_rounds": expansion["rounds"],
            "audited_writes": len(h.acked),
            "bit_exact": True,  # the gates raised otherwise
            "steady_library_builds": steady_builds,
            "chaos": {
                "target_kill": {
                    "killed_mid_migration": True,
                    "rounds": chaos_a["rounds"] + chaos_a2["rounds"],
                    "upticks": chaos_a2["upticks"],
                },
                "primary_rm": {
                    "victim": victim,
                    "rounds": chaos_b["rounds"],
                    "peak": chaos_b["peak"],
                    "upticks": chaos_b["upticks"],
                },
                "flap": {
                    "rounds": chaos_c["rounds"],
                    "residue": chaos_c["final"],
                },
            },
        }
    finally:
        if h is not None:
            await h.stop_load()
        await cluster.shutdown()


def run_elastic_path_bench(*, smoke: bool = False,
                           moved_ratio_bound: float = 1.25,
                           uptick_bound: int = 2,
                           client_p99_bound_ms: float = 2000.0,
                           seed: int = 99,
                           profile: Dict[str, str] = PROFILE) -> Dict:
    """Boot, expand, contract, converge; returns the metric dict or
    raises AssertionError on any gate.  ``smoke`` shrinks object count,
    size and client fan-out for the tier-1 run -- same topology, same
    code paths, same gates."""
    kwargs = dict(
        n_objects=24 if smoke else 72,
        obj_bytes=(4 << 10) if smoke else (12 << 10),
        n_hot=8 if smoke else 16,
        n_clients=8 if smoke else 24,
        moved_ratio_bound=moved_ratio_bound,
        uptick_bound=uptick_bound,
        client_p99_bound_ms=client_p99_bound_ms,
        seed=seed,
        profile=profile,
    )
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(_run(**kwargs))
    finally:
        loop.close()
