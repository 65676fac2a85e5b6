"""The host layers under the port's EC cluster against the JAX package's.

CRUSH (``crush/``, ``osd/placement.py``): the port's ``CrushPlacement``
acting set of PG x (its ``do_rule`` of x) is the JAX package's
``do_rule`` mapping of x, on flat maps of 8, 12 and 16 OSDs at k+m 6 and
12, and on a host hierarchy.  Both packages' CRUSH is Python at 2-9 ms a
mapping on the CPU (140 ms at k+m 12 on 8 OSDs, where every mapping has
holes and spends the erasure rule's 100 tries), so x runs over all of
[0, 4096) at 16 OSDs k+m 6 (the cluster path's shape class), over every
16th x of [0, 4096) in the other cases, and over the first 16 x at k+m 12
on 8 OSDs.  The PG log,
hit sets, extent cache, PG stats, op tracker, the wpq and mClock queues
and the QoS admission each run one script of calls in both packages and
must end in the same observations; the config subset matches the JAX
package's schema.
"""

import asyncio
import json
import time

import pytest

from ceph_tpu import crush as j_crush
from ceph_tpu.crush import map as j_crush_map
from ceph_tpu.osd import extent_cache as j_extent_cache
from ceph_tpu.osd import hitset as j_hitset
from ceph_tpu.osd import opqueue as j_opqueue
from ceph_tpu.osd import pg_stats as j_pg_stats
from ceph_tpu.osd import pglog as j_pglog
from ceph_tpu.osd import placement as j_placement
from ceph_tpu.osd import qos as j_qos
from ceph_tpu.osd import types as j_types
from ceph_tpu.osd.memstore import MemStore as JMemStore
from ceph_tpu.utils import config as j_config
from ceph_tpu.utils import lockdep as j_lockdep
from ceph_tpu.utils import optracker as j_optracker
from ceph_tpu_torch import crush
from ceph_tpu_torch.crush import map as crush_map
from ceph_tpu_torch.osd import (extent_cache, hitset, opqueue, pg_stats,
                                pglog, placement, qos, types)
from ceph_tpu_torch.osd.memstore import MemStore
from ceph_tpu_torch.utils import config, lockdep, optracker
from torch_verify import port_verifiers

X = range(4096)


@pytest.fixture(autouse=True)
def _loop_policy():
    """Both packages' loops run under the port's verifiers
    (``tests/torch_verify.py``): its atomic-section verifier, which holds
    both packages' sections, and its residency verifier."""
    with port_verifiers():
        yield


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# -- CRUSH ----------------------------------------------------------------


@pytest.mark.parametrize("n_osds,km", [(8, 6), (8, 12), (12, 6), (12, 12),
                                       (16, 6), (16, 12)])
def test_crush_placement_acting_sets_match_jax_do_rule(n_osds, km):
    if km > n_osds:
        xs = range(16)
    elif (n_osds, km) == (16, 6):
        xs = X
    else:
        xs = range(0, len(X), 16)
    mine = placement.CrushPlacement(n_osds, km, pg_num=len(X))
    m, root = j_crush.build_flat_map(n_osds)
    ruleno = m.add_rule(j_crush_map.erasure_rule(root))
    got = [mine.acting_for_pg(x) for x in xs]
    assert len(got) == len(xs)
    want = [j_crush.do_rule(m, ruleno, x, km, [0x10000] * n_osds,
                            j_crush.Tunables()) for x in xs]
    assert got == [[None if v == j_crush_map.ITEM_NONE else v for v in r]
                   for r in want]
    # the port's do_rule is what its placement ran
    pm, proot = crush.build_flat_map(n_osds)
    pr = pm.add_rule(crush_map.erasure_rule(proot))
    assert [crush.do_rule(pm, pr, x, km, [0x10000] * n_osds,
                          crush.Tunables()) for x in xs[:32]] == want[:32]
    assert all(len(r) == km for r in got)
    if km > n_osds:
        assert all(None in r for r in got)


@pytest.mark.parametrize("n_osds", [8, 12, 16])
def test_crush_placement_objects_and_remaps_match_jax(n_osds):
    mine = placement.CrushPlacement(n_osds, 6)
    theirs = j_placement.CrushPlacement(n_osds, 6)
    assert [mine.pg_of(f"obj{x}") for x in X] == \
        [theirs.pg_of(f"obj{x}") for x in X]
    before = mine.pg_actings()
    assert before == theirs.pg_actings()
    # a weight change and an OSD out remap both alike
    for p in (mine, theirs):
        p.reweight(1, 0.5)
        p.mark_out(n_osds - 1)
    assert mine.pg_actings() == theirs.pg_actings()
    assert placement.movement_plan(before, mine.pg_actings()) == \
        j_placement.movement_plan(before, theirs.pg_actings())
    assert [mine.acting(f"o{x}") for x in range(512)] == \
        [theirs.acting(f"o{x}") for x in range(512)]


def test_crush_placement_on_hosts_matches_jax():
    hosts = [[0, 1, 2], [3, 4, 5], [6, 7], [8, 9, 10, 11]]
    mine = placement.CrushPlacement(12, 4, hosts=hosts)
    theirs = j_placement.CrushPlacement(12, 4, hosts=hosts)
    assert mine.pg_actings() == theirs.pg_actings()
    assert placement.movement_plan(mine.pg_actings(), mine.pg_actings()) \
        == []
    assert placement.fallback_acting("obj7", 12, 6) == \
        j_placement.fallback_acting("obj7", 12, 6)


def test_crush_hashes_match_jax():
    for x in range(0, 1 << 20, 4099):
        assert crush.crush_hash32(x) == j_crush.crush_hash32(x)
        assert crush.crush_hash32_2(x, 7) == j_crush.crush_hash32_2(x, 7)
        assert crush.crush_hash32_3(x, 7, x >> 3) == \
            j_crush.crush_hash32_3(x, 7, x >> 3)


# -- PG log ---------------------------------------------------------------


def _pglog_script(mod, tmod, store):
    seen = []
    log = mod.PGLog(trim_target=3)
    store.queue_transaction(tmod.Transaction().write("o@0", 0, b"AAAA")
                            .setattr("o@0", "_version", (1, "")))
    log.append("o@0", "write", (1, ""), existed=False, prior_size=0)
    store.queue_transaction(tmod.Transaction().write("o@0", 4, b"BBBB")
                            .setattr("o@0", "_version", (2, "")))
    log.append("o@0", "write", (2, ""), existed=True, prior_size=4,
               prior_attrs={"_version": (1, "")})
    seen.append(log.rollback_object_to("o@0", (1, ""), store))
    seen.append(store.read("o@0"))
    for i in range(1, 7):
        log.append(f"q{i}@0", "write", (i, ""))
        log.record_dup(("client.a", i), i * 10, oid=f"q{i}", version=(i, ""))
    seen.append([e.seq for e in log.entries_after(3)])
    log.maybe_trim()
    seen.append((log.head_seq, log.tail_seq, log.covers(log.tail_seq),
                 log.covers(0)))
    seen.append([(d.reqid, d.result, d.oid) for d in log.dups_after(2)])
    seen.append([None if d is None else d.result for d in
                 log.lookup_dups_batch([("client.a", 2), ("client.b", 1)])])
    log.merge_dup(("client.c", 1), "r", "x", version=(9, ""))
    seen.append(log.lookup_dup(("client.c", 1)).result)
    seen.append(log.dup_head_seq)
    return seen


def test_pglog_matches_jax():
    assert _pglog_script(pglog, types, MemStore()) == \
        _pglog_script(j_pglog, j_types, JMemStore())


# -- hit sets --------------------------------------------------------------


def _hitset_script(mod, kind):
    t = mod.HitSetTracker(kind=kind, period=10.0, count=3)
    t.current_start = 0.0
    seen = []
    for step in range(40):
        now = step * 1.5
        t.record(f"obj{step % 7}", now=now)
        if step % 5 == 0:
            t.record_many([f"hot{i}" for i in range(3)], now=now)
        seen.append(round(t.temperature("hot1", now=now), 9))
        seen.append(round(t.temperature(f"obj{step % 3}", now=now), 9))
    dump = t.dump()
    seen.append((dump["current_entries"], [a["entries"]
                                           for a in dump["archived"]]))
    return seen


@pytest.mark.parametrize("kind", ["bloom", "explicit_hash"])
def test_hitset_tracker_matches_jax(kind):
    assert _hitset_script(hitset, kind) == _hitset_script(j_hitset, kind)


# -- extent cache ------------------------------------------------------------


def _extent_script(mod):
    cache = mod.ExtentCache(max_object_bytes=64, max_cached_objects=2)
    seen = []

    async def main():
        async with cache.pin("a", 0, 32) as pin:
            pin.commit(0, b"x" * 32)
        async with cache.pin("a", 16, 48) as pin:
            pin.commit(16, b"y" * 32)
        seen.append(cache.get("a", 0, 48))
        seen.append(cache.get("a", 40, 30))
        async with cache.pin("b", 0, 8) as pin:
            pin.commit(0, b"b" * 8)
        async with cache.pin("c", 0, 8) as pin:
            pin.commit(0, b"c" * 8)
        seen.append([cache.get(o, 0, 8) for o in "abc"])
        order = []

        async def writer(tag, start, end):
            async with cache.pin("d", start, end):
                order.append(("in", tag))
                await asyncio.sleep(0)
                order.append(("out", tag))

        await asyncio.gather(writer(1, 0, 10), writer(2, 5, 15),
                             writer(3, 20, 30))
        seen.append(order)
        cache.invalidate("a")
        seen.append((cache.get("a", 0, 1), cache.hits, cache.misses,
                     sorted(cache._objects)))

    _run(main())
    return seen


def test_extent_cache_matches_jax():
    assert _extent_script(extent_cache) == _extent_script(j_extent_cache)


# -- PG stats -------------------------------------------------------------


class _Messenger:
    def __init__(self, down):
        self.down = down

    def is_down(self, name):
        return name in self.down


class _Backend:
    def __init__(self):
        self.pool_name = "ecpool"
        self.osds = list(range(6))
        self.messenger = _Messenger({"osd.2"})
        self._dirty = {"w1"}
        self._dirty_meta = set()
        self.scrub_errors = {"s": {}}


def _pg_stats_script(mod):
    b = _Backend()
    st = mod.PGStats(b)
    seen = [st.pg_stat()]
    st.note_down_victims("osd.2", ["a", "b", "c"])
    st.note_down_victims("wipe:osd.3", ["c", "d"])
    seen.append(st.pg_stat())
    st.clear_down_reason("osd.2")
    seen.append(sorted(st.degraded_oids()))
    st.note_recovering(["d", "e"])
    st.misplaced.add("m")
    seen.append(st.state_bits())
    st.note_recovered("d")
    st.end_pass(["c", "e", "m"], still_dirty=["e"])
    seen.append((sorted(st.degraded_oids()), st.degraded_count(),
                 st.pg_stat()))
    b.messenger.down.clear()
    b._dirty.clear()
    st.end_pass(["e"], still_dirty=[])
    b.scrub_errors.clear()
    seen.append(st.pg_stat())
    return seen


def test_pg_stats_matches_jax():
    assert _pg_stats_script(pg_stats) == _pg_stats_script(j_pg_stats)


# -- op tracker -------------------------------------------------------------


def _optracker_script(mod):
    tr = mod.OpTracker(history_size=3, history_slow_size=2, name="osd.0")
    now = time.monotonic()
    ops = [tr.create_request(f"op{i}", t0=now - 0.01 * (i % 4))
           for i in range(6)]
    seen = [tr.num_inflight(), tr.dump_ops_in_flight()["num_ops"]]
    for i, op in enumerate(ops):
        op.mark_event("queued", t=now - 0.01 * (i % 4) + 0.001)
        if i % 2 == 0:
            op.finish()
    seen.append(tr.num_inflight())
    seen.append([o["description"] for o in tr.dump_historic_ops()["ops"]])
    slow = tr.dump_historic_slow_ops()
    seen.append(([o["description"] for o in slow["ops"]],
                 slow["complaint_time"], slow["slow_ops_counted"]))
    seen.append([[e["event"] for e in o["type_data"]["events"]]
                 for o in tr.dump_historic_ops()["ops"]])
    seen.append(sorted(tr.dump_ops_in_flight()["ops"][0]))
    seen.append([s["segment"] for s in ops[0].timeline()["segments"]])
    return seen


def test_optracker_matches_jax():
    assert _optracker_script(optracker) == _optracker_script(j_optracker)


# -- op queues and QoS admission ---------------------------------------------


def _wpq_script(mod):
    q = mod.WeightedPriorityQueue(strict_cutoff=196)
    for i in range(30):
        q.enqueue((63, 127, 196, 255, 10)[i % 5], 1 + (i * 7) % 13, i)
    out = []
    while not q.empty():
        out.append(q.dequeue())
    return out, len(q)


def test_wpq_dequeue_order_matches_jax():
    assert _wpq_script(opqueue) == _wpq_script(j_opqueue)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _mclock_script(mod):
    clock = _Clock()
    q = mod.MClockQueue({"client": (100.0, 2.0, 0.0),
                         "recovery": (10.0, 1.0, 50.0),
                         "scrub": (0.0, 1.0, 20.0)}, clock=clock)
    for i in range(24):
        q.enqueue(("client", "recovery", "scrub", "other")[i % 4],
                  1 + i % 5, i)
    out = []
    while not q.empty():
        item = q.dequeue()
        if item is None:
            out.append(("wait", round(q.idle_for(), 9)))
            clock.t = q.next_ready()
            continue
        out.append(item)
    return out


def test_mclock_dequeue_order_matches_jax():
    assert _mclock_script(opqueue) == _mclock_script(j_opqueue)


def _qos_script(mod):
    clock = _Clock()
    seen = []

    async def main():
        adm = mod.QoSAdmission(
            slots=2, clock=clock, schedule_timers=False,
            classes={"client": (1000.0, 4.0, 0.0),
                     "recovery": (100.0, 1.0, 400.0)})
        order = []

        async def user(klass, cost, tag):
            async with adm.slot(klass, cost):
                order.append(tag)
                await asyncio.sleep(0)

        tasks = [asyncio.ensure_future(user(
            ("client", "recovery", "bulk")[i % 3], 100 + 50 * i, i))
            for i in range(12)]
        for _ in range(200):
            await asyncio.sleep(0)
            if all(t.done() for t in tasks):
                break
            clock.t += 0.05
            adm.poll()
        await asyncio.gather(*tasks)
        seen.append(order)
        seen.append(adm.status())
        seen.append(mod.parse_profile("a:1:2:3, b:x:1:1 c:0:1:0"))
        seen.append(mod.profile_bytes_per_s(mod.parse_profile("")))

    _run(main())
    return seen


def test_qos_admission_grants_match_jax():
    assert _qos_script(qos) == _qos_script(j_qos)


# -- lockdep and config ------------------------------------------------------


def test_lockdep_is_the_ports_own_and_reads_its_config():
    assert lockdep.enabled() is False
    assert lockdep.enabled() == j_lockdep.enabled()
    assert lockdep.LockdepError is not j_lockdep.LockdepError


CLUSTER_OPTIONS = (
    "osd_ec_op_coalesce", "osd_qos_unified", "osd_qos_slots",
    "osd_qos_op_slots", "osd_qos_profile", "osd_op_batch_exec",
    "osd_op_batch_max", "osd_recovery_sleep", "osd_recovery_max_active",
    "osd_recovery_batch_bytes", "osd_recovery_max_chunk",
    "osd_recovery_batched", "osd_read_gather_timeout", "osd_tick_interval",
    "osd_scrub_objects_per_tick", "osd_scrub_chunk_max",
    "osd_pg_log_dups_tracked", "osd_ec_fractional_repair",
    "osd_client_op_commit_timeout", "osd_tier_promote_temp",
    "osd_tier_promote_on_recovery", "osd_tier_promote_from_encode",
    "client_backoff_base", "client_backoff_max", "client_probe_retries",
    "client_probe_grace", "lockdep", "osd_op_history_size",
    "osd_op_history_slow_size", "osd_op_complaint_time")


def test_config_declares_the_cluster_options_as_jax_does():
    for name in CLUSTER_OPTIONS:
        opt, ref = config.OPTIONS[name], j_config.OPTIONS[name]
        assert (opt.type, opt.default, opt.level) == \
            (ref.type, ref.default, ref.level), name
    # the mesh data plane's options, declared since the port has it
    for name in ("osd_mesh_data_plane", "osd_mesh_devices",
                 "osd_mesh_scatter", "osd_mesh_board_bytes"):
        opt, ref = config.OPTIONS[name], j_config.OPTIONS[name]
        assert (opt.type, opt.default, opt.level, opt.see_also) == \
            (ref.type, ref.default, ref.level, ref.see_also), name


def test_counters_and_config_are_each_packages_own():
    """``PerfCounters.reset_all`` (the recovery bench resets before each
    mode) and ``apply_changes`` touch only the package that runs them."""
    from ceph_tpu.utils.perf import PerfCounters as JPerfCounters
    from ceph_tpu_torch.utils.perf import PerfCounters

    JPerfCounters("layers.jax").inc("kept")
    PerfCounters("layers.port").inc("gone")
    PerfCounters.reset_all()
    assert "layers.port" not in json.loads(PerfCounters.dump())
    assert json.loads(JPerfCounters.dump())["layers.jax"] == {"kept": 1}
    cfg, jcfg = config.get_config(), j_config.get_config()
    prior, jprior = (cfg.get_val("osd_recovery_batched"),
                     jcfg.get_val("osd_recovery_batched"))
    try:
        cfg.apply_changes({"osd_recovery_batched": not prior})
        assert jcfg.get_val("osd_recovery_batched") == jprior
    finally:
        cfg.apply_changes({"osd_recovery_batched": prior})
