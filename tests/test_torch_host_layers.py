"""The port's host layers under PG against the JAX package's, side by side.

The same script of calls runs through both packages and must leave the
same observable state: ``BatchCoalescer`` batches, results, counters and
error fan-out; ``PerfCounters`` dumps and histograms; trace span trees
(ids renumbered in order of appearance, times dropped); the profiling
ledger's stage counts; ``MemStore`` state after the same ``Transaction``s;
the in-process ``Messenger`` with a seeded ``FaultInjector``; write plans;
the value types and the config schema.  Each package keeps its own module
state, which the last test checks.
"""

import asyncio
import dataclasses
import json

import numpy as np
import pytest

from ceph_tpu import profiling as j_profiling
from ceph_tpu.msg import fault as j_fault
from ceph_tpu.osd import coalescer as j_coalescer
from ceph_tpu.osd import ectransaction as j_ectransaction
from ceph_tpu.osd import ecutil as j_ecutil
from ceph_tpu.osd import memstore as j_memstore
from ceph_tpu.osd import messenger as j_messenger
from ceph_tpu.osd import types as j_types
from ceph_tpu.utils import config as j_config
from ceph_tpu.utils import perf as j_perf
from ceph_tpu.utils import trace as j_trace
from ceph_tpu_torch import profiling
from ceph_tpu_torch.msg import FaultInjector, fault
from ceph_tpu_torch.osd import (coalescer, ectransaction, ecutil, memstore,
                                messenger, types)
from ceph_tpu_torch.utils import aio, config, perf, trace

PORT = {"coalescer": coalescer, "perf": perf, "trace": trace,
        "memstore": memstore, "types": types, "messenger": messenger,
        "fault": fault, "profiling": profiling}
REF = {"coalescer": j_coalescer, "perf": j_perf, "trace": j_trace,
       "memstore": j_memstore, "types": j_types, "messenger": j_messenger,
       "fault": j_fault, "profiling": j_profiling}


def _policy_runs_tasks() -> bool:
    """Whether the current event-loop policy's loops can run a task.  The
    tier-1 conftest installs the JAX package's atomic-section verifier as
    every loop's task factory; where ``asyncio.Task`` takes only
    coroutines (Python 3.12 on), it refuses the generator the verifier
    wraps each coroutine in."""
    async def nothing():
        return None

    coro = nothing()
    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(coro)
        return True
    except TypeError:
        coro.close()
        return False
    finally:
        loop.close()


@pytest.fixture(autouse=True)
def _loop_policy():
    """Keep the conftest's verifying policy where it can run a task, so
    the JAX package's half of each comparison runs under its verifier;
    where it cannot, this file's loops, the JAX package's included, run
    under asyncio's default policy."""
    if _policy_runs_tasks():
        yield
        return
    saved = asyncio.get_event_loop_policy()
    asyncio.set_event_loop_policy(asyncio.DefaultEventLoopPolicy())
    yield
    asyncio.set_event_loop_policy(saved)


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# -- the coalescer ----------------------------------------------------------

#: (max_batch, max_bytes, depth, waves): each wave is a list of item sizes
#: submitted by concurrent tasks in one tick; waves are a tick apart
SCENARIOS = {
    "one_tick": (64, 64 << 20, 2, [[10] * 7]),
    "max_batch": (3, 64 << 20, 2, [[1] * 8, [1] * 2]),
    "max_bytes": (64, 100, 1, [[40, 40, 40, 5, 90, 10], [200]]),
    "ticks": (64, 64 << 20, 2, [[5, 6], [7], [], [8, 9, 10]]),
    "depth_one": (2, 64 << 20, 1, [[1, 2, 3, 4, 5], [6, 7]]),
}


async def _coalesce_script(mod, max_batch, max_bytes, depth, waves, *,
                           asynchronous, fail_on=None):
    batches = []

    def dispatch(items):
        batches.append(list(items))
        if fail_on is not None and fail_on in items:
            raise fail_on_exc(fail_on)
        return [(i, len(items)) for i in items]

    async def adispatch(items):
        await asyncio.sleep(0)
        return dispatch(items)

    perf_mod = PORT["perf"] if mod is coalescer else REF["perf"]
    pc = perf_mod.PerfCounters(f"coalesce-test-{id(batches)}")
    coal = mod.BatchCoalescer(adispatch if asynchronous else dispatch,
                              max_batch=max_batch, max_bytes=max_bytes,
                              depth=depth, perf=pc, counter="ec_encode")
    n = 0
    tasks = []
    for wave in waves:
        for size in wave:
            tasks.append(asyncio.ensure_future(coal.submit(n, size)))
            n += 1
        await asyncio.sleep(0)
    results = await asyncio.gather(*tasks, return_exceptions=True)
    outcome = [("error", type(r).__name__, r.args)
               if isinstance(r, BaseException) else r for r in results]
    return batches, outcome, pc.snapshot()


def fail_on_exc(item):
    return ValueError("dispatch failed", item)


@pytest.mark.parametrize("asynchronous", [False, True],
                         ids=["sync", "async"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_coalescer_batches_match_jax(scenario, asynchronous):
    args = SCENARIOS[scenario]
    ours = _run(_coalesce_script(coalescer, *args,
                                 asynchronous=asynchronous))
    theirs = _run(_coalesce_script(j_coalescer, *args,
                                   asynchronous=asynchronous))
    assert ours == theirs
    batches, outcome, counters = ours
    assert [i for b in batches for i in b] == sorted(
        i for b in batches for i in b)
    assert counters["ec_encode_items"] == len(outcome)


def test_coalescer_error_fan_out_matches_jax():
    args = SCENARIOS["max_batch"]
    ours = _run(_coalesce_script(coalescer, *args, asynchronous=False,
                                 fail_on=4))
    theirs = _run(_coalesce_script(j_coalescer, *args, asynchronous=False,
                                   fail_on=4))
    assert ours == theirs
    _batches, outcome, counters = ours
    failed = [o for o in outcome if o[0] == "error"]
    # every waiter of the failing batch gets the error, the others their
    # results; the failed batch is not counted
    assert failed == [("error", "ValueError", ("dispatch failed", 4))] * 3
    assert counters["ec_encode_items"] == len(outcome) - 3


def test_coalescer_error_without_args_becomes_ioerror():
    async def script(mod):
        def dispatch(items):
            raise KeyError()

        coal = mod.BatchCoalescer(dispatch)
        got = await asyncio.gather(coal.submit(1), coal.submit(2),
                                   return_exceptions=True)
        return [type(e).__name__ for e in got]

    assert _run(script(coalescer)) == _run(script(j_coalescer)) == \
        ["OSError", "OSError"]


# -- perf counters ----------------------------------------------------------


def _perf_script(mod):
    mod.PerfCounters.reset_all()
    a = mod.PerfCounters("osd.0")
    b = mod.PerfCounters("client")
    for i in range(5):
        a.inc("ops")
        a.inc("bytes", 4096 * i)
        a.hwm("peak", [3, 9, 2, 9, 1][i])
        b.tinc("lat", 0.25 * (i + 1))
    h = mod.stage_histogram("osd.0.dispatch")
    for usec, size in ((1, 10), (3, 4096), (1000, 1 << 20), (7, 0)):
        h.inc(usec, size)
    h.inc_many(12, [1, 2, 3])
    axis = mod.HistogramAxis("x", 0, 64, 32, "log2")
    return (json.loads(mod.PerfCounters.dump()),
            json.loads(mod.PerfHistogram.dump()),
            mod.histogram_marginals(), mod.histograms_prometheus_text(),
            [axis.bucket_for(v) for v in (0, 1, 63, 64, 65, 1e9)],
            axis.upper_bounds(), axis.to_dict())


def test_perf_counters_dump_matches_jax():
    try:
        assert _perf_script(perf) == _perf_script(j_perf)
    finally:
        perf.PerfCounters.reset_all()
        j_perf.PerfCounters.reset_all()


# -- trace spans --------------------------------------------------------------


def _normalize(dumps):
    ids = {}

    def rid(i):
        if i == 0:
            return 0
        return ids.setdefault(i, len(ids) + 1)

    for d in dumps:
        rid(d["span_id"])
    return [{
        "span": rid(d["span_id"]), "trace": rid(d["trace_id"]),
        "parents": [rid(p) for p in d["parent_ids"]],
        "name": d["name"], "events": d["events"],
        "tags": {k.split(":")[0] + (":" if ":" in k else ""):
                 (rid(v) if k.startswith("fanin:") else v)
                 for k, v in d["tags"].items()},
        "amortized_over": d["amortized_over"],
        "finished": d["duration_ms"] is not None,
    } for d in dumps]


async def _trace_script(tmod, cmod):
    """Three op spans ride one coalesced dispatch (fan-in span), with a
    child span, events and tags, and an unsampled task."""
    roots = []

    def dispatch(items):
        tmod.event("dispatching")
        tmod.tag("n", len(items))
        return items

    coal = cmod.BatchCoalescer(dispatch, counter="ec_encode")

    async def op(i):
        root = tmod.new_trace(f"op{i}")
        roots.append(root)
        with tmod.use_span(root):
            root.event("start")
            with root.child("prepare") as child:
                child.tag_set("i", i)
            got = await coal.submit(i, 10)
            root.tag_set("result", got)
        root.finish()

    async def unsampled():
        return await coal.submit(99, 1)

    await asyncio.gather(*(op(i) for i in range(3)), unsampled())
    joined = tmod.join(roots[0].to_wire(), "remote")
    joined.event("handle")
    joined.finish()
    return tmod.dump(), tmod.status(), tmod.unfinished_count()


def _traced(tmod, cmod):
    saved = tmod.mode()
    tmod.configure(mode="full")
    tmod.clear()
    try:
        dumps, status, unfinished = _run(_trace_script(tmod, cmod))
    finally:
        tmod.configure(mode=saved)
        tmod.clear()
    return _normalize(dumps), status, unfinished


def test_trace_span_trees_match_jax():
    ours = _traced(trace, coalescer)
    theirs = _traced(j_trace, j_coalescer)
    assert ours == theirs
    spans, status, unfinished = ours
    fanin = [s for s in spans if s["name"] == "batch_encode"]
    assert len(fanin) == 1 and len(fanin[0]["parents"]) == 3
    assert fanin[0]["amortized_over"] == 4  # the unsampled rider counts
    assert unfinished == 0 and status["finished"] == len(spans)


def test_trace_null_span_and_sampling_match_jax():
    def script(tmod):
        saved = tmod.mode()
        try:
            tmod.configure(mode="sampled", sample_every=3)
            tmod.clear()
            sampled = [bool(tmod.new_trace("r")) for _ in range(7)]
            tmod.configure(mode="off")
            off = [bool(tmod.new_trace("r")), tmod.join([1, 2], "x")]
            null = tmod.NULL_SPAN
            return (sampled, [bool(x) for x in off], null.to_wire(),
                    null.child("c") is null, tmod.current() is null)
        finally:
            tmod.configure(mode=saved, sample_every=64)
            tmod.clear()

    assert script(trace) == script(j_trace)


# -- the profiling ledger ----------------------------------------------------


def _profile_script(pmod):
    saved = pmod.mode()
    pmod.configure("on")
    pmod.reset()
    try:
        outer, inner = pmod.stage("t.outer"), pmod.stage("t.inner")
        for i in range(4):
            with outer:
                outer.add_bytes(100)
                with inner:
                    inner.add_bytes(i)
        pmod.stage_enter(inner)
        pmod.stage_exit(inner)
        pmod.note_burst("osd.1", 4, 4096, 4000)
        pmod.note_burst("osd.1", 2, 100, 100)
        snap = pmod.snapshot()
        stages = {n: (s["calls"], s["bytes"])
                  for n, s in snap["stages"].items() if n.startswith("t.")}
        bursts = snap["bursts"]["by_connection"]
        rows = [r["stage"] for r in pmod.decomposition(10**9)["rows"]]
        return stages, bursts, sorted(rows), pmod.mode()
    finally:
        pmod.configure(saved)
        pmod.reset()


def test_profiling_ledger_matches_jax():
    ours = _profile_script(profiling)
    theirs = _profile_script(j_profiling)
    assert ours == theirs
    assert ours[0] == {"t.outer": (4, 400), "t.inner": (5, 6)}


# -- MemStore / Transaction ---------------------------------------------------


def _txns(tmod):
    T = tmod.Transaction
    return [
        T().write("a@0", 0, b"hello").setattr("a@0", "hinfo", {"x": 1}),
        T().write("a@0", 10, b"world").write("b@1", 3, b"xyz"),
        T().omap_setkeys("a@meta", {"k1": b"v1", "k2": b"v2"})
           .write("a@meta", 0, b"m"),
        T().truncate("a@0", 7).omap_rmkeys("a@meta", ["k1"]),
        T().clone("a@0", "a@0.snap1").write("a@0", 0, b"HELLO"),
        T().truncate("b@1", 20).remove("missing"),
        T().clone("nope", "x").write("never", 0, b"!"),  # fails whole
        T().remove("b@1").omap_clear("a@meta"),
    ]


def _store_state(mmod, tmod):
    store = mmod.MemStore()
    errors = []
    for txn in _txns(tmod):
        try:
            store.queue_transaction(txn)
        except FileNotFoundError as e:
            errors.append(str(e))
    objs = store.list_objects()
    return (objs, {o: store.read(o) for o in objs},
            {o: store.getattr(o, "hinfo") for o in objs},
            {o: store.omap_get(o) for o in objs},
            {o: store.stat(o) for o in objs}, store.stats(), errors,
            store.exists("never"))


def test_memstore_state_matches_jax():
    ours = _store_state(memstore, types)
    assert ours == _store_state(j_memstore, j_types)
    assert ours[0] == ["a@0", "a@0.snap1", "a@meta"]
    assert ours[1]["a@0"] == b"HELLO\0\0"


def test_types_match_jax():
    for name in ("TxnOp", "Transaction", "LogEntry", "ECSubWrite",
                 "ECSubWriteReply", "ECSubRead", "ECSubReadReply"):
        ours, theirs = getattr(types, name), getattr(j_types, name)
        assert [(f.name, f.default) for f in dataclasses.fields(ours)] == \
            [(f.name, f.default) for f in dataclasses.fields(theirs)], name
    assert [dataclasses.astuple(op) for op in _txns(types)[2].ops] == \
        [dataclasses.astuple(op) for op in _txns(j_types)[2].ops]


# -- messenger + fault injection ---------------------------------------------


async def _deliveries(mmod, fmod, n=200):
    inj = fmod.FaultInjector(drop_probability=0.25, delay_probability=0.2,
                             max_delay=0.0005, seed=7)
    bus = mmod.Messenger(fault=inj)
    got = []

    async def dispatcher(src, msg):
        got.append((src, msg))

    bus.register("osd.0", dispatcher)
    bus.register("osd.1", dispatcher)
    bus.mark_down("osd.1")
    for i in range(n):
        await bus.send_message("client", "osd.0", ("op", i))
        await bus.send_message("client", "osd.1", ("lost", i))
    await bus.send_messages("client", [("osd.0", "a"), ("osd.0", "b"),
                                       ("osd.9", "c")])
    for _ in range(100):
        if not bus._queues["osd.0"].qsize():
            break
        await asyncio.sleep(0)
    await asyncio.sleep(0)
    await bus.shutdown()
    return got, inj.dropped


def test_messenger_with_seeded_faults_delivers_the_same_sequence():
    ours = _run(_deliveries(messenger, fault))
    theirs = _run(_deliveries(j_messenger, j_fault))
    assert ours == theirs
    got, dropped = ours
    assert 0 < dropped < 200 and len(got) > 100
    assert [m for _s, m in got[:-2]] == sorted(m for _s, m in got[:-2])


def test_fault_injector_one_shots_match_jax():
    def script(cls):
        inj = cls(seed=3)
        out = [inj.conn_kill_split(4)]
        inj.schedule_conn_kill(5)
        out += [inj.conn_kill_split(4), inj.conn_kill_split(4),
                inj.conn_kill_split(4)]
        inj.schedule_kill_after_apply("write")
        out += [inj.kill_after_apply_fire("read"),
                inj.kill_after_apply_fire("write"),
                inj.kill_after_apply_fire("write")]
        inj.schedule_ring_tear(2)
        out += [inj.ring_tear_fire() for _ in range(4)]
        inj.drop_probability = 0.5
        out += [inj.maybe_drop() for _ in range(20)]
        return out, inj.conn_kills, inj.apply_kills, inj.ring_tears, \
            inj.dropped

    assert script(FaultInjector) == script(j_fault.FaultInjector)
    assert messenger.FaultInjector is FaultInjector


def test_fault_injector_from_config_tracks_changes():
    def script(cmod, fmod):
        cfg = cmod.get_config()
        saved = cfg.get_val("ms_inject_socket_failures")
        try:
            inj = fmod.FaultInjector.from_config()
            before = inj.drop_probability
            cfg.apply_changes({"ms_inject_socket_failures": 4})
            return before, inj.drop_probability
        finally:
            cfg.apply_changes({"ms_inject_socket_failures": saved})

    assert script(config, fault) == script(j_config, j_fault) == (0.0, 0.25)


def test_adopt_task_logs_and_prunes(capsys):
    async def script():
        bus = messenger.Messenger(fault=FaultInjector())

        async def boom():
            raise RuntimeError("tick loop died")

        task = asyncio.ensure_future(boom())
        bus.adopt_task("tick", task)
        await asyncio.gather(task, return_exceptions=True)
        await asyncio.sleep(0)
        return dict(bus._tasks)

    assert _run(script()) == {}
    assert "tick loop died" in capsys.readouterr().err
    assert aio.log_task_exception.__module__ == "ceph_tpu_torch.utils.aio"


# -- write plans, config schema, separate state --------------------------------


def test_write_plans_match_jax():
    rs = np.random.RandomState(37)
    for k, chunk in ((4, 32), (8, 4096), (3, 64)):
        s = ecutil.StripeInfo(k, k * chunk)
        js = j_ecutil.StripeInfo(k, k * chunk)
        for _ in range(200):
            size, off, length = rs.randint(0, 8 * k * chunk, 3).tolist()
            got = ectransaction.get_write_plan(s, size, off, length + 1)
            want = j_ectransaction.get_write_plan(js, size, off, length + 1)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_config_schema_matches_jax():
    # the port declares the options it reads, each as the reference has it
    assert set(config.OPTIONS) <= set(j_config.OPTIONS)
    for name, opt in config.OPTIONS.items():
        ref = j_config.OPTIONS[name]
        assert (opt.type, opt.default, opt.level) == \
            (ref.type, ref.default, ref.level), name
    c, jc = config.Config({"trace_keep": "12"}), \
        j_config.Config({"trace_keep": "12"})
    shown = jc.show_config()
    assert c.show_config() == {n: shown[n] for n in config.OPTIONS}
    with pytest.raises(KeyError):
        c.get_val("no_such_option")


def test_config_reads_every_option_the_port_declares():
    import pathlib
    import re

    root = pathlib.Path(config.__file__).resolve().parents[1]
    read = set()
    for path in root.rglob("*.py"):
        read |= set(re.findall(r'(?:get|set)_val\(\s*"(\w+)"',
                               path.read_text()))
    assert read == set(config.OPTIONS)


def test_config_environment_layer_is_the_ports_own(monkeypatch):
    monkeypatch.setenv("CEPH_TPU_TRACE_KEEP", "7")
    monkeypatch.setenv("CEPH_TPU_TORCH_TRACE_SAMPLE_EVERY", "5")
    c, jc = config.Config(), j_config.Config()
    assert (c.get_val("trace_keep"), c.get_val("trace_sample_every")) == \
        (256, 5)
    assert (jc.get_val("trace_keep"), jc.get_val("trace_sample_every")) == \
        (7, 64)


def test_the_packages_keep_separate_state():
    # a test that imports both packages must not cross-feed them
    assert config.get_config() is not j_config.get_config()
    perf.PerfCounters.reset_all()
    j_perf.PerfCounters.reset_all()
    try:
        perf.PerfCounters("only-in-the-port").inc("x")
        assert json.loads(j_perf.PerfCounters.dump()) == {}
    finally:
        perf.PerfCounters.reset_all()
    assert trace.NULL_SPAN is not j_trace.NULL_SPAN
    assert profiling.stage("coalescer.submit") is not \
        j_profiling.stage("coalescer.submit")
    for name, mod in PORT.items():
        assert mod.__name__.startswith("ceph_tpu_torch."), name
        assert REF[name].__name__.startswith("ceph_tpu."), name
