"""The port's stage markers and stack sampler (``profiling/ledger.py``,
``profiling/sampler.py``) against the JAX package's.

The port's markers are the C ``_wire_native.Stage`` of its native wire
codec (loaded at import, both gates on); the Python ``StageMarker`` is the
gated-off twin.  The same nested script runs through the port's C and
Python markers and the JAX package's C and Python markers: calls and
bytes equal exactly, every stage's time is exclusive (the stages' sum
stays inside the measured wall), a GC credit comes off the stage it
interrupted, and disabled markers accumulate and allocate nothing.  The
sampler's exports (speedscope document, collapsed lines, stage shares)
equal the JAX package's for the same stacks, and the ``full`` mode runs
it behind ``profiling.configure``.
"""

import gc
import sys
import time

import pytest

from ceph_tpu.native import wire_codec as j_wire_codec
from ceph_tpu.profiling import ledger as j_ledger
from ceph_tpu.profiling import sampler as j_sampler
from ceph_tpu_torch import profiling
from ceph_tpu_torch.native import wire_codec
from ceph_tpu_torch.profiling import ledger, sampler

BUSY_S = 0.002


@pytest.fixture(autouse=True)
def _profiling_off_after():
    yield
    profiling.configure(mode="off")
    profiling.reset()
    ledger.set_enabled(False)
    j_ledger.set_enabled(False)


def _busy(seconds):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pass


def _marker_kinds():
    kinds = {"port-c": (ledger, wire_codec.native().Stage),
             "port-python": (ledger, ledger.StageMarker),
             "jax-python": (j_ledger, j_ledger.StageMarker)}
    try:
        j_nat = j_wire_codec.native()
    except Exception:  # noqa: BLE001 -- its loader's own business
        j_nat = None
    if j_nat is not None:
        kinds["jax-c"] = (j_ledger, j_nat.Stage)
    return kinds


def _script(make):
    """Nested stages: outer > inner > leaf, with work at every level."""
    outer, inner, leaf = make("t.outer"), make("t.inner"), make("t.leaf")
    t0 = time.perf_counter_ns()
    for i in range(8):
        with outer:
            _busy(BUSY_S)
            with inner:
                _busy(BUSY_S)
                inner.add_bytes(100 + i)
                with leaf:
                    _busy(BUSY_S)
            _busy(BUSY_S)
    wall = time.perf_counter_ns() - t0
    return wall, [(m.name, m.calls, m.nbytes, m.ns)
                  for m in (outer, inner, leaf)]


def test_c_and_python_markers_give_the_same_ledger():
    rows = {}
    for label, (led, cls) in _marker_kinds().items():
        led.set_enabled(True)
        try:
            wall, stages = _script(cls)
        finally:
            led.set_enabled(False)
        total = sum(ns for *_rest, ns in stages)
        # exclusive: every nanosecond in one stage, none counted twice
        assert 0.5 * wall <= total <= wall, (label, total, wall)
        # the parent's clock pauses while a child runs
        assert all(ns >= 8 * BUSY_S * 0.9e9 for *_r, ns in stages), label
        assert stages[0][3] <= wall - stages[1][3] - stages[2][3], label
        rows[label] = [(name, calls, nbytes) for name, calls, nbytes, _ns
                       in stages]
    want = [("t.outer", 8, 0), ("t.inner", 8, 828), ("t.leaf", 8, 0)]
    assert all(r == want for r in rows.values()), rows


def test_the_port_selects_the_c_markers_and_they_follow_the_ledger():
    assert ledger.marker_class() is wire_codec.native().Stage
    m = profiling.stage("t.selected")
    assert isinstance(m, ledger.marker_class())
    cls = ledger.marker_class()
    outer, inner = cls("t.cur.outer"), cls("t.cur.inner")
    ledger.set_enabled(True)
    with outer:
        assert ledger.current_stage_name() == "t.cur.outer"
        t0 = time.perf_counter_ns()
        with inner:
            assert ledger.current_stage_name() == "t.cur.inner"
            _busy(0.01)
            ledger.gc_credit(5_000_000)  # a 5 ms GC pause inside inner
        inner_wall = time.perf_counter_ns() - t0
    assert ledger.current_stage_name() is None
    ledger.set_enabled(False)
    # the credit comes off the interrupted stage
    assert 0 < inner.ns <= inner_wall - 5_000_000 and inner.calls == 1


@pytest.mark.parametrize("label", ["port-c", "port-python"])
def test_disabled_markers_accumulate_and_allocate_nothing(label):
    led, cls = _marker_kinds()[label]
    led.set_enabled(False)
    m1, m2 = cls("t.off.a"), cls("t.off.b")

    def marked():
        for _ in range(20000):
            with m1:
                with m2:
                    pass

    def control():
        for _ in range(20000):
            pass

    def measure(fn):
        base = sys.getallocatedblocks()
        fn()
        return sys.getallocatedblocks() - base

    marked()
    control()
    gc.disable()
    try:
        deltas = [measure(marked) - measure(control) for _ in range(3)]
    finally:
        gc.enable()
    assert min(deltas) == 0
    assert (m1.calls, m1.ns, m2.calls, m2.ns) == (0, 0, 0, 0)


def _stacks():
    return {
        ("wire.encode", ("main (a.py:1)", "loop (b.py:9)", "enc (c.py:3)")):
            5,
        ("wire.encode", ("main (a.py:1)", "loop (b.py:9)")): 2,
        ("unattributed", ("main (a.py:1)", "idle (d.py:7)")): 3,
        ("wire.parse", ("main (a.py:1)", "loop (b.py:9)", "p (e.py:2)")): 1,
    }


def test_exports_equal_the_jax_sampler_for_the_same_stacks():
    mine, theirs = sampler.StackSampler(hz=50.0), j_sampler.StackSampler(
        hz=50.0)
    for s in (mine, theirs):
        s.stacks = _stacks()
        s.samples = sum(s.stacks.values())
    assert mine.collapsed() == theirs.collapsed()
    assert mine.stage_shares() == theirs.stage_shares()
    doc, j_doc = mine.speedscope(), theirs.speedscope()
    assert set(doc) == set(j_doc)
    for key in ("$schema", "activeProfileIndex", "shared", "profiles"):
        assert doc[key] == j_doc[key], key
    assert doc["exporter"] == "ceph_tpu_torch.profiling"
    assert [p["name"] for p in doc["profiles"]] == \
        ["unattributed", "wire.encode", "wire.parse"]
    for prof in doc["profiles"]:
        assert len(prof["samples"]) == len(prof["weights"])


def test_full_mode_samples_the_stages():
    profiling.configure(mode="full")
    s = profiling.current_sampler()
    assert s is not None and s.interval == pytest.approx(1 / 87.0)
    s.interval = 1 / 400.0
    with profiling.stage("t.sampled.busy"):
        _busy(0.2)
    time.sleep(0.02)
    assert profiling.snapshot()["sampler"]["samples"] > 0
    assert "t.sampled.busy" in s.stage_shares()
    doc = profiling.asok_dump({"format": "speedscope"})["speedscope"]
    assert doc["$schema"] == \
        "https://www.speedscope.app/file-format-schema.json"
    nframes = len(doc["shared"]["frames"])
    assert nframes and all(0 <= i < nframes for prof in doc["profiles"]
                           for smp in prof["samples"] for i in smp)
    collapsed = profiling.asok_dump({"format": "collapsed"})["collapsed"]
    assert any(line.startswith("t.sampled.busy;")
               for line in collapsed.splitlines())
    assert profiling.asok_dump()["mode"] == "full"
    profiling.configure(mode="off")
    assert profiling.current_sampler() is None
