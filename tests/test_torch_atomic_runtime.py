"""The port's runtime verifiers: the atomic-section verifier
(``ceph_tpu_torch/analysis/runtime.py``) and the device-resident-section
verifier (``analysis/residency.py``), as the JAX package's
``tests/test_atomic_runtime.py`` and ``tests/test_residency_runtime.py``
hold its own.  The residency counters, both verifier modes and nested
sections are compared with the JAX package's in
``tests/test_torch_host_layers.py``.

The JAX package's verifier wraps each coroutine in a ``types.coroutine``
generator, which ``asyncio.Task`` refuses from Python 3.12 on; the
port's shim is a ``collections.abc.Coroutine`` and runs tasks there
(``test_verifier_runs_tasks_where_jax_raises``).  Private verifiers are
used throughout, so the deliberate violations never reach the one the
port's test helper installs (``tests/torch_verify.py``)."""

from __future__ import annotations

import asyncio
import inspect
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

from ceph_tpu.analysis import runtime as j_runtime
from ceph_tpu_torch.analysis import residency, runtime
from ceph_tpu_torch.analysis.runtime import (AtomicSectionError,
                                             AtomicVerifier,
                                             register_default_sections)
from torch_verify import atomic_verifier, port_verifiers, residency_verifier

YIELDING = textwrap.dedent(
    """
    import asyncio

    async def op(state):
        # cephlint: atomic-section test-rmw-span
        state["a"] = state.get("a", 0) + 1
        await asyncio.sleep(0)   # the deliberate switch point
        state["b"] = state["a"]
        # cephlint: end-atomic-section
        return state
    """
)

CLEAN = textwrap.dedent(
    """
    import asyncio

    async def op(state):
        await asyncio.sleep(0)   # OUTSIDE the section: allowed
        # cephlint: atomic-section test-clean-span
        state["a"] = state.get("a", 0) + 1
        state["b"] = state["a"]
        # cephlint: end-atomic-section
        await asyncio.sleep(0)
        return state
    """
)

PARKED = textwrap.dedent(
    """
    async def op(evt):
        # cephlint: atomic-section test-parked-span
        await evt.wait()
        # cephlint: end-atomic-section
    """
)


@pytest.fixture(autouse=True)
def _loop_policy():
    with port_verifiers():
        yield


def _load(tmp_path, name: str, src: str):
    """Materialize ``src`` at a real path so its frames carry a filename
    the verifier's section table can hit."""
    path = tmp_path / f"{name}.py"
    path.write_text(src)
    ns: dict = {}
    exec(compile(src, str(path), "exec"), ns)
    return str(path), ns


async def _drive(v: AtomicVerifier, coro):
    return await v.wrap(coro)


def test_yielding_atomic_section_records_a_violation(tmp_path):
    path, ns = _load(tmp_path, "yielding", YIELDING)
    v = AtomicVerifier()
    assert v.register_source(path, YIELDING) == 1
    state = asyncio.run(_drive(v, ns["op"]({})))
    assert state["b"] == state["a"] == 1  # semantics untouched
    assert len(v.violations) == 1
    viol = v.violations[0]
    assert (viol.section, viol.path) == ("test-rmw-span", path)
    assert "asyncio.sleep(0)" in YIELDING.splitlines()[viol.line - 1]


def test_yield_free_atomic_section_is_silent(tmp_path):
    path, ns = _load(tmp_path, "clean", CLEAN)
    v = AtomicVerifier()
    assert v.register_source(path, CLEAN) == 1
    asyncio.run(_drive(v, ns["op"]({})))
    assert v.violations == []


def test_raise_mode_turns_the_switch_into_an_error(tmp_path):
    path, ns = _load(tmp_path, "yielding_raise", YIELDING)
    v = AtomicVerifier(raise_on_violation=True)
    v.register_source(path, YIELDING)
    with pytest.raises(AtomicSectionError, match="test-rmw-span"):
        asyncio.run(_drive(v, ns["op"]({})))


def test_tear_sweep_sees_task_parked_inside_section(tmp_path):
    path, ns = _load(tmp_path, "parked", PARKED)
    v = AtomicVerifier()
    v.register_source(path, PARKED)

    async def main():
        evt = asyncio.Event()
        task = asyncio.get_running_loop().create_task(ns["op"](evt))
        for _ in range(3):
            await asyncio.sleep(0)  # let the task reach evt.wait()
        v.check_all_tasks("injected tear (test)")
        evt.set()
        await task

    asyncio.run(main())
    assert [viol.section for viol in v.violations] == ["test-parked-span"]
    assert "injected tear" in v.violations[0].note


def test_fault_injector_tears_reach_the_ports_verifier(tmp_path,
                                                        monkeypatch):
    """``msg/fault.py`` reports each injected tear to :func:`on_tear`: a
    connection kill while another task is parked inside a section is a
    violation."""
    from ceph_tpu_torch.msg.fault import FaultInjector

    path, ns = _load(tmp_path, "torn", PARKED)
    v = AtomicVerifier()
    v.register_source(path, PARKED)
    monkeypatch.setattr(runtime, "_GLOBAL", v)
    fi = FaultInjector()
    fi.schedule_conn_kill(0)

    async def main():
        evt = asyncio.Event()
        task = asyncio.get_running_loop().create_task(ns["op"](evt))
        for _ in range(3):
            await asyncio.sleep(0)
        assert fi.conn_kill_split(4) == 0  # fires the tear
        evt.set()
        await task

    asyncio.run(main())
    assert [(x.section, x.note) for x in v.violations] == \
        [("test-parked-span", "injected tear (mid-burst connection kill)")]


def test_verifier_runs_tasks_where_jax_raises(tmp_path):
    """A task through ``loop.create_task`` and ``run_until_complete``
    under each package's verifying task factory.  The port's runs it on
    this interpreter; the JAX package's generator shim raises TypeError
    from Python 3.12 on (the fault that fails the JAX package's asyncio
    tests under its conftest)."""
    async def answer():
        await asyncio.sleep(0)
        return 42

    outcome = {}
    for name, verifier in (("port", AtomicVerifier()),
                           ("jax", j_runtime.AtomicVerifier())):
        loop = asyncio.new_event_loop()
        verifier.install(loop)
        coro = answer()
        try:
            outcome[name] = loop.run_until_complete(loop.create_task(coro))
        except TypeError as e:
            outcome[name] = e
            coro.close()
        finally:
            loop.close()
    assert outcome["port"] == 42
    if sys.version_info >= (3, 12):
        assert isinstance(outcome["jax"], TypeError)
        assert "coroutine was expected" in str(outcome["jax"])


def test_cancelled_before_its_first_step_closes_the_inner_coroutine():
    v = AtomicVerifier()
    loop = asyncio.new_event_loop()
    v.install(loop)

    async def never():
        await asyncio.sleep(10)

    coro = never()
    try:
        task = loop.create_task(coro)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            loop.run_until_complete(task)
    finally:
        loop.close()
    assert inspect.getcoroutinestate(coro) == inspect.CORO_CLOSED
    assert isinstance(task.get_coro(), runtime.VerifyingCoroutine)
    assert "never" in repr(task)  # the inner coroutine's name


def test_policy_records_a_deliberate_switch_through_create_task(tmp_path):
    path, ns = _load(tmp_path, "policy", YIELDING)
    v = AtomicVerifier()
    v.register_source(path, YIELDING)
    loop = runtime.VerifyingPolicy(v).new_event_loop()
    try:
        state = loop.run_until_complete(loop.create_task(ns["op"]({})))
    finally:
        loop.close()
    assert state == {"a": 1, "b": 1}
    assert [x.section for x in v.violations] == ["test-rmw-span"]


def test_port_sections_are_registered():
    v = AtomicVerifier()
    n = register_default_sections(v)
    names = {name for table in v.sections.values() for name, _s, _e in table}
    assert n == sum(len(t) for t in v.sections.values())
    assert {"osd-listen-to-host-pool", "msgr-watermark-ordering",
            "sub-write-apply", "peering-dup-merge"} <= names
    assert all(os.path.realpath(p).startswith(
        os.path.realpath(runtime.__file__).rsplit("/analysis/", 1)[0])
        for p in v.sections)
    # the helper's verifier holds both packages' sections
    helper = atomic_verifier()
    if helper is not None:
        paths = set(helper.sections)
        assert any("/ceph_tpu/msg/tcp.py" in p for p in paths)
        assert any("/ceph_tpu_torch/msg/tcp.py" in p for p in paths)


def test_malformed_sections_register_nothing(tmp_path):
    src = "# cephlint: atomic-" + "section dangling\nx = 1\n"
    v = AtomicVerifier()
    assert v.register_source(str(tmp_path / "m.py"), src) == 0


# -- the device-resident sections ---------------------------------------------

_SYNCING_SECTION_SRC = textwrap.dedent(
    """
    import torch
    from ceph_tpu_torch.analysis import residency

    def deliberate(data, dev):
        d = residency.device_put(data, dev)
        # cephlint: device-resident-section deliberate
        with residency.resident_section("deliberate"):
            return residency.device_get(d)
        # cephlint: end-device-resident-section
    """
)


def test_syncing_section_fails_at_runtime_and_statically():
    from ceph_tpu_torch.analysis.runner import scan_file

    v = residency.ResidencyVerifier("raise")
    t = residency.device_put(np.arange(64, dtype=np.uint8),
                             torch.device("cpu"))
    with pytest.raises(residency.ResidencySectionError, match="deliberate"):
        with v.section("deliberate"):
            residency.device_get(t)
    findings = [f for f in scan_file("ceph_tpu_torch/ops/_deliberate.py",
                                     _SYNCING_SECTION_SRC)
                if f.rule == "torch-d2h-in-resident-section"]
    assert findings and "device_get" in findings[0].message


def test_helper_installs_the_ports_residency_verifier():
    mode = residency.mode_from_env()
    if mode is None:
        pytest.skip("residency verifier switched off")
    assert residency.global_verifier() is residency_verifier()
    assert residency.global_verifier().mode == mode


def test_port_declares_its_guarded_device_resident_sections():
    from ceph_tpu_torch.analysis.core import parse_resident_sections

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(runtime.__file__)))
    names = []
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if fn.endswith(".py") and not dirpath.endswith("analysis"):
                with open(os.path.join(dirpath, fn)) as fh:
                    names += [s.name for s in parse_resident_sections(
                        fh.read().splitlines())[0]]
    assert sorted(names) == ["encode-compute", "encode-dispatch",
                             "granule-flush-encode", "tier-hit-read",
                             "tier-promote-transfer"]


def test_real_encode_path_enters_sections_cleanly():
    from ceph_tpu_torch.matrices import reed_sol
    from ceph_tpu_torch.ops.pipeline import DeviceCodec

    v = residency.global_verifier()
    if v is None:
        pytest.skip("residency verifier switched off")
    violations_before = len(v.violations)
    entered_before = dict(v.sections_entered)
    before = residency.counters().snapshot()
    k, m, w = 4, 2, 8
    codec = DeviceCodec(matrix=reed_sol.vandermonde_coding_matrix(k, m, w),
                        k=k, m=m, w=w, device="cpu")
    data = np.random.RandomState(3).randint(0, 256, size=(k, 4096),
                                            dtype=np.uint8)
    assert codec.encode(data).shape == (m, 4096)
    delta = residency.ResidencyCounters.delta(
        before, residency.counters().snapshot())
    assert delta["h2d_ops"] >= 1 and delta["d2h_ops"] >= 1
    assert len(v.violations) == violations_before
    for name in ("encode-dispatch", "granule-flush-encode",
                 "encode-compute"):
        assert v.sections_entered.get(name, 0) > \
            entered_before.get(name, 0), name


def test_status_payload_shape():
    st = residency.status()
    base = {"h2d_ops", "h2d_bytes", "d2h_ops", "d2h_bytes",
            "library_builds"}
    assert base <= set(st["counters"])
    assert all(k.startswith("mesh_") for k in set(st["counters"]) - base)
    assert {"mode", "violations", "sections_entered"} <= set(st)
