"""The port's cluster path and mesh path over real localhost TCP
(``msg/cluster_bench.py``, ``msg/mesh_bench.py``) against the JAX
package's.

The cluster-path cases are the JAX package's ``tests/test_cluster_path.py``
at its shape (jerasure k=2 m=1 there, 12 objects of 2 KiB, 4 writers),
run on the port's ``cuda`` plugin at ``device=cpu``, with the JAX test's
own gates and constants (1.35 for the full-stack walls, 1.15 for the
wire stage).  The JAX test gates one cycle a mode; these gates read the
best of three cycles, which is looser: on an 8-core CPU, 7 of 18 single
cycles at this shape failed one of the gates.  Each timing test also
records the JAX test's one-cycle ratios, from its first cycle, with
``record_property``.  At k=8 m=4 (12 OSDs) the same bench runs and its
counters are checked.  At both shapes every stored shard
equals the JAX package's, made in the same run from the same payloads.
The mesh-path case runs the port's sweep at a smoke shape on 1, 2 and 4
CPU slots: its stored shards equal the JAX package's ``tcp_only`` run,
and wire bytes avoided are monotone in the slot count.  Both tools'
``-w cluster-path`` and ``-w mesh-path`` print the JAX tool's keys.

Policies: the port's half runs under the port's verifiers
(``tests/torch_verify.py``); each JAX package half runs under the
port's verifying policy, switched on for that call alone, whose
verifier holds the JAX package's declared sections too (those of
``ceph_tpu/msg/tcp.py`` among them).
"""

import asyncio
import contextlib
import io
import json

import pytest
import torch

from ceph_tpu.msg import cluster_bench as j_cluster_bench
from ceph_tpu.msg import mesh_bench as j_mesh_bench
from ceph_tpu.plugins import registry as j_registry
from ceph_tpu_torch import parallel
from ceph_tpu_torch.msg import cluster_bench, mesh_bench
from ceph_tpu_torch.plugins import registry as registry_mod
from ceph_tpu_torch.tools import ec_benchmark
from torch_verify import port_verifiers, verifying_policy

#: the JAX test's constants (tests/test_cluster_path.py)
_TOLERANCE = 1.35
_WIRE_FLOOR = 1.15
#: the JAX test's shape; k=8 m=4 runs 12 objects of 8 KiB (1 KiB chunks)
SHAPES = {"k2m1": (2, 1, 12, 2 << 10), "k8m4": (8, 4, 12, 8 << 10)}
#: iterations of each mode: the walls the timing gates read are the best
#: of ITERS cycles (the bench's own best-of-``iters``), so that a host
#: busy with other test workers times the wire, not its scheduler
ITERS = 3
SEED = 4321  # run_cluster_path_bench's default payload seed


@contextlib.contextmanager
def _policy(default: bool):
    """A port run under the port's verifiers (``tests/torch_verify.py``);
    a JAX package call (``default``) under the port's verifying policy
    alone, which holds the JAX package's sections too."""
    if not default:
        with port_verifiers():
            yield
        return
    saved = asyncio.get_event_loop_policy()
    asyncio.set_event_loop_policy(verifying_policy())
    try:
        yield
    finally:
        asyncio.set_event_loop_policy(saved)


def _jax_call(fn, *a, **kw):
    """A JAX package call under the port's verifying policy."""
    with _policy(True):
        return fn(*a, **kw)


def _port_ec(k, m):
    return registry_mod.instance().factory(
        "cuda", {"k": str(k), "m": str(m), "technique": "reed_sol_van",
                 "device": "cpu"})


def _jax_ec(k, m):
    return j_registry.instance().factory(
        "jerasure", {"k": str(k), "m": str(m), "technique": "reed_sol_van"})


def _jax_shards(k, m, n_objects, obj_bytes, writers):
    """The JAX package's corked cycle's stored shards, from the payloads
    ``run_cluster_path_bench`` makes."""
    payloads = j_cluster_bench.make_payloads(n_objects, obj_bytes, SEED)

    def cycle():
        loop = asyncio.new_event_loop()
        try:
            return loop.run_until_complete(j_cluster_bench._one_cycle(
                _jax_ec(k, m), k + m, payloads, writers, cork=True))
        finally:
            loop.close()

    return _jax_call(cycle)["_shards"]


@pytest.fixture(scope="module", params=sorted(SHAPES))
def run(request):
    k, m, n_objects, obj_bytes = SHAPES[request.param]
    with _policy(False):
        port = cluster_bench.run_cluster_path_bench(
            _port_ec(k, m), n_objects=n_objects, obj_bytes=obj_bytes,
            writers=4, iters=ITERS, keep_shards=True, keep_cycles=True)
    shards = port.pop("_shards")
    jax = _jax_shards(k, m, n_objects, obj_bytes, 4)
    return request.param, port, shards, jax


def test_cluster_path_bit_exact(run):
    shape, result, shards, jax = run
    k, m = SHAPES[shape][:2]
    assert result["bit_exact"]
    assert result["k"] == k and result["m"] == m and result["n_osds"] == k + m
    assert result["wire_codec"] == "native"
    assert result["steady_library_builds"] == 0
    # every stored shard, object for object, is the JAX package's
    assert shards and set(shards) == set(jax)
    for key in jax:
        assert shards[key] == jax[key], key


def test_cluster_path_corked_not_slower(run, record_property):
    shape, result, _, _ = run
    if shape != "k2m1":
        return  # the JAX gate's shape only
    cycles = result["_cycles"]
    assert len(cycles["per_message"]) == len(cycles["corked"]) == ITERS
    (pm_w, pm_r), (ck_w, ck_r) = cycles["per_message"][0], \
        cycles["corked"][0]
    # the JAX test's one-cycle ratios, reported beside the gate
    record_property("first_cycle_write_ratio", ck_w / pm_w)
    record_property("first_cycle_read_ratio", ck_r / pm_r)
    assert result["corked"]["wall_write_s"] <= \
        result["per_message"]["wall_write_s"] * _TOLERANCE, result
    assert result["corked"]["wall_read_s"] <= \
        result["per_message"]["wall_read_s"] * _TOLERANCE, result


def test_cluster_path_wire_stage_corking_wins(run, record_property):
    shape, result, _, _ = run
    if shape != "k2m1":
        return  # the JAX gate's shape only
    cycles = result["_cycles"]
    assert len(cycles["wire_per_message"]) == len(cycles["wire_corked"]) \
        == ITERS
    record_property("first_cycle_wire_speedup",
                    cycles["wire_per_message"][0] / cycles["wire_corked"][0])
    assert result["wire_write_speedup"] is not None
    assert result["wire_write_speedup"] >= _WIRE_FLOOR, result


def test_cluster_path_wire_counters_shape(run):
    _, result, _, _ = run
    corked = result["wire_corked"]["counters"]
    base = result["wire_per_message"]["counters"]
    assert corked["frames_per_burst"] > 1.5, corked
    assert corked["drains"] < corked["frames_sent"] / 4, corked
    assert corked["acks_piggybacked"] > 0, corked
    assert corked["ack_piggyback_ratio"] > 0.3, corked
    assert base["frames_per_burst"] == 1.0, base
    assert base["drains"] == base["frames_sent"], base
    assert base["acks_piggybacked"] == 0, base


def test_cluster_path_full_stack_counters_recorded(run):
    _, result, _, _ = run
    for mode in ("per_message", "corked"):
        c = result[mode]["counters"]
        for key in ("frames_sent", "bursts", "bytes_sent",
                    "frames_per_burst", "ack_piggyback_ratio"):
            assert key in c, (mode, c)
        res = result[mode]["residency"]
        assert res["write"]["library_builds"] == 0, res
        assert res["write"]["granules"] > 0, res
        assert res["write"]["h2d_per_granule"] <= 1, res


def test_cluster_path_signed_cycle_stores_the_same_shards():
    """One corked cycle with a keyring holding every entity's key (every
    connection authenticated, every frame signed) stores the unsigned
    cycle's shards."""
    from ceph_tpu_torch.auth import KeyRing

    payloads = cluster_bench.make_payloads(8, 2048, seed=5)
    ring = KeyRing()
    for name in [f"osd.{i}" for i in range(3)] + ["client"]:
        ring.add(name)

    def cycle(keyring):
        loop = asyncio.new_event_loop()
        try:
            return loop.run_until_complete(cluster_bench._one_cycle(
                _port_ec(2, 1), 3, payloads, 2, cork=True,
                keyring=keyring))
        finally:
            loop.close()

    with _policy(False), cluster_bench.python_wire_codec():
        plain, signed = cycle(None), cycle(ring)
    assert signed["_shards"] == plain["_shards"]
    assert signed["counters"]["frames_sent"] > 0


def _tool_json(tool, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = tool.main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def _keys(d, depth=2):
    """The key tree of a result, ``depth`` levels down."""
    if depth == 0 or not isinstance(d, dict):
        return None
    return {k: _keys(v, depth - 1) for k, v in d.items()}


def test_cluster_path_tool_prints_the_jax_keys():
    from tools import ec_benchmark as j_ec_benchmark

    argv = ["-w", "cluster-path", "--objects", "6", "-s", "2048",
            "--writers", "2", "-P", "k=2", "-P", "m=1"]
    with _policy(False):
        rc, mine = _tool_json(ec_benchmark, argv + ["-P", "device=cpu"])
    assert rc == 0
    j_rc, theirs = _jax_call(_tool_json, j_ec_benchmark,
                             argv + ["-p", "jerasure"])
    assert j_rc == 0
    # the JAX tool's keys, two levels down, plus the port's additions
    extra = {"wire_codec", "steady_library_builds"}
    assert set(mine) == set(theirs) | extra
    assert mine["wire_codec"] == "native"
    for key, sub in _keys(theirs).items():
        if isinstance(sub, dict):
            mode_extra = {"residency", "steady_library_builds"} \
                if key in ("per_message", "corked") else set()
            assert set(mine[key]) == set(sub) | mode_extra, key


# -- mesh path ---------------------------------------------------------------


@pytest.fixture
def cpu_slots():
    parallel.configure_devices([torch.device("cpu")] * 8)
    yield
    parallel.configure_devices(None)


MESH = dict(n_objects=8, obj_bytes=4 << 10, writers=4, k=2, m=2)


def test_mesh_path_shards_equal_jax_and_avoided_monotone(cpu_slots):
    with _policy(False):
        result = mesh_bench.run_mesh_path_bench(
            mesh_sizes=(1, 2, 4), profile={"device": "cpu"},
            keep_shards=True, **MESH)
    shards = result.pop("_shards")
    assert result["bit_exact"] and result["steady_library_builds"] == 0
    assert result["wire_codec"] == "native"
    avoided = result["wire_bytes_avoided"]
    assert avoided["tcp_only"] == 0
    assert avoided["mesh_1"] <= avoided["mesh_2"] <= avoided["mesh_4"]
    assert avoided["mesh_4"] > 0
    sent = result["wire_bytes_sent"]
    assert sent["mesh_4"] < sent["tcp_only"]
    for name in ("tcp_only", "mesh_1", "mesh_2", "mesh_4"):
        assert result["results"][name]["steady_library_builds"] == 0

    # the JAX package's tcp_only cycle, its own plugin (tpu) on the CPU
    payloads = j_cluster_bench.make_payloads(
        MESH["n_objects"], MESH["obj_bytes"], 1717)

    def cycle():
        from ceph_tpu.parallel import mesh_plane as j_mesh_plane
        from ceph_tpu.utils.config import get_config as j_get_config

        cfg = j_get_config()
        prior = cfg.get_val("osd_mesh_data_plane")
        cfg.set_val("osd_mesh_data_plane", False)
        j_mesh_plane.reset()
        ec = j_registry.instance().factory(
            "tpu", {"technique": "reed_sol_van", "k": "2", "m": "2"}, "")
        loop = asyncio.new_event_loop()
        try:
            return loop.run_until_complete(j_mesh_bench._one_cycle(
                ec, 4, payloads, MESH["writers"], None))
        finally:
            loop.close()
            cfg.set_val("osd_mesh_data_plane", prior)

    jax = _jax_call(cycle)["_shards"]
    assert shards and set(shards) == set(jax)
    for key in jax:
        assert shards[key] == jax[key], key


def test_mesh_path_tool_prints_the_jax_keys():
    """The port tool's ``-w mesh-path`` JSON: the JAX tool's keys, with
    ``steady_library_builds`` where the JAX result has
    ``steady_jit_retraces``, and ``wire_codec``."""
    from tools import ec_benchmark as j_ec_benchmark

    argv = ["-w", "mesh-path", "--objects", "4", "-s", "4096",
            "--writers", "2", "--mesh-sizes", "1,2"]
    prior = parallel.configured_devices()
    with _policy(False):
        rc, mine = _tool_json(ec_benchmark, argv + ["-P", "device=cpu"])
    assert rc == 0 and parallel.configured_devices() == prior
    j_rc, theirs = _jax_call(_tool_json, j_ec_benchmark, argv)
    assert j_rc == 0

    def renamed(keys):
        return {"steady_library_builds" if k == "steady_jit_retraces"
                else k for k in keys}

    assert set(mine) == renamed(theirs) | {"wire_codec"}
    assert mine["mesh_sizes"] == theirs["mesh_sizes"] == [1, 2]
    assert set(mine["results"]) == set(theirs["results"])
    for name, sub in theirs["results"].items():
        assert set(mine["results"][name]) == renamed(sub), name
