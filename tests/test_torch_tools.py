"""The port's command-line tools (``ceph_tpu_torch/tools/{osdmaptool,
monstore_tool,objectstore_tool,ceph_volume,ceph_cli,rados_bench,
rados_cli}.py``) against the JAX package's (``tools/``), on the CPU.

Each case runs both tools on the same inputs (made with numpy from a
seed) and compares what they print and what they leave on disk; files one
tool writes (maps, dumps, stores) are fed to the other.  Fields that are
times, uuids, pids, rates or random keys are compared by type.  Every
pool of the port is the ``cuda`` plugin's codec on the CPU
(``device=cpu``); the JAX package's tools run under the port's
verifying policy for their call alone.
"""

import asyncio
import contextlib
import io
import json
import os
import re
import shutil
import tempfile

import numpy as np
import pytest

from ceph_tpu import objectstore as j_objectstore
from ceph_tpu.mon import monitor as j_monitor
from ceph_tpu.osd import messenger as j_messenger
from ceph_tpu.osd import types as j_types
from ceph_tpu_torch import objectstore
from ceph_tpu_torch.mon import monitor
from ceph_tpu_torch.osd import messenger, types
from ceph_tpu_torch.tools import (ceph_cli, ceph_volume, monstore_tool,
                                  objectstore_tool, osdmaptool, rados_bench,
                                  rados_cli, vstart)
from ceph_tpu_torch.utils.admin_socket import admin_command
from tools import ceph_cli as j_ceph_cli
from tools import ceph_volume as j_ceph_volume
from tools import monstore_tool as j_monstore_tool
from tools import objectstore_tool as j_objectstore_tool
from tools import osdmaptool as j_osdmaptool
from tools import rados_bench as j_rados_bench
from tools import rados_cli as j_rados_cli
from torch_process_lock import one_cluster_at_a_time
from torch_verify import port_verifiers, verifying_policy

PROFILE = {"k": "2", "m": "1", "device": "cpu"}


@pytest.fixture(autouse=True)
def _loop_policy(monkeypatch):
    """Daemons get one OpenMP thread; this file's loops both packages' loops run under the port's verifiers
    (``tests/torch_verify.py``)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with port_verifiers():
        yield


@contextlib.contextmanager
def _jax_policy(jax: bool):
    """The JAX package's calls under the port's verifying policy alone."""
    saved = asyncio.get_event_loop_policy()
    if jax:
        asyncio.set_event_loop_policy(verifying_policy())
    try:
        yield
    finally:
        asyncio.set_event_loop_policy(saved)


def _call(tool, argv, jax=False):
    """(rc, stdout, stderr) of ``tool.main(argv)`` in this process."""
    out, err = io.StringIO(), io.StringIO()
    with _jax_policy(jax), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        try:
            rc = tool.main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def _run(coro, jax=False):
    with _jax_policy(jax):
        loop = asyncio.new_event_loop()
        try:
            return loop.run_until_complete(coro)
        finally:
            loop.close()


# -- osdmaptool --------------------------------------------------------------


OSDMAP_STEPS = (["--createsimple", "10"],
                ["--create-pool", "data", "--k", "4", "--m", "2",
                 "--pg-num", "32"],
                ["--mark-out", "3"], ["--mark-down", "5"],
                ["--test-map-pgs", "--pool", "data"],
                ["--test-map-object", "obj1"], ["--mark-up", "5"],
                ["--mark-in", "3"], ["--test-map-pgs"], ["--print"])


def test_osdmaptool_matches_the_reference(tmp_path):
    """The reference's lifecycle (``tests/test_pyext_tools.py``) on both
    tools: every line printed and every saved map equal, including the
    ``--test-map-pgs`` table; then each tool on the other's map."""
    paths = {tool: str(tmp_path / f"{name}.json") for name, tool in (
        ("port", osdmaptool), ("jax", j_osdmaptool))}
    for argv in OSDMAP_STEPS:
        outs = {}
        for tool, path in paths.items():
            rc, out, _err = _call(tool, [path, *argv])
            assert rc == 0, argv
            outs[tool] = out.replace(path, "MAP")
        assert outs[osdmaptool] == outs[j_osdmaptool], argv
        with open(paths[osdmaptool]) as a, open(paths[j_osdmaptool]) as b:
            assert a.read() == b.read(), argv
    table = _call(osdmaptool, [paths[osdmaptool], "--test-map-pgs"])[1]
    assert "holes 0" in table and table.count("\nosd.") == 10
    for tool, path in ((osdmaptool, paths[j_osdmaptool]),
                       (j_osdmaptool, paths[osdmaptool])):
        assert _call(tool, [path, "--test-map-pgs", "--pool", "data"]) == \
            (0, table, "")
    assert _call(osdmaptool, [])[0] == 1


# -- monstore_tool -----------------------------------------------------------


def _mon_store(mon, msgr, path, jax):
    """A stopped 3-mon quorum's stores under ``path`` (the reference's
    ``tests/test_mon_store.py`` scenario)."""
    async def main():
        ms = msgr.Messenger()
        mc = mon.MonCluster(3, ms, store_dir=path)
        await mc.form_quorum()
        cl = mon.MonClient(ms, 3, "client0")

        async def dispatch(src, msg):
            await cl.handle_reply(msg)

        ms.register("client0", dispatch)
        await cl.command({"prefix": "osd create", "n": 4})
        await cl.command({"prefix": "config-key set", "key": "k",
                          "value": "v"})
        await cl.command({"prefix": "osd erasure-code-profile set",
                          "name": "p", "profile": {
                              "plugin": "jerasure", "k": "2", "m": "1"}})
        await cl.command({"prefix": "osd pool create", "name": "pool",
                          "profile": "p", "pg_num": 16})
        await asyncio.sleep(0.1)
        await ms.shutdown()
        mc.close_stores()

    _run(main(), jax)


def test_monstore_tool_matches_the_reference(tmp_path):
    """Each package's mon writes a store; each tool reads both: the same
    lines from both tools on a store, and the same osdmap from both
    stores."""
    stores = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
    _mon_store(monitor, messenger, stores["port"], False)
    _mon_store(j_monitor, j_messenger, stores["jax"], True)
    maps = []
    for path in stores.values():
        mon0 = os.path.join(path, "mon.0")
        for cmd in (["show-versions"], ["dump-paxos"],
                    ["dump-paxos", "--first", "2", "--last", "3"],
                    ["get-osdmap"], ["dump-keys"]):
            got = _call(monstore_tool, [mon0, *cmd])
            assert got == _call(j_monstore_tool, [mon0, *cmd]), cmd
            assert got[0] == 0
        sv = json.loads(_call(monstore_tool, [mon0, "show-versions"])[1])
        assert sv["last_committed"] == 4 and sv["stored_versions"] == 4
        maps.append(json.loads(_call(monstore_tool, [mon0, "get-osdmap"])[1]))
    assert maps[0] == maps[1] and maps[0]["max_osd"] == 4
    assert maps[0]["pools"]["pool"]["pg_num"] == 16


# -- objectstore_tool --------------------------------------------------------


def _fill(store_mod, types_mod, kind, path, rs):
    """A store of ``kind`` holding 3 objects of seeded bytes, two with
    the EC path's shard attributes."""
    s = store_mod.create(kind, path)
    objs = {}
    for i, n in enumerate((70000, 4096, 333)):
        data = rs.randint(0, 256, n, dtype=np.uint8).tobytes()
        txn = types_mod.Transaction().write(f"obj{i}@{i}", 0, data)
        if i < 2:
            txn.setattr(f"obj{i}@{i}", "_size", n)
            txn.setattr(f"obj{i}@{i}", "_version", 7 + i)
        s.queue_transaction(txn)
        objs[f"obj{i}@{i}"] = data
    s.umount()
    return objs


@pytest.mark.parametrize("kind", ["filestore", "kstore"])
def test_objectstore_tool_export_import_across_packages(kind, tmp_path):
    """The same store written by each package: every op prints the same
    lines in both tools; a dump exported by one tool imports with the
    other, the bytes and attributes equal to the source's."""
    rs = np.random.RandomState(26)
    src = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
    objs = _fill(objectstore, types, kind, src["port"], rs)
    rs = np.random.RandomState(26)
    assert _fill(j_objectstore, j_types, kind, src["jax"], rs) == objs
    for label, tool, other, other_mod in (
            ("port", objectstore_tool, j_objectstore_tool, j_objectstore),
            ("jax", j_objectstore_tool, objectstore_tool, objectstore)):
        base = ["--data-path", src[label], "--type", kind]
        dump = str(tmp_path / f"{label}.dump")
        for op in (["list"], ["info", "--oid", "obj0@0"],
                   ["info", "--oid", "obj2@2"]):
            got = _call(tool, [*base, "--op", *op])
            assert got[0] == 0 and got == _call(other, [*base, "--op", *op])
        rc, out, _err = _call(tool, [*base, "--op", "export", "--file", dump])
        assert rc == 0 and out == f"exported 3 object(s) to {dump}\n"
        dst = str(tmp_path / f"{label}-into-other")
        rc, out, _err = _call(other, ["--data-path", dst, "--type", kind,
                                      "--op", "import", "--file", dump])
        assert rc == 0 and out == f"imported 3 object(s) from {dump}\n"
        s = other_mod.create(kind, dst)
        try:
            assert sorted(s.list_objects()) == sorted(objs)
            for oid, data in objs.items():
                assert s.read(oid) == data
            assert s.getattr("obj1@1", "_version") == 8
        finally:
            s.umount()
    with open(tmp_path / "port.dump", "rb") as a, \
            open(tmp_path / "jax.dump", "rb") as b:
        assert a.read() == b.read()
    base = ["--data-path", src["port"], "--type", kind]
    assert _call(objectstore_tool, [*base, "--op", "remove",
                                    "--oid", "obj1@1"])[:2] == \
        (0, "removed obj1@1\n")
    assert "obj1@1" not in _call(objectstore_tool, [*base, "--op", "list"])[1]


# -- ceph_volume -------------------------------------------------------------


@pytest.mark.parametrize("tool", [ceph_volume, j_ceph_volume],
                         ids=["port", "jax"])
def test_ceph_volume_prepare_activate_list(tool, tmp_path):
    """The reference's case (``tests/test_pyext_tools.py``): prepare,
    a refused second prepare, list, activate of an unprepared id and of
    a run directory that vstart never initialized."""
    run_dir = str(tmp_path / "run")
    rc, out, _err = _call(tool, ["prepare", "--run-dir", run_dir, "--id",
                                 "0", "--objectstore", "blockstore"])
    assert rc == 0 and out.startswith("prepared osd.0 (blockstore) at ")
    assert _call(tool, ["prepare", "--run-dir", run_dir, "--id", "0"]) == \
        (1, "", "osd.0 already prepared\n")
    rc, out, _err = _call(tool, ["list", "--run-dir", run_dir])
    meta = json.loads(out)["osd.0"]
    assert rc == 0 and meta["objectstore"] == "blockstore"
    assert meta["whoami"] == 0 and meta["prepared"] is True
    assert isinstance(meta["fsid"], str) and len(meta["fsid"]) == 36
    rc, _out, err = _call(tool, ["activate", "--run-dir", run_dir,
                                 "--id", "7"])
    assert rc == 1 and "not prepared" in err
    rc, _out, err = _call(tool, ["activate", "--run-dir", run_dir,
                                 "--id", "0"])
    assert rc == 1 and "has no addr_map.json" in err
    assert _call(tool, ["list", "--run-dir", str(tmp_path / "none")]) == \
        (0, "{}\n", "")


# -- ceph_cli ----------------------------------------------------------------


CLI_SEQUENCE = (
    (["osd", "erasure-code-profile", "set", "ec42", "plugin=jerasure",
      "technique=reed_sol_van", "k=4", "m=2"], 0),
    (["osd", "erasure-code-profile", "set", "ec42", "k=9", "m=9"], 1),
    (["osd", "erasure-code-profile", "ls"], 0),
    (["osd", "erasure-code-profile", "get", "ec42"], 0),
    (["osd", "pool", "create", "mypool", "erasure", "ec42"], 0),
    (["osd", "pool", "create", "rep", "replicated", "2"], 0),
    (["osd", "erasure-code-profile", "rm", "ec42"], 1),
    (["osd", "pool", "ls"], 0),
    (["status"], 0),
    (["compression", "ls"], 0),
    (["osd", "erasure-code-profile", "set", "bad", "plugin=jerasure", "k=4",
      "m=2", "w=9"], 22),
    (["osd", "erasure-code-profile", "get", "nosuch"], 2),
    (["nosuch"], 1))


def test_ceph_cli_sequence_matches_the_reference(tmp_path, monkeypatch):
    """``tests/test_control_plane.py``'s sequence on both tools, each on
    its own state file: the same return codes, output and state; then a
    ``plugin=cuda`` profile on the port's (``device=cpu`` here; without
    it the codec raises where there is no CUDA)."""
    states = {ceph_cli: str(tmp_path / "port.json"),
              j_ceph_cli: str(tmp_path / "jax.json")}
    for argv, want in CLI_SEQUENCE:
        outs = {}
        for tool, state in states.items():
            monkeypatch.setenv(tool.STATE_ENV, state)
            outs[tool] = _call(tool, argv)
            assert outs[tool][0] == want, (argv, outs[tool])
        if argv == ["nosuch"]:  # the usage: each tool's docstring
            outs = {tool: (rc, out, err.split("Commands", 1)[1].split(
                "\n", 1)[1]) for tool, (rc, out, err) in outs.items()}
        assert outs[ceph_cli] == outs[j_ceph_cli], argv
    with open(states[ceph_cli]) as a, open(states[j_ceph_cli]) as b:
        assert a.read() == b.read()
    assert ceph_cli.STATE_ENV == "CEPH_TPU_TORCH_CLI_STATE"
    monkeypatch.setenv(ceph_cli.STATE_ENV, states[ceph_cli])
    rc, out, _err = _call(ceph_cli, [
        "osd", "erasure-code-profile", "set", "card", "plugin=cuda",
        "technique=reed_sol_van", "k=8", "m=4", "device=cpu"])
    assert rc == 0 and json.loads(out) == {
        "profile": "card", "chunk_count": 12, "data_chunk_count": 8}
    rc, out, _err = _call(ceph_cli, ["osd", "pool", "create", "cardpool",
                                     "erasure", "card"])
    assert rc == 0 and json.loads(out)["chunk_count"] == 12
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ceph_cli.validate_profile({"plugin": "cuda", "k": "2", "m": "1"})


# -- rados_bench -------------------------------------------------------------


@pytest.mark.parametrize("profile,j_profile", [
    ("plugin=cuda technique=reed_sol_van k=4 m=2 device=cpu",
     "plugin=jerasure technique=reed_sol_van k=4 m=2"),
    (None, None)], ids=["cuda-device-cpu", "default-lrc"])
def test_rados_bench_small_shape(profile, j_profile):
    """Both tools at a small shape print the same two lines, rates
    compared by type; the port's ``bench`` keeps its cluster, whose
    stored objects read back."""
    shape = ["--osds", "16", "--objects", "3", "--size", "65536"]
    lines = []
    for tool, prof, jax in ((rados_bench, profile, False),
                            (j_rados_bench, j_profile, True)):
        argv = shape + (["--profile", prof] if prof else [])
        rc, out, _err = _call(tool, argv, jax)
        assert rc == 0
        rows = [json.loads(line) for line in out.splitlines()]
        for row in rows:
            assert isinstance(row.pop("mb_s"), float)
        lines.append(rows)
    assert lines[0] == lines[1] == [
        {"phase": p, "objects": 3, "size": 65536} for p in ("write", "read")]

    async def keep():
        cluster, payloads, results = await rados_bench.bench(
            6, 2, 5000, rados_bench.parse_profile(profile or "k=4 m=2 "
                                                  "device=cpu"))
        try:
            return [await cluster.read(oid) == data
                    for oid, data in payloads.items()], results
        finally:
            await cluster.shutdown()

    same, results = _run(keep())
    assert same == [True, True] and len(results) == 2


# -- rados_cli and ceph_volume activate on process clusters ------------------


CLI_COMMANDS = (["put", "o1", "{src}"], ["put", "o2", "{src}"],
                ["stat", "o1"], ["get", "o1", "{dst}"], ["ls"], ["df"],
                ["setomapval", "o1", "key", "val"], ["listomapvals", "o1"],
                ["rm", "o2"], ["ls"], ["df"], ["tier", "status"],
                ["recovery", "status"], ["ops"], ["ops", "historic"],
                ["ops", "slow"], ["trace", "status"], ["trace", "{trace}"],
                ["profile", "status"], ["profile", "dump"],
                ["profile", "reset"], ["residency", "status"],
                ["health"], ["health", "detail"], ["pg", "stat"],
                ["status"], ["log", "last", "5"])
#: the mgr's views, compared while it reports the cluster clean
MGR_VIEWS = ("health", "pg", "status")
#: the subcommands whose lines carry counts of ops, rates or times
TIMED = ("tier", "recovery", "ops", "trace", "profile", "residency", "pg",
         "status")
#: a cluster-log line: its stamp, severity and message
LOG_LINE = re.compile(r"\d+\.\d{3} [A-Z]+ \S.*")


def _shape(text: str) -> set:
    """A tool's distinct lines with their numbers masked: the counts,
    rates, ages and op histories that depend on timing."""
    return set(re.sub(r"\d+(\.\d+)?", "N", text).splitlines())


async def _clean(mgr_asok) -> bool:
    """Whether the mgr reports HEALTH_OK and every PG slice active+clean
    (its beacon grace can flag a daemon of a loaded host for a moment, and
    a slice's state follows its primary's next report)."""
    return (await admin_command(mgr_asok, "health"))["status"] == \
        "HEALTH_OK" and set((await admin_command(
            mgr_asok, "pg stat"))["by_state"]) == {"active+clean"}


async def _wait_clean(mgr_asok, deadline_s=60.0):
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    while not await _clean(mgr_asok):
        assert loop.time() - t0 < deadline_s, "the mgr never saw it clean"
        await asyncio.sleep(0.2)


def _cli_round(tool, run_dir, tmp_path, label, jax):
    """Every ``CLI_COMMANDS`` entry through ``tool`` against the cluster
    in ``run_dir``: [(argv, rc, stdout)]."""
    src, dst = tmp_path / f"{label}.in", str(tmp_path / f"{label}.out")
    src.write_bytes(np.random.RandomState(7).randint(
        0, 256, 300_000, dtype=np.uint8).tobytes())
    asok = os.path.join(run_dir, "data", "osd.0.asok")
    mgr = os.path.join(run_dir, "data", "mgr.0.asok")
    rows = []
    for argv in CLI_COMMANDS:
        if argv == ["trace", "{trace}"]:
            spans = _run(admin_command(asok, "trace dump"), jax)
            argv = ["trace", str(spans[0]["trace_id"] if spans else 1)]
        argv = [a.format(src=src, dst=dst) for a in argv]
        while True:
            if argv[0] in MGR_VIEWS:
                _run(_wait_clean(mgr), jax)
            rc, out, _err = _call(tool, ["--dir", run_dir, *argv], jax)
            # a mgr view counts when the cluster read clean around it
            if argv[0] not in MGR_VIEWS or _run(_clean(mgr), jax):
                break
        rows.append((argv[0], rc, out))
    with open(dst, "rb") as f:
        assert f.read() == src.read_bytes()
    return rows


def test_rados_cli_and_ceph_volume_on_process_clusters(tmp_path):
    """A CPU process cluster of each package (3 OSDs, k=2 m=1, a mgr):
    every subcommand of ``rados_cli`` through each package's tool, the
    same return codes and the same lines where they carry no timing (the
    rest by shape); then ``ceph_volume`` prepares a SIGKILLed port OSD
    and ``activate`` boots it back into the cluster."""
    import importlib.util

    from ceph_tpu_torch.daemon.client import RemoteClient

    spec = importlib.util.spec_from_file_location(
        "jax_tools_vstart_for_cli",
        os.path.join(os.path.dirname(j_rados_cli.__file__), "vstart.py"))
    j_vstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_vstart)
    rounds = {}
    with one_cluster_at_a_time():
        for label, starter, tool, profile, jax in (
                ("jax", j_vstart, j_rados_cli,
                 {"plugin": "jerasure", "k": "2", "m": "1"}, True),
                ("port", vstart, rados_cli, PROFILE, False)):
            run_dir = tempfile.mkdtemp(prefix=f"ct-rc-{label}-")
            try:
                starter.start_cluster(run_dir, 3, profile, wait=60.0,
                                      n_mgrs=1)
                rounds[label] = _cli_round(tool, run_dir, tmp_path, label,
                                           jax)
                if jax:
                    continue
                assert vstart.kill_osd(run_dir, 2)
                assert _call(ceph_volume, [
                    "prepare", "--run-dir", run_dir, "--id", "2",
                    "--objectstore", "memstore"])[0] == 0
                rc, out, err = _call(ceph_volume, [
                    "activate", "--run-dir", run_dir, "--id", "2"])
                assert rc == 0, err
                pid = vstart._load_pids(run_dir)[2]
                assert out == f"activated osd.2 pid={pid}\n"

                async def probe():
                    c = await RemoteClient.connect(
                        os.path.join(run_dir, "addr_map.json"), PROFILE)
                    try:
                        return await c.probe_osds()
                    finally:
                        await c.close()

                assert _run(probe())["osd.2"] is True
            finally:
                starter.stop_cluster(run_dir)
                shutil.rmtree(run_dir, ignore_errors=True)
    port, ref = rounds["port"], rounds["jax"]
    for (cmd, rc, out), (_c, j_rc, j_out) in zip(port, ref):
        assert rc == j_rc == 0, (cmd, rc, j_rc, out, j_out)
        if cmd == "residency":
            j_out = j_out.replace("retraces", "builds")
        if cmd == "log":
            assert all(LOG_LINE.fullmatch(line)
                       for line in (out + j_out).splitlines()), (out, j_out)
        elif cmd in TIMED:
            assert _shape(out) == _shape(j_out), (cmd, out, j_out)
        else:
            assert out == j_out, cmd
