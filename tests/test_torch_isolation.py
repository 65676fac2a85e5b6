"""The port stands alone: no module of ceph_tpu_torch, and not chip_smoke.py,
imports JAX, the JAX package or the JAX package's tools and experiments.
Checked twice: statically (an AST scan of every import) and at run time (a
fresh interpreter in which ``jax``, ``ceph_tpu``, ``tools`` and
``experiments`` cannot be imported imports every port module, encodes
and decodes one stripe, runs one small coalesced storage-path pass, one
small EC cluster's write, kill, degraded read and recovery at k=2 m=1, the
device tier's bench and a writeback cluster's tier hit, the registry's
``preload()`` and one stripe through each of the regen, isa, shec, lrc and
example plugins, the repair-path bench's fractional rebuild of 4 objects,
the kernel sweep and its two probe tools on the CPU, a mon-backed cluster
on blockstore with a replicated pool beside its EC pool, its crash
remount, each persistent engine's round trip, an OSD cap check, the
entry twin's fast dry run over four CPU slots, object-class ``exec``s
through ``Rados``/``IoCtx``, a mgr scrape over HTTP, the elastic
bench's smoke shape, one cluster cycle over localhost TCP: OSD daemons
on ``TCPMessenger``s with the native wire codec, corked and signed, the
codec fuzzer, the client libraries of ``osdc/``, and the services on
RADOS: an RBD image's write and read, served over NBD, the ``rbd_cli``
import and export, an S3 PUT and GET over the gateway and a CephFS
file's write and read, beside two MDS ranks).  The
native host
libraries are held to the same rule: every source the port's build names
lies in ``ceph_tpu_torch/native/``, no port module names a path under the
JAX package, and every shared library a process of the port maps from
this repository was built under ``ceph_tpu_torch/build/``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "ceph_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "ceph_tpu", "tools", "experiments")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    # whole module names: ceph_tpu_torch is not ceph_tpu
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_port_files_import_no_jax_and_no_reference_package():
    files = _port_files()
    assert len(files) > 15
    # the device cache tier is part of the scan
    assert {"__init__.py", "device_tier.py", "agent.py", "tier_bench.py"} \
        <= {p.name for p in files if p.parent == PORT / "tier"}
    # so are the plugin layer, its matrices and the repair bench
    assert {"regen.py", "isa.py", "shec.py", "lrc.py", "example.py"} \
        <= {p.name for p in files if p.parent == PORT / "plugins"}
    assert {"product_matrix.py", "isa.py"} \
        <= {p.name for p in files if p.parent == PORT / "matrices"}
    assert PORT / "osd" / "repair_bench.py" in files
    # so are the native layer, its engine and the EC tools
    assert {"build.py", "gf_native.py", "registry_native.py",
            "py_binding.py"} <= {p.name for p in files
                                 if p.parent == PORT / "native"}
    assert PORT / "ops" / "native_engine.py" in files
    assert {"ec_info.py", "ec_non_regression.py", "ec_bench_sweep.py",
            "crushtool.py"} <= {p.name for p in files
                                if p.parent == PORT / "tools"}
    # so are the durable cluster's modules: the persistent engines, the KV
    # layer, the encoding, compressor and log, replicated pools, caps and
    # the mon quorum
    assert {"filestore.py", "kstore.py", "blockstore.py", "statfs.py"} \
        <= {p.name for p in files if p.parent == PORT / "objectstore"}
    assert {"keyvaluedb.py", "lsm.py"} \
        <= {p.name for p in files if p.parent == PORT / "kv"}
    assert {"monitor.py", "paxos.py", "osdmap.py", "services.py"} \
        <= {p.name for p in files if p.parent == PORT / "mon"}
    assert {PORT / "utils" / "encoding.py", PORT / "utils" / "log.py",
            PORT / "compressor.py", PORT / "osd" / "replicated.py",
            PORT / "auth" / "caps.py"} <= set(files)
    # and the mesh data plane with the entry twin
    assert {"__init__.py", "distributed.py", "mesh_plane.py"} \
        <= {p.name for p in files if p.parent == PORT / "parallel"}
    assert PORT / "entry.py" in files
    # and the object classes, the librados surface, the manager and the
    # elastic and failover benches
    assert {"__init__.py", "cls_lock.py", "cls_version.py", "cls_rbd.py"} \
        <= {p.name for p in files if p.parent == PORT / "cls"}
    assert {"__init__.py", "mgr.py", "module_host.py", "pgmap.py",
            "report.py"} <= {p.name for p in files if p.parent == PORT / "mgr"}
    assert {"__init__.py", "status.py", "prometheus.py", "balancer.py"} \
        <= {p.name for p in files
            if p.parent == PORT / "mgr" / "mgr_modules"}
    assert {PORT / "client.py", PORT / "osd" / "elastic_bench.py",
            PORT / "osd" / "failover_bench.py"} <= set(files)
    # and the TCP messenger: wire codec, rings, transport, its benches,
    # the dispatch throttle and cephx
    assert {"__init__.py", "fault.py", "wire.py", "shm_ring.py", "tcp.py",
            "cluster_bench.py", "mesh_bench.py"} \
        <= {p.name for p in files if p.parent == PORT / "msg"}
    assert {PORT / "utils" / "throttle.py",
            PORT / "auth" / "cephx.py"} <= set(files)
    # and the native wire codec, the profiler's sampler, the benches over
    # the wire, the codec fuzzer and the client libraries
    assert {PORT / "native" / "wire_codec.py",
            PORT / "profiling" / "sampler.py",
            PORT / "profiling" / "wire_tax_bench.py",
            PORT / "osd" / "trace_bench.py",
            PORT / "tools" / "wire_fuzz.py"} <= set(files)
    assert {"__init__.py", "striper.py", "object_cacher.py", "journaler.py",
            "kv_store.py", "rados_striper.py"} \
        <= {p.name for p in files if p.parent == PORT / "osdc"}
    # and the services on RADOS with their command-line tool
    assert {"__init__.py", "objectmap.py", "journal.py", "image.py",
            "mirror.py", "replay.py", "nbd.py"} \
        <= {p.name for p in files if p.parent == PORT / "rbd"}
    assert {"__init__.py", "mds.py", "cephfs.py", "multimds.py"} \
        <= {p.name for p in files if p.parent == PORT / "mds"}
    assert {"__init__.py", "gateway.py", "sync.py"} \
        <= {p.name for p in files if p.parent == PORT / "rgw"}
    assert PORT / "tools" / "rbd_cli.py" in files
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_port_cuda_sources_include_only_toolkit_and_generated_headers():
    # the kernels build from the checkout alone: CUDA runtime and C headers,
    # the XOR network's header that the port generates at build time, and
    # the headers of csrc/ itself (the w=8 lookup body both table kernels
    # share)
    headers = sorted((PORT / "csrc").glob("*.cuh"))
    allowed = {"cuda_runtime.h", "stdint.h", "xornet_net.h",
               *(h.name for h in headers)}
    sources = sorted((PORT / "csrc").glob("*.cu"))
    assert len(sources) >= 3
    for path in sources + headers:
        included = {line.split()[1].strip('<>"')
                    for line in path.read_text().splitlines()
                    if line.startswith("#include")}
        assert included <= allowed, (path.name, included - allowed)


def test_forbidden_prefix_compares_whole_module_names():
    assert _forbidden("ceph_tpu") and _forbidden("ceph_tpu.ops.gf")
    assert _forbidden("jax.numpy") and not _forbidden("jaxtyping")
    assert not _forbidden("ceph_tpu_torch.ops.gf")
    assert _forbidden("tools.ec_kernel_sweep") and _forbidden("experiments")
    assert not _forbidden("ceph_tpu_torch.tools.ec_kernel_sweep")
    assert not _forbidden("functools")


_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["ceph_tpu"] = None
sys.modules["tools"] = None
sys.modules["experiments"] = None
import numpy as np
import ceph_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ceph_tpu_torch.__path__,
                                                "ceph_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401  (imported, not run)
from ceph_tpu_torch.plugins import registry
reg = registry.instance()
profile = {"technique": "reed_sol_van", "k": "4", "m": "2"}
ec = reg.factory("cuda", dict(profile, device="cpu"))
ref = reg.factory("jerasure", dict(profile))
payload = np.random.RandomState(0).randint(0, 256, 4096, dtype=np.uint8)
enc = ec.encode(set(range(6)), payload)
want = ref.encode(set(range(6)), payload)
assert all(np.array_equal(enc[c], want[c]) for c in want)
dec = ec.decode(set(range(6)), {c: enc[c] for c in (0, 2, 3, 5)})
assert all(np.array_equal(dec[c], want[c]) for c in want)
import asyncio
from ceph_tpu_torch.osd import storage_bench
h = storage_bench.StoragePathHarness(ec)
payloads = storage_bench.make_payloads(6, 3000, seed=1)
loop = asyncio.new_event_loop()
store = loop.run_until_complete(h.write_pass(payloads, coalesce=True,
                                             writers=3))
got = loop.run_until_complete(h.read_pass(store, 6, [3000] * 6,
                                          coalesce=True, readers=3))
loop.close()
assert got == payloads and len(store) == 6 * 6
from ceph_tpu_torch.osd import cluster_bench
from ceph_tpu_torch.osd.cluster import ECCluster
small = cluster_bench.make_payloads(4, 5000, seed=2)
over = cluster_bench.make_overwrites(small, 2, seed=3)
r = cluster_bench.run_storage_cycle(
    lambda: ECCluster(4, {"k": "2", "m": "1", "device": "cpu"}),
    small, over, writers=2, deadline_s=30.0)
assert r["final"] == dict(small, **over) and r["rebuilt_bytes"] > 0
assert type(r["cluster"].ec).__module__ == "ceph_tpu_torch.plugins.cuda"
from ceph_tpu_torch.tier import tier_bench
t = tier_bench.run_tier_path_bench(ec, n_objects=2, obj_bytes=4096,
                                   iters=1, erasures=1)
assert t["bit_exact"] and t["tier_hits"] >= 2
async def tiered():
    c = ECCluster(4, {"k": "2", "m": "1", "device": "cpu"})
    c.set_tier_mode("writeback")
    await c.write("o", b"t" * 3000)
    for _ in range(2):
        await c.read("o")
    for osd in c.osds:
        await osd.tier_tick()
    hits = sum(o.tier.hits for o in c.osds)
    assert await c.read("o") == b"t" * 3000
    assert sum(o.tier.hits for o in c.osds) == hits + 1
    await c.shutdown()
loop = asyncio.new_event_loop()
loop.run_until_complete(tiered())
loop.close()
reg.preload()
assert {"jerasure", "lrc", "isa", "cuda"} <= set(reg._plugins)
for name, prof in (("regen", {"k": "4", "m": "3", "device": "cpu"}),
                   ("isa", {"k": "4", "m": "2", "backend": "cuda",
                            "device": "cpu"}),
                   ("shec", {"backend": "cuda", "device": "cpu"}),
                   ("lrc", {"k": "4", "m": "2", "l": "3"}),
                   ("example", {})):
    pec = reg.factory(name, prof)
    km = pec.get_chunk_count()
    raw = np.random.RandomState(3).randint(0, 256, 5000, dtype=np.uint8)
    chunks = pec.encode(set(range(km)), raw)
    back = pec.decode({0}, {c: a for c, a in chunks.items() if c != 0})
    assert np.array_equal(back[0], chunks[0]), name
    assert type(pec).__module__ == "ceph_tpu_torch.plugins." + name
from ceph_tpu_torch.osd import repair_bench
loop = asyncio.new_event_loop()
rp = loop.run_until_complete(repair_bench._run_mode(
    True, n_osds=8, n_objects=4, obj_bytes=6 << 10,
    payloads=[bytes([i]) * (6 << 10) for i in range(4)], victim=0,
    profile=dict(repair_bench.PROFILE, device="cpu")))
loop.close()
assert rp["counters"]["recovery_bytes_saved"] > 0 and rp["drain"][-1] == 0
from ceph_tpu_torch.tools import ec_kernel_sweep, kernel_r4_probe, kernel_r4_split
for tool in (ec_kernel_sweep, kernel_r4_split, kernel_r4_probe):
    assert tool.main(["--device", "cpu", "--iters", "1"]) == 0
import tempfile
from ceph_tpu_torch import objectstore
from ceph_tpu_torch.auth.caps import OSDCap, op_capable
from ceph_tpu_torch.osd.types import Transaction
assert op_capable(OSDCap.parse("allow r pool=p"), "p", "o", "read")
with tempfile.TemporaryDirectory() as tmp:
    for kind in ("filestore", "kstore", "blockstore", "blockstore:zlib"):
        s = objectstore.create(kind, f"{tmp}/{kind}")
        s.queue_transaction(Transaction().write("o", 0, b"z" * 70000)
                            .omap_setkeys("o", {"k": b"v"}))
        s.umount()
        s = objectstore.create(kind, f"{tmp}/{kind}")
        assert s.read("o") == b"z" * 70000 and s.omap_get("o") == {"k": b"v"}
        s.umount()
    async def durable(path, write):
        c = await ECCluster.create_with_mons(
            6, {"k": "2", "m": "1", "device": "cpu"}, n_mons=3,
            objectstore="blockstore", data_path=path)
        meta = c.add_pool("meta", pool_type="replicated", size=3)
        if write:
            await c.write("d", b"e" * 9000)
            await meta.write("i", b"m" * 100)
            await meta.omap_set("i", {"k": b"v"})
        assert await c.read("d") == b"e" * 9000
        assert await meta.read("i") == b"m" * 100
        assert await meta.omap_get("i") == {"k": b"v"}
        rc, st = await c.mon_command({"prefix": "status"})
        assert rc == 0 and st["leader"] == 0
        await c.shutdown()  # no umount: the next pass remounts a crash
    for write in (True, False):
        loop = asyncio.new_event_loop()
        loop.run_until_complete(durable(f"{tmp}/cluster", write))
        loop.close()
import contextlib, io
from ceph_tpu_torch import entry, parallel
parallel.configure_devices(["cpu"] * 4)
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    entry.dryrun_multichip(4, fast=True)
assert buf.getvalue().startswith("dryrun_multichip ok (fast)")
parallel.configure_devices(None)
from ceph_tpu_torch.client import Rados
from ceph_tpu_torch.utils.encoding import Encoder
rados = Rados(n_osds=6)
io_a = rados.pool_create("cls", {"k": "2", "m": "1", "device": "cpu"})
io_b = rados.open_ioctx("cls")
io_a.write_full("hdr", b"h" * 5000)
assert io_a.lock_exclusive("hdr", "l", "a") == 0
assert io_b.lock_exclusive("hdr", "l", "b") == -16
assert io_a.exec("hdr", "rbd", "create",
                 Encoder().value({"size": 1 << 22}).bytes())[0] == 0
assert io_b.exec("hdr", "version", "inc")[0] == 0
assert io_b.read("hdr") == b"h" * 5000
from ceph_tpu_torch.mgr import MgrDaemon
async def scrape(c):
    d = MgrDaemon(c)
    port = await d.start()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(b"GET /metrics HTTP/1.1\r\n\r\n")
    await writer.drain()
    body = await reader.read()
    writer.close()
    await d.stop()
    return body.decode()
text = rados._run(scrape(io_a._cluster))
assert "ceph_library_builds_total " in text and "ceph_osd_up{" in text
rados.shutdown()
from ceph_tpu_torch.osd import elastic_bench
el = elastic_bench.run_elastic_path_bench(
    smoke=True, profile=dict(elastic_bench.PROFILE, device="cpu"))
assert el["bit_exact"] and el["data_moved_ratio"] <= 1.25
from ceph_tpu_torch.auth import KeyRing
from ceph_tpu_torch.msg import cluster_bench as msg_bench
ring = KeyRing()
for ent in ("osd.0", "osd.1", "osd.2", "client"):
    ring.add(ent)
from ceph_tpu_torch.native import wire_codec
from ceph_tpu_torch.profiling import ledger
assert msg_bench.wire_codec_name() == "native"
assert ledger.marker_class() is wire_codec.native().Stage
wire_payloads = msg_bench.make_payloads(6, 3000, seed=4)
loop = asyncio.new_event_loop()
wc = loop.run_until_complete(msg_bench._one_cycle(
    reg.factory("cuda", {"k": "2", "m": "1", "device": "cpu"}),
    3, wire_payloads, 2, cork=True, keyring=ring))
loop.close()
assert wc["counters"]["tcp_conns"] > 0 and wc["counters"]["frames_sent"] > 0
assert len(wc["_shards"]) == 6 * 3
from ceph_tpu_torch.tools import wire_fuzz
assert wire_fuzz.run_fuzz(cases=20, ring_cases=5)["ok"]
from ceph_tpu_torch.osdc.rados_striper import RadosStriper
from ceph_tpu_torch.osdc.journaler import Journaler
async def osdc():
    c = ECCluster(4, {"k": "2", "m": "1", "device": "cpu"})
    rs = RadosStriper(c.backend, object_size=64 << 10, stripe_unit=16 << 10,
                      stripe_count=2)
    await rs.write("f", b"s" * 100000)
    assert await rs.read("f") == b"s" * 100000
    j = Journaler(c.backend, "j", object_size=4096)
    await j.open()
    await j.append({"n": 1})
    assert [e for _p, e in await j.replay()] == [{"n": 1}]
    await c.shutdown()
loop = asyncio.new_event_loop()
loop.run_until_complete(osdc())
loop.close()
import os
import struct
import tempfile
from ceph_tpu_torch.mds import CephFS, MultiMDS
from ceph_tpu_torch.rbd.nbd import NBDServer
from ceph_tpu_torch.tools import rbd_cli
from ceph_tpu_torch.rbd import RBD, Image
from ceph_tpu_torch.rgw import RGWGateway, sign_v2
async def services():
    c = ECCluster(4, {"k": "2", "m": "1", "device": "cpu"})
    await RBD(c.backend).create("img", 1 << 20, order=16)
    img = await Image.open(c.backend, "img")
    await img.write(70000, b"r" * 5000)
    assert await img.read(69999, 5002) == b"\0" + b"r" * 5000 + b"\0"
    gw = RGWGateway(c.backend)
    await gw.create_user("a", "s")
    port = await gw.start()
    async def s3(method, target, body=b""):
        date = "Thu, 01 Jan 2026 00:00:00 GMT"
        sig = sign_v2("s", method, target, date)
        r, w = await asyncio.open_connection("127.0.0.1", port)
        w.write(f"{method} {target} HTTP/1.1\r\nDate: {date}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Authorization: AWS a:{sig}\r\n\r\n".encode() + body)
        raw = await r.read()
        w.close()
        head, _, payload = raw.partition(b"\r\n\r\n")
        return int(head.split()[1]), payload
    assert (await s3("PUT", "/b"))[0] == 200
    assert (await s3("PUT", "/b/k", b"g" * 9000))[0] == 200
    assert await s3("GET", "/b/k") == (200, b"g" * 9000)
    await gw.stop()
    nbd = NBDServer(c.backend)
    port = await nbd.start()
    r, w = await asyncio.open_connection("127.0.0.1", port)
    await r.readexactly(18)
    w.write(struct.pack(">I", 2) + struct.pack(">QII", 0x49484156454F5054,
                                               1, 3) + b"img")
    assert struct.unpack(">QH", await r.readexactly(10))[0] == 1 << 20
    w.write(struct.pack(">IHHQQI", 0x25609513, 0, 0, 1, 70000, 8))
    assert (await r.readexactly(24))[16:] == b"r" * 8
    w.close()
    await nbd.stop()
    fs = await CephFS.mount(c.backend)
    await fs.mkdirs("/d/e")
    await fs.write_file("/d/e/f", b"c" * 3000)
    assert await fs.read_file("/d/e/f") == b"c" * 3000
    assert await fs.readdir("/d") == ["e"]
    multi = MultiMDS(c.backend, n_ranks=2)
    await multi.start()
    await multi.mkdir("/m")
    await multi.export_subtree("/m", 1)
    await multi.create("/m/x")
    assert multi.rank_of("/m/x") == 1
    await c.shutdown()
loop = asyncio.new_event_loop()
loop.run_until_complete(services())
loop.close()
with tempfile.TemporaryDirectory() as tmp:
    src, dst = os.path.join(tmp, "src"), os.path.join(tmp, "dst")
    with open(src, "wb") as f:
        f.write(b"cli" * 30000)
    base = ["--data-path", os.path.join(tmp, "data"), "--osds", "4",
            "--device", "cpu"]
    assert rbd_cli.main(["import", src, "disk", "--order", "16", *base]) == 0
    assert rbd_cli.main(["export", "disk", dst, *base]) == 0
    with open(dst, "rb") as f:
        assert f.read() == b"cli" * 30000
loop.close()
assert not any(m in ("jax", "tools", "experiments")
               or m.startswith(("jax.", "ceph_tpu.", "tools.", "experiments."))
               for m, mod in sys.modules.items() if mod is not None)
print("imported", len(names))
"""


def test_port_runs_where_jax_and_the_reference_cannot_import():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) > 15


def _string_constants(tree):
    """String constants of a module, less its docstrings."""
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [n for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_native_layer_names_no_path_of_the_jax_package():
    from ceph_tpu_torch.native import build

    assert build.SOURCE_DIR == PORT / "native"
    assert build.BUILD_DIR == PORT / "build"
    for name in build.SOURCES + build.WIRE_SOURCES:
        assert (PORT / "native" / name).is_file(), name
    cxx = "g++"
    for stage in build.commands(cxx):
        for cmd in stage:
            paths = [a for a in cmd[1:] if "/" in a and
                     not a.startswith(("-Wl,", "-I"))]
            assert paths and all(
                Path(a).parent == PORT / "native" for a in paths), cmd
            assert not any("ceph_tpu/" in a for a in cmd), cmd
    native = sorted((PORT / "native").glob("*.py")) + [
        PORT / "ops" / "native_engine.py"]
    for path in native:
        tree = ast.parse(path.read_text(), filename=str(path))
        bad = [c.value for c in _string_constants(tree)
               if "ceph_tpu/" in c.value or c.value == "ceph_tpu"]
        assert not bad, (path.name, bad)
    for path in sorted((PORT / "native").glob("*.[ch]*")):
        code = [line for line in path.read_text().splitlines()
                if line.lstrip().startswith("#include")]
        assert not any("ceph_tpu" in line for line in code), path.name


_NATIVE_PROBE = r"""
import sys
sys.modules["jax"] = None
sys.modules["ceph_tpu"] = None
import numpy as np
from ceph_tpu_torch.native import gf_native, py_binding, registry_native
assert gf_native.cpu_features()["build"]
assert registry_native.load("xor_native") == 0
assert registry_native.load("regen_native") == 0
assert registry_native.load("fail_to_register_native") == -9
ext = py_binding.load()
assert ext.crc32c(b"123456789") == 0x1CF96D7C
from ceph_tpu_torch.plugins import registry
ec = registry.instance().factory("jerasure", {"backend": "native"})
ec.encode(set(range(3)), np.zeros(4096, np.uint8))
maps = {line.split()[-1] for line in open("/proc/self/maps")
        if line.rstrip().endswith(".so") or ".so." in line}
print("\n".join(sorted(maps)))
"""


def test_native_libraries_are_built_and_loaded_from_the_port_only():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NATIVE_PROBE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    mapped = proc.stdout.split()
    ours = [p for p in mapped if p.startswith(str(REPO) + "/")]
    assert len(ours) >= 4, mapped
    for path in ours:
        assert path.startswith(str(PORT / "build") + "/"), path
    assert not any("/ceph_tpu/" in p for p in mapped), mapped
