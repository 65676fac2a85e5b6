#!/usr/bin/env python3
"""Developer mini-cluster over real processes (vstart.sh analogue).

Port of ``tools/vstart.py``: the daemons are ``python -m
ceph_tpu_torch.daemon.{osd,mon,mgr}``.  A pool's profile decides where
its chunk math runs, as everywhere in the port: the ``cuda`` plugin by
default, on the card, and on the CPU only where the profile says
``device=cpu``; each OSD process then makes its own CUDA context.
Nothing here downgrades a profile: a profile on ``cuda`` raises without
CUDA.  Before it spawns a daemon, :func:`start_cluster` builds (or finds)
in this process what the daemons load -- the host libraries and, for a
pool on the card, the kernel library -- so N daemons booting on a cold
tree do not each run the compilers at once.  A daemon that exits before
it is up (it could not load the library, or its store) makes
:func:`start_cluster` stop the cluster and raise, naming the daemon and
its log.

Reference: src/vstart.sh boots mon/mgr/osd daemons on loopback ports for
development; qa/standalone/ceph-helpers.sh (run_osd/kill_daemons) drives
the same layout from tests.  Here:

  python -m ceph_tpu_torch.tools.vstart start --dir RUN --osds 6 \
      --k 4 --m 2 [--objectstore filestore] [--device cpu]
  python -m ceph_tpu_torch.tools.vstart status --dir RUN
  python -m ceph_tpu_torch.tools.vstart put --dir RUN OID FILE
  python -m ceph_tpu_torch.tools.vstart get --dir RUN OID [FILE]
  python -m ceph_tpu_torch.tools.vstart kill-osd --dir RUN N
  python -m ceph_tpu_torch.tools.vstart stop --dir RUN

``RUN/addr_map.json`` is the cluster address book; ``RUN/cluster.json``
records the EC profile; pids live in ``RUN/pids``; each daemon writes
``RUN/<name>.log`` and its admin socket ``RUN/data/<name>.asok`` (keep
``RUN`` short: a socket path must fit in 107 bytes).
"""

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _daemon_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def prebuild(profile):
    """Build (or find) the libraries a daemon of ``profile``'s pool
    loads, once, in this process: crc32c, the native wire codec and, for
    a pool whose codec runs on the card, the kernel library.  Every build
    is keyed by its digest and lands atomically, so the daemons then only
    load.  Raises where the profile's codec cannot be made (``cuda``
    without CUDA)."""
    from ceph_tpu_torch.device import codec_device
    from ceph_tpu_torch.native import build as native_build
    from ceph_tpu_torch.native import gf_native
    from ceph_tpu_torch.osd.cluster import DEFAULT_PLUGIN
    from ceph_tpu_torch.plugins import registry as registry_mod

    gf_native.build()
    native_build.wire_ext()
    profile = dict(profile)
    if profile.pop("pool_type", "erasure") == "replicated":
        return
    plugin = profile.pop("plugin", DEFAULT_PLUGIN)
    ec = registry_mod.instance().factory(plugin, profile)
    if codec_device(ec).type == "cuda":
        from ceph_tpu_torch.ops import cuda_gf

        cuda_gf.build()


def _log_path(run_dir, who):
    return os.path.join(run_dir, f"{who}.log")


#: pid -> Popen of the daemons this process spawned (kept referenced:
#: a collected Popen of a running child lets ``subprocess`` reap it
#: behind our back, and its exit status would be lost)
_PROCS = {}


def _spawn(cmd, log_path):
    with open(log_path, "ab") as log:
        proc = subprocess.Popen(
            cmd, stdout=log, stderr=log, env=_daemon_env(), cwd=REPO,
        )
    _PROCS[proc.pid] = proc
    return proc.pid


def _check_alive(run_dir, who, pid):
    """Raise if the daemon ``who`` (``pid``) has exited, naming it, its
    exit status and its log (whose tail is quoted)."""
    proc = _PROCS.get(pid)
    if proc is None or proc.poll() is None:
        return  # running, or not spawned here (its port decides)
    log = _log_path(run_dir, who)
    try:
        with open(log, errors="replace") as f:
            tail = f.read()[-2000:]
    except FileNotFoundError:
        tail = ""
    raise RuntimeError(
        f"{who} (pid {pid}) exited with status {proc.returncode} "
        f"before it was up; "
        f"log {log}:\n{tail}")


def start_cluster(run_dir, n_osds, profile, objectstore="memstore",
                  op_queue="wpq", wait=60.0, auth=False, n_mons=0,
                  n_mgrs=1):
    """Boot n_osds daemon processes; returns the addr map path.
    Library entry point used by the CLI and the standalone tests.
    With auth=True a keyring is generated and every connection runs the
    cephx-style handshake + message signing (vstart.sh enables cephx by
    default too).

    With ``n_mons`` > 0 the cluster is MONITOR-INTEGRATED (the reference
    vstart.sh shape: mons boot first, pools are created through the mon,
    OSDs boot INTO the mon and learn pools from osdmap broadcasts,
    peer heartbeats drive mon mark-down).

    ``n_mgrs`` (default 1, like vstart.sh) spawns mgr daemon processes:
    every OSD/mon discovers ``mgr.*`` in the address map and runs its
    MgrClient report loop against them, so ``rados_cli status / health
    / pg stat`` work against the live cluster from wire-fed telemetry
    alone.  0 disables telemetry entirely (the reports-off baseline).

    ``wait`` bounds each boot stage (the JAX package's 10 s is the CPU's:
    a daemon on the card loads torch and makes its CUDA context first;
    12 of them took 25-32 s on the H100 machine's 8 host cores)."""
    os.makedirs(run_dir, exist_ok=True)
    prebuild(profile)
    try:
        return _start(run_dir, n_osds, profile, objectstore, op_queue,
                      wait, auth, n_mons, n_mgrs)
    except BaseException:
        stop_cluster(run_dir)
        raise


def _start(run_dir, n_osds, profile, objectstore, op_queue, wait, auth,
           n_mons, n_mgrs):
    ports = _free_ports(n_osds + n_mons + n_mgrs + 1)
    addr_map = {f"osd.{i}": ("127.0.0.1", ports[i]) for i in range(n_osds)}
    for r in range(n_mons):
        addr_map[f"mon.{r}"] = ("127.0.0.1", ports[n_osds + r])
    for r in range(n_mgrs):
        addr_map[f"mgr.{r}"] = ("127.0.0.1", ports[n_osds + n_mons + r])
    addr_map["client"] = ("127.0.0.1", ports[n_osds + n_mons + n_mgrs])
    map_path = os.path.join(run_dir, "addr_map.json")
    with open(map_path, "w") as f:
        json.dump(addr_map, f)
    if auth:
        from ceph_tpu_torch.auth import KeyRing

        ring = KeyRing()
        if n_mons:
            # mon-backed provisioning (the ceph-deploy/ceph-authtool
            # bootstrap flow): only the mon + bootstrap-client + mgr
            # keys are generated locally; OSD keys are minted THROUGH
            # the AuthMonitor (`auth get-or-create`) during bootstrap
            # and appended to the keyring before the OSDs spawn
            for r in range(n_mons):
                ring.add(f"mon.{r}")
            for r in range(n_mgrs):
                ring.add(f"mgr.{r}")
            ring.add("client")
        else:
            for entity in addr_map:
                ring.add(entity)
        ring.save(os.path.join(run_dir, "keyring"))
    with open(os.path.join(run_dir, "cluster.json"), "w") as f:
        json.dump({"profile": profile, "n_osds": n_osds,
                   "objectstore": objectstore, "auth": auth,
                   "n_mons": n_mons, "n_mgrs": n_mgrs}, f)
    data_path = os.path.join(run_dir, "data")
    if n_mons:
        mon_deadline = time.time() + wait
        mon_pids = {r: spawn_mon(run_dir, r, n_mons, auth=auth)
                    for r in range(n_mons)}
        with open(os.path.join(run_dir, "mon_pids"), "w") as f:
            json.dump({str(r): p for r, p in mon_pids.items()}, f)
        for r in range(n_mons):
            _wait_port(addr_map[f"mon.{r}"], mon_deadline, f"mon.{r}",
                       run_dir, mon_pids[r])
        # pools flow mon -> daemons: create them BEFORE the osds boot so
        # the subscription's first map already carries them; with auth,
        # OSD keys are minted through the AuthMonitor here too
        import asyncio as _asyncio

        _asyncio.new_event_loop().run_until_complete(
            _bootstrap_pools(run_dir, n_osds, profile, auth=auth)
        )
    if n_mgrs:
        # mgr daemons boot alongside: they only LISTEN for beacon/report
        # frames, so ordering vs OSDs does not matter -- but their port
        # must be up before rados_cli's first status call
        mgr_pids = {r: spawn_mgr(run_dir, r, data_path=data_path,
                                 auth=auth)
                    for r in range(n_mgrs)}
        with open(os.path.join(run_dir, "mgr_pids"), "w") as f:
            json.dump({str(r): p for r, p in mgr_pids.items()}, f)
    pids = {}
    for i in range(n_osds):
        pids[i] = spawn_osd(run_dir, i, objectstore=objectstore,
                            op_queue=op_queue, data_path=data_path,
                            auth=auth)
    _save_pids(run_dir, pids)
    # readiness: every daemon's port accepts connections.  Fresh budget:
    # slow mon quorum formation above must not eat the OSDs' allowance.
    deadline = time.time() + wait
    for i in range(n_osds):
        _wait_port(addr_map[f"osd.{i}"], deadline, f"osd.{i}", run_dir,
                   pids[i])
    for r in range(n_mgrs):
        _wait_port(addr_map[f"mgr.{r}"], deadline, f"mgr.{r}", run_dir,
                   mgr_pids[r])
    if n_mons:
        # mon-integrated daemons learn their pools from the osdmap
        # SUBSCRIPTION after boot: a client dispatching the instant the
        # ports open can land on an OSD that hosts no pool yet.  Poll
        # the admin sockets until every daemon hosts the pool.
        _wait_pools(n_osds, data_path, deadline + wait)
    return map_path


def _wait_pools(n_osds, data_path, deadline):
    import asyncio

    from ceph_tpu_torch.utils.admin_socket import admin_command

    async def ready(i):
        try:
            st = await admin_command(
                os.path.join(data_path, f"osd.{i}.asok"), "status")
            return bool(st.get("pools"))
        except (OSError, ValueError):
            # ValueError covers a daemon dying mid-reply (empty/truncated
            # JSON); either way this OSD is simply not ready yet
            return False

    async def wait_all():
        pending = set(range(n_osds))
        while pending:
            done = {i for i in pending if await ready(i)}
            pending -= done
            if not pending:
                return
            if time.time() > deadline:
                raise TimeoutError(
                    f"osds {sorted(pending)} never hosted the pool")
            await asyncio.sleep(0.1)

    asyncio.new_event_loop().run_until_complete(wait_all())


def _wait_port(addr, deadline, who, run_dir, pid):
    host, port = addr
    while True:
        try:
            socket.create_connection((host, port), timeout=0.25).close()
            return
        except OSError:
            _check_alive(run_dir, who, pid)
            if time.time() > deadline:
                raise TimeoutError(
                    f"{who} did not come up; log "
                    f"{_log_path(run_dir, who)}")
            time.sleep(0.05)


def spawn_mgr(run_dir, rank, data_path=None, auth=False):
    """Start one mgr daemon process (wire-fed telemetry endpoint);
    returns its pid.  The admin socket lands next to the OSDs' so
    rados_cli finds it with the same glob."""
    data_path = data_path or os.path.join(run_dir, "data")
    os.makedirs(data_path, exist_ok=True)
    log_path = _log_path(run_dir, f"mgr.{rank}")
    cmd = [sys.executable, "-m", "ceph_tpu_torch.daemon.mgr",
           "--rank", str(rank),
           "--addr-map", os.path.join(run_dir, "addr_map.json"),
           "--admin-socket", os.path.join(data_path, f"mgr.{rank}.asok")]
    if auth:
        cmd += ["--keyring", os.path.join(run_dir, "keyring")]
    return _spawn(cmd, log_path)


def spawn_mon(run_dir, rank, n_mons, auth=False):
    """Start one monitor daemon process; returns its pid."""
    log_path = _log_path(run_dir, f"mon.{rank}")
    store = os.path.join(run_dir, "mon", str(rank))
    os.makedirs(store, exist_ok=True)
    cmd = [sys.executable, "-m", "ceph_tpu_torch.daemon.mon",
           "--rank", str(rank), "--mons", str(n_mons),
           "--addr-map", os.path.join(run_dir, "addr_map.json"),
           "--store-path", store]
    if auth:
        cmd += ["--keyring", os.path.join(run_dir, "keyring")]
    return _spawn(cmd, log_path)


async def _bootstrap_pools(run_dir, n_osds, profile, pool="ecpool",
                           auth=False):
    """Create osds + the pool through the mon quorum (the `ceph osd ...`
    command flow, reference src/mon/OSDMonitor.cc); with auth, mint the
    OSD keys through the AuthMonitor and append them to the keyring the
    daemons will load (the ceph-authtool provisioning flow)."""
    import asyncio

    from ceph_tpu_torch.mon.monitor import MonClient
    from ceph_tpu_torch.msg.tcp import TCPMessenger

    from ceph_tpu_torch.utils import aio

    addr_map = {
        k: tuple(v) for k, v in
        (await aio.read_json(os.path.join(run_dir,
                                          "addr_map.json"))).items()
    }
    n_mons = sum(1 for k in addr_map if k.startswith("mon."))
    keyring = None
    if auth:
        from ceph_tpu_torch.auth import KeyRing

        keyring = KeyRing.load(os.path.join(run_dir, "keyring"))
    ms = TCPMessenger("client", addr_map, keyring=keyring)
    await ms.start()
    monc = MonClient(ms, n_mons, "client")

    async def dispatch(src, msg):
        if isinstance(msg, dict):
            await monc.handle_reply(msg)

    ms.register("client", dispatch)
    try:
        deadline = time.time() + 15
        while True:  # quorum may still be forming
            rc, out = await monc.command(
                {"prefix": "osd create", "n": n_osds}, timeout=2.0
            )
            if rc == 0:
                break
            if time.time() > deadline:
                raise TimeoutError(f"mon bootstrap failed: {out}")
            await asyncio.sleep(0.4)
        if profile.get("pool_type") == "replicated":
            rc, out = await monc.command({
                "prefix": "osd pool create", "name": pool,
                "pool_type": "replicated", "size": int(profile["size"]),
            })
        else:
            rc, out = await monc.command({
                "prefix": "osd erasure-code-profile set",
                "name": f"{pool}-profile", "profile": profile,
            })
            if rc != 0:
                raise RuntimeError(f"profile set: {out}")
            rc, out = await monc.command({
                "prefix": "osd pool create", "name": pool,
                "profile": f"{pool}-profile",
            })
        if rc != 0:
            raise RuntimeError(f"pool create: {out}")
        if auth:
            # mint the OSD keys through the AuthMonitor and persist them
            # for the daemons (reference: `ceph auth get-or-create osd.N`
            # at provisioning time)
            for i in range(n_osds):
                rc, out = await monc.command({
                    "prefix": "auth get-or-create", "entity": f"osd.{i}",
                    "caps": {"osd": "allow *"},
                }, timeout=5.0)
                if rc != 0:
                    raise RuntimeError(f"auth get-or-create osd.{i}: {out}")
                keyring.add(f"osd.{i}", bytes.fromhex(out["key"]))
            keyring.save(os.path.join(run_dir, "keyring"))
    finally:
        await ms.shutdown()


def spawn_osd(run_dir, osd_id, objectstore="memstore", op_queue="wpq",
              data_path=None, auth=False):
    """Start (or restart) one OSD daemon process; returns its pid."""
    data_path = data_path or os.path.join(run_dir, "data")
    log_path = _log_path(run_dir, f"osd.{osd_id}")
    cmd = [sys.executable, "-m", "ceph_tpu_torch.daemon.osd",
           "--id", str(osd_id),
           "--addr-map", os.path.join(run_dir, "addr_map.json"),
           "--objectstore", objectstore,
           "--data-path", data_path,
           "--op-queue", op_queue,
           "--cluster-conf", os.path.join(run_dir, "cluster.json")]
    if auth:
        cmd += ["--keyring", os.path.join(run_dir, "keyring")]
    return _spawn(cmd, log_path)


def _save_pids(run_dir, pids):
    with open(os.path.join(run_dir, "pids"), "w") as f:
        json.dump({str(k): v for k, v in pids.items()}, f)


def _load_pids(run_dir):
    try:
        with open(os.path.join(run_dir, "pids")) as f:
            return {int(k): v for k, v in json.load(f).items()}
    except FileNotFoundError:
        return {}


def kill_osd(run_dir, osd_id, sig=signal.SIGKILL):
    pids = _load_pids(run_dir)
    pid = pids.get(osd_id)
    if pid is None:
        return False
    try:
        os.kill(pid, sig)
        os.waitpid(pid, 0)
    except (ProcessLookupError, ChildProcessError):
        pass  # already gone, or reaped by _check_alive
    _PROCS.pop(pid, None)
    del pids[osd_id]
    _save_pids(run_dir, pids)
    return True


def revive_osd(run_dir, osd_id, wait=30.0):
    """Respawn ``osd.<osd_id>`` on its data and wait for its port (a
    daemon on the card takes seconds to load torch and make its CUDA
    context: the JAX package's 10 s is the CPU's budget)."""
    with open(os.path.join(run_dir, "cluster.json")) as f:
        conf = json.load(f)
    pids = _load_pids(run_dir)
    pids[osd_id] = spawn_osd(run_dir, osd_id,
                             objectstore=conf["objectstore"],
                             auth=conf.get("auth", False))
    _save_pids(run_dir, pids)
    with open(os.path.join(run_dir, "addr_map.json")) as f:
        addr = json.load(f)[f"osd.{osd_id}"]
    _wait_port(addr, time.time() + wait, f"osd.{osd_id}", run_dir,
               pids[osd_id])


def stop_cluster(run_dir):
    pids = dict(_load_pids(run_dir))
    for extra in ("mon_pids", "mgr_pids"):
        try:
            with open(os.path.join(run_dir, extra)) as f:
                pids.update({f"{extra[:3]}.{k}": v
                             for k, v in json.load(f).items()})
        except FileNotFoundError:
            pass
    for pid in pids.values():
        try:
            os.kill(pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
    # bounded graceful wait, then SIGKILL: a daemon that wedges inside
    # its own SIGTERM shutdown must not hang this caller forever (the
    # unbounded waitpid here turned one stuck daemon into a stuck test
    # run) nor leak as an orphan holding its port
    deadline = time.time() + 10.0
    for pid in pids.values():
        while True:
            try:
                if os.waitpid(pid, os.WNOHANG)[0]:
                    break  # reaped
            except (ChildProcessError, ProcessLookupError):
                # not our child (CLI stop from another process) or
                # already reaped: poll raw liveness instead
                try:
                    os.kill(pid, 0)
                except ProcessLookupError:
                    break  # gone
            if time.time() > deadline:
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                try:
                    os.waitpid(pid, 0)
                except (ChildProcessError, ProcessLookupError):
                    pass
                break
            time.sleep(0.05)
    for pid in pids.values():
        _PROCS.pop(pid, None)
    _save_pids(run_dir, {})
    for extra in ("mon_pids", "mgr_pids"):
        try:
            os.remove(os.path.join(run_dir, extra))
        except FileNotFoundError:
            pass


async def _client(run_dir):
    from ceph_tpu_torch.daemon.client import RemoteClient
    from ceph_tpu_torch.utils import aio

    conf = await aio.read_json(os.path.join(run_dir, "cluster.json"))
    keyring = (
        os.path.join(run_dir, "keyring") if conf.get("auth") else None
    )
    c = await RemoteClient.connect(
        os.path.join(run_dir, "addr_map.json"), conf["profile"],
        keyring=keyring,
    )
    await c.probe_osds()
    return c


def main(argv=None):
    import asyncio

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("cmd", choices=["start", "stop", "status", "put", "get",
                                    "kill-osd", "revive-osd"])
    ap.add_argument("args", nargs="*")
    ap.add_argument("--dir", default="./vstart-run")
    ap.add_argument("--osds", type=int, default=6)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--plugin", default="cuda")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where a cuda-plugin pool's chunk math runs "
                         "(cpu adds device=cpu to the profile)")
    ap.add_argument("--pool-type", default="erasure",
                    choices=["erasure", "replicated"],
                    help="pool strategy (reference `ceph osd pool create "
                         "... replicated|erasure`)")
    ap.add_argument("--size", type=int, default=3,
                    help="replica count for --pool-type replicated")
    ap.add_argument("--objectstore", default="memstore")
    ap.add_argument("--auth", action="store_true",
                    help="enable cephx-style auth (keyring + signing)")
    ap.add_argument("--mons", type=int, default=0,
                    help="monitor count; >0 boots a mon quorum, creates "
                         "the pool through it, and OSDs boot into the mon "
                         "(heartbeat mark-down, map-driven pools)")
    ap.add_argument("--mgrs", type=int, default=1,
                    help="mgr daemon count (wire-fed telemetry: daemons "
                         "report to mgr.* from the address map; 0 = "
                         "telemetry off)")
    args = ap.parse_args(argv)

    if args.cmd == "start":
        if args.pool_type == "replicated":
            profile = {"pool_type": "replicated", "size": str(args.size)}
        else:
            profile = {"plugin": args.plugin, "k": str(args.k),
                       "m": str(args.m)}
            if args.device == "cpu":
                profile["device"] = "cpu"
        start_cluster(args.dir, args.osds, profile,
                      objectstore=args.objectstore, auth=args.auth,
                      n_mons=args.mons, n_mgrs=args.mgrs)
        print(f"cluster up: {args.osds} osds"
              + (f", {args.mons} mons" if args.mons else "")
              + (f", {args.mgrs} mgrs" if args.mgrs else "")
              + f", profile {profile}"
              + (" [cephx auth]" if args.auth else ""))
    elif args.cmd == "stop":
        stop_cluster(args.dir)
        print("stopped")
    elif args.cmd == "status":
        pids = _load_pids(args.dir)
        for osd_id, pid in sorted(pids.items()):
            try:
                os.kill(pid, 0)
                state = "up"
            except ProcessLookupError:
                state = "down"
            print(f"osd.{osd_id}: pid {pid} {state}")
    elif args.cmd == "kill-osd":
        kill_osd(args.dir, int(args.args[0]))
        print(f"killed osd.{args.args[0]}")
    elif args.cmd == "revive-osd":
        revive_osd(args.dir, int(args.args[0]))
        print(f"revived osd.{args.args[0]}")
    elif args.cmd == "put":
        oid, path = args.args
        with open(path, "rb") as f:
            data = f.read()

        async def put():
            c = await _client(args.dir)
            await c.write(oid, data)
            await c.close()

        asyncio.run(put())
        print(f"wrote {oid} ({len(data)} bytes)")
    elif args.cmd == "get":
        oid = args.args[0]

        async def get():
            c = await _client(args.dir)
            data = await c.read(oid)
            await c.close()
            return data

        data = asyncio.run(get())
        if len(args.args) > 1:
            with open(args.args[1], "wb") as f:
                f.write(data)
        else:
            sys.stdout.buffer.write(data)
    return 0


if __name__ == "__main__":
    sys.exit(main())
