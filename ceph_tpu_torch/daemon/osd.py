"""ceph-osd daemon: one OSD process serving EC sub-ops over TCP.

Port of ``ceph_tpu/daemon/osd.py``.  A pool's codec follows its profile:
the ``cuda`` plugin by default (the port's ``DEFAULT_PLUGIN``, where the
JAX package's daemons default to ``jerasure``), on the card unless the
profile says ``device=cpu``; the OSD's device cache tier lives on the
same device.  With ``--cluster-conf`` the daemon builds the conf's codec
before its socket listens and encodes and decodes one stripe through it,
so its kernel library is loaded at boot: a daemon that cannot load it
exits non-zero with the error in its log, before it says ``up``.  In the
mon-integrated boot the conf's profile only picks that device and warms
the codec; the pools themselves still come from the osdmap.  On SIGTERM
the daemon unmounts its object store (a persistent store is whole on
disk after a clean stop).

Reference boot flow: src/ceph_osd.cc (SURVEY.md §3.4) -- global init,
ObjectStore::create, messengers, OSD::init.  Here:

  python -m ceph_tpu_torch.daemon.osd --id N --addr-map map.json \
      [--objectstore filestore --data-path DIR] [--op-queue wpq]

``map.json`` is the cluster address book: {"osd.0": ["127.0.0.1", 7000],
..., "client": [...]} (the vstart harness writes it).  The process prints
``osd.N up`` once the socket is listening (the harness's readiness
signal) and runs until SIGTERM/SIGINT.
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys

from ceph_tpu_torch.osd.cluster import DEFAULT_PLUGIN


async def _mon_integrate(args, shard, messenger, addr_map,
                         n_mons: int) -> None:
    """Boot this OSD into the monitor cluster.

    Reference flow (src/osd/OSD.cc:5386-5513 start_boot/_send_boot +
    :4612 handle_osd_ping):

    * ``osd boot`` registers the daemon; the mon marks it up and bumps
      the osdmap epoch;
    * a subscription streams every committed osdmap; the daemon applies
      up/down marks to its messenger, pushes CRUSH weights into hosted
      placements, and HOSTS POOLS it learns from the map (pool create
      flows mon -> daemons, not from a static file);
    * a heartbeat loop probes every peer OSD; a peer silent past
      ``osd_heartbeat_grace`` is reported via ``osd failure``, and the
      mon marks it down once ``mon_osd_min_down_reporters`` distinct
      daemons agree.
    """
    import asyncio

    from ceph_tpu_torch.mon.monitor import MonClient
    from ceph_tpu_torch.utils.config import get_config

    from ceph_tpu_torch.mon.osdmap import apply_map_view

    name = shard.name
    monc = MonClient(messenger, n_mons, name)
    n_osds = sum(1 for k in addr_map if k.startswith("osd."))
    state = {"epoch": 0, "up": {}}
    flags = {"booting": False}
    loop = asyncio.get_event_loop()

    def apply_osdmap(m: dict) -> None:
        if not apply_map_view(
            m, state, messenger,
            placements=[b.placement for b in shard.pools.values()],
            skip_entity=name,
        ):
            return
        if not state["up"].get(shard.osd_id, True) and \
                not flags["booting"]:
            # the map says WE are down but this process is alive (a
            # spurious mark-down): re-boot into the mon (reference
            # OSD::_committed_osd_maps -> start_boot)
            flags["booting"] = True
            messenger.adopt_task(f"{name}.reboot", loop.create_task(boot()))
        # pools flow mon -> daemon: host engines for map pools we lack
        from ceph_tpu_torch.osd.placement import CrushPlacement

        for pname, p in m.get("pools", {}).items():
            if pname in shard.pools:
                # the cache-tier mode flows with every map epoch
                # (`osd tier cache-mode` commits -> broadcast -> here)
                shard.pools[pname].tier_mode = p.get("cache_mode", "none")
                continue
            if p.get("pool_type") == "replicated":
                ec, km = None, int(p["size"])
            else:
                profile = dict(
                    m.get("ec_profiles", {}).get(p["profile_name"], {})
                )
                if not profile:
                    continue  # profile missing from the map: skip
                plugin = profile.pop("plugin", DEFAULT_PLUGIN)
                from ceph_tpu_torch.plugins import registry as registry_mod

                ec = registry_mod.instance().factory(plugin, profile)
                km = ec.get_chunk_count()
            placement = CrushPlacement(n_osds, km, hosts=p.get("hosts"))
            # seed the fresh placement through the shared gate (fresh
            # view state, so the current epoch applies): weight pushes
            # AND elastic map growth stay in one place -- a raw
            # weights[] loop here IndexError'd on ids past n_osds
            apply_map_view(m, {}, None, placements=[placement])
            hosted = shard.host_pool(
                pname, ec, n_osds, placement,
                pool_type=p.get("pool_type", "erasure"),
                size=km, min_size=p.get("min_size") or None,
            )
            hosted.tier_mode = p.get("cache_mode", "none")
        # elastic growth: widen every hosted engine's membership view
        # to the map's max_osd, so peering enumerates osds that joined
        # after boot (ids the addr map doesn't name yet read as down
        # on the messenger until their daemon actually connects)
        for b in shard.pools.values():
            for j in range(len(b.osds), int(m.get("max_osd", 0))):
                b.osds.append(j)
        shard.request_peering()  # re-peer on every map epoch

    async def mon_hook(src, msg):
        if await monc.handle_reply(msg):
            return
        if msg.get("type") == "osdmap":
            apply_osdmap(msg["map"])

    shard.mon_hook = mon_hook

    async def boot():
        flags["booting"] = True
        try:
            while True:
                rc, _out = await monc.command(
                    {"prefix": "osd boot", "osd": shard.osd_id}, timeout=2.0
                )
                if rc == 0:
                    break
                await asyncio.sleep(0.5)  # mons still electing
            await monc.subscribe()
        finally:
            flags["booting"] = False

    async def heartbeat_loop():
        # peer heartbeats + failure reports (OSD.cc:4612 handle_osd_ping
        # -> send_failures).  Steady state is a cheap ping/pong over the
        # CACHED connection (a per-round probe() would cycle
        # every peer's TCP connection); the expensive probe runs only to
        # CONFIRM a peer whose pongs went silent past the grace.
        # membership follows the map: added osds join the ping rounds,
        # removed ones drop out (a boot-frozen list would report a
        # removed id as failed forever)
        def current_peers():
            ids = sorted(state["up"]) if state["up"] else range(n_osds)
            return [j for j in ids if f"osd.{j}" != name]

        start = loop.time()
        for j in current_peers():  # never-ponged peers age from start
            shard.hb_pongs.setdefault(f"osd.{j}", start)
        # budget-bounded fan-out (async-unbounded-fanout): the gathered
        # ping round holds at most this many coroutines in flight no
        # matter how many peers the map grows to
        hb_budget = asyncio.Semaphore(32)

        async def ping_one(j):
            async with hb_budget:
                try:
                    # bound the send: a blackholed peer's TCP connect
                    # would otherwise stall the whole gathered round for
                    # the OS SYN timeout
                    await asyncio.wait_for(
                        messenger.send_message(name, f"osd.{j}", "ping"),
                        timeout=1.0)
                except (OSError, asyncio.TimeoutError):
                    pass  # dead peer: pong stays stale, the grace fires

        async def confirm_down(j):
            async with hb_budget:
                try:
                    return not await messenger.probe(
                        f"osd.{j}", timeout=1.0)
                except (OSError, asyncio.TimeoutError):
                    return True

        while True:
            cfg = get_config()
            await asyncio.sleep(float(cfg.get_val("osd_heartbeat_interval")))
            grace = float(cfg.get_val("osd_heartbeat_grace"))
            peers = current_peers()
            now0 = loop.time()
            for j in peers:  # a just-added peer ages from this round
                shard.hb_pongs.setdefault(f"osd.{j}", now0)
            await asyncio.gather(*(ping_one(j) for j in peers))
            now = loop.time()
            suspects = [
                j for j in peers
                if now - shard.hb_pongs.get(f"osd.{j}", start) >= grace
                and state["up"].get(j, True)
            ]
            if not suspects:
                continue
            confirmed = await asyncio.gather(*(
                confirm_down(j) for j in suspects
            ))
            for j, down in zip(suspects, confirmed):
                if not down:
                    shard.hb_pongs[f"osd.{j}"] = now  # probe answered
                    continue
                # report once per grace window; the mon dedups reporters
                # and the map broadcast stops the loop
                shard.hb_pongs[f"osd.{j}"] = now
                await monc.command(
                    {"prefix": "osd failure", "osd": j, "from": name},
                    timeout=1.0,
                )

    messenger.adopt_task(f"{name}.boot", loop.create_task(boot()))
    messenger.adopt_task(
        f"{name}.heartbeat", loop.create_task(heartbeat_loop())
    )
    shard.start_tick()


def _conf_codec(conf: dict):
    """The codec of a conf's pool profile (None for a replicated pool)
    and its chunk count: the plugin the profile names, else the port's
    default (``cuda``)."""
    from ceph_tpu_torch.plugins import registry as registry_mod

    profile = dict(conf["profile"])
    pool_type = profile.pop("pool_type", conf.get("pool_type", "erasure"))
    if pool_type == "replicated":
        return None, int(profile.get("size", 3))
    plugin = profile.pop("plugin", DEFAULT_PLUGIN)
    ec = registry_mod.instance().factory(plugin, profile)
    return ec, ec.get_chunk_count()


async def serve(args) -> None:
    from ceph_tpu_torch.device import codec_device
    from ceph_tpu_torch.msg.tcp import TCPMessenger
    from ceph_tpu_torch.osd.ecbackend import OSDShard
    from ceph_tpu_torch.osd.elastic_bench import warm_codec

    from ceph_tpu_torch.utils import aio

    addr_map = {
        k: tuple(v)
        for k, v in (await aio.read_json(args.addr_map)).items()
    }
    name = f"osd.{args.id}"
    keyring = None
    if args.keyring:
        from ceph_tpu_torch.auth import KeyRing

        keyring = KeyRing.load(args.keyring)
    messenger = TCPMessenger(name, addr_map, keyring=keyring)
    mon_ranks = sorted(
        int(k.split(".", 1)[1]) for k in addr_map if k.startswith("mon.")
    )
    conf = None
    ec, km = None, 0
    if args.cluster_conf:
        # read the pool conf BEFORE the socket listens: the moment
        # start() returns, peers replay queued lossless sub-ops (a
        # revived OSD's backlog), and the stretch from listen to
        # host_pool below must stay yield-free or early ops are
        # dispatched into a shard that "hosts no pool"
        conf = await aio.read_json(args.cluster_conf)
        ec, km = _conf_codec(conf)
        if ec is not None:
            # load the kernel library now: a daemon that cannot exits
            # here, non-zero, instead of failing every op it leads
            warm_codec(ec)
    device = codec_device(ec) if ec is not None else "cuda"
    # the shard (and its object store) before the socket: a daemon whose
    # store cannot mount exits before it ever listens, so the harness's
    # readiness probe never mistakes it for up
    shard = OSDShard(
        args.id, messenger, op_queue=args.op_queue,
        objectstore=args.objectstore, data_path=args.data_path,
        device=device,
    )
    await messenger.start()
    # The socket is LISTENING from the moment start() returns, and peers
    # immediately replay queued lossless sub-ops (a revived OSD's
    # backlog).  The stretch from here to host_pool below must stay
    # yield-free, or early ops are dispatched into a shard that "hosts no
    # pool" (the cluster conf is read BEFORE start() for exactly this
    # reason).
    # cephlint: atomic-section osd-listen-to-host-pool
    if conf is not None and not mon_ranks:
        # legacy static bring-up: host a primary engine for the cluster's
        # pool from a JSON conf: THIS daemon (not the client) owns
        # placement, version authority and sub-op fan-out for objects
        # whose acting set it leads (the PrimaryLogPG role)
        from ceph_tpu_torch.osd.placement import CrushPlacement

        n_osds = sum(1 for k in addr_map if k.startswith("osd."))
        pool_type = "erasure" if ec is not None else "replicated"
        placement = CrushPlacement(n_osds, km, hosts=conf.get("hosts"))
        shard.host_pool(conf.get("pool", "ecpool"), ec, n_osds, placement,
                        pool_type=pool_type, size=km)
        # daemons run peering-driven auto recovery by default (OSD::tick)
        shard.start_tick()
    # cephlint: end-atomic-section
    if mon_ranks:
        # monitor-integrated boot (reference src/ceph_osd.cc:650 ->
        # OSD::start_boot, src/osd/OSD.cc:5386): register with the mon,
        # subscribe to osdmap epochs, learn pools FROM the map, run peer
        # heartbeats and report failures -- no static pool conf needed.
        # (Mon-learned pools arrive via osdmap broadcasts; replayed
        # sub-ops for them are refused un-acked until the map applies,
        # so this branch may yield -- it sits OUTSIDE the section.)
        await _mon_integrate(args, shard, messenger, addr_map,
                             len(mon_ranks))
    # MgrClient report loop (mgr/report.py): when the address
    # map names mgr daemons, beacon + report frames flow to every one
    # of them -- cluster health/status/pg-stat over real TCP derive
    # from THESE frames, never from in-process introspection.  No mgr
    # in the map = telemetry off, zero overhead (the bench baseline).
    from ceph_tpu_torch.mgr.report import ReportSender, mgr_targets_from

    reporter = None
    mgr_targets = mgr_targets_from(addr_map)
    if mgr_targets:
        reporter = ReportSender(name, messenger, shard.mgr_report_stats,
                                mgr_targets, perf=shard.perf)
        reporter.start()
    # admin socket (src/common/admin_socket.cc): perf dump / ops /
    # config show / status over a unix socket next to the data dir
    asok = None
    if args.admin_socket or args.data_path:
        from ceph_tpu_torch.utils.admin_socket import AdminSocket
        from ceph_tpu_torch.utils.config import get_config

        asok_path = args.admin_socket or f"{args.data_path}/{name}.asok"
        asok = AdminSocket(asok_path)
        asok.register("perf dump", lambda cmd: shard.perf.snapshot())
        asok.register("perf histogram dump",
                      lambda cmd: shard.op_hist.snapshot())
        asok.register(
            "ops", lambda cmd: shard.optracker.dump_ops_in_flight()
        )
        asok.register(
            "dump_ops_in_flight",
            lambda cmd: shard.optracker.dump_ops_in_flight(),
        )
        asok.register(
            "dump_historic_ops",
            lambda cmd: shard.optracker.dump_historic_ops(),
        )
        asok.register(
            "dump_historic_slow_ops",
            lambda cmd: shard.optracker.dump_historic_slow_ops(),
        )

        def _trace_status(cmd):
            from ceph_tpu_torch.utils import trace

            return dict(trace.status(), name=name)

        def _trace_dump(cmd):
            from ceph_tpu_torch.utils import trace

            tid = cmd.get("trace_id")
            if tid is not None:
                return trace.dump_trace(int(tid))
            if cmd.get("slow"):
                return trace.dump_slow(cmd.get("count"))
            return trace.dump()

        asok.register("trace status", _trace_status)
        asok.register("trace dump", _trace_dump)

        # wire-tax profiler hooks (profiling/): status/dump/
        # reset; enable at runtime via `config set profile_mode on`
        # (the config-set hook below re-applies through configure())
        from ceph_tpu_torch import profiling

        asok.register("profile status",
                      lambda cmd: dict(profiling.asok_status(cmd),
                                       name=name))
        asok.register("profile dump", profiling.asok_dump)
        asok.register("profile reset", profiling.asok_reset)
        # a runtime `config set profile_mode on` installs/uninstalls
        # the profiler arms through the normal observer plumbing
        get_config().add_observer(
            lambda changed: profiling.configure()
            if "profile_mode" in changed else None)
        profiling.configure()  # apply env/conf-selected mode at boot
        asok.register(
            "config show", lambda cmd: get_config().show_config()
        )
        asok.register(
            "config set",
            lambda cmd: get_config().apply_changes(
                {cmd["key"]: cmd["value"]}
            ) or {"success": True},
        )
        def _live_objects():
            # removal tombstones are durable state but not live objects:
            # ls and df must agree the deleted name is gone.  Two kinds:
            # meta-plane tombstones (_meta_removed) and replicated-pool
            # data tombstones (whiteout "removed",
            # osd/replicated.py).
            from ceph_tpu_torch.osd.pg import WHITEOUT_KEY

            out = []
            for o in shard.store.list_objects():
                if o.endswith("@meta") and \
                        shard.store.getattr(o, "_meta_removed"):
                    continue
                if shard.store.getattr(o, WHITEOUT_KEY) == "removed":
                    continue
                out.append(o)
            return out

        asok.register("status", lambda cmd: {
            "name": name,
            "objects": len(_live_objects()),
            "pools": sorted(shard.pools),
        })
        asok.register("list_objects", lambda cmd: sorted(_live_objects()))
        asok.register("tier status", lambda cmd: dict(
            shard.tier.status(), name=name,
            modes={p: b.tier_mode for p, b in shard.pools.items()},
        ))
        def _residency_status(cmd):
            from ceph_tpu_torch.analysis import residency

            return residency.status()

        asok.register("residency status", _residency_status)

        def _recovery_status(cmd):
            # background data-plane health (osd/recovery.py): batched
            # rebuild counters, scrub cursor progress, throttle
            # preemptions, per-pool dirty (pg_missing) depth and knobs
            snap = shard.perf.snapshot()
            return {
                "name": name,
                "batched": bool(get_config().get_val(
                    "osd_recovery_batched")),
                "counters": {
                    key: snap.get(key, 0)
                    for key in ("recovery_ops_batched", "recovery_bytes",
                                "recovery_batches", "recovery_preempted",
                                "recover", "recover_window",
                                "recover_failed", "scrub_chunks",
                                "tier_promote_from_recovery")
                },
                "client_ops_queued": shard._client_ops_queued,
                "dirty_objects": {
                    pool: len(b._dirty) + len(b._dirty_meta)
                    for pool, b in shard.pools.items()
                },
                "knobs": {
                    key: get_config().get_val(key)
                    for key in ("osd_recovery_max_active",
                                "osd_recovery_batch_bytes",
                                "osd_recovery_sleep",
                                "osd_scrub_chunk_max",
                                "osd_tier_promote_on_recovery")
                },
            }

        asok.register("recovery status", _recovery_status)
        asok.register("hit_set ls", lambda cmd: shard.hitsets.dump())
        asok.register("hit_set temperature", lambda cmd: {
            "oid": cmd.get("oid", ""),
            "temperature": shard.hitsets.temperature(cmd.get("oid", "")),
        })
        from ceph_tpu_torch.utils import perfglue

        perfglue.register(asok)  # cpu_profiler start/stop/status
        await asok.start()
    print(f"{name} up", flush=True)

    # startup warm-up is over: freeze the boot heap out of the
    # collector (gc_freeze_on_start; the GC-pause fix -- full
    # collections stop re-tracing codecs/maps/config every pause)
    from ceph_tpu_torch.utils import gcopt

    gcopt.freeze_after_warmup()
    stop = asyncio.Event()
    loop = asyncio.get_event_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    if reporter is not None:
        reporter.stop()
    if asok is not None:
        await asok.stop()
    await messenger.shutdown()
    # a clean stop leaves the store whole on disk (the blockstore's WAL
    # flushed and closed) and settles the device ledger
    shard.tier.clear()
    umount = getattr(shard.store, "umount", None)
    if umount is not None:
        umount()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--id", type=int, required=True)
    ap.add_argument("--addr-map", required=True)
    ap.add_argument("--objectstore", default="memstore")
    ap.add_argument("--data-path", default="")
    ap.add_argument("--op-queue", default="wpq")
    ap.add_argument("--keyring", default="",
                    help="keyring file enabling cephx-style auth")
    ap.add_argument("--admin-socket", default="",
                    help="unix socket path for daemon introspection "
                         "(default <data-path>/<name>.asok)")
    ap.add_argument("--cluster-conf", default="",
                    help="cluster.json with the pool profile: this OSD "
                         "hosts a primary engine for the pool")
    args = ap.parse_args(argv)
    try:
        asyncio.run(serve(args))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
