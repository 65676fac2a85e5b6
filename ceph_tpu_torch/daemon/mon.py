"""ceph-mon daemon: one monitor process over TCP with a durable store.

Port of ``ceph_tpu/daemon/mon.py``.

Reference boot flow: src/ceph_mon.cc -- global init, open the
MonitorDBStore, messenger, Monitor::preinit/bootstrap into an election.
Here:

  python -m ceph_tpu_torch.daemon.mon --rank R --mons N --addr-map map.json \
      [--store-path DIR] [--admin-socket PATH]

``map.json`` must name every monitor (``mon.0``..``mon.N-1``).  The
process prints ``mon.R up`` once the socket listens.  Rank 0 kicks the
first election after a short settle delay; every rank runs the lease
tick, so the quorum re-elects across real process kills and restarts,
and a mon restarted on its store rejoins with its committed state (the
paxos share path catches it up on anything it missed).
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys


async def serve(args) -> None:
    from ceph_tpu_torch.mon.monitor import Monitor
    from ceph_tpu_torch.msg.tcp import TCPMessenger

    from ceph_tpu_torch.utils import aio

    addr_map = {
        k: tuple(v)
        for k, v in (await aio.read_json(args.addr_map)).items()
    }
    name = f"mon.{args.rank}"
    keyring = None
    if args.keyring:
        from ceph_tpu_torch.auth import KeyRing

        keyring = KeyRing.load(args.keyring)
    messenger = TCPMessenger(name, addr_map, keyring=keyring)
    await messenger.start()
    mon = Monitor(args.rank, args.mons, messenger,
                  store_path=args.store_path or None)
    asok = None
    if args.admin_socket:
        from ceph_tpu_torch.utils.admin_socket import AdminSocket

        asok = AdminSocket(args.admin_socket)
        asok.register("mon_status", lambda cmd: {
            "name": name,
            "rank": mon.rank,
            "state": "leader" if mon.is_leader() else
                     ("peon" if mon.leader is not None else "probing"),
            "quorum": mon.quorum,
            "election_epoch": mon.election_epoch,
            "osdmap_epoch": mon.osdmap.epoch,
            "paxos_last_committed": mon.paxos.store.last_committed,
        })
        await asok.start()
    print(f"{name} up", flush=True)
    # lease tick: peons probe the leader and call an election on
    # silence (Monitor.start_tick), so a killed leader is replaced
    mon.start_tick(interval=0.25)

    # mgr telemetry: mons beacon + report like every daemon (MON_DOWN
    # derives from beacon staleness; the lag probe attributes a wedged
    # mon event loop).  Report payload is the mon's own state summary.
    from ceph_tpu_torch.mgr.report import ReportSender, mgr_targets_from
    from ceph_tpu_torch.mgr.report import REPORT_SCHEMA_VERSION

    reporter = None
    mgr_targets = mgr_targets_from(addr_map)
    if mgr_targets:
        def mon_stats():
            return {
                "v": REPORT_SCHEMA_VERSION,
                "kind": "mon",
                "rank": mon.rank,
                "is_leader": mon.is_leader(),
                "election_epoch": mon.election_epoch,
                "osdmap_epoch": mon.osdmap.epoch,
                "perf": {},
            }

        reporter = ReportSender(name, messenger, mon_stats, mgr_targets)
        reporter.start()

    async def bootstrap():
        # every rank proposes until SOME leader is known, staggered so
        # the lowest live rank usually wins first (Elector probing): a
        # late-booting or restarted mon thereby forces a round it can
        # learn the leader from, instead of waiting forever
        await asyncio.sleep(args.settle + args.rank * 0.3)
        while mon.leader is None:
            await mon.start_election()
            await asyncio.sleep(0.5 + args.rank * 0.2)

    messenger.adopt_task(
        f"{name}.bootstrap",
        asyncio.get_event_loop().create_task(bootstrap()))

    # startup warm-up is over: freeze the boot heap out of the
    # collector (gc_freeze_on_start; the GC-pause fix)
    from ceph_tpu_torch.utils import gcopt

    gcopt.freeze_after_warmup()
    stop = asyncio.get_event_loop().create_future()

    def _stop(*_a):
        if not stop.done():
            stop.set_result(True)

    loop = asyncio.get_event_loop()
    loop.add_signal_handler(signal.SIGTERM, _stop)
    loop.add_signal_handler(signal.SIGINT, _stop)
    await stop
    if reporter is not None:
        reporter.stop()
    if asok is not None:
        await asok.stop()
    await messenger.shutdown()
    mon.close_store()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--mons", type=int, required=True)
    ap.add_argument("--addr-map", required=True)
    ap.add_argument("--store-path", default="")
    ap.add_argument("--keyring", default="",
                    help="keyring enabling cephx-style auth; entities "
                         "minted later via `auth get-or-create` are "
                         "learned from the replicated AuthDB")
    ap.add_argument("--admin-socket", default="")
    ap.add_argument("--settle", type=float, default=0.5,
                    help="seconds rank 0 waits before the first election")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    asyncio.new_event_loop().run_until_complete(serve(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
