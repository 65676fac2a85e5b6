"""ceph-mgr daemon: the wire-fed telemetry endpoint over TCP.

Port of ``ceph_tpu/daemon/mgr.py``.

Reference boot flow: src/ceph_mgr.cc -- global init, messengers,
MgrStandby::init; DaemonServer accepts every daemon's MgrClient session
and folds MMgrReport/MPGStats into the cluster map.  Here:

  python -m ceph_tpu_torch.daemon.mgr --rank 0 --addr-map map.json \
      [--http-port P] [--admin-socket PATH]

``map.json`` must name this mgr (``mgr.R``).  OSD/mon daemons discover
``mgr.*`` entries in the same map and run their ReportSender loops
against them (``mgr/report.py``).  The process prints
``mgr.R up [http PORT]`` once both the messenger socket and the HTTP
endpoint listen; health/status/pg-stat are served over the admin socket
(``status`` / ``health`` / ``pg stat``) and /metrics /health
/status over HTTP (the prometheus scrape).
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys


async def serve(args) -> None:
    from ceph_tpu_torch.mgr.pgmap import MgrServer
    from ceph_tpu_torch.mgr.report import LoopLagProbe
    from ceph_tpu_torch.msg.tcp import TCPMessenger
    from ceph_tpu_torch.utils import aio

    addr_map = {
        k: tuple(v)
        for k, v in (await aio.read_json(args.addr_map)).items()
    }
    name = f"mgr.{args.rank}"
    keyring = None
    if args.keyring:
        from ceph_tpu_torch.auth import KeyRing

        keyring = KeyRing.load(args.keyring)
    messenger = TCPMessenger(name, addr_map, keyring=keyring)
    await messenger.start()
    mgr = MgrServer(name, messenger, addr_map=addr_map,
                    http_port=args.http_port)
    http_port = await mgr.start_http()
    # the mgr watches its own event loop too (it is a daemon like any
    # other; a lagging mgr mis-dates every staleness judgement)
    lag = LoopLagProbe()
    lag.start(messenger, name)

    asok = None
    if args.admin_socket:
        from ceph_tpu_torch.utils.admin_socket import AdminSocket

        asok = AdminSocket(args.admin_socket)
        asok.register("status", lambda cmd: mgr.pgmap.dump())
        asok.register("status text",
                      lambda cmd: {"text": mgr.pgmap.status_text()})
        asok.register("health", lambda cmd: mgr.pgmap.health())
        asok.register("pg stat", lambda cmd: mgr.pgmap.pg_stat())
        asok.register("metrics",
                      lambda cmd: {"text": mgr.pgmap.prometheus_text()})
        # the mgr-local cluster event log (clog analogue): health
        # transitions + slow-op warnings, rendered by `rados_cli log`
        asok.register("log last", lambda cmd: {
            "lines": mgr.pgmap.clog.last(int(cmd.get("count", 20))),
        })
        asok.register("mgr status", lambda cmd: {
            "name": name,
            "http_port": http_port,
            "daemons_reporting": len(mgr.pgmap.daemons),
            "reports_folded": mgr.pgmap.reports_folded,
            "beacons_folded": mgr.pgmap.beacons_folded,
            "lag_ms": round(lag.lag_ms, 3),
        })
        await asok.start()
    print(f"{name} up http {http_port}", flush=True)

    # startup warm-up is over: freeze the boot heap out of the
    # collector (gc_freeze_on_start; the GC-pause fix)
    from ceph_tpu_torch.utils import gcopt

    gcopt.freeze_after_warmup()
    stop = asyncio.Event()
    loop = asyncio.get_event_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    if asok is not None:
        await asok.stop()
    await mgr.stop()
    await messenger.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--addr-map", required=True)
    ap.add_argument("--http-port", type=int, default=0,
                    help="prometheus/health HTTP port (0 = ephemeral; "
                         "printed on the readiness line)")
    ap.add_argument("--keyring", default="",
                    help="keyring file enabling cephx-style auth")
    ap.add_argument("--admin-socket", default="",
                    help="unix socket for status/health/pg-stat "
                         "introspection (rados_cli reads it)")
    args = ap.parse_args(argv)
    try:
        asyncio.run(serve(args))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
