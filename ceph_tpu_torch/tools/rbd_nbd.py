#!/usr/bin/env python3
"""rbd-nbd: serve a pool's RBD images over the NBD protocol.

Port of ``tools/rbd_nbd.py``: a ``RemoteClient`` of a port cluster
started by ``ceph_tpu_torch.tools.vstart`` (the pool's chunk math runs in
the OSD daemons, on the card where the pool's profile puts it) under the
port's ``NBDServer``.

Reference: src/tools/rbd_nbd/rbd-nbd.cc (`rbd-nbd map`).  This serves
the standard fixed-newstyle NBD protocol on a TCP port; attach with any
NBD client, e.g.:

    nbd-client 127.0.0.1 <port> /dev/nbd0 -name <image>
    qemu-nbd --connect=... / nbdfuse mnt 'nbd://127.0.0.1:<port>/<image>'

Usage:
  python -m ceph_tpu_torch.tools.rbd_nbd --dir RUN [--port P]
  (runs until SIGINT/SIGTERM; prints the bound port when up)
"""

from __future__ import annotations

import argparse
import asyncio
import os
import signal
import sys

from ceph_tpu_torch.daemon.client import RemoteClient
from ceph_tpu_torch.rbd.nbd import NBDServer
from ceph_tpu_torch.utils import aio


async def serve(args) -> None:
    conf = await aio.read_json(os.path.join(args.dir, "cluster.json"))
    keyring = os.path.join(args.dir, "keyring")
    c = await RemoteClient.connect(
        os.path.join(args.dir, "addr_map.json"), dict(conf["profile"]),
        keyring=keyring if conf.get("auth") and os.path.exists(keyring)
        else None,
    )
    srv = NBDServer(c.backend, port=args.port)
    port = await srv.start()
    print(f"nbd server up on 127.0.0.1:{port}", flush=True)
    stop = asyncio.get_event_loop().create_future()
    for sig in (signal.SIGTERM, signal.SIGINT):
        asyncio.get_event_loop().add_signal_handler(
            sig, lambda: stop.done() or stop.set_result(True))
    await stop
    await srv.stop()
    await c.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", required=True,
                    help="vstart run directory (addr_map/cluster.json)")
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
    try:
        asyncio.run(serve(args))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
