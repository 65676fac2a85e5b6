#!/usr/bin/env python3
"""rbd CLI (reference: src/tools/rbd) over an in-process pool.

Port of ``tools/rbd_cli.py``; the pool's codec runs on the card unless
``--device cpu`` asks for the CPU.

  python -m ceph_tpu_torch.tools.rbd_cli create IMG --size BYTES [--order N]
  ... ls | info IMG | resize IMG --size N | rm IMG
  ... import SRC IMG | export IMG DST
  ... snap create IMG@SNAP | snap ls IMG | snap rm IMG@SNAP
  ... bench IMG --io-size 65536 --io-total 8388608

State is per-invocation (an in-process cluster seeded from --data-path
when given) -- the vstart/TCP world uses the library API instead.
"""

import argparse
import asyncio
import os
import sys
import time

from ceph_tpu_torch.osd.cluster import ECCluster
from ceph_tpu_torch.rbd import RBD, Image
from ceph_tpu_torch.utils import aio


def _cluster(args):
    kw = {}
    if args.data_path:
        kw = {"objectstore": args.objectstore, "data_path": args.data_path}
    return ECCluster(args.osds, {"k": str(args.k), "m": str(args.m),
                                 "device": args.device}, **kw)


async def _run(args) -> int:
    c = _cluster(args)
    rbd = RBD(c.backend)
    try:
        if args.cmd == "create":
            await rbd.create(args.image, args.size, order=args.order)
            print(f"created {args.image} ({args.size} bytes)")
        elif args.cmd == "ls":
            for name in await rbd.list():
                print(name)
        elif args.cmd == "info":
            img = await Image.open(c.backend, args.image)
            print(f"rbd image '{img.name}':")
            print(f"\tsize {img.size} bytes")
            print(f"\torder {img.order} ({1 << img.order} byte objects)")
            print(f"\tsnapshots: {', '.join(img.snap_list()) or '(none)'}")
        elif args.cmd == "resize":
            img = await Image.open(c.backend, args.image)
            await img.resize(args.size)
            print(f"resized {args.image} to {args.size}")
        elif args.cmd == "rm":
            await rbd.remove(args.image)
            print(f"removed {args.image}")
        elif args.cmd == "import":
            data = await aio.read_bytes(args.src)
            await rbd.create(args.image, len(data), order=args.order)
            img = await Image.open(c.backend, args.image)
            await img.write(0, data)
            print(f"imported {args.src} -> {args.image} ({len(data)} bytes)")
        elif args.cmd == "export":
            img = await Image.open(c.backend, args.image)
            data = await img.read(0, img.size)
            await aio.write_bytes(args.dst, data)
            print(f"exported {args.image} -> {args.dst} ({len(data)} bytes)")
        elif args.cmd == "snap":
            if args.snap_cmd == "ls":
                img = await Image.open(c.backend, args.image)
                for s in img.snap_list():
                    print(s)
            else:
                image, snap = args.image.split("@", 1)
                img = await Image.open(c.backend, image)
                if args.snap_cmd == "create":
                    sid = await img.snap_create(snap)
                    print(f"created snap {snap} (id {sid})")
                else:
                    await img.snap_remove(snap)
                    print(f"removed snap {snap}")
        elif args.cmd == "feature":
            img = await Image.open(c.backend, args.image)
            feat = args.feature_name
            if args.feature_cmd == "enable":
                await img.update_features(enable=[feat])
            else:
                await img.update_features(disable=[feat])
            print(f"features of {args.image}: "
                  f"{', '.join(img.features) or '(none)'}")
        elif args.cmd == "journal":
            from ceph_tpu_torch.rbd import FEATURE_JOURNALING, ImageJournal

            img = await Image.open(c.backend, args.image)
            if FEATURE_JOURNALING not in img.features:
                print(f"error: image {args.image} has no journaling "
                      "feature (a status command must not create one)")
                return 1
            jr = ImageJournal(c.backend, args.image)
            await jr.open()
            if args.journal_cmd == "status":
                clients = await jr.j.clients()
                print(f"journal for {args.image}: "
                      f"write_pos {jr.j.write_pos} "
                      f"commit_pos {jr.j.commit_pos} "
                      f"expire_pos {jr.j.expire_pos}")
                for cid, pos in sorted(clients.items()):
                    print(f"\tclient {cid}: position {pos}")
            elif args.journal_cmd == "inspect":
                for start, _end, ev in await jr.j.replay_entries(
                        jr.j.expire_pos):
                    desc = {k: (f"<{len(v)} bytes>"
                                if isinstance(v, bytes) else v)
                            for k, v in ev.items()}
                    print(f"{start}\t{desc}")
        elif args.cmd == "mirror":
            from ceph_tpu_torch.rbd import mirror_disable, mirror_enable, \
                mirror_list

            if args.mirror_cmd in ("enable", "disable") and not args.image:
                print(f"error: mirror {args.mirror_cmd} requires an image")
                return 2
            if args.mirror_cmd == "enable":
                await mirror_enable(c.backend, args.image)
                print(f"mirroring enabled for {args.image}")
            elif args.mirror_cmd == "disable":
                await mirror_disable(c.backend, args.image)
                print(f"mirroring disabled for {args.image}")
            elif args.mirror_cmd == "ls":
                for name in await mirror_list(c.backend):
                    print(name)
        elif args.cmd == "bench":
            img = await Image.open(c.backend, args.image)
            payload = os.urandom(args.io_size)
            n = args.io_total // args.io_size
            t0 = time.perf_counter()
            for i in range(n):
                await img.write((i * args.io_size) % max(
                    1, img.size - args.io_size), payload)
            dt = time.perf_counter() - t0
            mb = n * args.io_size / 1e6
            print(f"{n} writes x {args.io_size} B in {dt:.3f}s "
                  f"= {mb / dt:.1f} MB/s")
    finally:
        await c.shutdown()
    return 0


def main(argv=None) -> int:
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--osds", type=int, default=6)
    common.add_argument("--k", type=int, default=2)
    common.add_argument("--m", type=int, default=1)
    common.add_argument("--order", type=int, default=22)
    common.add_argument("--size", type=int, default=0)
    common.add_argument("--io-size", type=int, default=65536)
    common.add_argument("--io-total", type=int, default=1 << 23)
    common.add_argument("--data-path", default="")
    common.add_argument("--objectstore", default="filestore")
    common.add_argument("--device", default="cuda",
                        help="the codec's device (cuda: the card)")

    ap = argparse.ArgumentParser(description=__doc__, parents=[common])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("create", "info", "resize", "rm", "bench"):
        p = sub.add_parser(name, parents=[common])
        p.add_argument("image")
    sub.add_parser("ls", parents=[common])
    p = sub.add_parser("feature", parents=[common])
    p.add_argument("feature_cmd", choices=["enable", "disable"])
    p.add_argument("image")
    # only features the framework implements; a typo must not be
    # persisted verbatim into the image header
    p.add_argument("feature_name", choices=["journaling"])
    p = sub.add_parser("journal", parents=[common])
    p.add_argument("journal_cmd", choices=["status", "inspect"])
    p.add_argument("image")
    p = sub.add_parser("mirror", parents=[common])
    p.add_argument("mirror_cmd", choices=["enable", "disable", "ls"])
    p.add_argument("image", nargs="?", default="")
    p = sub.add_parser("import", parents=[common])
    p.add_argument("src")
    p.add_argument("image")
    p = sub.add_parser("export", parents=[common])
    p.add_argument("image")
    p.add_argument("dst")
    p = sub.add_parser("snap", parents=[common])
    p.add_argument("snap_cmd", choices=["create", "ls", "rm"])
    p.add_argument("image")
    args = ap.parse_args(argv)
    return asyncio.run(_run(args))


if __name__ == "__main__":
    sys.exit(main())
