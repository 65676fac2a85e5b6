#!/usr/bin/env python3
"""Offline ObjectStore surgery tool (ceph_objectstore_tool analogue).

Port of ``tools/objectstore_tool.py`` over the port's engines
(``objectstore/``) and frames (``utils/encoding.py``): a dump written by
either package's tool imports with the other's.  Host code only: it never
touches the card.  As in the reference, the targets are ``filestore`` and
``kstore``; a ``blockstore`` is not one.

Reference: src/tools/ceph_objectstore_tool.cc -- operate on an OSD's store
while the daemon is down: list objects, export/import them (with
attributes) as a portable framed dump, remove objects, show info.

  python -m ceph_tpu_torch.tools.objectstore_tool --data-path DIR \
      --type {filestore,kstore} --op list
  ... --op export --file dump.bin [--oid OID]
  ... --op import --file dump.bin
  ... --op remove --oid OID
  ... --op info --oid OID
"""

import argparse
import sys

from ceph_tpu_torch import objectstore as os_mod
from ceph_tpu_torch.osd.types import Transaction
from ceph_tpu_torch.utils.encoding import Decoder, Encoder, frame, unframe

#: the EC path's shard xattrs (there is no attr-enumeration API on the
#: store surface, so the dump lists them explicitly; VERSION_KEY matters:
#: without it imported shards decode as version 0 and the read-time
#: consistent cut would discard them as stale)
_KNOWN_ATTRS = ("hinfo_key", "_size", "_version")


def export(store, oids, path):
    with open(path, "wb") as f:
        for oid in oids:
            enc = Encoder()
            enc.string(oid)
            enc.blob(store.read(oid))
            attrs = {}
            for name in _KNOWN_ATTRS:
                v = store.getattr(oid, name)
                if v is not None:
                    attrs[name] = v
            enc.value(attrs)
            f.write(frame(enc.bytes()))
    print(f"exported {len(oids)} object(s) to {path}")


def do_import(store, path):
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    n = 0
    while True:
        payload, pos = unframe(data, pos)
        if payload is None:
            break
        dec = Decoder(payload)
        oid = dec.string()
        body = dec.blob()
        attrs = dec.value()
        txn = Transaction().write(oid, 0, body).truncate(oid, len(body))
        for name, value in attrs.items():
            txn.setattr(oid, name, value)
        store.queue_transaction(txn)
        n += 1
    print(f"imported {n} object(s) from {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-path", required=True)
    ap.add_argument("--type", default="filestore",
                    choices=["filestore", "kstore"])
    ap.add_argument("--op", required=True,
                    choices=["list", "export", "import", "remove", "info"])
    ap.add_argument("--file")
    ap.add_argument("--oid")
    args = ap.parse_args(argv)

    store = os_mod.create(args.type, args.data_path)
    try:
        if args.op == "list":
            for oid in store.list_objects():
                print(oid)
        elif args.op == "export":
            if not args.file:
                ap.error("--op export needs --file")
            oids = [args.oid] if args.oid else store.list_objects()
            export(store, oids, args.file)
        elif args.op == "import":
            if not args.file:
                ap.error("--op import needs --file")
            do_import(store, args.file)
        elif args.op == "remove":
            if not args.oid:
                ap.error("--op remove needs --oid")
            store.queue_transaction(Transaction().remove(args.oid))
            print(f"removed {args.oid}")
        elif args.op == "info":
            if not args.oid:
                ap.error("--op info needs --oid")
            print(f"oid: {args.oid}")
            print(f"size: {store.stat(args.oid)}")
            for name in _KNOWN_ATTRS:
                v = store.getattr(args.oid, name)
                if v is not None:
                    print(f"attr {name}: {v}")
    finally:
        if hasattr(store, "umount"):
            store.umount()
    return 0


if __name__ == "__main__":
    sys.exit(main())
