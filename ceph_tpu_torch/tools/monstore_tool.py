#!/usr/bin/env python3
"""ceph-monstore-tool: offline monitor-store inspection.

Port of ``tools/monstore_tool.py`` over the port's LSM store
(``kv/lsm.py``) in the mon's paxos layout (``mon/paxos.py``: prefix "P"
version -> value, "T" paxos metadata), which both packages write alike:
either package's tool reads either package's stopped mon store.  Host
code only: it never touches the card.

Reference: src/tools/ceph_monstore_tool.cc -- opens a (stopped) mon's
store.db and dumps paxos versions / rebuilds service state without a
running quorum.

Usage:
  python -m ceph_tpu_torch.tools.monstore_tool <mon-store-path> show-versions
  ... <mon-store-path> dump-paxos [--first V] [--last V]
  ... <mon-store-path> get-osdmap
  ... <mon-store-path> dump-keys
"""

from __future__ import annotations

import json
import sys

from ceph_tpu_torch.kv.lsm import LSMStore
from ceph_tpu_torch.mon.osdmap import OSDMap
from ceph_tpu_torch.utils.encoding import Decoder


def _open(path: str) -> LSMStore:
    db = LSMStore(path)
    db.open()
    return db


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) < 2:
        print(__doc__)
        return 1
    path, cmd = args[0], args[1]
    rest = args[2:]
    db = _open(path)
    try:
        meta_raw = db.get("T", "meta")
        meta = Decoder(meta_raw).value() if meta_raw else {
            "last_committed": 0, "accepted_pn": 0,
            "uncommitted_v": None, "uncommitted_value": None}
        if cmd == "show-versions":
            versions = sorted(int(k) for k, _ in db.get_iterator("P"))
            print(json.dumps({
                "first_committed": versions[0] if versions else 0,
                "last_committed": meta["last_committed"],
                "accepted_pn": meta["accepted_pn"],
                "uncommitted_v": meta["uncommitted_v"],
                "stored_versions": len(versions),
            }, indent=2))
            return 0
        if cmd == "dump-paxos":
            first = last = None
            if "--first" in rest:
                first = int(rest[rest.index("--first") + 1])
            if "--last" in rest:
                last = int(rest[rest.index("--last") + 1])
            for k, raw in sorted(db.get_iterator("P"),
                                 key=lambda kv: int(kv[0])):
                v = int(k)
                if first is not None and v < first:
                    continue
                if last is not None and v > last:
                    continue
                print(json.dumps({"v": v, "value": Decoder(raw).value()}))
            return 0
        if cmd == "get-osdmap":
            # rebuild the map by replaying committed increments, the
            # way a restarted mon does (PaxosService update_from_paxos)
            m = OSDMap()
            for k, raw in sorted(db.get_iterator("P"),
                                 key=lambda kv: int(kv[0])):
                if int(k) > meta["last_committed"]:
                    continue
                inc = Decoder(raw).value()["inc"]
                op = inc.get("op", "")
                if op.startswith(("kv_", "config_")) or op == "clog_append":
                    continue  # other service slices
                m.apply(inc)
            print(json.dumps(m.to_dict(), indent=2, sort_keys=True))
            return 0
        if cmd == "dump-keys":
            for prefix in ("P", "T"):
                for k, raw in db.get_iterator(prefix):
                    print(f"{prefix}\t{k}\t{len(raw)} bytes")
            return 0
        print(__doc__)
        return 1
    finally:
        db.close()


if __name__ == "__main__":
    sys.exit(main())
