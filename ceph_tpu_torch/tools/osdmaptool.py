#!/usr/bin/env python3
"""osdmaptool: offline OSDMap manipulation + mapping analysis.

Port of ``tools/osdmaptool.py`` over the port's JSON-serialized OSDMap
(``mon/osdmap.py``) and CRUSH engine (``osd/placement.py``).  Host code
only: it never touches the card.  A map file written by either package's
tool reads in the other's.

Reference: src/tools/osdmaptool.cc -- operates on an osdmap FILE
(create, print, mark osds, test PG mappings and report the placement
distribution) without any cluster running.

Usage:
  python -m ceph_tpu_torch.tools.osdmaptool <mapfile> --createsimple <numosd>
  ... <mapfile> --create-pool <name> --k K --m M [--pg-num N]
  ... <mapfile> --print
  ... <mapfile> --mark-out <osd> | --mark-in <osd>
                | --mark-down <osd> | --mark-up <osd>
  ... <mapfile> --test-map-pgs [--pool <name>]
  ... <mapfile> --test-map-object <oid> [--pool <name>]
"""

from __future__ import annotations

import json
import sys

from ceph_tpu_torch.mon.osdmap import OSDMap, PoolInfo
from ceph_tpu_torch.osd.placement import CrushPlacement


def _load(path: str) -> OSDMap:
    with open(path) as f:
        return OSDMap.from_dict(json.load(f))


def _save(path: str, m: OSDMap) -> None:
    with open(path, "w") as f:
        json.dump(m.to_dict(), f, indent=2, sort_keys=True)


def _placement(m: OSDMap, pool: PoolInfo) -> CrushPlacement:
    p = CrushPlacement(m.max_osd, pool.k + pool.m, pg_num=pool.pg_num,
                       hosts=pool.hosts)
    for osd in range(m.max_osd):
        w = m.weights.get(osd, 0x10000)
        if w != 0x10000:
            p.reweight(osd, w / 0x10000)
    return p


def _pick_pool(m: OSDMap, name: str | None) -> PoolInfo:
    if not m.pools:
        raise SystemExit("map has no pools (use --create-pool)")
    if name is None:
        return next(iter(m.pools.values()))
    pool = m.pools.get(name)
    if pool is None:
        raise SystemExit(f"no pool {name!r} in map")
    return pool


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print(__doc__)
        return 1
    path = args.pop(0)

    def opt(name, default=None):
        if name in args:
            i = args.index(name)
            args.pop(i)
            return args.pop(i)
        return default

    def flag(name):
        if name in args:
            args.remove(name)
            return True
        return False

    if flag("--createsimple"):
        n = int(args.pop(0))
        m = OSDMap()
        m.apply({"op": "create_osds", "n": n})
        _save(path, m)
        print(f"osdmaptool: wrote simple map with {n} osds to {path}")
        return 0

    m = _load(path)

    create_pool = opt("--create-pool")
    if create_pool:
        k = int(opt("--k", "2"))
        mm = int(opt("--m", "1"))
        pg_num = int(opt("--pg-num", "128"))
        m.apply({"op": "pool_create", "pool": {
            "name": create_pool, "profile_name": "default",
            "k": k, "m": mm, "pg_num": pg_num, "hosts": None}})
        _save(path, m)
        print(f"osdmaptool: added pool {create_pool} k={k} m={mm} "
              f"pg_num={pg_num}")
        return 0

    for fname, op in (("--mark-out", "osd_out"), ("--mark-in", "osd_in"),
                      ("--mark-down", "osd_down"), ("--mark-up", "osd_up")):
        v = opt(fname)
        if v is not None:
            m.apply({"op": op, "osd": int(v)})
            _save(path, m)
            print(f"osdmaptool: {op} osd.{v}, epoch now {m.epoch}")
            return 0

    if flag("--print"):
        print(json.dumps(m.to_dict(), indent=2, sort_keys=True))
        return 0

    pool_name = opt("--pool")

    if flag("--test-map-pgs"):
        pool = _pick_pool(m, pool_name)
        placement = _placement(m, pool)
        per_osd = [0] * m.max_osd
        primaries = [0] * m.max_osd
        holes = 0
        for pg in range(pool.pg_num):
            acting = placement.acting_for_pg(pg)
            for s, osd in enumerate(acting):
                if osd is None:
                    holes += 1
                    continue
                per_osd[osd] += 1
                if s == 0:
                    primaries[osd] += 1
        width = pool.k + pool.m
        print(f"pool {pool.name} pg_num {pool.pg_num} size {width}")
        print("#osd\tcount\tfirst\tweight")
        for osd in range(m.max_osd):
            w = m.weights.get(osd, 0x10000) / 0x10000
            print(f"osd.{osd}\t{per_osd[osd]}\t{primaries[osd]}\t{w:g}")
        in_osds = [per_osd[o] for o in range(m.max_osd)
                   if m.weights.get(o, 0x10000)]
        if in_osds:
            mean = sum(in_osds) / len(in_osds)
            print(f"avg {mean:.1f} min {min(in_osds)} max {max(in_osds)} "
                  f"holes {holes}")
        return 0

    obj = opt("--test-map-object")
    if obj:
        pool = _pick_pool(m, pool_name)
        placement = _placement(m, pool)
        pg = placement.pg_of(obj)
        acting = placement.acting_for_pg(pg)
        print(f"object '{obj}' -> pg {pg} -> {acting}")
        return 0

    print(__doc__)
    return 1


if __name__ == "__main__":
    sys.exit(main())
