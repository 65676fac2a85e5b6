"""OSDMap: the epoch-versioned cluster map the monitors replicate.

Port of ``ceph_tpu/mon/osdmap.py``.

Reference: src/osd/OSDMap.{h,cc} — epoch, per-osd up/down + in/out
(weight) state, pools with their erasure-code profiles and crush rules;
src/mon/OSDMonitor.cc applies incrementals under paxos.  Here the map is a
plain dict-serializable object; incrementals are shallow command dicts
applied in `apply`.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class PoolInfo:
    name: str
    # pg_pool_t type (reference src/osd/osd_types.h TYPE_REPLICATED /
    # TYPE_ERASURE): erasure pools carry a profile + k/m, replicated
    # pools carry size/min_size
    profile_name: str = ""
    k: int = 0
    m: int = 0
    pool_type: str = "erasure"
    size: int = 0
    min_size: int = 0
    pg_num: int = 128
    # crush failure-domain spec: None -> flat over osds
    hosts: Optional[List[List[int]]] = None
    # device cache-tier mode (pg_pool_t cache_mode role, re-targeted at
    # device residency): "writeback" | "readproxy" | "none"; flows to the
    # daemons with every map broadcast (`osd tier cache-mode`)
    cache_mode: str = "none"


def apply_map_view(m: dict, state: dict, messenger=None, placements=(),
                   skip_entity: Optional[str] = None) -> bool:
    """Apply one broadcast osdmap dict to a subscriber-side view -- the
    epoch gate, up/down marks on the messenger, and CRUSH weight pushes
    every daemon/client subscriber needs (shared so the three consumers
    cannot drift).  ``state`` accumulates
    {"epoch", "up"}; ``placements`` get weights + an epoch bump; pass
    ``messenger=None`` to skip up/down marks (in-process harnesses own
    their liveness view).  Returns False when the epoch is stale."""
    if m["epoch"] <= state.get("epoch", 0):
        return False
    state["epoch"] = m["epoch"]
    state["up"] = {int(k): v for k, v in m["up"].items()}
    if messenger is not None:
        for osd_id, up in state["up"].items():
            entity = f"osd.{osd_id}"
            if entity == skip_entity:
                continue
            if up and messenger.is_down(entity):
                messenger.mark_up(entity)
            elif not up and not messenger.is_down(entity):
                messenger.mark_down(entity)
    for placement in placements:
        if placement is None:
            continue
        broadcast = {int(k): w for k, w in m["weights"].items()}
        for osd_id, w in sorted(broadcast.items()):
            # elastic growth: a weight for an id the placement has never
            # seen grows the crush map first (a fixed-size assignment
            # here IndexError'd every subscriber on the first osd_add)
            if osd_id >= len(placement.weights):
                placement.ensure_osd(osd_id, w)
            else:
                placement.weights[osd_id] = w
        # an id the mon dropped from the map (osd_rm) no longer
        # broadcasts a weight: zero it so CRUSH remaps away
        for osd_id in range(len(placement.weights)):
            if osd_id not in broadcast:
                placement.weights[osd_id] = 0
        placement.epoch += 1  # invalidate pg cache
    return True


@dataclass
class OSDMap:
    epoch: int = 0
    max_osd: int = 0
    # osd id -> up? (down osds keep acting positions; CRUSH ignores this)
    up: Dict[int, bool] = field(default_factory=dict)
    # osd id -> 16.16 in/out weight (0 == out); drives CRUSH placement
    weights: Dict[int, int] = field(default_factory=dict)
    ec_profiles: Dict[str, Dict[str, str]] = field(default_factory=dict)
    pools: Dict[str, PoolInfo] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "max_osd": self.max_osd,
            "up": {str(k): v for k, v in self.up.items()},
            "weights": {str(k): v for k, v in self.weights.items()},
            "ec_profiles": copy.deepcopy(self.ec_profiles),
            "pools": {
                name: {
                    "name": p.name,
                    "profile_name": p.profile_name,
                    "k": p.k,
                    "m": p.m,
                    "pool_type": p.pool_type,
                    "size": p.size,
                    "min_size": p.min_size,
                    "pg_num": p.pg_num,
                    "hosts": p.hosts,
                    "cache_mode": p.cache_mode,
                }
                for name, p in self.pools.items()
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "OSDMap":
        m = cls(
            epoch=d["epoch"],
            max_osd=d["max_osd"],
            up={int(k): v for k, v in d["up"].items()},
            weights={int(k): v for k, v in d["weights"].items()},
            ec_profiles=copy.deepcopy(d["ec_profiles"]),
        )
        for name, p in d["pools"].items():
            m.pools[name] = PoolInfo(**p)
        return m

    # -- incremental application (OSDMonitor::update_from_paxos analogue) --

    def apply(self, inc: dict) -> None:
        """Apply one committed incremental; bumps epoch."""
        op = inc["op"]
        if op == "create_osds":
            n = inc["n"]
            for i in range(n):
                self.up.setdefault(i, True)
                self.weights.setdefault(i, 0x10000)
            self.max_osd = max(self.max_osd, n)
        elif op == "osd_down":
            self.up[inc["osd"]] = False
        elif op == "osd_up":
            self.up[inc["osd"]] = True
        elif op == "osd_out":
            self.weights[inc["osd"]] = 0
        elif op == "osd_in":
            self.weights[inc["osd"]] = inc.get("weight", 0x10000)
        elif op == "osd_add":
            # elastic expansion: one new device, up + weighted in
            osd = inc["osd"]
            if osd in self.up:
                raise ValueError(f"osd_add for existing osd {osd}")
            self.up[osd] = True
            self.weights[osd] = inc.get("weight", 0x10000)
            self.max_osd = max(self.max_osd, osd + 1)
        elif op == "osd_rm":
            # elastic contraction: the id leaves the map entirely;
            # subscribers zero any weight for ids absent from the
            # broadcast (apply_map_view), so CRUSH remaps away
            osd = inc["osd"]
            if osd not in self.up:
                raise ValueError(f"osd_rm for unknown osd {osd}")
            self.up.pop(osd, None)
            self.weights.pop(osd, None)
        elif op == "profile_set":
            self.ec_profiles[inc["name"]] = dict(inc["profile"])
        elif op == "profile_rm":
            self.ec_profiles.pop(inc["name"], None)
        elif op == "pool_create":
            p = inc["pool"]
            self.pools[p["name"]] = PoolInfo(**p)
        elif op == "pool_rm":
            self.pools.pop(inc["name"], None)
        elif op == "pool_tier":
            # cache-tier mode change (OSDMonitor `osd tier cache-mode`)
            pool = self.pools.get(inc["name"])
            if pool is None:
                raise ValueError(f"pool_tier for unknown pool {inc['name']}")
            pool.cache_mode = inc["cache_mode"]
        else:
            raise ValueError(f"unknown incremental op {op}")
        self.epoch += 1
