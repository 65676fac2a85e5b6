"""Monitor services beyond the OSDMonitor (the PaxosService family).

Port of ``ceph_tpu/mon/services.py``.

Reference: src/mon/PaxosService.{h,cc} -- every monitor hosts a set of
services that share the one paxos instance; each service owns a slice
of replicated state and applies committed increments to it.  Here the
slices are plain objects on the Monitor and increments are routed by
their ``op`` prefix in ``Monitor._on_commit``:

- ``ConfigKeyStore`` -- src/mon/ConfigKeyService.cc: a replicated
  key/value store (``ceph config-key set/get/rm/ls``), used by mgr
  modules and deployment tooling for small blobs.
- ``ConfigStore`` -- the centralized daemon-config service
  (src/mon/ConfigMonitor.cc role): ``ceph config set <who> <opt> <val>``
  stores options by section (global / daemon-type / daemon-name); each
  commit pushes the merged view to subscribers so daemons pick up
  changes at runtime (MonClient config notifications).
- ``ClusterLog`` -- src/mon/LogMonitor.cc + src/common/LogClient.cc:
  daemons send cluster-log entries (clog) to the monitors; the leader
  sequences them through paxos into a bounded replicated ring served
  by ``ceph log last``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional


class ConfigKeyStore:
    """Replicated flat KV (ConfigKeyService)."""

    def __init__(self):
        self.kv: Dict[str, str] = {}

    def apply(self, inc: dict) -> None:
        if inc["op"] == "kv_set":
            self.kv[inc["key"]] = inc["value"]
        elif inc["op"] == "kv_rm":
            self.kv.pop(inc["key"], None)


class ConfigStore:
    """Centralized daemon configuration by section (ConfigMonitor).

    Sections, most-generic first: ``global``, a daemon type (``osd``,
    ``mon``, ``mds``, ``mgr``), or a full daemon name (``osd.3``).
    ``entity_view`` merges them in that order, so the most specific
    section wins -- the reference's mask/section precedence."""

    def __init__(self):
        self.sections: Dict[str, Dict[str, str]] = {}
        self.version = 0

    def apply(self, inc: dict) -> None:
        self.version += 1
        sec = self.sections.setdefault(inc["who"], {})
        if inc["op"] == "config_set":
            sec[inc["name"]] = inc["value"]
        elif inc["op"] == "config_rm":
            sec.pop(inc["name"], None)
            if not sec:
                self.sections.pop(inc["who"], None)

    def entity_view(self, entity: str) -> Dict[str, str]:
        """The merged option map one daemon should run with."""
        merged: Dict[str, str] = {}
        sections = ["global"]
        if "." in entity:
            sections.append(entity.split(".")[0])
        sections.append(entity)
        for s in sections:
            merged.update(self.sections.get(s, {}))
        return merged

    def dump(self) -> Dict[str, Dict[str, str]]:
        return {s: dict(kv) for s, kv in self.sections.items()}


class ClusterLog:
    """Bounded replicated cluster log ring (LogMonitor)."""

    MAX_ENTRIES = 10_000
    LEVELS = ("debug", "info", "warn", "error")

    def __init__(self):
        self.entries: List[dict] = []
        self.seq = 0

    def apply(self, inc: dict) -> None:
        self.seq += 1
        level = inc.get("level", "info")
        if level not in self.LEVELS:
            level = "info"  # a bad replicated entry must never poison
            # LEVELS.index() in every future filtered query
        self.entries.append({
            "seq": self.seq,
            "stamp": inc.get("stamp", 0.0),
            "who": inc.get("who", "?"),
            "level": level,
            "message": inc.get("message", ""),
        })
        if len(self.entries) > self.MAX_ENTRIES:
            del self.entries[: len(self.entries) - self.MAX_ENTRIES]

    def last(self, n: int = 20, level: Optional[str] = None) -> List[dict]:
        """The newest ``n`` entries at or above ``level`` (the
        ``ceph log last [n] [level]`` surface), oldest first."""
        if level is None:
            picked = self.entries
        else:
            floor = self.LEVELS.index(level)
            picked = [e for e in self.entries
                      if self.LEVELS.index(e.get("level", "info")) >= floor]
        return [dict(e) for e in picked[-n:]]


class LogClient:
    """Daemon-side clog sender (src/common/LogClient.cc): queues one
    cluster-log entry per call through the mon command path (any mon
    forwards to the leader)."""

    def __init__(self, mon_client, who: str):
        self.monc = mon_client
        self.who = who

    async def _log(self, level: str, message: str):
        return await self.monc.command({
            "prefix": "log", "who": self.who, "level": level,
            "message": message, "stamp": time.time(),
        })

    async def debug(self, message: str):
        return await self._log("debug", message)

    async def info(self, message: str):
        return await self._log("info", message)

    async def warn(self, message: str):
        return await self._log("warn", message)

    async def error(self, message: str):
        return await self._log("error", message)


class AuthDB:
    """Replicated entity/key/caps store (src/mon/AuthMonitor.cc role).

    Entities (``client.admin``, ``osd.3``, ...) each hold a secret and a
    caps map; ``auth get-or-create`` mints a key exactly once, ``auth
    rotate`` replaces it (the reference's rotating service keys reduced
    to explicit per-entity rotation -- ticket renewal then picks up the
    new secret on the next handshake)."""

    def __init__(self):
        self.entities: Dict[str, dict] = {}
        self.version = 0

    def apply(self, inc: dict) -> None:
        self.version += 1
        op = inc["op"]
        if op == "auth_add":
            self.entities[inc["entity"]] = {
                "key": inc["key"], "caps": dict(inc.get("caps") or {}),
            }
        elif op == "auth_caps":
            ent = self.entities.get(inc["entity"])
            if ent is not None:
                ent["caps"] = dict(inc.get("caps") or {})
        elif op == "auth_rotate":
            ent = self.entities.get(inc["entity"])
            if ent is not None:
                ent["key"] = inc["key"]
        elif op == "auth_rm":
            self.entities.pop(inc["entity"], None)


class MgrMap:
    """Active/standby manager map (src/mon/MgrMonitor.cc role).

    Daemons send ``mgr beacon``; the first becomes active, later ones
    queue as standbys; ``mgr fail`` (or a beacon arriving while the
    active's beacons are stale past the grace) promotes a standby."""

    def __init__(self):
        self.epoch = 0
        self.active: Optional[str] = None
        self.standbys: List[str] = []

    def apply(self, inc: dict) -> None:
        self.epoch += 1
        op = inc["op"]
        if op == "mgr_register":
            name = inc["name"]
            if self.active is None:
                self.active = name
            elif name != self.active and name not in self.standbys:
                self.standbys.append(name)
        elif op == "mgr_failover":
            failed = inc.get("failed")
            if failed == self.active:
                self.active = self.standbys.pop(0) if self.standbys \
                    else None
            elif failed in self.standbys:
                self.standbys.remove(failed)

    def to_dict(self) -> dict:
        return {"epoch": self.epoch, "active": self.active,
                "standbys": list(self.standbys)}


class FSMap:
    """Filesystem / MDS rank map (src/mon/MDSMonitor.cc FSMap role).

    ``fs new`` creates a filesystem with ``max_mds`` ranks; ``mds
    beacon`` registers daemons (filling vacant ranks first, then the
    standby pool); ``mds_failover`` vacates a rank and promotes a
    standby -- the standby-takeover flow the MDS cluster tests drive."""

    def __init__(self):
        self.epoch = 0
        self.filesystems: Dict[str, dict] = {}
        self.standbys: List[str] = []

    def apply(self, inc: dict) -> None:
        self.epoch += 1
        op = inc["op"]
        if op == "fs_new":
            self.filesystems[inc["name"]] = {
                "name": inc["name"],
                "max_mds": int(inc.get("max_mds", 1)),
                "ranks": {},
            }
            self._fill_ranks()
        elif op == "fs_rm":
            fs = self.filesystems.pop(inc["name"], None)
            if fs:
                for mds in fs["ranks"].values():
                    if mds not in self.standbys:
                        self.standbys.append(mds)
        elif op == "fs_set_max_mds":
            fs = self.filesystems.get(inc["name"])
            if fs:
                fs["max_mds"] = int(inc["max_mds"])
                if fs["max_mds"] < len(fs["ranks"]):
                    # shrink: highest ranks stop and return to standby
                    for r in sorted(fs["ranks"], reverse=True):
                        if len(fs["ranks"]) <= fs["max_mds"]:
                            break
                        self.standbys.append(fs["ranks"].pop(r))
                self._fill_ranks()
        elif op == "mds_register":
            name = inc["name"]
            if name not in self.standbys and not any(
                name in fs["ranks"].values()
                for fs in self.filesystems.values()
            ):
                self.standbys.append(name)
            self._fill_ranks()
        elif op == "mds_failover":
            failed = inc["name"]
            if failed in self.standbys:
                self.standbys.remove(failed)
            for fs in self.filesystems.values():
                for r, mds in list(fs["ranks"].items()):
                    if mds == failed:
                        del fs["ranks"][r]
            self._fill_ranks()

    def _fill_ranks(self) -> None:
        """Vacant ranks claim standbys (rank order, fs name order)."""
        for fs in sorted(self.filesystems.values(),
                         key=lambda f: f["name"]):
            for r in range(fs["max_mds"]):
                if r not in fs["ranks"] and self.standbys:
                    fs["ranks"][r] = self.standbys.pop(0)

    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "filesystems": {
                n: {"name": f["name"], "max_mds": f["max_mds"],
                    "ranks": {str(r): m for r, m in f["ranks"].items()}}
                for n, f in self.filesystems.items()
            },
            "standbys": list(self.standbys),
        }
