"""OSD capability grammar + checks (reference: src/osd/OSDCap.{h,cc}).

Port of ``ceph_tpu/auth/caps.py``.

The reference parses cap strings like ``allow rwx pool=data
object_prefix rbd_`` (boost::spirit grammar, OSDCapParser) into grants
and answers ``is_capable(pool, object, r, w, class_call)`` by OR-ing
grants.  Same model here for the subset the framework enforces:

  caps      := grant { "," grant }
  grant     := "allow" ( "*" | "all" | rwx-spec ) { match }
  rwx-spec  := subset of "r" "w" "x" (x = object-class call, exec)
  match     := "pool=" name | "object_prefix" prefix

A mon keyring entry's ``caps osd`` string rides the cephx ticket; the
OSD checks every client op against it (PrimaryLogPG op_has_sufficient_
caps, src/osd/PrimaryLogPG.cc).
"""

from __future__ import annotations

from typing import List, Optional


class CapGrant:
    def __init__(self, allow_all: bool = False, r: bool = False,
                 w: bool = False, x: bool = False,
                 pool: Optional[str] = None,
                 object_prefix: Optional[str] = None):
        self.allow_all = allow_all
        self.r, self.w, self.x = r, w, x
        self.pool = pool
        self.object_prefix = object_prefix

    def _matches(self, pool: str, obj: str) -> bool:
        if self.pool is not None and self.pool != pool:
            return False
        if self.object_prefix is not None and \
                not obj.startswith(self.object_prefix):
            return False
        return True

    def covers(self, pool: str, obj: str, need_r: bool, need_w: bool,
               need_x: bool) -> bool:
        if not self._matches(pool, obj):
            return False
        if self.allow_all:
            return True
        if need_r and not self.r:
            return False
        if need_w and not self.w:
            return False
        if need_x and not self.x:
            return False
        return True


class OSDCap:
    def __init__(self, grants: List[CapGrant]):
        self.grants = grants

    @classmethod
    def parse(cls, caps: str) -> "OSDCap":
        grants: List[CapGrant] = []
        for clause in caps.split(","):
            toks = clause.split()
            if not toks:
                continue
            if toks[0] != "allow":
                raise ValueError(f"cap clause must start with allow: "
                                 f"{clause!r}")
            g = CapGrant()
            i = 1
            if i < len(toks) and toks[i] in ("*", "all"):
                g.allow_all = True
                i += 1
            elif i < len(toks) and set(toks[i]) <= set("rwx"):
                g.r = "r" in toks[i]
                g.w = "w" in toks[i]
                g.x = "x" in toks[i]
                i += 1
            else:
                raise ValueError(f"bad rwx spec in {clause!r}")
            while i < len(toks):
                t = toks[i]
                if t.startswith("pool="):
                    g.pool = t[len("pool="):]
                    i += 1
                elif t == "object_prefix" and i + 1 < len(toks):
                    g.object_prefix = toks[i + 1]
                    i += 2
                else:
                    raise ValueError(f"bad match clause {t!r} in {clause!r}")
            grants.append(g)
        if not grants:
            raise ValueError("empty cap string")
        return cls(grants)

    def is_capable(self, pool: str, obj: str, need_r: bool = False,
                   need_w: bool = False, need_x: bool = False) -> bool:
        """True when some grant covers the op.  An exec (x) op also
        implies read access in the reference; callers pass the
        fine-grained needs and this ORs grants exactly like
        OSDCap::is_capable."""
        return any(g.covers(pool, obj, need_r, need_w, need_x)
                   for g in self.grants)


#: which framework op kinds need which access bits (PrimaryLogPG
#: op_has_sufficient_caps' may_read/may_write/may_exec classification)
OP_NEEDS = {
    "read": (True, False, False),
    "read_range": (True, False, False),
    "stat": (True, False, False),
    "omap_get": (True, False, False),
    "list_snaps": (True, False, False),
    "write": (False, True, False),
    "write_range": (False, True, False),
    "remove": (False, True, False),
    "omap_set": (False, True, False),
    "omap_rm": (False, True, False),
    "omap_clear": (False, True, False),
    "omap_cas": (False, True, False),
    "snap_trim": (False, True, False),
    "snap_rollback": (False, True, False),
    # watch mutates primary-side watcher state: the reference's
    # CEPH_OSD_OP_WATCH is a write-mode op (may_write), and unwatch must
    # mirror it so a watcher can always unregister what it registered
    "exec": (True, False, True),
    "watch": (False, True, False),
    "unwatch": (False, True, False),
    "notify": (True, False, False),
    "scrub": (True, False, False),
    "recover": (False, True, False),
}


def op_capable(cap: OSDCap, pool: str, obj: str, op_kind: str) -> bool:
    need_r, need_w, need_x = OP_NEEDS.get(op_kind, (True, True, False))
    return cap.is_capable(pool, obj, need_r, need_w, need_x)


class MonCap:
    """Minimal monitor capability (reference: src/mon/MonCap.{h,cc}).

    Only the decision the AuthMonitor needs is modeled: does this entity
    hold mon ADMIN authority (``allow *`` / ``allow all`` / ``allow
    profile admin``)?  Service profiles (``allow profile osd`` etc.) and
    r/w grants parse without error but confer no admin authority --
    exactly the property that stops a minted osd.* key from minting or
    revoking other keys.
    """

    def __init__(self, admin: bool = False):
        self.admin = admin

    @classmethod
    def parse(cls, caps: str) -> "MonCap":
        admin = False
        for clause in (caps or "").split(","):
            toks = clause.split()
            if toks[:2] in (["allow", "*"], ["allow", "all"]):
                admin = True
            elif toks[:3] == ["allow", "profile", "admin"]:
                admin = True
        return cls(admin)

    def is_admin(self) -> bool:
        return self.admin
