"""Object -> PG -> acting-set placement via CRUSH.

Port of ``ceph_tpu/osd/placement.py``.

Reference: the OSD maps hobject_t -> pg (ceph_str_hash + pg_num mask,
src/osd/osd_types.h raw_pg_to_pg) and pg -> up/acting osds via
OSDMap::pg_to_up_acting_osds -> crush->do_rule with the pool's rule in
'indep' mode for EC pools (src/osd/OSDMap.cc:_pg_to_raw_osds).  Devices
marked *out* get weight 0 and are remapped; *down* devices keep their
acting position (degraded) until marked out — the same up/acting split the
reference has.  Unmappable indep positions come back as ``None`` (the
CRUSH_ITEM_NONE hole): the pg stays usable as long as >= k positions map.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

from ceph_tpu_torch.crush import CrushMap, Tunables, build_flat_map, build_hierarchy, do_rule
from ceph_tpu_torch.crush.hash import crush_hash32
from ceph_tpu_torch.crush.map import ITEM_NONE, erasure_rule, weight_fp


def fallback_acting(oid: str, n_osds: int, km: int) -> List[int]:
    """CRUSH-lite: deterministic permutation seeded by the object name.
    Used when no CrushPlacement is attached (unit-test clusters)."""
    if n_osds < km:
        raise RuntimeError("not enough OSDs for the acting set")
    seed = int.from_bytes(
        hashlib.blake2b(oid.encode(), digest_size=8).digest(), "big"
    )
    order = sorted(
        range(n_osds), key=lambda i: (seed * (i + 1)) % (2**61 - 1)
    )
    return order[:km]


class CrushPlacement:
    """CRUSH-backed acting-set computation for an EC pool."""

    def __init__(
        self,
        n_osds: int,
        km: int,
        pg_num: int = 128,
        hosts: Optional[Sequence[Sequence[int]]] = None,
    ):
        if hosts is not None:
            all_osds = sorted(o for h in hosts for o in h)
            if all_osds != list(range(n_osds)):
                raise ValueError(
                    f"hosts layout covers osds {all_osds}, "
                    f"expected exactly 0..{n_osds - 1}"
                )
            self.map, root = build_hierarchy(hosts)
            domain = 2  # host
        else:
            self.map, root = build_flat_map(n_osds)
            domain = 0
        self._root = root
        self._domain = domain
        self.ruleno = self.map.add_rule(
            erasure_rule(root, failure_domain_type=domain)
        )
        self.km = km
        self.pg_num = pg_num
        self.weights = [0x10000] * n_osds
        self.tunables = Tunables()
        self.epoch = 1  # bumped on every weight/map mutation
        # pg -> acting, valid for the current epoch only (the reference
        # equivalent is OSDMapMapping's precomputed pg->osds cache).
        self._cache: Dict[int, List[Optional[int]]] = {}
        self._cache_epoch = self.epoch
        # oid -> pg is pure hashing, independent of the epoch; the data
        # path asks for the same object's acting set dozens of times per
        # op (_shard_up loops), so the hash must not re-run each time.
        # Bounded: cleared wholesale when it grows past ~64k names.
        self._pg_cache: Dict[str, int] = {}

    def pg_of(self, oid: str) -> int:
        pg = self._pg_cache.get(oid)
        if pg is None:
            if len(self._pg_cache) >= (1 << 16):
                self._pg_cache.clear()
            h = crush_hash32(
                int.from_bytes(
                    hashlib.blake2b(oid.encode(),
                                    digest_size=4).digest(), "big"
                )
            )
            pg = self._pg_cache[oid] = int(h) % self.pg_num
        return pg

    def acting_for_pg(self, pg: int) -> List[Optional[int]]:
        """km entries; ``None`` marks an unmappable position (hole).
        Raises only when fewer positions map than the caller can ever
        decode from is *not* known here — callers enforce k/min_size."""
        if self._cache_epoch != self.epoch:
            self._cache.clear()
            self._cache_epoch = self.epoch
        cached = self._cache.get(pg)
        if cached is not None:
            return cached
        out = do_rule(
            self.map, self.ruleno, pg, self.km, self.weights, self.tunables
        )
        acting: List[Optional[int]] = [
            None if v == ITEM_NONE else v for v in out
        ]
        acting += [None] * (self.km - len(acting))
        self._cache[pg] = acting
        return acting

    def acting(self, oid: str) -> List[Optional[int]]:
        return self.acting_for_pg(self.pg_of(oid))

    # -- osdmap mutations --------------------------------------------------

    def mark_out(self, osd_id: int) -> None:
        self.weights[osd_id] = 0
        self.epoch += 1

    def mark_in(self, osd_id: int, weight: float = 1.0) -> None:
        self.weights[osd_id] = weight_fp(weight)
        self.epoch += 1

    def reweight(self, osd_id: int, weight: float) -> None:
        self.weights[osd_id] = weight_fp(weight)
        self.epoch += 1

    # -- elastic membership (online osd add/rm) ----------------------------

    @property
    def n_osds(self) -> int:
        return len(self.weights)

    def ensure_osd(self, osd_id: int, weight_fp16: int = 0) -> bool:
        """Grow the placement so ``osd_id`` is a known device, initially
        at the given 16.16 weight (default 0 = out, so a growth driven
        by a map broadcast only moves data once the weight lands too).
        Idempotent; returns True when the crush map actually grew.

        Flat maps get the device appended to the root straw2 bucket;
        hierarchies get a fresh single-osd host bucket (the smallest
        failure-domain-preserving expansion).  straw2 makes either
        growth minimal-movement by construction: only PGs whose draw
        now favours the new item move.
        """
        if osd_id < len(self.weights):
            return False
        # fill any id gap with weight-0 devices NOT in the crush tree --
        # do_rule treats ids past the weight vector as out, and a hole
        # id never wins a straw2 draw at weight 0.
        while len(self.weights) < osd_id:
            self.weights.append(0)
        self.weights.append(weight_fp16)
        root = self.map.buckets[self._root]
        if self._domain == 0:
            root.add_item(osd_id, 0x10000)
        else:
            hb = self.map.new_bucket(
                type=2, name=f"host-osd{osd_id}"
            )
            hb.add_item(osd_id, 0x10000)
            root.add_item(hb.id, hb.weight)
        self.map.note_device(osd_id)
        self.epoch += 1
        return True

    def add_osd(self, osd_id: int, weight: float = 1.0) -> None:
        """Grow the map AND bring the osd in, in one epoch step."""
        if not self.ensure_osd(osd_id, weight_fp(weight)):
            self.weights[osd_id] = weight_fp(weight)
            self.epoch += 1

    def remove_osd(self, osd_id: int) -> None:
        """Contract: weight drops to 0 so CRUSH remaps away from the
        device (straw2 touches only the PGs that mapped there).  The
        crush bucket entry stays -- a departed id never wins a draw at
        weight 0, and keeping the tree append-only keeps every other
        PG's draw (and hence the movement set) untouched."""
        if osd_id < len(self.weights):
            self.weights[osd_id] = 0
            self.epoch += 1

    # -- movement accounting (expansion/contraction planning) --------------

    def pg_actings(self) -> Dict[int, List[Optional[int]]]:
        """Full pg -> acting snapshot at the current epoch (O(pg_num);
        the expansion planner diffs two of these to find the minimal
        movement set)."""
        return {pg: list(self.acting_for_pg(pg)) for pg in range(self.pg_num)}


def movement_plan(
    before: Dict[int, List[Optional[int]]],
    after: Dict[int, List[Optional[int]]],
) -> List[Tuple[int, int, Optional[int], Optional[int]]]:
    """Diff two pg->acting snapshots into the minimal movement set:
    one (pg, position, src_osd, dst_osd) entry per acting-set slot
    whose holder changed.  Unchanged positions never appear -- only
    moved shards migrate."""
    plan: List[Tuple[int, int, Optional[int], Optional[int]]] = []
    for pg, old in before.items():
        new = after.get(pg, old)
        for pos, (src, dst) in enumerate(zip(old, new)):
            if src != dst:
                plan.append((pg, pos, src, dst))
    return plan


def theoretical_min_moved(
    weights_before: Sequence[int],
    weights_after: Sequence[int],
    total_positions: int,
) -> float:
    """Lower bound on acting-set positions that MUST move for the
    weight change: every osd whose capacity share grew must end up
    holding its new share, so at least sum(max(0, share_after -
    share_before)) of all positions migrate.  A perfectly minimal
    placement (straw2's design goal) moves exactly this."""
    tb = float(sum(weights_before)) or 1.0
    ta = float(sum(weights_after)) or 1.0
    gained = 0.0
    n = max(len(weights_before), len(weights_after))
    for i in range(n):
        wb = weights_before[i] if i < len(weights_before) else 0
        wa = weights_after[i] if i < len(weights_after) else 0
        gained += max(0.0, wa / ta - wb / tb)
    return gained * total_positions
