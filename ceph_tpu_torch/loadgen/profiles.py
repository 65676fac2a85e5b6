"""Workload profiles: weighted op/size tables per traffic family.

Port of ``ceph_tpu/loadgen/profiles.py`` (the same tables, so the same
seeded ``random.Random`` draws the same ops in both packages).

Each profile is a declarative schema (documented in docs/qos.md) the
LoadClient samples from:

* ``mix`` -- (op kind, weight) pairs.  Kinds map onto the Objecter
  surface: ``put``/``get`` whole objects (RGW S3/Swift object I/O),
  ``range_write``/``range_read`` sub-object extents (RBD small random
  I/O -- extent writes exercise the RMW read lane), ``meta_set``/
  ``meta_get`` omap metadata (CephFS dirfrag-style), ``cas`` atomic
  omap compare-and-swap and ``exec`` a cls method call (the
  transactional/non-idempotent family the exactly-once machinery
  guards).
* ``sizes`` -- (bytes, weight) pairs for data-carrying ops.

The tables are data, not code: a scenario can pass a custom
WorkloadProfile without touching this module.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

#: op kinds that carry a data payload (size sampling applies)
DATA_KINDS = frozenset({"put", "get", "range_write", "range_read"})
#: op kinds that mutate state (the read/write split in reporting)
WRITE_KINDS = frozenset({"put", "range_write", "meta_set", "cas", "exec"})


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    name: str
    mix: Tuple[Tuple[str, float], ...]
    sizes: Tuple[Tuple[int, float], ...]
    description: str = ""

    def sample(self, rng) -> Tuple[str, int]:
        """One (op kind, payload bytes) draw."""
        kind = _weighted(rng, self.mix)
        size = _weighted(rng, self.sizes) if kind in DATA_KINDS else 0
        return kind, size


def _weighted(rng, pairs):
    total = sum(w for _v, w in pairs)
    roll = rng.random() * total
    acc = 0.0
    for value, weight in pairs:
        acc += weight
        if roll < acc:
            return value
    return pairs[-1][0]


#: the shipped profile set (scenario groups reference these by name)
PROFILES: Dict[str, WorkloadProfile] = {
    p.name: p
    for p in [
        WorkloadProfile(
            "rgw",
            mix=(("put", 3.0), ("get", 6.0), ("meta_get", 1.0)),
            sizes=((4 << 10, 4.0), (16 << 10, 3.0), (64 << 10, 1.0)),
            description="S3/Swift-style object store traffic: GET-heavy "
                        "whole-object I/O with mixed sizes and a bucket-"
                        "listing-ish metadata read share",
        ),
        WorkloadProfile(
            "rbd",
            mix=(("range_write", 5.0), ("range_read", 5.0)),
            sizes=((4 << 10, 6.0), (8 << 10, 3.0), (16 << 10, 1.0)),
            description="block-device-style small random extent I/O "
                        "inside preallocated images (extent writes take "
                        "the RMW lane)",
        ),
        WorkloadProfile(
            "cephfs",
            mix=(("meta_set", 3.0), ("meta_get", 3.0), ("put", 2.0),
                 ("get", 2.0)),
            sizes=((4 << 10, 5.0), (32 << 10, 2.0)),
            description="filesystem-style metadata+data mix: omap "
                        "create/lookup traffic alongside small file "
                        "bodies",
        ),
        WorkloadProfile(
            "put8k",
            mix=(("put", 1.0),),
            sizes=((8 << 10, 1.0),),
            description="uniform 8 KiB PUTs: the fixed-cost probe the "
                        "QoS bench calibrates capacity and reservation "
                        "floors against",
        ),
        WorkloadProfile(
            "txn",
            mix=(("cas", 6.0), ("exec", 2.0), ("meta_get", 2.0)),
            sizes=(),
            description="transactional traffic: omap compare-and-swap "
                        "counters and cls exec calls -- the non-"
                        "idempotent family whose exactly-once accounting "
                        "gates every scenario",
        ),
    ]
}
