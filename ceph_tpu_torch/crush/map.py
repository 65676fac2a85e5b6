"""CRUSH map model: devices, buckets, rules.

Port of ``ceph_tpu/crush/map.py``.

Reference: src/crush/crush.h (struct crush_map / crush_bucket / crush_rule),
src/crush/builder.c (map construction), src/crush/CrushWrapper.h (named
types/items).  Weights are 16.16 fixed point exactly as the reference's
(0x10000 == weight 1.0); bucket ids are negative, device ids >= 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# bucket algorithms (reference: crush.h:140-190)
BUCKET_UNIFORM = 1
BUCKET_LIST = 2
BUCKET_TREE = 3
BUCKET_STRAW = 4  # legacy straw1 (hammer straw_calc_version=1 straws)
BUCKET_STRAW2 = 5

# rule step ops (reference: crush.h CRUSH_RULE_*)
RULE_TAKE = 1
RULE_CHOOSE_FIRSTN = 2
RULE_CHOOSE_INDEP = 3
RULE_EMIT = 4
RULE_CHOOSELEAF_FIRSTN = 6
RULE_CHOOSELEAF_INDEP = 7
RULE_SET_CHOOSE_TRIES = 8
RULE_SET_CHOOSELEAF_TRIES = 9

ITEM_NONE = 0x7FFFFFFF  # reference: crush.h CRUSH_ITEM_NONE
ITEM_UNDEF = 0x7FFFFFFE

_STEP_NAMES = {
    RULE_TAKE: "take",
    RULE_CHOOSE_FIRSTN: "choose firstn",
    RULE_CHOOSE_INDEP: "choose indep",
    RULE_EMIT: "emit",
    RULE_CHOOSELEAF_FIRSTN: "chooseleaf firstn",
    RULE_CHOOSELEAF_INDEP: "chooseleaf indep",
    RULE_SET_CHOOSE_TRIES: "set_choose_tries",
    RULE_SET_CHOOSELEAF_TRIES: "set_chooseleaf_tries",
}


@dataclass
class Bucket:
    """One interior node of the hierarchy.

    ``weights`` are per-item 16.16 fixed point; the bucket's own weight is
    their sum (straw2 draws only consult per-item weights).
    """

    id: int  # negative
    type: int  # 0 is reserved for devices
    alg: int = BUCKET_STRAW2
    items: List[int] = field(default_factory=list)
    weights: List[int] = field(default_factory=list)
    name: str = ""

    def __post_init__(self) -> None:
        if self.id >= 0:
            raise ValueError("bucket ids must be negative")
        if len(self.items) != len(self.weights):
            raise ValueError("items/weights length mismatch")

    @property
    def size(self) -> int:
        return len(self.items)

    @property
    def weight(self) -> int:
        return sum(self.weights)

    def add_item(self, item: int, weight: int) -> None:
        self.items.append(item)
        self.weights.append(weight)
        # derived-array caches (tree node weights, straw lengths)
        self._tree_cache = None
        self._straw_cache = None

    def items_array(self) -> np.ndarray:
        return np.asarray(self.items, dtype=np.int64)

    def weights_array(self) -> np.ndarray:
        return np.asarray(self.weights, dtype=np.int64)

    # -- tree bucket (reference builder.c crush_make_tree_bucket) ----------

    def tree_node_weights(self) -> np.ndarray:
        """node_weights over the 2^depth binary-tree labels (items at
        odd nodes via crush_calc_tree_node(i) = ((i+1)<<1)-1; each
        ancestor holds its subtree's weight sum).  Cached: do_rule
        draws per replica per retry, and the reference computes this
        once at map build (builder.c crush_make_tree_bucket)."""
        cached = getattr(self, "_tree_cache", None)
        if cached is not None:
            return cached
        size = self.size
        if size == 0:
            return np.zeros(0, dtype=np.int64)
        depth = 1
        t = size - 1
        while t:
            t >>= 1
            depth += 1
        nw = np.zeros(1 << depth, dtype=np.int64)
        for i, w in enumerate(self.weights):
            node = ((i + 1) << 1) - 1
            nw[node] = w
            for _ in range(1, depth):
                node = _tree_parent(node)
                nw[node] += w
        self._tree_cache = nw
        return nw

    # -- legacy straw1 (builder.c crush_calc_straw, calc version 1) --------

    def straws(self) -> np.ndarray:
        """Per-item straw lengths (16.16) for the legacy straw bucket,
        per the hammer straw_calc_version=1 recipe: ascending-weight
        walk, each weight step scales the remaining straws by
        (1/pbelow)^(1/numleft).  Cached like the tree node weights."""
        import math

        cached = getattr(self, "_straw_cache", None)
        if cached is not None:
            return cached
        size = self.size
        straws = np.zeros(size, dtype=np.int64)
        order = sorted(range(size), key=lambda i: self.weights[i])
        numleft = size
        straw = 1.0
        wbelow = 0.0
        lastw = 0.0
        i = 0
        while i < size:
            if self.weights[order[i]] == 0:
                straws[order[i]] = 0
                i += 1
                numleft -= 1
                continue
            straws[order[i]] = int(straw * 0x10000)
            i += 1
            if i == size:
                break
            wbelow += (float(self.weights[order[i - 1]]) - lastw) * numleft
            numleft -= 1
            wnext = numleft * (self.weights[order[i]]
                               - self.weights[order[i - 1]])
            pbelow = wbelow / (wbelow + wnext) if (wbelow + wnext) else 1.0
            if pbelow > 0:
                straw *= math.pow(1.0 / pbelow, 1.0 / numleft)
            lastw = float(self.weights[order[i - 1]])
        self._straw_cache = straws
        return straws


def _tree_parent(n: int) -> int:
    """Parent in the tree bucket's node labelling (builder.c parent())."""
    h = 0
    t = n
    while (t & 1) == 0:
        h += 1
        t >>= 1
    if n & (1 << (h + 1)):  # on the right of its parent
        return n - (1 << h)
    return n + (1 << h)


@dataclass
class Step:
    op: int
    arg1: int = 0
    arg2: int = 0

    def __str__(self) -> str:
        return f"{_STEP_NAMES.get(self.op, self.op)} {self.arg1} {self.arg2}"


@dataclass
class Rule:
    steps: List[Step]
    name: str = ""
    # reference rules carry min_size/max_size; unused by do_rule itself.


class CrushMap:
    """The placement map: devices + bucket hierarchy + rules.

    ``max_device`` bounds device ids (reference: crush_map.max_devices);
    out-ness is controlled by the per-device ``device_weights`` vector the
    caller passes to :func:`ceph_tpu_torch.crush.mapper.do_rule` (reference passes
    the osdmap's weights the same way, OSDMap.cc crush->do_rule call sites).
    """

    def __init__(self) -> None:
        self.buckets: Dict[int, Bucket] = {}
        self.rules: List[Rule] = []
        self.max_device = 0
        self.type_names: Dict[int, str] = {0: "osd"}
        self._next_id = -1

    # -- construction ------------------------------------------------------

    def new_bucket(
        self,
        type: int,
        alg: int = BUCKET_STRAW2,
        name: str = "",
        id: Optional[int] = None,
    ) -> Bucket:
        if id is None:
            id = self._next_id
        b = Bucket(id=id, type=type, alg=alg, name=name)
        if id in self.buckets:
            raise ValueError(f"duplicate bucket id {id}")
        self.buckets[id] = b
        self._next_id = min(self.buckets) - 1
        return b

    def note_device(self, dev: int) -> None:
        self.max_device = max(self.max_device, dev + 1)

    def add_rule(self, rule: Rule) -> int:
        self.rules.append(rule)
        return len(self.rules) - 1

    def bucket_by_name(self, name: str) -> Bucket:
        for b in self.buckets.values():
            if b.name == name:
                return b
        raise KeyError(name)

    # -- introspection (CrushWrapper-lite) ---------------------------------

    def dump(self) -> dict:
        return {
            "max_device": self.max_device,
            "buckets": [
                {
                    "id": b.id,
                    "name": b.name,
                    "type": b.type,
                    "alg": {BUCKET_UNIFORM: "uniform", BUCKET_LIST: "list",
                            BUCKET_TREE: "tree", BUCKET_STRAW: "straw",
                            BUCKET_STRAW2: "straw2"}.get(b.alg, b.alg),
                    "items": [
                        {"id": i, "weight": w / 0x10000}
                        for i, w in zip(b.items, b.weights)
                    ],
                }
                for b in sorted(self.buckets.values(), key=lambda b: -b.id)
            ],
            "rules": [
                {"rule_id": i, "name": r.name, "steps": [str(s) for s in r.steps]}
                for i, r in enumerate(self.rules)
            ],
        }


def weight_fp(w: float) -> int:
    """Float weight -> 16.16 fixed point."""
    return int(round(w * 0x10000))


def build_flat_map(
    n_osds: int, weights: Optional[Sequence[float]] = None
) -> Tuple[CrushMap, int]:
    """One straw2 root holding all OSDs. Returns (map, root_id)."""
    m = CrushMap()
    root = m.new_bucket(type=1, name="root")
    m.type_names[1] = "root"
    for i in range(n_osds):
        w = weight_fp(weights[i]) if weights is not None else 0x10000
        root.add_item(i, w)
        m.note_device(i)
    return m, root.id


def build_hierarchy(
    hosts: Sequence[Sequence[int]],
    weights: Optional[Dict[int, float]] = None,
) -> Tuple[CrushMap, int]:
    """root -> host buckets -> osds (the canonical 2-level tree).

    ``hosts`` is a list of osd-id lists, one per host.  Returns
    (map, root_id); host buckets get type 2 ("host"), root type 3 ("root").
    """
    m = CrushMap()
    m.type_names.update({2: "host", 3: "root"})
    root = m.new_bucket(type=3, name="root", id=-1)
    next_id = -2
    for hi, osds in enumerate(hosts):
        hb = m.new_bucket(type=2, name=f"host{hi}", id=next_id)
        next_id -= 1
        for o in osds:
            w = weight_fp(weights.get(o, 1.0)) if weights else 0x10000
            hb.add_item(o, w)
            m.note_device(o)
        root.add_item(hb.id, hb.weight)
    return m, root.id


def replicated_rule(root_id: int, leaf_type: int = 0) -> Rule:
    """firstn rule: N distinct leaves (reference: default replicated_rule)."""
    steps = [Step(RULE_TAKE, root_id)]
    if leaf_type:
        steps.append(Step(RULE_CHOOSELEAF_FIRSTN, 0, leaf_type))
    else:
        steps.append(Step(RULE_CHOOSE_FIRSTN, 0, 0))
    steps.append(Step(RULE_EMIT))
    return Rule(steps, name="replicated")


def erasure_rule(
    root_id: int, failure_domain_type: int = 0, tries: int = 100
) -> Rule:
    """indep rule with positional holes, as ErasureCode::create_rule builds
    (reference: src/erasure-code/ErasureCode.cc:54-73 — set_chooseleaf_tries 5,
    take root, chooseleaf indep 0 type <domain>, emit; "indep" mode keeps
    surviving shards at their positions when one is unmappable)."""
    steps = [
        Step(RULE_SET_CHOOSELEAF_TRIES, 5),
        Step(RULE_SET_CHOOSE_TRIES, tries),
        Step(RULE_TAKE, root_id),
    ]
    if failure_domain_type:
        steps.append(Step(RULE_CHOOSELEAF_INDEP, 0, failure_domain_type))
    else:
        steps.append(Step(RULE_CHOOSE_INDEP, 0, 0))
    steps.append(Step(RULE_EMIT))
    return Rule(steps, name="erasure")
