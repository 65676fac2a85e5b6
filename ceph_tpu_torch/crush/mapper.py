"""CRUSH rule execution: straw2 draws, firstn/indep descent, retries.

Port of ``ceph_tpu/crush/mapper.py``.

Reference: src/crush/mapper.c — bucket_straw2_choose (:361),
crush_choose_firstn (:470), crush_choose_indep (:720), crush_do_rule (:860),
is_out (:441).  The straw2 exponential draw replaces the reference's
fixed-point log lookup table (crush_ln_table.h) with a precomputed
2^44*log2(u+1) table built at import — same fixed-point scale, same
[0,0xffff] -> [-2^48,0] mapping, built from the formula rather than the
shipped table (semantic parity; see docs/crush.md for the derivation).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ceph_tpu_torch.crush.hash import (crush_hash32_2, crush_hash32_3,
                                 crush_hash32_4)
from ceph_tpu_torch.crush.map import (
    BUCKET_LIST,
    BUCKET_STRAW,
    BUCKET_STRAW2,
    BUCKET_TREE,
    BUCKET_UNIFORM,
    ITEM_NONE,
    ITEM_UNDEF,
    RULE_CHOOSE_FIRSTN,
    RULE_CHOOSE_INDEP,
    RULE_CHOOSELEAF_FIRSTN,
    RULE_CHOOSELEAF_INDEP,
    RULE_EMIT,
    RULE_SET_CHOOSE_TRIES,
    RULE_SET_CHOOSELEAF_TRIES,
    RULE_TAKE,
    Bucket,
    CrushMap,
)

_S64_MIN = -(2**63)

# ln table: u in [0,0xffff] -> 2^44*log2(u+1) - 2^48  (<= 0).
# The reference's crush_ln computes the same quantity via a 256-entry
# reciprocal+log lookup (mapper.c:248-292); we build the full table directly.
_LN = (np.floor((2.0**44) * np.log2(np.arange(1, 0x10001, dtype=np.float64)))
       .astype(np.int64) - (1 << 48))


@dataclass
class Tunables:
    """Default values = the reference's "jewel" optimal profile
    (reference: src/crush/CrushWrapper.h set_tunables_jewel)."""

    choose_total_tries: int = 50
    choose_local_tries: int = 0
    choose_local_fallback_tries: int = 0
    chooseleaf_descend_once: int = 1
    chooseleaf_vary_r: int = 1
    chooseleaf_stable: int = 1


def _straw2_choose(bucket: Bucket, x: int, r: int) -> int:
    """Max exponential draw wins; weight-0 items can never win unless all
    are weight 0 (then index 0 wins, as the reference's i==0 seed does)."""
    items = bucket.items_array()
    weights = bucket.weights_array()
    u = np.asarray(
        crush_hash32_3(x, (items & 0xFFFFFFFF).astype(np.uint64), r)
    ).astype(np.int64) & 0xFFFF
    ln = _LN[u]
    draws = np.full(len(items), _S64_MIN, dtype=np.int64)
    nz = weights > 0
    # C div64_s64 truncates toward zero; ln <= 0, so negate-floordiv-negate.
    draws[nz] = -((-ln[nz]) // weights[nz])
    return int(items[int(np.argmax(draws))])


def _perm_choose(bucket: Bucket, x: int, r: int) -> int:
    """Pseudorandom-permutation choose for uniform buckets: a deterministic
    Fisher-Yates shuffle seeded by (x, bucket.id), position r mod size
    (reference: mapper.c bucket_perm_choose builds work->perm lazily)."""
    n = bucket.size
    perm = list(range(n))
    for i in range(n - 1):
        j = i + int(crush_hash32_3(x, bucket.id & 0xFFFFFFFF, i)) % (n - i)
        perm[i], perm[j] = perm[j], perm[i]
    return bucket.items[perm[r % n]]


def _list_choose(bucket: Bucket, x: int, r: int) -> int:
    """Walk from most-recently-added; draw w*2^16-scaled hash vs cumulative
    weight (reference: mapper.c bucket_list_choose)."""
    cum = 0
    for i in range(bucket.size - 1, -1, -1):
        cum += bucket.weights[i]
    running = cum
    for i in range(bucket.size - 1, 0, -1):
        w = int(crush_hash32_3(x, bucket.items[i] & 0xFFFFFFFF, r)) & 0xFFFF
        if w * running < bucket.weights[i] << 16:
            return bucket.items[i]
        running -= bucket.weights[i]
    return bucket.items[0]


def _tree_choose(bucket: Bucket, x: int, r: int) -> int:
    """Binary-tree descent (reference: mapper.c bucket_tree_choose
    :195-222): at each interior node draw a point in [0, node weight)
    via hash32_4(x, node, r, bucket id) and descend left when it falls
    under the left subtree's weight; items sit at odd node labels."""
    nw = bucket.tree_node_weights()
    n = len(nw) >> 1  # root
    if int(nw[n]) == 0:
        # all-zero weights: every draw is 0 and the descent would walk
        # into the right padding (IndexError); mirror straw2's
        # all-zero tiebreak and answer item 0
        return bucket.items[0]
    while not (n & 1):
        w = int(nw[n])
        t = (int(crush_hash32_4(
            x, n, r, bucket.id & 0xFFFFFFFF)) * w) >> 32
        h = 0
        m = n
        while (m & 1) == 0:
            h += 1
            m >>= 1
        left = n - (1 << (h - 1))
        n = left if t < int(nw[left]) else n + (1 << (h - 1))
    return bucket.items[n >> 1]


def _straw_choose(bucket: Bucket, x: int, r: int) -> int:
    """Legacy straw1 draw (reference: mapper.c bucket_straw_choose
    :227-248): (hash & 0xffff) * precomputed straw length, max wins."""
    straws = bucket.straws()
    items = bucket.items_array()
    draws = (np.asarray(crush_hash32_3(
        x, (items & 0xFFFFFFFF).astype(np.uint64), r)
    ).astype(np.int64) & 0xFFFF) * straws
    return int(items[int(np.argmax(draws))])


def _bucket_choose(bucket: Bucket, x: int, r: int) -> int:
    if bucket.alg == BUCKET_STRAW2:
        return _straw2_choose(bucket, x, r)
    if bucket.alg == BUCKET_UNIFORM:
        return _perm_choose(bucket, x, r)
    if bucket.alg == BUCKET_LIST:
        return _list_choose(bucket, x, r)
    if bucket.alg == BUCKET_TREE:
        return _tree_choose(bucket, x, r)
    if bucket.alg == BUCKET_STRAW:
        return _straw_choose(bucket, x, r)
    raise ValueError(f"unknown bucket alg {bucket.alg}")


def _is_out(
    device_weights: Optional[Sequence[int]], item: int, x: int
) -> bool:
    """Probabilistic reweight/out test (reference: mapper.c:441 is_out)."""
    if device_weights is None:
        return False
    if item >= len(device_weights):
        return True
    w = device_weights[item]
    if w >= 0x10000:
        return False
    if w == 0:
        return True
    return (int(crush_hash32_2(x, item)) & 0xFFFF) >= w


def _item_type(m: CrushMap, item: int) -> int:
    return m.buckets[item].type if item < 0 else 0


def _choose_firstn(
    m: CrushMap,
    bucket: Bucket,
    device_weights: Optional[Sequence[int]],
    x: int,
    numrep: int,
    type: int,
    out: List[int],
    outpos: int,
    out_size: int,
    tries: int,
    recurse_tries: int,
    local_retries: int,
    local_fallback_retries: int,
    recurse_to_leaf: bool,
    vary_r: int,
    stable: int,
    out2: Optional[List[int]],
    parent_r: int,
) -> int:
    """Returns new outpos.  Mirrors mapper.c crush_choose_firstn's
    reject/collide/retry ladder exactly."""
    count = out_size
    item = 0
    rep = 0 if stable else outpos
    while rep < numrep and count > 0:
        ftotal = 0
        skip_rep = False
        retry_descent = True
        while retry_descent:
            retry_descent = False
            in_b = bucket
            flocal = 0
            retry_bucket = True
            while retry_bucket:
                retry_bucket = False
                collide = False
                reject = False
                r = rep + parent_r + ftotal
                if in_b.size == 0:
                    reject = True
                else:
                    if (
                        local_fallback_retries > 0
                        and flocal >= (in_b.size >> 1)
                        and flocal > local_fallback_retries
                    ):
                        item = _perm_choose(in_b, x, r)
                    else:
                        item = _bucket_choose(in_b, x, r)
                    if item >= m.max_device:
                        skip_rep = True
                        break
                    itemtype = _item_type(m, item)
                    if itemtype != type:
                        if item >= 0 or item not in m.buckets:
                            skip_rep = True
                            break
                        in_b = m.buckets[item]
                        retry_bucket = True
                        continue
                    for i in range(outpos):
                        if out[i] == item:
                            collide = True
                            break
                    if not collide and recurse_to_leaf:
                        if item < 0:
                            sub_r = r >> (vary_r - 1) if vary_r else 0
                            if (
                                _choose_firstn(
                                    m,
                                    m.buckets[item],
                                    device_weights,
                                    x,
                                    1 if stable else outpos + 1,
                                    0,
                                    out2,
                                    outpos,
                                    count,
                                    recurse_tries,
                                    0,
                                    local_retries,
                                    local_fallback_retries,
                                    False,
                                    vary_r,
                                    stable,
                                    None,
                                    sub_r,
                                )
                                <= outpos
                            ):
                                reject = True  # didn't get a leaf
                        else:
                            out2[outpos] = item
                    if not reject and not collide and itemtype == 0:
                        reject = _is_out(device_weights, item, x)

                if reject or collide:
                    ftotal += 1
                    flocal += 1
                    if collide and flocal <= local_retries:
                        retry_bucket = True
                    elif (
                        local_fallback_retries > 0
                        and flocal <= in_b.size + local_fallback_retries
                    ):
                        retry_bucket = True
                    elif ftotal < tries:
                        retry_descent = True
                    else:
                        skip_rep = True
        if skip_rep:
            rep += 1
            continue
        out[outpos] = item
        outpos += 1
        count -= 1
        rep += 1
    return outpos


def _choose_indep(
    m: CrushMap,
    bucket: Bucket,
    device_weights: Optional[Sequence[int]],
    x: int,
    left: int,
    numrep: int,
    type: int,
    out: List[int],
    outpos: int,
    tries: int,
    recurse_tries: int,
    recurse_to_leaf: bool,
    out2: Optional[List[int]],
    parent_r: int,
) -> None:
    """Positional selection with CRUSH_ITEM_NONE holes
    (reference: mapper.c crush_choose_indep)."""
    endpos = outpos + left
    for rep in range(outpos, endpos):
        out[rep] = ITEM_UNDEF
        if out2 is not None:
            out2[rep] = ITEM_UNDEF

    ftotal = 0
    while left > 0 and ftotal < tries:
        for rep in range(outpos, endpos):
            if out[rep] != ITEM_UNDEF:
                continue
            in_b = bucket
            while True:
                r = rep + parent_r
                if in_b.alg == BUCKET_UNIFORM and in_b.size % numrep == 0:
                    r += (numrep + 1) * ftotal
                else:
                    r += numrep * ftotal
                if in_b.size == 0:
                    # reference breaks without placing (mapper.c "empty
                    # bucket"): a later ftotal pass may pick a different
                    # subtree; cleanup converts leftover UNDEF to NONE.
                    break
                item = _bucket_choose(in_b, x, r)
                if item >= m.max_device:
                    out[rep] = ITEM_NONE
                    if out2 is not None:
                        out2[rep] = ITEM_NONE
                    left -= 1
                    break
                itemtype = _item_type(m, item)
                if itemtype != type:
                    if item >= 0 or item not in m.buckets:
                        out[rep] = ITEM_NONE
                        if out2 is not None:
                            out2[rep] = ITEM_NONE
                        left -= 1
                        break
                    in_b = m.buckets[item]
                    continue
                collide = False
                for i in range(outpos, endpos):
                    if out[i] == item:
                        collide = True
                        break
                if collide:
                    break
                if recurse_to_leaf:
                    if item < 0:
                        _choose_indep(
                            m,
                            m.buckets[item],
                            device_weights,
                            x,
                            1,
                            numrep,
                            0,
                            out2,
                            rep,
                            recurse_tries,
                            0,
                            False,
                            None,
                            r,
                        )
                        if out2[rep] == ITEM_NONE:
                            break
                    else:
                        out2[rep] = item
                if itemtype == 0 and _is_out(device_weights, item, x):
                    break
                out[rep] = item
                left -= 1
                break
        ftotal += 1

    for rep in range(outpos, endpos):
        if out[rep] == ITEM_UNDEF:
            out[rep] = ITEM_NONE
        if out2 is not None and out2[rep] == ITEM_UNDEF:
            out2[rep] = ITEM_NONE


def do_rule(
    m: CrushMap,
    ruleno: int,
    x: int,
    result_max: int,
    device_weights: Optional[Sequence[int]] = None,
    tunables: Optional[Tunables] = None,
) -> List[int]:
    """Execute a rule for input x; returns up to result_max device ids
    (ITEM_NONE marks an unmappable indep position).
    Reference: mapper.c crush_do_rule."""
    t = tunables or Tunables()
    if ruleno >= len(m.rules):
        return []
    rule = m.rules[ruleno]

    choose_tries = t.choose_total_tries + 1  # off-by-one compat (mapper.c:884)
    choose_leaf_tries = 0
    result: List[int] = []
    w: List[int] = []
    for step in rule.steps:
        if step.op == RULE_TAKE:
            tgt = step.arg1
            if (0 <= tgt < m.max_device) or tgt in m.buckets:
                w = [tgt]
        elif step.op == RULE_SET_CHOOSE_TRIES:
            if step.arg1 > 0:
                choose_tries = step.arg1
        elif step.op == RULE_SET_CHOOSELEAF_TRIES:
            if step.arg1 > 0:
                choose_leaf_tries = step.arg1
        elif step.op in (
            RULE_CHOOSE_FIRSTN,
            RULE_CHOOSE_INDEP,
            RULE_CHOOSELEAF_FIRSTN,
            RULE_CHOOSELEAF_INDEP,
        ):
            if not w:
                continue
            firstn = step.op in (RULE_CHOOSE_FIRSTN, RULE_CHOOSELEAF_FIRSTN)
            recurse_to_leaf = step.op in (
                RULE_CHOOSELEAF_FIRSTN,
                RULE_CHOOSELEAF_INDEP,
            )
            o: List[int] = [ITEM_NONE] * result_max
            c: List[int] = [ITEM_NONE] * result_max
            osize = 0
            for wi in w:
                numrep = step.arg1
                if numrep <= 0:
                    numrep += result_max
                    if numrep <= 0:
                        continue
                if wi >= 0 or wi not in m.buckets:
                    continue  # probably ITEM_NONE
                bucket = m.buckets[wi]
                if firstn:
                    if choose_leaf_tries:
                        recurse_tries = choose_leaf_tries
                    elif t.chooseleaf_descend_once:
                        recurse_tries = 1
                    else:
                        recurse_tries = choose_tries
                    osize = _choose_firstn(
                        m,
                        bucket,
                        device_weights,
                        x,
                        numrep,
                        step.arg2,
                        o,
                        osize,
                        result_max - osize,
                        choose_tries,
                        recurse_tries,
                        t.choose_local_tries,
                        t.choose_local_fallback_tries,
                        recurse_to_leaf,
                        t.chooseleaf_vary_r,
                        t.chooseleaf_stable,
                        c,
                        0,
                    )
                else:
                    out_size = min(numrep, result_max - osize)
                    _choose_indep(
                        m,
                        bucket,
                        device_weights,
                        x,
                        out_size,
                        numrep,
                        step.arg2,
                        o,
                        osize,
                        choose_tries,
                        choose_leaf_tries if choose_leaf_tries else 1,
                        recurse_to_leaf,
                        c,
                        0,
                    )
                    osize += out_size
            if recurse_to_leaf:
                o = c[:]  # final leaf values become the working set
            w = o[:osize]
        elif step.op == RULE_EMIT:
            result.extend(w[: result_max - len(result)])
            w = []
    return result
