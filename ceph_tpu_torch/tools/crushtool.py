#!/usr/bin/env python3
"""crushtool analogue: build a map, test a rule, show the distribution.

Port of ``tools/crushtool.py`` over ``ceph_tpu_torch/crush/``.
Reference: src/tools/crushtool.cc (--build/--test/--show-mappings/
--show-utilization).  Operates on the framework's CrushMap; maps are built
from a compact spec instead of compiled text files.

Examples:
    python -m ceph_tpu_torch.tools.crushtool --build 12 --rule erasure \
        --num-rep 6 --min-x 0 --max-x 1023 --show-utilization
    python -m ceph_tpu_torch.tools.crushtool --build 4x3 --rule replicated \
        --num-rep 3 --show-mappings --max-x 7
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter

from ceph_tpu_torch.crush import (
    Tunables,
    build_flat_map,
    build_hierarchy,
    do_rule,
)
from ceph_tpu_torch.crush.map import ITEM_NONE, erasure_rule, replicated_rule


def build_from_spec(spec: str):
    """"N" -> flat root of N osds; "HxD" -> H hosts of D osds each."""
    if "x" in spec:
        h, d = (int(v) for v in spec.split("x"))
        hosts = [[hi * d + di for di in range(d)] for hi in range(h)]
        return build_hierarchy(hosts)
    return build_flat_map(int(spec))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--build", required=True, help='"N" flat or "HxD" hosts')
    p.add_argument("--rule", choices=["replicated", "erasure"], default="erasure")
    p.add_argument("--num-rep", type=int, default=3)
    p.add_argument("--min-x", type=int, default=0)
    p.add_argument("--max-x", type=int, default=1023)
    p.add_argument("--show-mappings", action="store_true")
    p.add_argument("--show-utilization", action="store_true")
    p.add_argument("--dump", action="store_true")
    p.add_argument("--weight", action="append", default=[],
                   metavar="DEV:W", help="override device weight (float)")
    args = p.parse_args(argv)

    m, root = build_from_spec(args.build)
    leaf_type = 2 if "x" in args.build else 0
    if args.rule == "erasure":
        ruleno = m.add_rule(erasure_rule(root, failure_domain_type=leaf_type))
    else:
        ruleno = m.add_rule(replicated_rule(root, leaf_type=leaf_type))

    weights = [0x10000] * m.max_device
    for ov in args.weight:
        dev, w = ov.split(":")
        weights[int(dev)] = int(float(w) * 0x10000)

    if args.dump:
        print(json.dumps(m.dump(), indent=2))
        return 0

    counts: Counter = Counter()
    bad = 0
    for x in range(args.min_x, args.max_x + 1):
        out = do_rule(m, ruleno, x, args.num_rep, weights, Tunables())
        if args.show_mappings:
            show = [("NONE" if v == ITEM_NONE else v) for v in out]
            print(f"CRUSH rule {ruleno} x {x} {show}")
        for v in out:
            if v == ITEM_NONE:
                bad += 1
            else:
                counts[v] += 1
    n_x = args.max_x - args.min_x + 1
    if args.show_utilization:
        for dev in sorted(counts):
            print(f"  device {dev}:\t{counts[dev]}")
    total = sum(counts.values())
    print(
        f"rule {ruleno} ({args.rule}) num_rep {args.num_rep} "
        f"result size == {total / n_x:.2f}/{args.num_rep}\t"
        f"bad mappings {bad}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
