"""Run one phase of ``chip_smoke.py`` from several checkouts in turns.

    python -m ceph_tpu_torch.tools.phase_turns --tree DIR --tree DIR \\
        [--phase cluster_path] [--rounds 1] [--seed 0] [--out FILE]

Each turn is a fresh interpreter started in one checkout, with that
checkout's ``ceph_tpu_torch`` and ``chip_smoke.py``: it builds the codec
kernels into the checkout's own ``build/`` and then calls
``chip_smoke.phase_<phase>([registry,] seed, card)``, which prints the
phase's lines.
The trees run in the order given and then reversed (A B B A for two
trees, A B C C B A for three), ``--rounds`` times, so that every tree
meets the card in the same states.  Needs a CUDA card; a checkout is any
tree whose ``chip_smoke.py`` has the phase, such as a ``git archive`` of
an earlier commit.

It prints every turn's result as one JSON line, and last, for the cluster
phase, each tree's write, degraded-read and read-after-recovery GiB/s and
time to clean per profile over its turns.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Dict, List

_TURN = r"""
import json, subprocess, sys
sys.path.insert(0, ".")
import inspect
import chip_smoke
from ceph_tpu_torch.ops import cuda_gf
from ceph_tpu_torch.plugins import registry
cuda_gf.build()  # before the phase, so that no step of it pays for nvcc
card = subprocess.run(
    ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
     "--format=csv,noheader"],
    capture_output=True, text=True, check=True).stdout.strip()
phase = getattr(chip_smoke, "phase_" + sys.argv[1])
args = (int(sys.argv[2]), card)
if next(iter(inspect.signature(phase).parameters)) == "reg":
    args = (registry.instance(),) + args
result = phase(*args)
print("TURN " + json.dumps({"card": card, "result": result}, default=str))
"""

#: the cluster phase's per-profile figures the summary lists
CLUSTER_KEYS = ("write_GiBs", "degraded_read_GiBs", "read_GiBs",
                "time_to_clean_s")


def _turn(tree: str, phase: str, seed: int) -> dict:
    proc = subprocess.run([sys.executable, "-c", _TURN, phase, str(seed)],
                          cwd=tree, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=""))
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: phase {phase} exited "
                           f"{proc.returncode}")
    line = next(ln for ln in reversed(proc.stdout.splitlines())
                if ln.startswith("TURN "))
    return json.loads(line[len("TURN "):])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", action="append", required=True,
                   help="a checkout holding chip_smoke.py (repeatable)")
    p.add_argument("--phase", default="cluster_path")
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="",
                   help="also write the turns' JSON lines to this file")
    args = p.parse_args(argv)
    order = args.tree + args.tree[::-1]
    turns: List[dict] = []
    for _ in range(args.rounds):
        for tree in order:
            rec = _turn(tree, args.phase, args.seed)
            rec["tree"] = tree
            turns.append(rec)
            print(json.dumps(rec, default=str), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for rec in turns:
                f.write(json.dumps(rec, default=str) + "\n")
    if args.phase == "cluster_path":
        summary: Dict[str, Dict[str, Dict[str, list]]] = {}
        for rec in turns:
            per_tree = summary.setdefault(rec["tree"], {})
            for label, row in rec["result"].items():
                cell = per_tree.setdefault(label, {k: [] for k in
                                                   CLUSTER_KEYS})
                for key in CLUSTER_KEYS:
                    cell[key].append(row[key])
        print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
