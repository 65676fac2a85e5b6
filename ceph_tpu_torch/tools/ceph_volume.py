#!/usr/bin/env python3
"""ceph-volume analogue: OSD provisioning (prepare / activate / list).

Port of ``tools/ceph_volume.py``.  ``activate`` boots the OSD through the
port's ``vstart.spawn_osd``: a ``python -m ceph_tpu_torch.daemon.osd``
process that builds its pool's codec (on the card for a pool of the
``cuda`` plugin, with its own CUDA context) before it listens.  Where the
reference watches the new process for 2 s, ``activate`` waits until the
daemon's port accepts connections (at most ``ACTIVATE_WAIT_S``), failing
if it exits first: on the card an OSD takes seconds to load torch and
make its context.  As in the reference, ``activate`` spawns the OSD
without a keyring (a cluster started with ``--auth`` is not a target).

Reference: src/ceph-volume -- prepares an OSD's backing storage (writes
the bootstrap files: fsid, whoami, type) and activates it (boots the
daemon against the prepared directory).

    python -m ceph_tpu_torch.tools.ceph_volume prepare --run-dir RUN \
        --id 0 [--objectstore blockstore]
    python -m ceph_tpu_torch.tools.ceph_volume activate --run-dir RUN --id 0
    python -m ceph_tpu_torch.tools.ceph_volume list --run-dir RUN
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
import uuid

#: seconds ``activate`` waits for the OSD's port
ACTIVATE_WAIT_S = 60.0


def osd_dir(run_dir: str, osd_id: int) -> str:
    return os.path.join(run_dir, "data", f"osd.{osd_id}")


def prepare(args) -> int:
    d = osd_dir(args.run_dir, args.id)
    os.makedirs(d, exist_ok=True)
    meta_path = os.path.join(d, "osd_meta.json")
    if os.path.exists(meta_path):
        print(f"osd.{args.id} already prepared", file=sys.stderr)
        return 1
    # the reference writes fsid/whoami/type files into the OSD dir
    with open(meta_path, "w") as f:
        json.dump({
            "fsid": str(uuid.uuid4()),
            "whoami": args.id,
            "objectstore": args.objectstore,
            "prepared": True,
        }, f, indent=2)
    print(f"prepared osd.{args.id} ({args.objectstore}) at {d}")
    return 0


def activate(args) -> int:
    """Boot the prepared OSD.  Requires a vstart-initialized run dir
    (addr_map.json + cluster.json): ceph-volume provisions the STORAGE,
    the cluster bring-up owns the address book, as in the reference."""
    from ceph_tpu_torch.tools import vstart

    d = osd_dir(args.run_dir, args.id)
    meta_path = os.path.join(d, "osd_meta.json")
    if not os.path.exists(meta_path):
        print(f"osd.{args.id} is not prepared", file=sys.stderr)
        return 1
    map_path = os.path.join(args.run_dir, "addr_map.json")
    if not os.path.exists(map_path):
        print(f"{args.run_dir} has no addr_map.json (run vstart first)",
              file=sys.stderr)
        return 1
    with open(meta_path) as f:
        meta = json.load(f)
    with open(map_path) as f:
        addr = json.load(f)[f"osd.{args.id}"]
    pid = vstart.spawn_osd(
        args.run_dir, args.id, objectstore=meta["objectstore"],
        data_path=os.path.join(args.run_dir, "data"),
    )
    # readiness: the daemon must survive its boot sequence and listen
    try:
        vstart._wait_port(addr, time.time() + ACTIVATE_WAIT_S,
                          f"osd.{args.id}", args.run_dir, pid)
    except RuntimeError as e:  # it exited before it listened
        print(f"osd.{args.id} died during boot: {e}", file=sys.stderr)
        return 1
    except TimeoutError as e:
        os.kill(pid, signal.SIGKILL)
        print(f"osd.{args.id} did not come up: {e}", file=sys.stderr)
        return 1
    # track the pid where vstart's stop_cluster looks for it
    pids = vstart._load_pids(args.run_dir)
    pids[args.id] = pid
    vstart._save_pids(args.run_dir, pids)
    print(f"activated osd.{args.id} pid={pid}")
    return 0


def list_osds(args) -> int:
    base = os.path.join(args.run_dir, "data")
    if not os.path.isdir(base):
        print("{}")
        return 0
    out = {}
    for entry in sorted(os.listdir(base)):
        meta_path = os.path.join(base, entry, "osd_meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                out[entry] = json.load(f)
    print(json.dumps(out, indent=2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in (("prepare", prepare), ("activate", activate),
                     ("list", list_osds)):
        p = sub.add_parser(name)
        p.add_argument("--run-dir", required=True)
        if name != "list":
            p.add_argument("--id", type=int, required=True)
        if name == "prepare":
            p.add_argument("--objectstore", default="blockstore")
        p.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
