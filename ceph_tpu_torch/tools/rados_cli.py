#!/usr/bin/env python3
"""rados: the object CLI against a running vstart cluster.

Port of ``tools/rados_cli.py`` against a cluster of the port's daemons
(``python -m ceph_tpu_torch.tools.vstart``): the same subcommands and
output lines.  Object I/O goes through the port's ``RemoteClient``; the
chunk math runs in the OSD processes, on the card where the pool's
profile puts it (the client builds the pool's codec for its chunk count,
on the card for a ``cuda`` pool, or on the CPU where the profile says
``device=cpu``).  ``residency`` prints the port's ``library_builds``
counter as ``builds`` where the reference prints ``jit_retraces`` as
``retraces``: the port compiles no JIT programs.

Reference: src/tools/rados/rados.cc -- put/get/rm/stat/ls/df plus omap
key commands against a live pool.  Connects through the same
RemoteClient/Objecter path every librados user takes; ``ls`` and ``df``
aggregate over the daemons' admin sockets (the reference lists via PG
listing; the admin-socket union serves the same operator need on the
mini-cluster).

Usage (``python -m ceph_tpu_torch.tools.rados_cli ...``):
  --dir RUN status                  (`ceph -s`, wire-fed)
  --dir RUN health [detail]
  --dir RUN pg stat
  --dir RUN put <obj> <file>
  --dir RUN get <obj> [<file>]      (default: stdout)
  --dir RUN rm <obj>
  --dir RUN stat <obj>
  --dir RUN ls
  --dir RUN df
  --dir RUN tier status
  --dir RUN recovery status
  --dir RUN ops [in-flight|historic|slow]
  --dir RUN trace [status|<trace_id>]
  --dir RUN profile [status|dump|reset]
  --dir RUN log last [n]
  --dir RUN residency status
  --dir RUN setomapval <obj> <key> <value>
  --dir RUN listomapvals <obj>
"""

from __future__ import annotations

import argparse
import asyncio
import glob
import json
import os
import sys

from ceph_tpu_torch.daemon.client import RemoteClient
from ceph_tpu_torch.utils import aio
from ceph_tpu_torch.utils.admin_socket import admin_command


async def _connect(run_dir: str) -> RemoteClient:
    conf = await aio.read_json(os.path.join(run_dir, "cluster.json"))
    keyring = None
    kr_path = os.path.join(run_dir, "keyring")
    if conf.get("auth") and os.path.exists(kr_path):
        keyring = kr_path
    c = await RemoteClient.connect(
        os.path.join(run_dir, "addr_map.json"), dict(conf["profile"]),
        keyring=keyring,
    )
    await c.probe_osds()  # learn down daemons up front so ops route
    # around them instead of burning the full op timeout
    return c


def _asoks(run_dir: str):
    # daemons drop sockets next to their data dir (RUN/data by default)
    return sorted(glob.glob(os.path.join(run_dir, "osd.*.asok"))
                  + glob.glob(os.path.join(run_dir, "data", "osd.*.asok")))


def _mgr_asoks(run_dir: str):
    return sorted(glob.glob(os.path.join(run_dir, "mgr.*.asok"))
                  + glob.glob(os.path.join(run_dir, "data", "mgr.*.asok")))


async def _mgr_command(run_dir: str, prefix: str, **kw):
    """First answering mgr's reply, or None when no mgr is reachable
    (telemetry-off clusters)."""
    for sock in _mgr_asoks(run_dir):
        try:
            reply = await admin_command(sock, prefix, **kw)
        except (OSError, ValueError):
            continue
        if isinstance(reply, dict) and "error" in reply:
            continue
        return reply
    return None


async def _run(args) -> int:
    if args.cmd == "status":
        # `ceph -s` against the live cluster: everything below arrived
        # over the wire as beacon/report frames and was folded into the
        # mgr's PGMap -- no in-process introspection anywhere
        st = await _mgr_command(args.dir, "status text")
        if st is None:
            print("no reachable mgr (cluster started with --mgrs 0?)",
                  file=sys.stderr)
            return 1
        sys.stdout.write(st["text"])
        return 0
    if args.cmd == "health":
        health = await _mgr_command(args.dir, "health")
        if health is None:
            print("no reachable mgr (cluster started with --mgrs 0?)",
                  file=sys.stderr)
            return 1
        print(health["status"])
        if args.args and args.args[0] == "detail":
            for name, chk in sorted(health["checks"].items()):
                print(f"[{chk['severity']}] {name}: {chk['summary']}")
        return 0
    if args.cmd == "pg":
        # `ceph pg stat`: the per-(pool, primary) slice histogram +
        # degraded/misplaced totals + the io rate block
        which = args.args[0] if args.args else "stat"
        if which != "stat":
            print(f"unknown pg view {which!r} (stat)", file=sys.stderr)
            return 1
        stat = await _mgr_command(args.dir, "pg stat")
        if stat is None:
            print("no reachable mgr (cluster started with --mgrs 0?)",
                  file=sys.stderr)
            return 1
        bits = "; ".join(f"{n} {state}"
                         for state, n in sorted(stat["by_state"].items()))
        io = stat["io"]
        print(f"{stat['num_pg_slices']} pg slices: {bits or 'none'}; "
              f"{stat['degraded']} degraded, {stat['misplaced']} "
              f"misplaced ({stat['recovering']} rebuilding); "
              f"io {io['client_ops_per_sec']} op/s, "
              f"{io['client_wr_bytes_per_sec']} B/s wr, "
              f"{io['client_rd_bytes_per_sec']} B/s rd; "
              f"recovery {io['recovery_bytes_per_sec']} B/s")
        return 0
    if args.cmd == "ls":
        seen = set()
        for sock in _asoks(args.dir):
            for stored in await admin_command(sock, "list_objects"):
                # "<oid>@<shard|meta>" storage names -> logical oid
                base, sep, _tag = stored.rpartition("@")
                seen.add(base if sep else stored)
        for oid in sorted(seen):
            print(oid)
        return 0
    if args.cmd == "df":
        total = 0
        for sock in _asoks(args.dir):
            st = await admin_command(sock, "status")
            print(f"{st['name']}\t{st['objects']} stored objects")
            total += st["objects"]
        print(f"total\t{total}")
        return 0
    if args.cmd == "tier" or args.cmd == "tier-status":
        # device cache-tier residency per daemon (admin-socket backed,
        # like ls/df: works against a live cluster without a client)
        found = False
        for sock in _asoks(args.dir):
            st = await admin_command(sock, "tier status")
            if "error" in st:
                continue
            found = True
            print(f"{st['name']}\t{st['resident_bytes']}/{st['budget']} "
                  f"bytes resident\t{st['entries']} objects "
                  f"({st['dirty']} dirty)\thit {st['hit']} "
                  f"miss {st['miss']}\tmodes {json.dumps(st['modes'])}")
        if not found:
            print("no daemons with a tier admin socket", file=sys.stderr)
            return 1
        return 0
    if args.cmd == "recovery" or args.cmd == "recovery-status":
        # background data-plane status per daemon (admin-socket backed):
        # batched rebuild counters, scrub cursor rounds, throttle
        # preemptions and dirty-object depth (osd/recovery.py)
        found = False
        for sock in _asoks(args.dir):
            st = await admin_command(sock, "recovery status")
            if "error" in st:
                continue
            found = True
            c = st["counters"]
            dirty = sum(st["dirty_objects"].values())
            print(f"{st['name']}\tbatched={st['batched']}\t"
                  f"recovered {c['recover']} "
                  f"({c['recovery_ops_batched']} batched, "
                  f"{c['recovery_bytes']}B)\t"
                  f"scrub_chunks {c['scrub_chunks']}\t"
                  f"preempted {c['recovery_preempted']}\t"
                  f"promote_from_recovery "
                  f"{c['tier_promote_from_recovery']}\t"
                  f"dirty {dirty}")
        if not found:
            print("no daemons with a recovery admin socket",
                  file=sys.stderr)
            return 1
        return 0
    if args.cmd == "ops":
        # slow-op forensics across the cluster (admin-socket union):
        # in-flight / historic / slow TrackedOps with their decomposed
        # per-stage timelines (docs/observability.md workflow)
        which = args.args[0] if args.args else "in-flight"
        prefix = {"in-flight": "dump_ops_in_flight",
                  "historic": "dump_historic_ops",
                  "slow": "dump_historic_slow_ops"}.get(which)
        if prefix is None:
            print(f"unknown ops view {which!r} "
                  "(in-flight|historic|slow)", file=sys.stderr)
            return 1
        found = False
        for sock in _asoks(args.dir):
            st = await admin_command(sock, prefix)
            if "error" in st:
                continue
            found = True
            daemon = os.path.basename(sock).rsplit(".asok", 1)[0]
            print(f"{daemon}\t{st['num_ops']} ops")
            for op_d in st["ops"]:
                age = op_d.get("age", 0.0)
                line = f"  {op_d['description']}\tage {age:.3f}s"
                if op_d.get("trace_id"):
                    line += f"\ttrace {op_d['trace_id']}"
                print(line)
                tl = op_d.get("timeline")
                if tl:
                    segs = "  ".join(
                        f"{s['segment']}={s['ms']:.2f}ms"
                        + (f" (share {s['amortized_share_ms']:.2f}ms"
                           f" of {s.get('batch_n', 1)})"
                           if "amortized_share_ms" in s else "")
                        for s in tl.get("segments", []))
                    print(f"    {segs}")
        if not found:
            print("no daemons with an ops admin socket", file=sys.stderr)
            return 1
        return 0
    if args.cmd == "trace":
        # trace collector status / one stitched trace across daemons
        want = args.args[0] if args.args else "status"
        found = False
        for sock in _asoks(args.dir):
            if want == "status":
                st = await admin_command(sock, "trace status")
                if "error" in st:
                    continue
                found = True
                print(f"{st['name']}\tmode {st['mode']} "
                      f"(1/{st['sample_every']})\t"
                      f"finished {st['finished']} "
                      f"dropped {st['dropped']} "
                      f"unfinished {st['unfinished']}")
            else:
                spans = await admin_command(
                    sock, "trace dump", trace_id=int(want))
                if isinstance(spans, dict) and "error" in spans:
                    continue
                found = True
                for s in spans:
                    dur = s.get("duration_ms")
                    print(f"{s['span_id']}\t{s['name']}\t"
                          f"parent {s['parent_id']}\t"
                          f"{dur if dur is None else round(dur, 3)}ms\t"
                          f"x{s.get('amortized_over', 1)}")
        if not found:
            print("no daemons with a trace admin socket",
                  file=sys.stderr)
            return 1
        return 0
    if args.cmd == "log":
        # the mgr-local cluster event log (clog analogue): health
        # transitions and slow-op warnings in arrival order
        n = 20
        if args.args and args.args[0] == "last" and len(args.args) > 1:
            n = int(args.args[1])
        reply = await _mgr_command(args.dir, "log last", count=n)
        if reply is None:
            print("no reachable mgr (cluster started with --mgrs 0?)",
                  file=sys.stderr)
            return 1
        for entry in reply["lines"]:
            print(f"{entry['stamp']:.3f} {entry['severity']} "
                  f"{entry['message']}")
        return 0
    if args.cmd == "profile":
        # wire-tax profiler (profiling/): per-daemon cost
        # centers over the admin socket
        want = args.args[0] if args.args else "status"
        found = False
        for sock in _asoks(args.dir):
            if want == "status":
                st = await admin_command(sock, "profile status")
                if "error" in st:
                    continue
                found = True
                print(f"{st.get('name', sock)}\tmode {st['mode']}\t"
                      f"stages {st['stages_active']} "
                      f"({st['stage_ns_total']}ns)\t"
                      f"lag {st.get('lag_ms', '-')}ms\t"
                      f"gc {st.get('gc_collections', '-')} pauses")
            elif want == "reset":
                st = await admin_command(sock, "profile reset")
                if "error" in st:
                    continue
                found = True
                print(f"{os.path.basename(sock)}\treset")
            else:  # dump
                st = await admin_command(sock, "profile dump")
                if "error" in st:
                    continue
                found = True
                daemon = os.path.basename(sock).rsplit(".asok", 1)[0]
                print(f"{daemon}\tmode {st['mode']}")
                for stage, row in sorted(
                        st["stages"].items(),
                        key=lambda kv: -kv[1]["ns"]):
                    print(f"  {stage}\t{row['ns']}ns\t"
                          f"{row['calls']} calls\t{row['bytes']}B")
                bursts = st.get("bursts") or {}
                if bursts.get("frames_observed"):
                    print(f"  ns/frame p50 {bursts['ns_per_frame_p50']}"
                          f" p99 {bursts['ns_per_frame_p99']} over "
                          f"{bursts['frames_observed']} frames")
        if not found:
            print("no daemons with a profile admin socket "
                  "(profile_mode off?)", file=sys.stderr)
            return 1
        return 0
    if args.cmd == "residency" or args.cmd == "residency-status":
        # device-residency ledger per daemon (analysis/residency.py):
        # seam transfer counts, library builds, verifier mode/violations
        found = False
        for sock in _asoks(args.dir):
            st = await admin_command(sock, "residency status")
            if "error" in st:
                continue
            found = True
            c = st["counters"]
            print(f"{sock.rsplit('/', 1)[-1]}\t"
                  f"h2d {c['h2d_ops']} ops/{c['h2d_bytes']}B\t"
                  f"d2h {c['d2h_ops']} ops/{c['d2h_bytes']}B\t"
                  f"builds {c['library_builds']}\tmode {st['mode']}\t"
                  f"violations {len(st['violations'])}")
        if not found:
            print("no daemons with a residency admin socket",
                  file=sys.stderr)
            return 1
        return 0

    c = await _connect(args.dir)
    try:
        if args.cmd == "put":
            data = await aio.read_bytes(args.args[1])
            await c.write(args.args[0], data)
            print(f"wrote {len(data)} bytes to {args.args[0]}")
        elif args.cmd == "get":
            data = await c.read(args.args[0])
            if len(args.args) > 1 and args.args[1] != "-":
                await aio.write_bytes(args.args[1], data)
                print(f"read {len(data)} bytes from {args.args[0]}")
            else:
                sys.stdout.buffer.write(data)
        elif args.cmd == "rm":
            await c.backend.remove_object(args.args[0])
            print(f"removed {args.args[0]}")
        elif args.cmd == "stat":
            size, _hinfo = await c.backend.stat(args.args[0])
            print(f"{args.args[0]} size {size}")
        elif args.cmd == "setomapval":
            await c.backend.omap_set(
                args.args[0], {args.args[1]: args.args[2].encode()})
            print("set")
        elif args.cmd == "listomapvals":
            omap = await c.backend.omap_get(args.args[0])
            for k in sorted(omap):
                v = omap[k]
                print(f"{k}\t{v!r}")
        else:
            print(__doc__)
            return 1
    finally:
        await c.close()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--dir", required=True, help="vstart run dir")
    p.add_argument("cmd")
    p.add_argument("args", nargs="*")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    return asyncio.new_event_loop().run_until_complete(_run(args))


if __name__ == "__main__":
    sys.exit(main())
