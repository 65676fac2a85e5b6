"""QoS-path benchmark stage: the unified
admission layer under scenario-diverse load at scale, fairness as a
first-class metric.

Port of ``ceph_tpu/osd/qos_bench.py``: the same stages and gates, with
the scenarios' pool on the ``cuda`` plugin (the JAX package's is
``jerasure`` on the host); ``profile={"device": "cpu"}`` runs it on the
CPU.  The gates on host wall times are keyword arguments whose defaults
are the JAX package's, and ``None`` opens one (the stage still returns
its figure): ``reservation_ratio_min`` (0.9), ``starved_divisor`` (at
most ``max(2, closed // 50)`` closed-loop clients at zero ops, full
shape only) and ``p99_vs_1k_max`` (scale10x p99 over the same-run 1k
p99, 1.0, full shape only).  The correctness gates (client counts, the
exactly-once audit, ops moved, admission waits observed, bulk not
starved, chaos fired) always hold.

Two sub-stages, both over the real-TCP path (ceph_tpu_torch/loadgen):

* **overload** -- the reservation-floor proof.  A ``gold`` client class
  holds a dmClock reservation calibrated from an uncontended run of the
  same clients (floor = RESERVATION_FRACTION of measured capacity) but
  carries negligible weight (1 vs 100), then a 10x ``bulk`` demand storm
  is thrown at the same cluster with execution slots deliberately
  scarce.  GATE: gold's achieved throughput stays within 10% of its
  reservation (phase-1 tags beat the weight storm), and bulk still gets
  the remainder (the floor is a floor, not a takeover).
* **scale** -- the million-client-direction proof: >= ``SCALE_CLIENTS``
  concurrent Objecters (hub-multiplexed over a handful of sockets)
  driving mixed RGW/RBD/CephFS/transactional profiles with thrash
  kills, a mid-run OSD wipe (background rebuild through the same
  admission layer) and writeback tier promotion running concurrently.
  GATES: the exactly-once audit is exact (every transactional client's
  counters equal its acked successes, zero unexplained drift), every
  closed-loop client made progress, and the saturation p99 + per-class
  fairness spread are reported as headline keys.

* **scale10x** -- SCALE_CLIENTS x 10 concurrent clients
  (10^4 full): a closed-loop transactional cohort carries the
  exactly-once audit and fairness spread, an open-loop bulk offered at
  half the same-run 1k-stage throughput carries the concurrency.
  GATES: client count, exact audit, bounded closed-loop starvation,
  and pooled p99 no worse than the same-run 1k closed-loop p99.

``--smoke`` (``python -m ceph_tpu_torch.tools.ec_benchmark -w qos-path
--smoke``) shrinks the stages to a few hundred clients and a few
seconds; the full stage is the JAX package's acceptance shape.
"""

from __future__ import annotations

import asyncio
from typing import Dict, Optional

#: fraction of measured capacity the gold class reserves in the
#: overload stage -- low enough that uneven CRUSH spread of gold
#: demand over primaries (the reservation is enforced per OSD) and
#: mid-run stalls of storm-sized encode batches cannot eat the 10%
#: tolerance the floor is gated against
RESERVATION_FRACTION = 0.15
#: the full stage's concurrent-client floor (the acceptance criterion)
SCALE_CLIENTS = 1000
#: the scale10x stage's multiplier over SCALE_CLIENTS (10^3
#: -> 10^4 hub-multiplexed clients)
SCALE10X_FACTOR = 10
#: scale10x offered load as a fraction of the same-run 1k-stage
#: measured throughput -- open-loop at half capacity keeps the
#: p99-no-worse gate honest (closed-loop p99 scales with client count
#: by queueing arithmetic alone, proving nothing about the stack)
SCALE10X_LOAD_FRACTION = 0.5


def _apply_profile(cfg, gold_res_mibs: float) -> Dict[str, object]:
    """Install the bench QoS profile (gold reservation, token weight;
    bulk all-weight) + scarce execution slots; returns priors."""
    keys = ("osd_qos_profile", "osd_qos_op_slots", "osd_qos_slots")
    prior = {key: cfg.get_val(key) for key in keys}
    cfg.apply_changes({
        "osd_qos_profile": (
            f"client:0:100:0,gold:{gold_res_mibs:.4f}:1:0,"
            "bulk:0:100:0,recovery:4:10:0,scrub:1:5:0"),
        # scarcity makes admission the scheduler: ~2 execution slots
        # per OSD forces the 10x storm to queue at the dmClock tags
        "osd_qos_op_slots": 2,
        "osd_qos_slots": 2,
    })
    return prior


async def _overload_stage(smoke: bool, *,
                          profile: Optional[Dict[str, str]] = None,
                          reservation_ratio_min: Optional[float] = 0.9
                          ) -> Dict:
    from ceph_tpu_torch.loadgen import ClientGroup, Scenario, run_scenario
    from ceph_tpu_torch.utils.config import get_config

    cfg = get_config()
    gold_n = 6 if smoke else 8
    bulk_n = 10 * gold_n
    calib_s = 3.0 if smoke else 5.0
    load_s = 6.0 if smoke else 10.0

    # -- calibrate: the gold clients alone, closed-loop, under the SAME
    # scarce-slot regime the storm will run in (no reservation yet --
    # uncontended admission is work-conserving, so none is needed)
    prior = _apply_profile(cfg, 0.0)
    try:
        calib = await run_scenario(Scenario(
            name="qos-calibrate", duration_s=calib_s,
            groups=(ClientGroup(count=gold_n, profile="put8k",
                                qos_class="gold"),),
            seed=101,
        ), n_osds=6, profile=profile)
        gold_alone = calib.groups[0]
        capacity_bps = gold_alone["ops"] * (8 << 10) / calib.wall_s
        floor_bps = RESERVATION_FRACTION * capacity_bps
        # per-OSD reservation: the admission instances are per daemon,
        # so the cluster-wide floor divides over the OSDs gold lands on
        res_mibs = floor_bps / 6 / (1 << 20)
        # arm the reservation (slots stay scarce from _apply_profile)
        cfg.apply_changes({"osd_qos_profile": (
            f"client:0:100:0,gold:{res_mibs:.4f}:1:0,"
            "bulk:0:100:0,recovery:4:10:0,scrub:1:5:0")})

        # -- the storm: gold demand is OPEN-LOOP at 1.4x its floor, so
        # demand provably exceeds the reservation regardless of latency
        # (closed-loop demand is latency-coupled and would understate
        # the floor exactly when the storm inflates latency)
        gold_rate = 2.0 * floor_bps / (8 << 10) / gold_n
        overload = await run_scenario(Scenario(
            name="qos-overload", duration_s=load_s,
            groups=(
                ClientGroup(count=gold_n, profile="put8k",
                            qos_class="gold", mode="open",
                            rate_ops_s=gold_rate),
                ClientGroup(count=bulk_n, profile="put8k",
                            qos_class="bulk"),
            ),
            seed=102,
        ), n_osds=6, op_timeout=60.0,
           tuning={"client_probe_grace": 15.0}, profile=profile)
    finally:
        cfg.apply_changes(prior)
    gold = next(g for g in overload.groups if g["qos_class"] == "gold")
    bulk = next(g for g in overload.groups if g["qos_class"] == "bulk")
    gold_bps = gold["ops"] * (8 << 10) / overload.wall_s
    ratio = gold_bps / floor_bps if floor_bps else 0.0
    result = {
        "capacity_MiBs": round(capacity_bps / (1 << 20), 3),
        "floor_MiBs": round(floor_bps / (1 << 20), 3),
        "gold_clients": gold_n,
        "bulk_clients": bulk_n,
        "gold_achieved_MiBs": round(gold_bps / (1 << 20), 3),
        "reservation_ratio": round(ratio, 3),
        "gold_p99_ms": gold["p99_ms"],
        "bulk_p99_ms": bulk["p99_ms"],
        "bulk_ops": bulk["ops"],
        "throttle_waits": overload.qos_counters.get(
            "qos_gold_throttle_waits", 0) + overload.qos_counters.get(
            "qos_bulk_throttle_waits", 0),
    }
    # GATE: the floor held within 10% under the 10x weight storm, the
    # storm was real (admission waits observed), and bulk still ran
    if reservation_ratio_min is not None and ratio < reservation_ratio_min:
        raise AssertionError(
            f"qos-path: gold reservation floor violated: achieved "
            f"{gold_bps / (1 << 20):.3f} MiB/s vs floor "
            f"{floor_bps / (1 << 20):.3f} MiB/s (ratio {ratio:.3f})")
    if result["throttle_waits"] == 0:
        raise AssertionError(
            "qos-path: overload never queued at admission -- the "
            "storm did not saturate the slots, the gate proves nothing")
    if bulk["ops"] == 0:
        raise AssertionError("qos-path: reservation starved bulk out")
    return result


def _mixed_groups(n: int):
    from ceph_tpu_torch.loadgen import ClientGroup

    rgw = int(n * 0.55)
    rbd = int(n * 0.15)
    fs = int(n * 0.20)
    txn = n - rgw - rbd - fs
    return (
        ClientGroup(count=rgw, profile="rgw"),
        ClientGroup(count=rbd, profile="rbd"),
        ClientGroup(count=fs, profile="cephfs", mode="open",
                    rate_ops_s=1.0),
        ClientGroup(count=txn, profile="txn"),
    )


async def _chaos_stage(smoke: bool, *,
                       profile: Optional[Dict[str, str]] = None) -> Dict:
    """Thrash kills + rebuild + tier promotion at MODERATE scale: the
    probe grace sits below the loaded p99 so TCP kills are actually
    DETECTED and failed over inside the run -- the regime where the
    exactly-once machinery does real work."""
    from ceph_tpu_torch.loadgen import Scenario, run_scenario

    n = 120 if smoke else 300
    scn = Scenario(
        name="qos-chaos", duration_s=5.0 if smoke else 8.0,
        groups=_mixed_groups(n),
        chaos=("thrash", "rebuild", "promote"),
        seed=77,
    )
    res = await run_scenario(
        scn, n_osds=6, op_timeout=25.0,
        tuning={"client_probe_grace": 1.0 if smoke else 2.5},
        profile=profile,
    )
    out = res.to_dict()
    if res.kills < 1 or res.wipes < 1:
        raise AssertionError("qos-path: chaos never fired")
    if not res.cas_exact:
        raise AssertionError(
            f"qos-path: exactly-once audit failed under thrash "
            f"({res.cas_mismatches} counter(s) off the acked books)")
    if res.ops == 0:
        raise AssertionError("qos-path: chaos scenario moved no ops")
    return out


def _starved(out: Dict):
    """(closed-loop clients that finished zero ops, closed-loop clients)."""
    closed = [g for g in out["groups"] if g["mode"] == "closed"]
    return (sum(g["clients_at_zero"] for g in closed),
            sum(g["clients"] for g in closed))


async def _scale_stage(smoke: bool, *,
                       profile: Optional[Dict[str, str]] = None,
                       starved_divisor: Optional[int] = 50) -> Dict:
    """>= SCALE_CLIENTS concurrent clients, saturation regime: rebuild
    + promotion chaos run along (thrash lives in the chaos stage -- at
    saturation the probe grace must clear the loaded p99, which makes
    sub-grace kill detection a contradiction in terms)."""
    from ceph_tpu_torch.loadgen import Scenario, run_scenario

    n = 250 if smoke else SCALE_CLIENTS
    scn = Scenario(
        name="qos-scale-smoke" if smoke else "qos-scale",
        duration_s=4.0 if smoke else 12.0,
        groups=_mixed_groups(n),
        chaos=("rebuild", "promote"),
        seed=78,
    )
    # probe grace must clear the SATURATED p99 (~9s at 1000 clients on
    # cpu-fallback): a grace below it makes every queued op probe, and
    # each probe tears down the hub's shared connection -- the measured
    # self-livelock mode of hub-multiplexed clients
    res = await run_scenario(
        scn, n_osds=6, op_timeout=30.0 if smoke else 90.0,
        tuning={"client_probe_grace": 6.0 if smoke else 30.0},
        profile=profile,
    )
    out = res.to_dict()
    # GATES: the acceptance criteria of the JAX package's scale stage
    if res.n_clients < n:
        raise AssertionError("qos-path: client count shortfall")
    if not res.cas_exact:
        raise AssertionError(
            f"qos-path: exactly-once audit failed "
            f"({res.cas_mismatches} counter(s) off the acked books)")
    if res.ops == 0:
        raise AssertionError("qos-path: the scenario moved no ops")
    # fairness floor: at saturation each closed-loop client only gets a
    # handful of ops, so the honest gate is a FRACTION bound -- a real
    # fairness collapse zeroes whole cohorts, ordinary queueing
    # variance strands at most a few stragglers
    starved, total_closed = _starved(out)
    if not smoke and starved_divisor is not None and total_closed and \
            starved > max(2, total_closed // starved_divisor):
        raise AssertionError(
            f"qos-path: {starved}/{total_closed} closed-loop clients "
            "finished zero ops -- fairness collapse")
    return out


async def _scale10x_stage(smoke: bool, ref: Optional[Dict], *,
                          profile: Optional[Dict[str, str]] = None,
                          starved_divisor: Optional[int] = 50,
                          p99_vs_1k_max: Optional[float] = 1.0) -> Dict:
    """10x the scale stage's client count (10^4 full): the
    hub-multiplexed transport must carry an order of magnitude more
    CONCURRENT clients without the tail degrading past the same-run
    1k closed-loop saturation p99.

    Two cohorts: a closed-loop transactional group (the exactly-once
    audit and fairness-spread carriers -- closed loops give every
    client a comparable ops budget, so the spread means something) and
    an open-loop bulk carrying the concurrency, offered at
    SCALE10X_LOAD_FRACTION of the 1k stage's MEASURED throughput.
    GATES: client count >= 10x, exactly-once audit exact, closed-loop
    starvation bounded, and pooled p99 <= the same-run 1k-stage p99
    (skipped, and recorded null, when the 1k stage did not run)."""
    from ceph_tpu_torch.loadgen import ClientGroup, Scenario, run_scenario

    n = 500 if smoke else SCALE_CLIENTS * SCALE10X_FACTOR
    closed_n = 64 if smoke else 256
    open_n = n - closed_n
    ref_ops_s = float((ref or {}).get("ops_per_s") or 0.0)
    ref_p99 = float((ref or {}).get("p99_ms") or 0.0)
    # offered aggregate = half the measured 1k capacity, spread evenly
    # over the open cohort (floor keeps the run non-degenerate when the
    # reference is missing or tiny)
    agg = max(20.0, SCALE10X_LOAD_FRACTION * ref_ops_s)
    rate = agg / max(1, open_n)
    scn = Scenario(
        name="qos-scale10x-smoke" if smoke else "qos-scale10x",
        duration_s=5.0 if smoke else 12.0,
        groups=(
            ClientGroup(count=closed_n, profile="txn"),
            ClientGroup(count=open_n, profile="rgw", mode="open",
                        rate_ops_s=rate),
        ),
        seed=79,
    )
    res = await run_scenario(
        scn, n_osds=6, op_timeout=30.0 if smoke else 90.0,
        tuning={"client_probe_grace": 6.0 if smoke else 30.0},
        profile=profile,
    )
    out = res.to_dict()
    out["offered_ops_s"] = round(agg, 3)
    out["ref_1k_ops_per_s"] = ref_ops_s or None
    out["ref_1k_p99_ms"] = ref_p99 or None
    if res.n_clients < n:
        raise AssertionError("qos-path scale10x: client count shortfall")
    if not res.cas_exact:
        raise AssertionError(
            f"qos-path scale10x: exactly-once audit failed "
            f"({res.cas_mismatches} counter(s) off the acked books)")
    if res.ops == 0:
        raise AssertionError("qos-path scale10x: the scenario moved no ops")
    starved, total_closed = _starved(out)
    if not smoke and starved_divisor is not None and total_closed and \
            starved > max(2, total_closed // starved_divisor):
        raise AssertionError(
            f"qos-path scale10x: {starved}/{total_closed} closed-loop "
            "clients finished zero ops -- fairness collapse")
    if not smoke and p99_vs_1k_max is not None and ref_p99 and \
            res.p99_ms > ref_p99 * p99_vs_1k_max:
        raise AssertionError(
            f"qos-path scale10x: p99 {res.p99_ms:.1f}ms at 10x client "
            f"count exceeds the same-run 1k-stage p99 {ref_p99:.1f}ms")
    return out


def run_qos_path_bench(*, smoke: bool = False,
                       stages: Optional[str] = None,
                       profile: Optional[Dict[str, str]] = None,
                       reservation_ratio_min: Optional[float] = 0.9,
                       starved_divisor: Optional[int] = 50,
                       p99_vs_1k_max: Optional[float] = 1.0) -> Dict:
    """The stage entry point; ``stages`` limits to one of "overload",
    "chaos", "scale" and "scale10x" (None = all).  ``profile`` overlays
    the pool's reed_sol_van k=2 m=1 on ``cuda``; the three gate keywords
    are the host-timing limits (module docstring; ``None`` opens one).
    Returns the JSON-ready dict with headline keys."""
    loop = asyncio.new_event_loop()
    try:
        result: Dict = {"smoke": smoke}
        if stages in (None, "overload"):
            result["overload"] = loop.run_until_complete(
                _overload_stage(
                    smoke, profile=profile,
                    reservation_ratio_min=reservation_ratio_min))
        if stages in (None, "chaos"):
            result["chaos"] = loop.run_until_complete(
                _chaos_stage(smoke, profile=profile))
        if stages in (None, "scale"):
            result["scale"] = loop.run_until_complete(
                _scale_stage(smoke, profile=profile,
                             starved_divisor=starved_divisor))
        if stages in (None, "scale10x"):
            result["scale10x"] = loop.run_until_complete(
                _scale10x_stage(smoke, result.get("scale"),
                                profile=profile,
                                starved_divisor=starved_divisor,
                                p99_vs_1k_max=p99_vs_1k_max))
    finally:
        loop.close()
    scale = result.get("scale") or {}
    chaos = result.get("chaos") or {}
    overload = result.get("overload") or {}
    spreads = [g["fairness_spread"] for g in scale.get("groups", [])
               if g.get("fairness_spread")]
    result.update({
        "qos_path_clients": scale.get("n_clients"),
        "qos_path_saturation_p99_ms": scale.get("p99_ms"),
        "qos_path_fairness_spread_max": max(spreads) if spreads else None,
        "qos_path_reservation_ratio": overload.get("reservation_ratio"),
        "qos_path_cas_exact": (
            scale.get("cas_exact") and chaos.get("cas_exact", True)
            if scale else chaos.get("cas_exact")),
        "qos_path_kills": chaos.get("kills"),
        "qos_path_dup_op_hits": chaos.get("dup_op_hits"),
        "qos_path_inflight_hwm": scale.get("inflight_hwm"),
    })
    scale10x = result.get("scale10x") or {}
    if scale10x:
        result.update({
            "qos_path_scale10x_clients": scale10x.get("n_clients"),
            "qos_path_scale10x_p99_ms": scale10x.get("p99_ms"),
            "qos_path_scale10x_ops_per_s": scale10x.get("ops_per_s"),
            "qos_path_scale10x_cas_exact": scale10x.get("cas_exact"),
        })
    return result


if __name__ == "__main__":
    import json
    import sys

    smoke = "--smoke" in sys.argv
    cpu = "--cpu" in sys.argv
    out = run_qos_path_bench(smoke=smoke,
                             profile={"device": "cpu"} if cpu else None)
    print(json.dumps(out))
