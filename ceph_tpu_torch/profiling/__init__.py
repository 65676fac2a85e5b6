"""Wire-tax profiler: hot-path cost attribution for the Python wire loop.

Port of ``ceph_tpu/profiling``: the ledger, the loop/GC arm, the stack
sampler, the mgr's two views (:func:`report_slice`,
:func:`prometheus_text`), the sampler's speedscope and collapsed exports
(:func:`asok_dump`; the other admin-socket views come with the admin
socket) and the wire-tax benchmark (:mod:`wire_tax_bench`).  The port
keeps its own module state, so a process that imports both packages does
not cross-feed them; its stage markers are the C ones of its native wire
codec where that codec's gates are on (``ledger.marker_class()``), else
the Python ones.

Three arms, one ledger:

* **stage cost ledger** (:mod:`ledger`): zero-alloc ``with
  prof.stage(name)`` markers on the real wire-loop seams (encoder
  assembly, crc fold, cork append, writelines, frame parse, body
  codecs, objecter/coalescer submit), exclusive-time nested, with
  per-connection per-burst sub-accounting;
* **event-loop + GC arm** (:mod:`loopmon`): every asyncio callback's
  duration + timer scheduling latency (subsuming ``LoopLagProbe`` --
  the probe's sleeper task is the sampled fallback when this arm is
  off) and ``gc.callbacks`` pause accounting, GC pauses credited OUT of
  the stage they interrupted so nothing double counts;
* **sampling profiler** (:mod:`sampler`): a thread sampler attributing
  stacks to the declared stages, exporting speedscope + collapsed
  flamegraph JSON.

Modes (``profile_mode``): ``off`` (default -- the instrumented seams
run one global-bool branch and allocate nothing), ``on`` (ledger +
loop/GC arms; the <=3%-overhead configuration the wire-tax bench
gates), ``full`` (``on`` plus the continuous stack sampler).
``tools/trace_main_path.py --storage-path`` turns it on to read the
coalescer's dispatch time.
"""

from __future__ import annotations

from typing import Optional

from ceph_tpu_torch.profiling import ledger as _ledger
from ceph_tpu_torch.profiling import loopmon as _loopmon

# the hot-path surface, re-exported (instrumented modules import these)
stage = _ledger.stage
stage_enter = _ledger.stage_enter
stage_exit = _ledger.stage_exit
note_burst = _ledger.note_burst
enabled = _ledger.enabled

_MODES = ("off", "on", "full")
_mode = "off"
_monitor: Optional["_loopmon.LoopMonitor"] = None
_sampler = None


def mode() -> str:
    return _mode


def loop_monitor():
    """The active LoopMonitor (None when the loop arm is off) -- the
    LoopLagProbe fold reads this to decide whether to run its own
    sleeper task."""
    return _loopmon.active()


def configure(mode: Optional[str] = None) -> str:
    """Apply ``profile_mode`` (argument overrides + persists to the
    config, the trace.configure() discipline); installs/uninstalls the
    arms.  Returns the effective mode."""
    global _mode, _monitor, _sampler
    from ceph_tpu_torch.utils.config import get_config

    cfg = get_config()
    if mode is not None:
        if mode not in _MODES:
            raise ValueError(f"bad profile mode {mode!r}")
        cfg.set_val("profile_mode", mode)
    eff = str(cfg.get_val("profile_mode"))
    if eff not in _MODES:
        eff = "off"
    if eff == _mode:
        return _mode
    # tear down what the old mode had up
    if _sampler is not None:
        _sampler.stop()
        _sampler = None
    if _monitor is not None and eff == "off":
        _monitor.uninstall()
    if eff == "off":
        _ledger.set_enabled(False)
        _mode = eff
        return _mode
    _ledger.set_enabled(True)
    if _monitor is None:
        _monitor = _loopmon.LoopMonitor()
    _monitor.install()
    if eff == "full":
        from ceph_tpu_torch.profiling.sampler import StackSampler

        hz = float(cfg.get_val("profile_sample_hz"))
        _sampler = StackSampler(hz=hz)
        _sampler.start()
    _mode = eff
    return _mode


def current_sampler():
    return _sampler


def reset() -> None:
    _ledger.reset()
    if _monitor is not None:
        _monitor.reset()


# -- views -------------------------------------------------------------------

def snapshot() -> dict:
    out = {
        "mode": _mode,
        "stages": _ledger.stages_snapshot(),
        "bursts": _ledger.bursts_snapshot(),
    }
    mon = _loopmon.active()
    if mon is not None:
        out["loop"] = mon.snapshot()
    if _sampler is not None:
        out["sampler"] = {
            "samples": _sampler.samples,
            "stage_shares": _sampler.stage_shares(),
        }
    return out


def decomposition(wall_ns: int) -> dict:
    """The wire-tax bill of costs for a measured ``wall_ns`` window
    (callers reset() before and snapshot after).

    Rows sum to ``covered_ns`` with no double counting: stage time is
    exclusive (nesting banks the parent), GC pauses are credited OUT of
    the stage they interrupted (ledger.gc_credit), and
    ``event_loop_other`` is callback time not inside any declared stage
    or GC pause.  ``idle`` is the selector/off-loop remainder.
    ``coverage_pct`` = covered / wall -- the bench gates it >= 90 on
    the saturated cluster path."""
    stages = _ledger.stages_snapshot()
    stage_ns = sum(s["ns"] for s in stages.values())
    mon = _loopmon.active()
    gc_ns = mon.gc_ns if mon is not None else 0
    cb_ns = mon.callback_ns if mon is not None else 0
    other = max(0, cb_ns - stage_ns - gc_ns)
    covered = stage_ns + gc_ns + other
    idle = max(0, wall_ns - covered)
    rows = [
        {"stage": name, "ns": s["ns"], "calls": s["calls"],
         "bytes": s["bytes"],
         "pct": round(100 * s["ns"] / wall_ns, 2) if wall_ns else 0.0}
        for name, s in stages.items()
    ]
    rows.append({"stage": "gc.pause", "ns": gc_ns,
                 "calls": mon.gc_collections if mon is not None else 0,
                 "bytes": 0,
                 "pct": round(100 * gc_ns / wall_ns, 2) if wall_ns else 0.0})
    rows.append({"stage": "event_loop.other", "ns": other,
                 "calls": mon.callbacks if mon is not None else 0,
                 "bytes": 0,
                 "pct": round(100 * other / wall_ns, 2) if wall_ns else 0.0})
    rows.sort(key=lambda r: -r["ns"])
    return {
        "wall_ns": wall_ns,
        "covered_ns": covered,
        "idle_ns": idle,
        "coverage_pct": round(100 * covered / wall_ns, 2)
        if wall_ns else 0.0,
        "rows": rows,
    }


def report_slice() -> Optional[dict]:
    """The compact MgrReport payload slice (None when off): per-stage
    ns + the loop/GC scalars -- what the mgr renders as
    ``ceph_profile_stage_seconds_total{stage}``."""
    if _mode == "off":
        return None
    out = {"stages": {name: s["ns"]
                      for name, s in _ledger.stages_snapshot().items()}}
    mon = _loopmon.active()
    if mon is not None:
        out["gc_ns"] = mon.gc_ns
        out["callback_ns"] = mon.callback_ns
        out["lag_ms"] = round(mon.lag_ms, 3)
    return out


def prometheus_text() -> str:
    """In-process exposition: cumulative per-stage seconds (the
    wire-fed twin renders the same family from report frames in
    mgr/pgmap.py)."""
    if _mode == "off":
        return ""
    lines = [
        "# HELP ceph_profile_stage_seconds_total exclusive seconds "
        "per wire-tax profiler stage (ceph_tpu_torch/profiling/)",
        "# TYPE ceph_profile_stage_seconds_total counter",
    ]
    for name, s in _ledger.stages_snapshot().items():
        lines.append(
            f'ceph_profile_stage_seconds_total{{stage="{name}"}} '
            f"{s['ns'] / 1e9:.6f}")
    mon = _loopmon.active()
    if mon is not None:
        lines += [
            "# HELP ceph_profile_gc_seconds_total GC pause seconds "
            "(gc.callbacks accounting)",
            "# TYPE ceph_profile_gc_seconds_total counter",
            f"ceph_profile_gc_seconds_total {mon.gc_ns / 1e9:.6f}",
            "# HELP ceph_profile_callback_seconds_total seconds inside "
            "asyncio callbacks (the event-loop arm)",
            "# TYPE ceph_profile_callback_seconds_total counter",
            f"ceph_profile_callback_seconds_total "
            f"{mon.callback_ns / 1e9:.6f}",
        ]
    return "\n".join(lines)


# -- admin-socket hooks (daemon/osd.py registers these) ----------------------

def asok_status(cmd=None) -> dict:
    out = {"mode": _mode}
    mon = _loopmon.active()
    if mon is not None:
        out.update({
            "callback_ns": mon.callback_ns,
            "callbacks": mon.callbacks,
            "lag_ms": round(mon.lag_ms, 3),
            "gc_ns": mon.gc_ns,
            "gc_collections": mon.gc_collections,
        })
    stages = _ledger.stages_snapshot()
    out["stages_active"] = len(stages)
    out["stage_ns_total"] = sum(s["ns"] for s in stages.values())
    return out


def asok_dump(cmd=None) -> dict:
    out = snapshot()
    fmt = (cmd or {}).get("format")
    if fmt == "speedscope" and _sampler is not None:
        out["speedscope"] = _sampler.speedscope()
    elif fmt == "collapsed" and _sampler is not None:
        out["collapsed"] = _sampler.collapsed()
    return out


def asok_reset(cmd=None) -> dict:
    reset()
    return {"reset": True, "mode": _mode}
