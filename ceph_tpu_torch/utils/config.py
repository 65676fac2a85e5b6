"""Typed configuration schema + runtime config (options.cc / md_config_t
equivalents).

Port of ``ceph_tpu/utils/config.py``; the port keeps its own copy (its own
globals and its own environment prefix), so a process that imports both
packages does not cross-feed them.  The schema holds only the options the
port reads, under the reference's names, types, defaults and levels.

Reference: src/common/options.cc declares every option once with type,
default, level and description; src/common/config.cc layers conf-file /
env / CLI / runtime overrides with change observers.  Same shape here:
a single OPTIONS schema, a Config that validates against it, observer
callbacks on apply_changes, and typed get_val access.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Callable, Dict, List, Optional

LEVEL_BASIC = "basic"
LEVEL_ADVANCED = "advanced"
LEVEL_DEV = "dev"


@dataclasses.dataclass
class Option:
    name: str
    type: type
    default: Any
    level: str = LEVEL_ADVANCED
    description: str = ""
    see_also: tuple = ()


def _opt(name, typ, default, level=LEVEL_ADVANCED, desc="", see_also=()):
    return Option(name, typ, default, level, desc, see_also)


#: the schema: the options the port reads, each with the reference's name,
#: type, default and level (reference: src/common/options.cc).  A later
#: slice declares an option when it comes to read it.
OPTIONS: Dict[str, Option] = {
    o.name: o
    for o in [
        _opt("trace_mode", str, "sampled", LEVEL_ADVANCED,
             "end-to-end op tracing (utils/trace.py): 'off' mints no "
             "spans; 'sampled' traces one in trace_sample_every root "
             "ops; 'full' traces every op.  The sampling decision "
             "travels with the context, so a trace is always whole",
             see_also=("trace_sample_every", "trace_keep")),
        _opt("trace_sample_every", int, 64, LEVEL_ADVANCED,
             "in sampled trace_mode, one of this many root ops is "
             "traced (client ops and background batches roll "
             "independently)",
             see_also=("trace_mode",)),
        _opt("trace_keep", int, 256, LEVEL_ADVANCED,
             "finished spans retained in the bounded collector ring "
             "(oldest dropped and counted)",
             see_also=("trace_keep_slow",)),
        _opt("trace_keep_slow", int, 64, LEVEL_ADVANCED,
             "slowest finished root spans retained past ring churn "
             "(the optracker historic-slow discipline)",
             see_also=("trace_keep",)),
        _opt("profile_mode", str, "off", LEVEL_ADVANCED,
             "stage profiler (profiling/): 'off' (default -- "
             "instrumented seams cost one branch, allocate nothing) or "
             "'on' (stage cost ledger + event-loop/GC arms)"),
        _opt("ms_inject_socket_failures", int, 0, LEVEL_DEV,
             "inject a message drop roughly every N messages"),
        _opt("ms_inject_internal_delays", float, 0.0, LEVEL_DEV,
             "probability of injected message delay"),
        _opt("osd_ec_op_coalesce", bool, True, LEVEL_ADVANCED,
             "gather concurrent client-op EC codec work into batched "
             "dispatches (the per-PG encode/decode coalescer; client "
             "ops only, recovery/scrub stay per-call)"),
        _opt("osd_ec_shape_rungs", str, "", LEVEL_ADVANCED,
             "granule rung ladder for the persistent encode pipeline: "
             "comma/space-separated byte rungs (ascending).  The top "
             "rung caps a granule's width and odd blocksizes pad up to "
             "a rung (ops/bucketing.py).  Empty = the built-in "
             "16KiB..16MiB power-of-two ladder"),
        _opt("osd_ec_overlap_depth", int, 2, LEVEL_ADVANCED,
             "encode pipeline H2D/compute overlap slots: granule N+1's "
             "packed upload is issued while up to this many earlier "
             "granules wait for their kernel (double-buffering at 2).  "
             "1 restores upload-then-compute-in-lockstep; the in-flight "
             "D2H depth is bounded separately"),
        _opt("osd_tier_promote_from_encode", bool, True, LEVEL_ADVANCED,
             "hand the cache tier the still-device-resident encode "
             "output when a written object should be hot (writeback "
             "promote-on-write composes the [k+m, shard] block ON "
             "device from the granule input and parity output: zero "
             "re-upload) instead of re-uploading the host copy.  "
             "Granules carrying such objects are never donated",
             see_also=("osd_tier_promote_temp",)),
        _opt("osd_recovery_max_chunk", int, 8 << 20, LEVEL_ADVANCED,
             "max bytes per recovery window"),
        _opt("osd_recovery_batched", bool, True, LEVEL_ADVANCED,
             "route recovery pushes through the batched background data "
             "plane (osd/recovery.py): per-PG recovery coalescer, fused "
             "decode dispatches, corked multi-push messenger bursts.  "
             "False restores the per-object windowed path (kept as the "
             "recovery-path bench baseline)",
             see_also=("osd_recovery_batch_bytes",
                       "osd_recovery_max_active")),
        _opt("osd_recovery_batch_bytes", int, 8 << 20, LEVEL_ADVANCED,
             "byte budget per batched recovery dispatch: a batch's "
             "gathered source chunks stay under this, and an object "
             "whose shards exceed the per-object share falls back to "
             "the windowed per-object path (bounded primary memory)",
             see_also=("osd_recovery_batched",)),
        _opt("osd_ec_fractional_repair", bool, True, LEVEL_ADVANCED,
             "let fractional-repair codecs (regenerating codes, plugin "
             "'regen') rebuild a single lost shard from beta-sized "
             "helper symbols instead of k whole chunks.  False forces "
             "the classic full-stripe gather (kept as the repair-path "
             "bench baseline)",
             see_also=("osd_recovery_batched",)),
        _opt("osd_recovery_sleep", float, 0.0, LEVEL_ADVANCED,
             "seconds of awaited pacing between background recovery/"
             "scrub batches (the osd_recovery_sleep role); 0 still "
             "yields the event loop once per batch so client ops "
             "interleave",
             see_also=("osd_recovery_batched",)),
        _opt("osd_scrub_chunk_max", int, 512 << 10, LEVEL_ADVANCED,
             "deep-scrub read-cursor chunk bytes per shard per round: "
             "scrub walks objects in chunks of this size through the "
             "batched read lane instead of one whole-shard read per "
             "object (bounded memory, paced I/O)"),
        _opt("osd_tier_promote_on_recovery", bool, True, LEVEL_ADVANCED,
             "land a rebuilt hot (or previously-resident) object's full "
             "shard block in the device tier as part of recovery itself "
             "(promote-on-recovery): the batch already holds every "
             "chunk, so the promote costs no extra shard reads.  The "
             "insert is counted as tier_promote_from_recovery",
             see_also=("osd_tier_promote_temp",
                       "osd_tier_promote_from_encode")),
        _opt("osd_qos_unified", bool, True, LEVEL_ADVANCED,
             "fuse the dmClock op-queue discipline into the batched "
             "data plane (osd/qos.py): coalesced client batches, "
             "recovery cycles and scrub rounds claim admission slots "
             "in per-class reservation/weight/limit tag order with "
             "cost = stripe bytes, replacing the "
             "BackgroundThrottle's client-pressure preemption gauge.  "
             "False restores the gauge-based preemption (the A/B "
             "baseline)",
             see_also=("osd_qos_profile", "osd_qos_slots")),
        _opt("osd_qos_profile", str,
             "client:0:100:0,recovery:4:10:0,scrub:1:5:0",
             LEVEL_ADVANCED,
             "per-class dmClock triple, comma/space-separated "
             "name:reservation:weight:limit entries -- reservation and "
             "limit in MiB/s (0 = none), weight unitless.  Applied by "
             "the unified admission layer (cost = batch stripe bytes) "
             "and, scaled to 4KiB cost units, by the mclock op queue "
             "for client sub-classes (a client op's qos_class field "
             "names one)",
             see_also=("osd_qos_unified",)),
        _opt("osd_qos_slots", int, 4, LEVEL_ADVANCED,
             "concurrent admission slots for batched dispatches per "
             "OSD: the unified QoS layer's service capacity -- when "
             "all are busy, freed slots go to queued classes in "
             "dmClock tag order (the point where reservation floors "
             "and weight shares are enforced)",
             see_also=("osd_qos_unified",)),
        _opt("osd_qos_op_slots", int, 64, LEVEL_ADVANCED,
             "concurrent client-op execution slots per OSD under "
             "unified QoS (the osd_op_tp width): freed slots are "
             "granted to queued client ops in dmClock tag order by "
             "qos_class instead of semaphore FIFO.  Matches the "
             "legacy _cop_sem width by default",
             see_also=("osd_qos_unified", "osd_qos_slots")),
        _opt("osd_pg_log_dups_tracked", int, 3000, LEVEL_ADVANCED,
             "reqid dup entries retained per OSD PG log for client-op "
             "replay detection; kept past trim() like the reference's "
             "pg_log_dup_t list (src/osd/osd_types.h), evicted oldest "
             "first past this bound"),
        _opt("client_probe_retries", int, 2, LEVEL_ADVANCED,
             "consecutive failed probes of an unresponsive primary "
             "before the Objecter demotes it and fails the op over "
             "(the osd_heartbeat_grace role on the client side; one "
             "missed connect under host load must not demote a live "
             "primary)"),
        _opt("client_probe_grace", float, 1.0, LEVEL_ADVANCED,
             "seconds per Objecter reply-wait slice and per probe "
             "attempt while an op is in flight",
             see_also=("client_probe_retries",)),
        _opt("client_backoff_base", float, 0.05, LEVEL_ADVANCED,
             "initial delay before an Objecter resend after a primary "
             "failover; doubles per attempt (with jitter) up to "
             "client_backoff_max, always capped by the op deadline"),
        _opt("client_backoff_max", float, 2.0, LEVEL_ADVANCED,
             "ceiling on the Objecter's exponential resend backoff",
             see_also=("client_backoff_base",)),
        _opt("osd_recovery_max_active", int, 3, LEVEL_ADVANCED,
             "max concurrent object recoveries per OSD"),
        _opt("osd_tick_interval", float, 5.0, LEVEL_ADVANCED,
             "seconds between OSD background ticks (peering/scrub)"),
        _opt("osd_op_complaint_time", float, 5.0, LEVEL_ADVANCED,
             "an op slower than this logs a slow-op warning with its "
             "full decomposed timeline and is retained by "
             "dump_historic_slow_ops (reference "
             "osd_op_complaint_time, 30s; shrunk to the mini-cluster "
             "time scale)"),
        _opt("osd_op_history_size", int, 20, LEVEL_ADVANCED,
             "completed TrackedOps retained per daemon for "
             "dump_historic_ops (reference osd_op_history_size)"),
        _opt("osd_op_history_slow_size", int, 20, LEVEL_ADVANCED,
             "slowest completed TrackedOps retained per daemon "
             "(reference osd_op_history_slow_op_size)"),
        _opt("lockdep", bool, False, LEVEL_DEV,
             "track lock acquisition order and raise on cycles "
             "(reference src/common/lockdep.h; asyncio-lock analogue)"),
        _opt("osd_client_op_commit_timeout", float, 30.0, LEVEL_ADVANCED,
             "seconds a primary waits for sub-write commit acks before "
             "failing the op (fault-injection tests shrink this to "
             "manufacture torn writes)"),
        _opt("osd_read_gather_timeout", float, 15.0, LEVEL_ADVANCED,
             "seconds a primary waits for sub-read replies before "
             "serving with whatever arrived (degraded decode or EIO)"),
        _opt("osd_scrub_objects_per_tick", int, 4, LEVEL_ADVANCED,
             "deep-scrub at most this many objects per background tick "
             "(rate limit; 0 disables background scrub)"),
        _opt("osd_tier_promote_temp", float, 0.25, LEVEL_ADVANCED,
             "hit-set temperature at or above which the tier agent "
             "promotes an object's shards into device memory (and "
             "writeback-mode writes refresh the resident copy, "
             "promote-on-write)"),
        _opt("osd_heartbeat_grace", float, 4.0, LEVEL_ADVANCED,
             "seconds of heartbeat silence before an OSD reports a peer "
             "failed to the mon (reference osd_heartbeat_grace; shrunk "
             "here to match the mini-cluster's time scale).  The mon "
             "expires failure reports older than 4 graces"),
        _opt("mon_mgr_beacon_grace", float, 30.0, LEVEL_ADVANCED,
             "seconds of mgr-beacon silence before a standby's beacon "
             "triggers failover (reference mon_mgr_beacon_grace)"),
        _opt("mgr_modules", str, "status prometheus", LEVEL_BASIC,
             "mgr modules loaded at start: bare names resolve under "
             "ceph_tpu_torch.mgr.mgr_modules, dotted paths import "
             "third-party modules (reference: mgr_initial_modules)"),
        _opt("mgr_beacon_interval", float, 0.25, LEVEL_ADVANCED,
             "seconds between daemon->mgr liveness beacons (the "
             "MgrClient beacon cadence; reference mgr_tick_period, "
             "shrunk to the mini-cluster time scale)",
             see_also=("mgr_daemon_beacon_grace",)),
        _opt("mgr_report_interval", float, 1.0, LEVEL_ADVANCED,
             "seconds between daemon->mgr MgrReport frames (per-PG "
             "stats, perf-counter slice, histogram marginals -- the "
             "mgr_stats_period role); consecutive reports feed the "
             "PGMap rate engine, so shrinking this sharpens the io "
             "rates at the cost of frame traffic"),
        _opt("mgr_daemon_beacon_grace", float, 2.0, LEVEL_ADVANCED,
             "seconds of beacon silence before the mgr's wire-fed map "
             "marks a daemon down (OSD_DOWN / MON_DOWN from staleness "
             "-- the mon_osd_report_timeout role, shrunk to the "
             "mini-cluster time scale)",
             see_also=("mgr_beacon_interval",)),
        _opt("mgr_pg_stale_grace", float, 4.0, LEVEL_ADVANCED,
             "seconds without a fresh per-PG report before the PGMap "
             "flags PG_STALE for that (pool, primary) slice (the "
             "reference's stale-PG detection via pg stats epochs)",
             see_also=("mgr_report_interval",)),
        _opt("mgr_lag_warn_ms", float, 250.0, LEVEL_ADVANCED,
             "event-loop lag (sampled sleep-drift EWMA, shipped in "
             "beacons/reports) at or above which a daemon counts "
             "toward the DAEMON_LAG health check",
             see_also=("mgr_lag_sustain",)),
        _opt("mgr_lag_sustain", int, 3, LEVEL_ADVANCED,
             "consecutive over-threshold beacons/reports before "
             "DAEMON_LAG fires (one GC pause must not page an "
             "operator; a saturated wire loop should)",
             see_also=("mgr_lag_warn_ms",)),
        _opt("osd_pool_default_erasure_code_profile", str,
             "plugin=cuda technique=reed_sol_van k=2 m=1",
             LEVEL_ADVANCED, "default EC profile for new pools (the JAX "
             "package's names plugin=jerasure, on the host; the port's "
             "runs on the card, with the same bytes)"),
        _opt("mon_osd_min_down_reporters", int, 2, LEVEL_ADVANCED,
             "distinct OSD failure reporters required before the mon "
             "marks the target down (reference "
             "mon_osd_min_down_reporters, src/mon/OSDMonitor.cc "
             "check_failure)"),
        _opt("osd_tier_hbm_bytes", int, 256 << 20, LEVEL_ADVANCED,
             "device byte budget for the storage layer's resident "
             "state: cache-tier shard blocks plus the pipeline's "
             "content-addressed H2D upload cache.  The tier evicts "
             "coldest-first to stay under it "
             "(tier/device_tier.py DeviceByteAccount)"),
        _opt("osd_tier_h2d_cache_bytes", int, 64 << 20, LEVEL_ADVANCED,
             "sub-allocation of osd_tier_hbm_bytes reserved for the "
             "pipeline's content-addressed H2D upload cache "
             "(ops/pipeline.py; CEPH_TPU_TORCH_NO_H2D_CACHE=1 turns the "
             "cache off).  The tier yields to this working set, never "
             "the other way around",
             see_also=("osd_tier_hbm_bytes",)),
        _opt("osd_mesh_data_plane", bool, False, LEVEL_ADVANCED,
             "mesh-slice the OSD data plane over the process device list "
             "(ceph_tpu_torch/parallel/mesh_plane.py): PG ownership is "
             "sliced over the mesh's pg axis, the per-PG coalescer's "
             "fused encode batches run across the device slots, and "
             "chunk payloads destined for in-mesh OSDs are delivered "
             "through the delivery board instead of being carried by "
             "the messenger.  False (default) keeps the single-device "
             "path -- the A/B baseline",
             see_also=("osd_mesh_devices", "osd_mesh_scatter",
                       "osd_mesh_board_bytes")),
        _opt("osd_mesh_devices", int, 0, LEVEL_ADVANCED,
             "device slots the mesh data plane spans (0 = every device "
             "of parallel.local_devices()).  Each slot hosts one OSD's "
             "PG-shard slice; OSDs past the slot count stay out-of-mesh "
             "and keep the wire delivery path",
             see_also=("osd_mesh_data_plane",)),
        _opt("osd_mesh_scatter", str, "auto", LEVEL_ADVANCED,
             "in-collective parity scatter mode for the mesh data "
             "plane: 'auto' splits the GF product over the mesh's shard "
             "axis (reduce-scatter parity placement) on CUDA devices, "
             "where the reduction rides device-to-device copies; 'on' "
             "forces it (CPU correctness runs); 'off' keeps every "
             "slot's encode local (pg slicing only)",
             see_also=("osd_mesh_data_plane",)),
        _opt("osd_mesh_board_bytes", int, 64 << 20, LEVEL_ADVANCED,
             "byte bound on the mesh delivery board (the in-collective "
             "chunk handoff between in-mesh OSDs): beyond it the "
             "oldest unclaimed deposits are dropped and the affected "
             "sub-write fails over to normal recovery (bounded memory; "
             "claims release immediately)",
             see_also=("osd_mesh_data_plane",)),
        _opt("osd_tier_promote_max_per_tick", int, 8, LEVEL_ADVANCED,
             "max objects promoted per tier-agent tick; the whole set "
             "rides one batched gather + device transfer",
             see_also=("osd_tier_promote_temp",)),
        _opt("osd_op_batch_exec", bool, True, LEVEL_ADVANCED,
             "execute decoded client-op bursts through the OSD shard's "
             "array-batched fast path (osd/shard.py): one optracker "
             "request, one dups-registry pass, per-class amortized QoS "
             "admission and one corked reply burst per batch instead "
             "of per-op dict walks.  Semantics (dup answers, typed "
             "errors, apply-window kills, caps) are identical; false "
             "runs the per-op path, the A/B baseline the wire-tax "
             "bench compares against",
             see_also=("osd_op_batch_max", "osd_wire_codec_native")),
        _opt("osd_op_batch_max", int, 64, LEVEL_ADVANCED,
             "max client ops gathered into one batched execution run "
             "(bounds per-batch reply latency and memory)",
             see_also=("osd_op_batch_exec",)),
        _opt("osd_client_message_size_cap", int, 500 * 1024 * 1024,
             LEVEL_ADVANCED,
             "max bytes of in-flight inbound messages a daemon holds "
             "before back-pressuring senders (dispatch throttle)"),
        _opt("osd_msgr_cork", bool, True, LEVEL_ADVANCED,
             "coalesce outgoing messenger frames per connection into "
             "scatter-gather bursts (one writelines + one drain per "
             "burst) and piggyback/batch acks instead of one ack frame "
             "+ drain per message; off = one write/drain per message "
             "(the pre-round-8 wire behavior, kept as the bench "
             "baseline)"),
        _opt("osd_msgr_cork_bytes", int, 256 * 1024, LEVEL_ADVANCED,
             "corked send queue byte threshold: a queue reaching this "
             "many pending frame bytes flushes immediately instead of "
             "waiting for the end-of-tick flush",
             see_also=("osd_msgr_cork",)),
        _opt("osd_msgr_shm_ring", bool, False, LEVEL_ADVANCED,
             "carry frame bursts between mesh-colocated daemons over "
             "seqlock'd shared-memory byte rings (msg/shm_ring.py) "
             "instead of the localhost TCP hop.  The protocol above "
             "the byte transport -- banner, auth, session watermarks, "
             "cumulative acks, frame crcs, torn-burst replay -- runs "
             "unchanged; peers without a ring-registered accept "
             "endpoint fall back to TCP per connection.  False "
             "(default) keeps TCP everywhere, the A/B baseline",
             see_also=("osd_shm_ring_bytes", "osd_msgr_cork")),
        _opt("osd_shm_ring_bytes", int, 4 << 20, LEVEL_ADVANCED,
             "per-direction byte capacity of each shared-memory frame "
             "ring; a full ring back-pressures the producer's drain() "
             "exactly like a full socket buffer",
             see_also=("osd_msgr_shm_ring",)),
        _opt("osd_wire_codec_native", bool, True, LEVEL_ADVANCED,
             "batch-encode/decode v4 frame bodies through the "
             "_wire_native C extension (ceph_tpu/native/wire_codec.py); "
             "false runs the pure-Python codec in msg/wire.py -- wire "
             "bytes are identical either way (the A/B baseline and the "
             "no-toolchain degraded mode).  The port has only the "
             "Python codec: with this and ``native`` both true, "
             "msg/tcp.py refuses to start (ROADMAP.md queue 1 item 16b)",
             see_also=("native", "osd_msgr_cork")),
        _opt("native", bool, True, LEVEL_DEV,
             "master toggle for the native C extensions on the wire "
             "path (CEPH_TPU_NATIVE=0 forces every codec seam to pure "
             "Python -- the no-toolchain degraded mode, log-once + "
             "ceph_wire_codec_native gauge).  The port reads it as "
             "CEPH_TPU_TORCH_NATIVE",
             see_also=("osd_wire_codec_native",)),
    ]
}

#: environment layer: CEPH_TPU_TORCH_<NAME> (the JAX package reads
#: CEPH_TPU_<NAME>; the prefixes differ so an override meant for one
#: package does not reach the other)
ENV_PREFIX = "CEPH_TPU_TORCH_"


class Config:
    """Layered config with observers (md_config_t role)."""

    def __init__(self, overrides: Optional[Dict[str, Any]] = None):
        self._lock = threading.Lock()
        self._values: Dict[str, Any] = {}
        self._observers: List[Callable[[set], None]] = []
        for name, opt in OPTIONS.items():
            env = os.environ.get(ENV_PREFIX + name.upper())
            if env is not None:
                self._values[name] = self._coerce(opt, env)
        if overrides:
            for key, val in overrides.items():
                self.set_val(key, val)

    @staticmethod
    def _coerce(opt: Option, value: Any):
        if opt.type is bool and isinstance(value, str):
            return value.lower() in ("1", "true", "yes")
        return opt.type(value)

    def get_val(self, name: str):
        opt = OPTIONS.get(name)
        if opt is None:
            raise KeyError(f"no such option: {name}")
        with self._lock:
            return self._values.get(name, opt.default)

    def set_val(self, name: str, value) -> None:
        opt = OPTIONS.get(name)
        if opt is None:
            raise KeyError(f"no such option: {name}")
        with self._lock:
            self._values[name] = self._coerce(opt, value)

    def add_observer(self, fn: Callable[[set], None]) -> None:
        self._observers.append(fn)

    def apply_changes(self, changes: Dict[str, Any]) -> None:
        changed = set()
        for key, val in changes.items():
            self.set_val(key, val)
            changed.add(key)
        for fn in list(self._observers):  # snapshot: observers may
            fn(changed)                   # self-remove when their owner
                                          # was garbage-collected

    def show_config(self) -> Dict[str, Any]:
        return {name: self.get_val(name) for name in sorted(OPTIONS)}


_global: Optional[Config] = None
_global_lock = threading.Lock()


def get_config() -> Config:
    global _global
    with _global_lock:
        if _global is None:
            _global = Config()
        return _global
