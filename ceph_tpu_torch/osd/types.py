"""Wire/value types for the EC storage backend (ECMsgTypes equivalents).

Port of ``ceph_tpu/osd/types.py``.

Reference: src/osd/ECMsgTypes.h -- ECSubWrite (:23-89), ECSubWriteReply
(:91-103), ECSubRead (:105), ECSubReadReply (:118); ObjectStore::Transaction
(src/os/Transaction.cc) reduced to the op set the EC path uses.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class TxnOp:
    """A single ObjectStore transaction op (append/write/setattr/remove)."""

    op: str  # "write" | "setattr" | "remove" | "truncate"
    oid: str = ""
    offset: int = 0
    data: bytes = b""
    attr_name: str = ""
    attr_value: object = None


@dataclasses.dataclass
class Transaction:
    ops: List[TxnOp] = dataclasses.field(default_factory=list)

    def write(self, oid: str, offset: int, data: bytes) -> "Transaction":
        self.ops.append(TxnOp("write", oid=oid, offset=offset, data=bytes(data)))
        return self

    def setattr(self, oid: str, name: str, value) -> "Transaction":
        self.ops.append(
            TxnOp("setattr", oid=oid, attr_name=name, attr_value=value)
        )
        return self

    def remove(self, oid: str) -> "Transaction":
        self.ops.append(TxnOp("remove", oid=oid))
        return self

    def truncate(self, oid: str, offset: int) -> "Transaction":
        self.ops.append(TxnOp("truncate", oid=oid, offset=offset))
        return self

    def clone(self, oid: str, dst_oid: str) -> "Transaction":
        """Copy ``oid`` (data + xattrs) to ``dst_oid`` -- the COW-clone
        primitive snapshots ride on (reference: ObjectStore clone,
        PrimaryLogPG::make_writeable cloning the head before a write
        under a newer SnapContext)."""
        self.ops.append(TxnOp("clone", oid=oid, attr_name=dst_oid))
        return self

    # -- omap (reference: ObjectStore omap_setkeys/rmkeys/clear; the
    # per-object sorted key->value map cls/mds/rbd metadata lives in) ----

    def omap_setkeys(self, oid: str, kvs: Dict[str, bytes]) -> "Transaction":
        self.ops.append(
            TxnOp("omap_set", oid=oid,
                  attr_value={k: bytes(v) for k, v in kvs.items()})
        )
        return self

    def omap_rmkeys(self, oid: str, keys: List[str]) -> "Transaction":
        self.ops.append(TxnOp("omap_rm", oid=oid, attr_value=list(keys)))
        return self

    def omap_clear(self, oid: str) -> "Transaction":
        self.ops.append(TxnOp("omap_clear", oid=oid))
        return self


@dataclasses.dataclass
class LogEntry:
    """Minimal pg-log entry: enough for rollback-aware appends
    (reference: ECSubWrite carries log entries + rollback versions,
    doc/dev/osd_internals/erasure_coding/ecbackend.rst:9-27)."""

    version: int
    oid: str
    op: str  # "append" | "touch" | "delete"
    prior_size: int = 0  # for append rollback


@dataclasses.dataclass
class ECSubWrite:
    from_shard: int
    tid: int
    oid: str
    transaction: Transaction
    #: object version tuple ``(counter, writer)`` — the eversion analogue
    #: with a writer tiebreak so two primaries racing the same counter
    #: produce *distinct, totally ordered* versions (no same-version mix)
    at_version: tuple
    log_entries: List[LogEntry] = dataclasses.field(default_factory=list)
    #: QoS class for the OSD op queue ("client" | "recovery" | "scrub")
    op_class: str = "client"
    #: peering-authorized rollback: lets a recovery push OVERWRITE a
    #: higher-versioned shard copy.  Set only when the primary's peering
    #: pass proved the newer version a torn write (held by < k shards
    #: with every mapped shard reporting) — the PG-log divergent-entry
    #: rollback role (reference doc/dev/osd_internals/log_based_pg.rst)
    rollback: bool = False
    #: base-version gate for INCREMENTAL writes (RMW extent writes): the
    #: version counter this write was computed on top of.  A shard whose
    #: applied counter differs missed history (e.g. it was down and
    #: revived hollow) — applying just the extent would stamp the new
    #: version over an object mostly made of stale/absent bytes, so the
    #: shard must skip the write and wait for recovery instead (the PG
    #: missing-set role, reference src/osd/PG.h pg_missing_t).  None for
    #: full-rewrite transactions, which are safe on any base.
    prev_version: object = None
    #: originating client op's reqid ``(client, incarnation, tid)`` for
    #: client-class sub-ops (the osd_reqid_t role): the applying shard
    #: records a PG-log dup entry so a replayed op after primary
    #: failover is answered from the log instead of re-executed.  None
    #: for recovery/scrub pushes and legacy senders.
    reqid: object = None
    #: originating op's trace context ``[trace_id, parent_span_id]``
    #: (utils/trace.py): the applying shard's sub-write span joins the
    #: client op's trace so one op stitches client -> primary ->
    #: sub-write across daemons.  None for unsampled ops and pre-trace
    #: senders (trailing optional wire field, msg/wire.py).
    trace: object = None
    #: originating client's QoS sub-class (gold/bulk/...; docs/qos.md):
    #: the RECEIVING shard's op queue orders this sub-write under that
    #: class, so end-to-end reservations hold through the replica hop,
    #: not just at the primary's admission.  Distinct from ``op_class``
    #: on purpose -- the version-gate/dup semantics key on op_class and
    #: must not change with scheduling class.  None = plain "client"
    #: (trailing optional wire field).
    qos_class: object = None


@dataclasses.dataclass
class ECSubWriteReply:
    from_shard: int
    tid: int
    committed: bool = False
    applied: bool = False
    #: set when a client-class write was refused as stale: the shard's
    #: currently-applied version tuple, so the writer can detect the
    #: conflict and retry at a higher version instead of believing a
    #: commit that never applied
    current_version: object = None
    #: the shard skipped an incremental write because its base version
    #: did not match ``prev_version`` (it missed history): it must NOT be
    #: counted toward the write's k-commit quorum, and it stays on the
    #: old version until peering recovers it
    missed: bool = False


@dataclasses.dataclass
class ECSubRead:
    from_shard: int
    tid: int
    # oid -> list of (offset, length) chunk-space extents
    to_read: Dict[str, List[Tuple[int, int]]] = dataclasses.field(
        default_factory=dict
    )
    attrs_to_read: List[str] = dataclasses.field(default_factory=list)
    subchunks: Dict[str, List[Tuple[int, int]]] = dataclasses.field(
        default_factory=dict
    )
    #: QoS class for the OSD op queue ("client" | "recovery" | "scrub")
    op_class: str = "client"
    #: originating op's trace context (see ECSubWrite.trace); trailing
    #: optional wire field, None for unsampled ops / pre-trace senders
    trace: object = None
    #: originating client's QoS sub-class (see ECSubWrite.qos_class);
    #: trailing optional wire field
    qos_class: object = None
    #: regenerating-code repair lane (plugins/regen.py): oid -> the
    #: GF(2^8) helper coefficients (phi_f).  The serving shard does NOT
    #: return raw extents for these oids -- it dots its own stored
    #: sub-chunks with the coefficients and replies the beta-sized
    #: helper symbol.  Trailing optional wire field, None for classic
    #: extent reads / pre-regen senders.
    regen: object = None


@dataclasses.dataclass
class ECSubReadReply:
    from_shard: int
    tid: int
    buffers_read: Dict[str, List[Tuple[int, bytes]]] = dataclasses.field(
        default_factory=dict
    )
    attrs_read: Dict[str, Dict[str, object]] = dataclasses.field(
        default_factory=dict
    )
    errors: Dict[str, int] = dataclasses.field(default_factory=dict)
