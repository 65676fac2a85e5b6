"""Typed message wire codecs.

Port of ``ceph_tpu/msg/wire.py``: the same type codes and the same bytes
for every message, over the port's ``osd/types.py`` and ``mgr/report.py``
dataclasses.  Only the pure-Python codec is ported; the JAX package's
batched C codec (``native/wire_codec.py``) is ROADMAP.md queue 1 item
16b, and ``msg/tcp.py`` refuses to start where the configuration asks
for it.

Reference: src/messages/* -- each message is a typed, versioned struct
serialized through the encoding framework and carried in a crc-guarded
envelope (src/msg/Message.cc header/footer crcs).  Here every message
body is encoded with ``ceph_tpu_torch.utils.encoding`` and the transport
frames it with ``frame()`` (magic + length + crc32c), so corruption and
torn writes are detected at the same layer they are in the reference.

Supported messages: the EC sub-op types (ECSubWrite/Read + replies), the
mgr telemetry frames, and arbitrary control values (str/dict/tuple/...
-- heartbeats, mon traffic).
"""

from __future__ import annotations

from ceph_tpu_torch.mgr.report import MgrBeacon, MgrReport
from ceph_tpu_torch.osd.types import (
    ECSubRead,
    ECSubReadReply,
    ECSubWrite,
    ECSubWriteReply,
    LogEntry,
    Transaction,
    TxnOp,
)
from ceph_tpu_torch.utils.encoding import Decoder, Encoder

# message type codes (the reference's CEPH_MSG_* / MSG_OSD_EC_* ids)
_MSG_VALUE = 0
_MSG_EC_SUB_WRITE = 1
_MSG_EC_SUB_WRITE_REPLY = 2
_MSG_EC_SUB_READ = 3
_MSG_EC_SUB_READ_REPLY = 4
# mgr telemetry frames (MMgrBeacon / MMgrReport+MPGStats roles); peers
# that predate them drop unknown kinds at the transport (msg/tcp.py
# counts unknown_msg_dropped) instead of tearing the connection down
_MSG_MGR_BEACON = 5
_MSG_MGR_REPORT = 6


def encode_transaction(enc: Encoder, txn: Transaction) -> None:
    enc.varint(len(txn.ops))
    for op in txn.ops:
        enc.string(op.op).string(op.oid).varint(op.offset)
        enc.blob(op.data)
        enc.string(op.attr_name)
        enc.value(op.attr_value)


def decode_transaction(dec: Decoder) -> Transaction:
    txn = Transaction()
    for _ in range(dec.varint()):
        txn.ops.append(
            TxnOp(
                dec.string(), oid=dec.string(), offset=dec.varint(),
                data=dec.blob(), attr_name=dec.string(),
                attr_value=dec.value(),
            )
        )
    return txn


def _encode_log_entry(enc: Encoder, e: LogEntry) -> None:
    enc.varint(e.version).string(e.oid).string(e.op).varint(e.prior_size)


def _decode_log_entry(dec: Decoder) -> LogEntry:
    return LogEntry(
        version=dec.varint(), oid=dec.string(), op=dec.string(),
        prior_size=dec.varint(),
    )


def message_encoder(msg: object) -> Encoder:
    """Encode ``msg`` into an :class:`Encoder` WITHOUT joining it: the
    transport nests ``enc.parts()`` straight into its frame part list
    (``Encoder.blob_parts``), so large payload blobs -- EC shard bytes
    inside a sub-write transaction -- cross the messenger by reference
    instead of being copied at every layer."""
    enc = Encoder()
    if isinstance(msg, ECSubWrite):
        enc.u8(_MSG_EC_SUB_WRITE)
        enc.varint(msg.from_shard).varint(msg.tid).string(msg.oid)
        encode_transaction(enc, msg.transaction)
        enc.value(tuple(msg.at_version) if isinstance(
            msg.at_version, (tuple, list)) else msg.at_version)
        enc.varint(len(msg.log_entries))
        for e in msg.log_entries:
            _encode_log_entry(enc, e)
        enc.string(msg.op_class)
        enc.value(msg.rollback)
        enc.value(msg.prev_version)
        enc.value(tuple(msg.reqid) if isinstance(
            msg.reqid, (tuple, list)) else msg.reqid)
        enc.value(list(msg.trace) if isinstance(
            msg.trace, (tuple, list)) else msg.trace)
        enc.value(msg.qos_class)
    elif isinstance(msg, ECSubWriteReply):
        enc.u8(_MSG_EC_SUB_WRITE_REPLY)
        enc.varint(msg.from_shard).varint(msg.tid)
        enc.value(msg.committed).value(msg.applied)
        enc.value(tuple(msg.current_version) if isinstance(
            msg.current_version, (tuple, list)) else msg.current_version)
        enc.value(msg.missed)
    elif isinstance(msg, ECSubRead):
        enc.u8(_MSG_EC_SUB_READ)
        enc.varint(msg.from_shard).varint(msg.tid)
        enc.value({k: [tuple(x) for x in v] for k, v in msg.to_read.items()})
        enc.value(list(msg.attrs_to_read))
        enc.value({k: [tuple(x) for x in v] for k, v in msg.subchunks.items()})
        enc.string(msg.op_class)
        enc.value(list(msg.trace) if isinstance(
            msg.trace, (tuple, list)) else msg.trace)
        enc.value(msg.qos_class)
        enc.value({k: [int(c) for c in v] for k, v in msg.regen.items()}
                  if isinstance(msg.regen, dict) else msg.regen)
    elif isinstance(msg, ECSubReadReply):
        enc.u8(_MSG_EC_SUB_READ_REPLY)
        enc.varint(msg.from_shard).varint(msg.tid)
        enc.value(
            {k: [(off, bytes(b)) for off, b in v]
             for k, v in msg.buffers_read.items()}
        )
        enc.value(msg.attrs_read)
        enc.value(msg.errors)
    elif isinstance(msg, MgrBeacon):
        enc.u8(_MSG_MGR_BEACON)
        enc.string(msg.name).varint(msg.seq)
        enc.value(msg.lag_ms)
    elif isinstance(msg, MgrReport):
        enc.u8(_MSG_MGR_REPORT)
        enc.string(msg.name).varint(msg.seq)
        enc.value(msg.interval)
        enc.value(msg.stats)
        enc.value(msg.lag_ms)
    else:
        enc.u8(_MSG_VALUE)
        enc.value(msg)
    return enc


def encode_message(msg: object) -> bytes:
    return message_encoder(msg).bytes()


def decode_message(data: bytes) -> object:
    dec = Decoder(data)
    kind = dec.u8()
    if kind == _MSG_VALUE:
        return dec.value()
    if kind == _MSG_EC_SUB_WRITE:
        from_shard = dec.varint()
        tid = dec.varint()
        oid = dec.string()
        txn = decode_transaction(dec)
        at_version = dec.value()
        entries = [_decode_log_entry(dec) for _ in range(dec.varint())]
        return ECSubWrite(
            from_shard=from_shard, tid=tid, oid=oid, transaction=txn,
            at_version=at_version, log_entries=entries,
            op_class=dec.string(), rollback=dec.value(),
            prev_version=dec.value(),
            # pre-reqid senders end here
            reqid=dec.value() if dec.remaining() else None,
            # pre-trace senders end at the reqid (and pre-trace
            # decoders stop there, ignoring this trailing context)
            trace=dec.value() if dec.remaining() else None,
            # pre-qos senders end at the
            # trace context
            qos_class=dec.value() if dec.remaining() else None,
        )
    if kind == _MSG_EC_SUB_WRITE_REPLY:
        return ECSubWriteReply(
            from_shard=dec.varint(), tid=dec.varint(),
            committed=dec.value(), applied=dec.value(),
            current_version=dec.value(), missed=dec.value(),
        )
    if kind == _MSG_EC_SUB_READ:
        return ECSubRead(
            from_shard=dec.varint(), tid=dec.varint(),
            to_read={k: [tuple(x) for x in v]
                     for k, v in dec.value().items()},
            attrs_to_read=dec.value(),
            subchunks={k: [tuple(x) for x in v]
                       for k, v in dec.value().items()},
            op_class=dec.string(),
            # pre-trace senders end here
            trace=dec.value() if dec.remaining() else None,
            # pre-qos senders end at the
            # trace context
            qos_class=dec.value() if dec.remaining() else None,
            # pre-regen senders end at the
            # qos class
            regen=dec.value() if dec.remaining() else None,
        )
    if kind == _MSG_EC_SUB_READ_REPLY:
        return ECSubReadReply(
            from_shard=dec.varint(), tid=dec.varint(),
            buffers_read=dec.value(), attrs_read=dec.value(),
            errors=dec.value(),
        )
    if kind == _MSG_MGR_BEACON:
        return MgrBeacon(
            name=dec.string(), seq=dec.varint(),
            # pre-lag senders end at the seq
            lag_ms=dec.value() if dec.remaining() else None,
        )
    if kind == _MSG_MGR_REPORT:
        return MgrReport(
            name=dec.string(), seq=dec.varint(),
            interval=dec.value(), stats=dec.value(),
            # pre-lag senders end at the
            # stats payload
            lag_ms=dec.value() if dec.remaining() else None,
        )
    raise ValueError(f"unknown message type {kind}")
