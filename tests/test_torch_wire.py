"""The port's wire codec (``msg/wire.py``) against the JAX package's.

For a typed corpus of every message kind -- control values, the four EC
sub-op messages with every transaction op and every optional field, and
the two mgr frames -- the port's ``encode_message`` bytes equal the JAX
package's exactly, each package decodes the other's bytes to equal
fields, and a sender that predates a trailing field (the encoding cut
where that field starts) decodes the same in both.  The corpus is drawn
by hypothesis and, for the fixed cases, made with numpy from a seed.
The mesh-delivery form of a sub-write (payloads detached to the board,
``tests/test_mesh_plane.py``'s case) is compared the same way.
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ceph_tpu.mgr import report as j_report
from ceph_tpu.msg import wire as j_wire
from ceph_tpu.osd import types as j_types
from ceph_tpu.parallel import mesh_plane as j_mesh_plane
from ceph_tpu_torch import parallel
from ceph_tpu_torch.mgr import report
from ceph_tpu_torch.msg import wire
from ceph_tpu_torch.osd import types as t_types
from ceph_tpu_torch.parallel import mesh_plane

PORT = types.SimpleNamespace(name="port", wire=wire, types=t_types,
                             report=report, mesh_plane=mesh_plane)
JAX = types.SimpleNamespace(name="jax", wire=j_wire, types=j_types,
                            report=j_report, mesh_plane=j_mesh_plane)


def _fields(msg):
    """A message as plain data (dataclasses unrolled), for comparing a
    port object with a JAX package object."""
    if dataclasses.is_dataclass(msg):
        return (type(msg).__name__,
                {f.name: _fields(getattr(msg, f.name))
                 for f in dataclasses.fields(msg)})
    if isinstance(msg, dict):
        return {k: _fields(v) for k, v in msg.items()}
    if isinstance(msg, (list, tuple)):
        return (type(msg).__name__, [_fields(v) for v in msg])
    return msg


def _txn(P, rng):
    blob = rng.randint(0, 256, size=int(rng.randint(0, 5000)),
                       dtype=np.uint8).tobytes()
    return (P.types.Transaction()
            .write("obj@1", int(rng.randint(0, 1 << 20)), blob)
            .setattr("obj@1", "_version", (7, "osd.1"))
            .setattr("obj@1", "hinfo", {"crcs": [1, 2, 3], "size": 4096})
            .truncate("obj@1", 512)
            .clone("obj@1", "obj@1:snap")
            .omap_setkeys("obj@1", {"a": b"x", "b": b""})
            .omap_rmkeys("obj@1", ["c", "d"])
            .omap_clear("obj@2")
            .remove("obj@3"))


def corpus(P, seed: int):
    """Every message kind, each optional field set and unset, made in
    package ``P``'s classes from ``seed``."""
    rng = np.random.RandomState(seed)
    T, R = P.types, P.report
    logs = [T.LogEntry(version=5, oid="obj", op="append", prior_size=17),
            T.LogEntry(version=6, oid="o2", op="delete")]
    out = [
        "heartbeat", 0, -5, 1 << 62, 3.25, None, True, b"\x00\xff",
        ("osd_ping", 3, 1.5), ["a", 1, None],
        {"op": "client_op", "tid": 9, "data": b"d" * 100,
         "nested": {"x": [1, (2, 3)]}},
        {"type": "mon_command", "cmd": {"prefix": "osd add", "osd": 4},
         "id": 2, "reqid": ["client", 2]},
        T.ECSubWrite(from_shard=1, tid=7, oid="obj",
                     transaction=_txn(P, rng), at_version=(3, "client")),
        T.ECSubWrite(from_shard=11, tid=1 << 40, oid="ö-unicode",
                     transaction=_txn(P, rng), at_version=[4, "osd.2"],
                     log_entries=logs, op_class="recovery", rollback=True,
                     prev_version=(2, "osd.2"), reqid=("client", 2, 9),
                     trace=(0xABCDEF, 17, 1), qos_class="client"),
        T.ECSubWrite(from_shard=0, tid=0, oid="", at_version=None,
                     transaction=T.Transaction(), trace=[1, 2, 3]),
        T.ECSubWriteReply(from_shard=2, tid=7),
        T.ECSubWriteReply(from_shard=3, tid=8, committed=True, applied=True,
                          current_version=(5, "osd.1"), missed=True),
        T.ECSubRead(from_shard=1, tid=3),
        T.ECSubRead(from_shard=4, tid=5,
                    to_read={"obj@4": [(0, 4096), (8192, 512)]},
                    attrs_to_read=["hinfo", "_version"],
                    subchunks={"obj@4": [(0, 1), (2, 3)]},
                    op_class="scrub", trace=(1, 2, 3), qos_class="best",
                    regen={"obj@4": [1, 2, 3]}),
        T.ECSubReadReply(from_shard=4, tid=5),
        T.ECSubReadReply(
            from_shard=4, tid=5,
            buffers_read={"obj@4": [(0, rng.bytes(300)), (300, b"")]},
            attrs_read={"obj@4": {"hinfo": {"size": 3}, "v": (1, "a")}},
            errors={"obj@9": -2}),
        R.MgrBeacon(name="osd.3", seq=12),
        R.MgrBeacon(name="osd.3", seq=13, lag_ms=0.25),
        R.MgrReport(name="osd.1", seq=4, interval=1.0,
                    stats={"pgs": {"1.0": {"objects": 3}},
                           "store": {"bytes": 4096}}),
        R.MgrReport(name="osd.1", seq=5, interval=0.5, stats={},
                    lag_ms=2.0),
    ]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_corpus_bytes_equal_and_cross_decode(seed):
    mine, theirs = corpus(PORT, seed), corpus(JAX, seed)
    assert len(mine) == len(theirs)
    for m, j in zip(mine, theirs):
        a, b = wire.encode_message(m), j_wire.encode_message(j)
        assert a == b, (m, len(a), len(b))
        assert _fields(wire.decode_message(b)) == \
            _fields(j_wire.decode_message(a)) == \
            _fields(j_wire.decode_message(b))
        # the zero-copy part list joins to the same bytes
        assert b"".join(bytes(p) for p in
                        wire.message_encoder(m).parts(64)) == a


def _value_strategy():
    leaves = (st.none() | st.booleans() | st.integers(-(1 << 63) + 1, (1 << 63) - 1)
              | st.floats(allow_nan=False) | st.binary(max_size=64)
              | st.text(max_size=16))
    return st.recursive(
        leaves,
        lambda kids: (st.lists(kids, max_size=4)
                      | st.tuples(kids, kids)
                      | st.dictionaries(st.text(max_size=8), kids,
                                        max_size=4)),
        max_leaves=24)


@settings(max_examples=150, deadline=None)
@given(value=_value_strategy(), tid=st.integers(0, 1 << 62),
       shard=st.integers(0, 255), oid=st.text(max_size=24),
       data=st.binary(max_size=2048), trace=_value_strategy())
def test_drawn_messages_bytes_equal(value, tid, shard, oid, data, trace):
    for P_msg in (
        lambda P: value,
        lambda P: P.types.ECSubWrite(
            from_shard=shard, tid=tid, oid=oid,
            transaction=P.types.Transaction().write(oid, tid % 4096, data)
            .setattr(oid, "v", value),
            at_version=(tid, oid), trace=trace, reqid=value),
        lambda P: P.types.ECSubReadReply(
            from_shard=shard, tid=tid, buffers_read={oid: [(tid, data)]},
            attrs_read={oid: {"a": value}}),
        lambda P: P.report.MgrReport(name=oid, seq=tid, interval=0.5,
                                     stats={"v": value}),
    ):
        m, j = P_msg(PORT), P_msg(JAX)
        a, b = wire.encode_message(m), j_wire.encode_message(j)
        assert a == b
        assert _fields(wire.decode_message(b)) == \
            _fields(j_wire.decode_message(a))


def _trailing(P):
    """Messages with optional trailing fields: (message, the trailing
    fields' values as the codec writes them, last field first)."""
    T, R = P.types, P.report
    sub = T.ECSubWrite(from_shard=1, tid=2, oid="o",
                       transaction=T.Transaction().write("o@1", 0, b"abc"),
                       at_version=(1, "c"), reqid=("c", 1, 1),
                       trace=(9, 8, 7), qos_class="client")
    read = T.ECSubRead(from_shard=1, tid=2, to_read={"o@1": [(0, 3)]},
                       trace=(1, 2), qos_class="x", regen={"o@1": [1]})
    return [
        (sub, ["client", [9, 8, 7], ("c", 1, 1)]),
        (read, [{"o@1": [1]}, "x", [1, 2]]),
        (R.MgrBeacon(name="osd.1", seq=3, lag_ms=1.5), [1.5]),
        (R.MgrReport(name="osd.1", seq=3, interval=1.0, stats={"a": 1},
                     lag_ms=2.5), [2.5]),
    ]


def test_senders_without_trailing_fields_decode_alike():
    """The bytes of a sender that predates each trailing field (the
    encoding cut where the field starts) decode to the same fields in
    both packages, the missing fields None."""
    from ceph_tpu_torch.utils.encoding import Encoder

    for (m, tail), (j, _) in zip(_trailing(PORT), _trailing(JAX)):
        whole = wire.encode_message(m)
        assert whole == j_wire.encode_message(j)
        cut = len(whole)
        for n, value in enumerate(tail, 1):
            cut -= len(Encoder().value(value).bytes())
            mine = wire.decode_message(whole[:cut])
            assert _fields(mine) == _fields(j_wire.decode_message(
                whole[:cut]))
            names = [f.name for f in dataclasses.fields(mine)][-n:]
            assert all(getattr(mine, name) is None for name in names), \
                (names, mine)


def test_unknown_kind_raises_alike():
    for w in (wire, j_wire):
        with pytest.raises(ValueError):
            w.decode_message(bytes([200]))


@pytest.fixture
def cpu_slots():
    """Eight CPU slots for the port's plane (the JAX package's tests run
    on eight virtual CPU devices)."""
    parallel.configure_devices([torch.device("cpu")] * 8)
    yield
    parallel.configure_devices(None)
    mesh_plane.reset()
    j_mesh_plane.reset()


def test_mesh_delivery_sub_write_matches_jax(cpu_slots):
    """The mesh-delivery form of a sub-write: payloads detached to each
    package's board, the frame a fraction of the full one, the same
    bytes in both, and both decode it back to a resolvable
    ``write_ref``."""
    payload = os.urandom(32768)
    frames = {}
    for P in (PORT, JAX):
        T = P.types
        full = T.ECSubWrite(
            from_shard=1, tid=7, oid="obj", at_version=(3, "w"),
            transaction=T.Transaction().write("obj@1", 0, payload))
        wire_full = P.wire.encode_message(full)
        plane = P.mesh_plane.configure(2)
        detached = T.ECSubWrite(
            from_shard=1, tid=7, oid="obj", at_version=(3, "w"),
            transaction=T.Transaction().write("obj@1", 0, payload))
        plane.detach_sub_write(detached)
        wire_ref = P.wire.encode_message(detached)
        assert len(wire_ref) < len(wire_full) // 50
        back = P.wire.decode_message(wire_ref)
        assert back.transaction.ops[0].op == "write_ref"
        assert plane.resolve_transaction(back.transaction) is True
        assert back.transaction.ops[0].data == payload
        frames[P.name] = (wire_full, wire_ref)
    assert frames["port"] == frames["jax"]
