"""The port's native wire codec (``native/wire_native.c`` through
``native/wire_codec.py``) against the JAX package's codecs.

* encode and decode of a typed corpus (numpy-seeded, built once from each
  package's message dataclasses): the port's C codec against the JAX
  package's Python codec (``ceph_tpu/msg/wire.py``) and against the JAX
  package's own C codec where it loads, byte for byte, and decodes
  field for field;
* the trailing-optional tails (pre-reqid / pre-trace / pre-qos senders);
* ``seal_frames`` against the Python entry frames of both packages;
* ``parse_burst`` on partial and corrupt bursts;
* an unknown frame kind counted and dropped by a native receiver;
* a forced ``FallbackError`` (a 64..70-bit int): the message takes the
  Python encoder and its bytes equal the JAX package's;
* the gates (``native``, ``osd_wire_codec_native``) and a failed build,
  which raises -- nothing falls back in silence;
* a port messenger on the native codec sharing a socket with a JAX
  package messenger on each of its codecs.

The extension builds from ``ceph_tpu_torch/native/`` with the host
compiler; where it cannot, these tests fail.  The tolerance is byte
equality.
"""

import asyncio
import dataclasses
import os
import socket
import types

import numpy as np
import pytest

from ceph_tpu.mgr import report as j_report
from ceph_tpu.msg import tcp as j_tcp
from ceph_tpu.msg import wire as j_wire
from ceph_tpu.native import wire_codec as j_wire_codec
from ceph_tpu.osd import types as j_types
from ceph_tpu.utils.config import get_config as j_get_config
from ceph_tpu.utils.encoding import frame as j_frame
from ceph_tpu_torch.mgr import report
from ceph_tpu_torch.msg import tcp, wire
from ceph_tpu_torch.msg.fault import FaultInjector
from ceph_tpu_torch.native import build as native_build
from ceph_tpu_torch.native import wire_codec
from ceph_tpu_torch.osd import types as p_types
from ceph_tpu_torch.utils.config import get_config
from ceph_tpu_torch.utils.encoding import Encoder
from torch_verify import port_verifiers, verifying_policy

NATIVE = wire_codec.native()
PORT_T = types.SimpleNamespace(report=report, types=p_types)
JAX_T = types.SimpleNamespace(report=j_report, types=j_types)
WIDE_INT = (1 << 64) + 3


@pytest.fixture(autouse=True)
def _loop_policy():
    """Both packages' loops run under the port's verifiers
    (``tests/torch_verify.py``): its atomic-section verifier, which holds
    both packages' sections, and its residency verifier."""
    with port_verifiers():
        yield


def _jax_native():
    """The JAX package's own C codec, or None where it does not load
    (it falls back to its Python codec by design)."""
    try:
        return j_wire_codec.native()
    except Exception:  # noqa: BLE001 -- its loader's own business
        return None


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _plain(v):
    """A package-neutral form of a decoded value: dataclasses become
    (class name, fields), numpy ints become ints."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,
                tuple((f.name, _plain(getattr(v, f.name)))
                      for f in dataclasses.fields(v)))
    if isinstance(v, dict):
        return ("dict", tuple((k, _plain(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, tuple(_plain(x) for x in v))
    if isinstance(v, np.integer):
        return int(v)
    return v


# -- corpus, built from either package's types -------------------------------

def _rand_value(rng, depth=0):
    kinds = ["int", "negint", "str", "bytes", "none", "bool", "float"]
    if depth < 3:
        kinds += ["list", "tuple", "dict"]
    kind = kinds[rng.randint(len(kinds))]
    if kind == "int":
        return int(rng.randint(0, 1 << 62)) >> int(rng.randint(62))
    if kind == "negint":
        return -int(rng.randint(1, 1 << 40))
    if kind == "str":
        return "".join(rng.choice(list("abcé中 xyz"), rng.randint(8)))
    if kind == "bytes":
        return rng.randint(0, 256, rng.randint(32), dtype=np.uint8).tobytes()
    if kind == "none":
        return None
    if kind == "bool":
        return bool(rng.randint(2))
    if kind == "float":
        return float(rng.random_sample() * 1e6 - 5e5)
    if kind == "list":
        return [_rand_value(rng, depth + 1) for _ in range(rng.randint(4))]
    if kind == "tuple":
        return tuple(_rand_value(rng, depth + 1)
                     for _ in range(rng.randint(4)))
    return {f"k{i}": _rand_value(rng, depth + 1)
            for i in range(rng.randint(4))}


def _pick(rng, options):
    return options[rng.randint(len(options))]


def _sub_write(T, rng):
    t = T.types
    txn = t.Transaction()
    for _ in range(rng.randint(3)):
        txn.write(f"o{rng.randint(4)}@1", int(rng.randint(1 << 20)),
                  rng.randint(0, 256, rng.randint(5000),
                              dtype=np.uint8).tobytes())
    txn.ops.append(t.TxnOp("setattr", oid="o@1", attr_name="hinfo",
                           attr_value=_rand_value(rng)))
    return t.ECSubWrite(
        int(rng.randint(8)), int(rng.randint(1 << 30)),
        f"o{rng.randint(4)}@1", txn,
        (int(rng.randint(100)), f"osd.{rng.randint(8)}"),
        [t.LogEntry(int(rng.randint(100)), "o@1",
                    _pick(rng, ["append", "touch", "delete"]),
                    int(rng.randint(1 << 16)))
         for _ in range(rng.randint(3))],
        op_class=_pick(rng, ["client", "recovery"]),
        rollback=bool(rng.randint(5) == 0),
        prev_version=_pick(rng, [None, (3, "osd.1")]),
        reqid=_pick(rng, [None, ("c", 12, int(rng.randint(1 << 40)))]),
        trace=_pick(rng, [None, [int(rng.randint(1 << 30)), 4, 1]]),
        qos_class=_pick(rng, [None, "gold", "bulk"]))


def corpus(T, seed=11, n=60):
    """The same messages from either package's dataclasses (the same
    seed draws the same values)."""
    rng = np.random.RandomState(seed)
    t, r = T.types, T.report
    out = []
    for _ in range(n):
        roll = rng.random_sample()
        if roll < 0.3:
            out.append(_sub_write(T, rng))
        elif roll < 0.4:
            out.append(t.ECSubWriteReply(
                int(rng.randint(8)), int(rng.randint(1 << 30)),
                committed=bool(rng.randint(2)), applied=bool(rng.randint(2)),
                current_version=_pick(rng, [None, (5, "osd.0"),
                                            [7, "osd.2"]]),
                missed=bool(rng.randint(5) == 0)))
        elif roll < 0.5:
            out.append(t.ECSubRead(
                int(rng.randint(8)), int(rng.randint(1 << 30)),
                to_read={f"o{i}": [(int(rng.randint(1 << 12)), 512)]
                         for i in range(rng.randint(3))},
                attrs_to_read=["hinfo"] if rng.randint(2) else [],
                subchunks={"o0": [(0, 1)]} if rng.randint(3) == 0 else {},
                trace=_pick(rng, [None, (9, 2, 0)]),
                qos_class=_pick(rng, [None, "gold"]),
                regen=_pick(rng, [None, {"o0": [int(x) for x in
                                                rng.randint(0, 256, 3)]}])))
        elif roll < 0.6:
            out.append(t.ECSubReadReply(
                int(rng.randint(8)), int(rng.randint(1 << 30)),
                buffers_read={"o0": [(0, rng.randint(
                    0, 256, 4096, dtype=np.uint8).tobytes())]},
                attrs_read={"o0": {"hinfo": _rand_value(rng)}},
                errors={} if rng.randint(10) < 7 else {"o1": "KeyError"}))
        elif roll < 0.7:
            out.append(r.MgrReport(
                f"osd.{rng.randint(8)}", int(rng.randint(1 << 20)),
                float(rng.random_sample() * 5),
                {"pgs": {"1": [1, 2]}, "perf": {"x": int(rng.randint(99))}},
                lag_ms=_pick(rng, [None, float(rng.random_sample() * 10)])))
        elif roll < 0.75:
            out.append(r.MgrBeacon("mon.0", int(rng.randint(1 << 20)),
                                   lag_ms=_pick(rng, [None, 0.5])))
        elif roll < 0.8:
            out.append({"op": "client_op", "tid": int(rng.randint(99)),
                        "data": rng.randint(0, 256, 16384,
                                            dtype=np.uint8).tobytes(),
                        "reqid": ["c", 1, 2], "snapc": None,
                        "n": np.int64(7), "m": np.uint32(1 << 20)})
        else:
            out.append(_rand_value(rng))
    return out


# -- codec interop -----------------------------------------------------------

def test_encode_decode_equal_jax_python_codec():
    mine, theirs = corpus(PORT_T), corpus(JAX_T)
    kinds = set()
    for i, (m, j) in enumerate(zip(mine, theirs)):
        body = NATIVE.encode_body(m)
        assert body == j_wire.encode_message(j), f"corpus[{i}]"
        assert body == wire.encode_message(m), f"corpus[{i}]"
        # each codec decodes the other's bytes to the same message
        got = NATIVE.decode_body(body)
        assert _plain(got) == _plain(j_wire.decode_message(body)), i
        assert _plain(got) == _plain(wire.decode_message(body)), i
        kinds.add(body[0])
    assert kinds == set(range(7))  # every message kind of the wire


def test_encode_equal_jax_native_codec():
    j_nat = _jax_native()
    if j_nat is None:
        pytest.skip("the JAX package's own C codec does not load here")
    for i, (m, j) in enumerate(zip(corpus(PORT_T, 23), corpus(JAX_T, 23))):
        body = NATIVE.encode_body(m)
        assert body == j_nat.encode_body(j), f"corpus[{i}]"
        assert _plain(NATIVE.decode_body(body)) == \
            _plain(j_nat.decode_body(body)), i


def _sub_write_tails(T, w):
    """A pre-reqid ECSubWrite body and its three longer tails, built with
    one package's encoder (``w``: its msg/wire module)."""
    txn = T.types.Transaction().write("o@1", 0, b"z" * 64)
    enc = w.Encoder().u8(1)
    enc.varint(2).varint(9).string("o@1")
    w.encode_transaction(enc, txn)
    enc.value((4, "osd.0"))
    enc.varint(1)
    enc.varint(4).string("o@1").string("append").varint(0)
    enc.string("client")
    enc.value(False)
    enc.value(None)
    pre_reqid = enc.bytes()
    pre_trace = pre_reqid + w.Encoder().value(("c", 1, 7)).bytes()
    pre_qos = pre_trace + w.Encoder().value([3, 1, 0]).bytes()
    full = pre_qos + w.Encoder().value("gold").bytes()
    return [pre_reqid, pre_trace, pre_qos, full]


def test_trailing_optional_tails_decode_like_jax():
    mine = _sub_write_tails(PORT_T, wire)
    assert mine == _sub_write_tails(JAX_T, j_wire)
    want = [(None, None, None), (("c", 1, 7), None, None),
            (("c", 1, 7), [3, 1, 0], None), (("c", 1, 7), [3, 1, 0], "gold")]
    for body, tail in zip(mine, want):
        got = NATIVE.decode_body(body)
        assert _plain(got) == _plain(j_wire.decode_message(body))
        assert (got.reqid, got.trace, got.qos_class) == tail


def test_seal_frames_equal_python_entry_frames_of_both_packages():
    cfg, j_cfg = get_config(), j_get_config()
    j_prior = j_cfg.get_val("osd_wire_codec_native")
    addr = {"a": ("127.0.0.1", 1)}
    m = tcp.TCPMessenger("a", addr)
    assert m._native is NATIVE
    cfg.set_val("osd_wire_codec_native", False)
    j_cfg.set_val("osd_wire_codec_native", False)
    try:
        py = tcp.TCPMessenger("a", addr)
        j_py = j_tcp.TCPMessenger("a", addr)
    finally:
        cfg.set_val("osd_wire_codec_native", True)
        j_cfg.set_val("osd_wire_codec_native", j_prior)
    msgs, j_msgs = corpus(PORT_T, 5, 10), corpus(JAX_T, 5, 10)
    native = [m._msg_entry("a", "b", i + 1, x) for i, x in enumerate(msgs)]
    python = [py._msg_entry("a", "b", i + 1, x) for i, x in enumerate(msgs)]
    j_python = [j_py._msg_entry("a", "b", i + 1, x)
                for i, x in enumerate(j_msgs)]
    for ne, pe in zip(native, python):
        assert b"".join(bytes(p) for p in ne.parts) == \
            b"".join(bytes(p) for p in pe.parts)
        assert ne.crc is not None  # folded during encode
    for ack in (0, 77):
        last = len(msgs) - 1
        for entries in (native, python):
            bufs, nbytes = NATIVE.seal_frames(entries, ack)
            flat = b"".join(bytes(b) for b in bufs)
            want = b"".join(
                bytes(b) for i, e in enumerate(j_python)
                for b in j_py._entry_frames(e, None,
                                            ack if i == last else 0))
            assert flat == want and nbytes == len(want)
    assert all(e.crc is not None for e in python)


def test_parse_burst_partial_and_corrupt():
    payloads = [wire.encode_message(x) for x in corpus(PORT_T, 3, 6)]
    stream = b"".join(j_frame(p) for p in payloads)
    frames, pos, ok = NATIVE.parse_burst(stream + stream[:7], 0)
    assert ok and frames == payloads and pos == len(stream)
    # a burst that starts mid-buffer, and one cut inside a frame's body
    first = len(j_frame(payloads[0]))
    frames, pos, ok = NATIVE.parse_burst(stream, first)
    assert ok and frames == payloads[1:] and pos == len(stream)
    frames, pos, ok = NATIVE.parse_burst(stream[:first + 20], 0)
    assert ok and frames == payloads[:1] and pos == first
    bad = bytearray(stream)
    bad[first + 14] ^= 0xFF  # corrupt frame 2's body
    frames, _pos, ok = NATIVE.parse_burst(bytes(bad), 0)
    assert not ok and frames == payloads[:1]
    bad = bytearray(stream)
    bad[0] ^= 0x01  # a bad magic on the first frame
    frames, _pos, ok = NATIVE.parse_burst(bytes(bad), 0)
    assert not ok and frames == []


def test_unknown_frame_kind_counted_and_dropped_native():
    """A NEWER peer's frame kind reaching a native receiver is dropped
    and counted with the connection intact; later traffic delivered."""
    pa, pb = _free_ports(2)
    addr = {"a": ("127.0.0.1", pa), "b": ("127.0.0.1", pb)}

    async def main():
        a = tcp.TCPMessenger("a", addr, fault=FaultInjector())
        b = tcp.TCPMessenger("b", addr, fault=FaultInjector())
        assert b._native is NATIVE
        a._native = None  # the patched Python encoder below sends
        await a.start()
        await b.start()
        got = []

        async def sink(src, msg):
            got.append(msg)

        b.register("b", sink)
        real_encoder = tcp.message_encoder

        def future_kind_encoder(msg):
            if msg == "from-the-future":
                return Encoder().u8(200).string("mystery-payload")
            return real_encoder(msg)

        tcp.message_encoder = future_kind_encoder
        try:
            await a.send_message("a", "b", "from-the-future")
            await a.send_message("a", "b", {"op": "after"})
            for _ in range(200):
                if got:
                    break
                await asyncio.sleep(0.01)
            return got, b.counters["unknown_msg_dropped"]
        finally:
            tcp.message_encoder = real_encoder
            await a.shutdown()
            await b.shutdown()

    got, dropped = _run(main())
    assert got == [{"op": "after"}] and dropped == 1


def _fallback_cases(T):
    t, r = T.types, T.report
    return [
        t.ECSubWrite(1, 7, "o@1", t.Transaction().write("o@1", 0, b"w" * 99),
                     (3, "osd.1"), [], reqid=("c", 1, WIDE_INT)),
        t.ECSubWriteReply(1, 9, committed=True, applied=True,
                          current_version=(WIDE_INT, "osd.0")),
        t.ECSubRead(2, 11, to_read={"o1": [(0, 512)]},
                    trace=[WIDE_INT, 1, 0]),
        t.ECSubReadReply(3, 13, buffers_read={},
                         attrs_read={"o0": {"w": -WIDE_INT}}, errors={}),
        r.MgrBeacon("mon.0", 44, lag_ms=WIDE_INT),
        r.MgrReport("osd.3", 45, 2.5, {"wide": WIDE_INT}, lag_ms=None),
        {"wide": WIDE_INT},
    ]


def test_forced_fallback_round_trip_equals_jax():
    """A 64..70-bit int is outside the C encoder's model: it raises
    FallbackError, the messenger encodes that message with the Python
    codec, and the bytes and both decodes equal the JAX package's."""
    m = tcp.TCPMessenger("a", {"a": ("127.0.0.1", 1)})
    for i, (mine, theirs) in enumerate(zip(_fallback_cases(PORT_T),
                                           _fallback_cases(JAX_T))):
        with pytest.raises(NATIVE.FallbackError):
            NATIVE.encode_body(mine)
        body = wire.encode_message(mine)
        assert body == j_wire.encode_message(theirs), i
        assert _plain(NATIVE.decode_body(body)) == \
            _plain(j_wire.decode_message(body)), i
        entry = m._msg_entry("a", "b", i + 1, mine)
        assert entry.crc is None  # the Python path digests at transmit
        flat = b"".join(bytes(p) for p in entry.parts)
        assert flat.endswith(body)


# -- the gates and a failed build --------------------------------------------

def test_gates_run_the_python_codec_by_name():
    cfg = get_config()
    assert wire_codec.enabled() and wire_codec.status() == {
        "enabled": True, "gated_off": False, "load_error": None}
    assert os.path.dirname(NATIVE.__file__).startswith(
        str(native_build.BUILD_DIR / "wire_native-"))
    for name in ("osd_wire_codec_native", "native"):
        cfg.set_val(name, False)
        try:
            assert wire_codec.native() is None and not wire_codec.enabled()
            assert wire_codec.status()["gated_off"] is True
            assert tcp.TCPMessenger(
                "a", {"a": ("127.0.0.1", 1)})._native is None
        finally:
            cfg.set_val(name, True)
    assert tcp.TCPMessenger("a", {"a": ("127.0.0.1", 1)})._native is NATIVE


def test_failed_build_raises(monkeypatch, tmp_path):
    # a compiler that fails: the build raises, with its command
    false = tmp_path / "cxx-that-fails"
    false.write_text("#!/bin/sh\necho no >&2\nexit 1\n")
    false.chmod(0o755)
    monkeypatch.setenv("CXX", str(false))
    with pytest.raises(RuntimeError, match="cxx-that-fails"):
        native_build.wire_ext()
    # with both gates on, the loader raises too (no Python fallback),
    # and so does a messenger; the failure is in status()
    monkeypatch.setattr(wire_codec, "_module", None)
    with pytest.raises(RuntimeError):
        wire_codec.native()
    with pytest.raises(RuntimeError):
        tcp.TCPMessenger("a", {"a": ("127.0.0.1", 1)})
    st = wire_codec.status()
    assert st["enabled"] is False and "cxx-that-fails" in st["load_error"]
    # a gate turned off by name runs the Python codec
    cfg = get_config()
    cfg.set_val("osd_wire_codec_native", False)
    try:
        assert tcp.TCPMessenger("a", {"a": ("127.0.0.1", 1)})._native is None
    finally:
        cfg.set_val("osd_wire_codec_native", True)
    monkeypatch.delenv("CXX")
    assert wire_codec.native() is not None  # the build dir's copy


# -- a port messenger and a JAX package messenger on one socket ---------------

@pytest.mark.parametrize("jax_native", [False, True],
                         ids=["jax-python-codec", "jax-native-codec"])
def test_port_native_and_jax_messenger_share_a_socket(jax_native):
    if jax_native and _jax_native() is None:
        pytest.skip("the JAX package's own C codec does not load here")
    msgs, j_msgs = corpus(PORT_T, 21, 24), corpus(JAX_T, 21, 24)
    pa, pb = _free_ports(2)
    addr = {"osd.0": ("127.0.0.1", pa), "osd.1": ("127.0.0.1", pb)}
    j_cfg = j_get_config()
    prior = j_cfg.get_val("osd_wire_codec_native")
    j_cfg.set_val("osd_wire_codec_native", jax_native)

    async def main():
        from ceph_tpu.msg.fault import FaultInjector as JFaultInjector

        a = tcp.TCPMessenger("osd.0", addr, fault=FaultInjector())
        b = j_tcp.TCPMessenger("osd.1", addr, fault=JFaultInjector())
        assert a._native is NATIVE
        assert (b._native is not None) == jax_native
        await a.start()
        await b.start()
        at_a, at_b = [], []

        async def sink_a(src, msg):
            at_a.append(msg)

        async def sink_b(src, msg):
            at_b.append(msg)

        a.register("osd.0", sink_a)
        b.register("osd.1", sink_b)
        try:
            for msg in msgs:
                await a.send_message("osd.0", "osd.1", msg)
            for msg in j_msgs:
                await b.send_message("osd.1", "osd.0", msg)
            for _ in range(300):
                if len(at_a) >= len(msgs) and len(at_b) >= len(msgs):
                    break
                await asyncio.sleep(0.01)
            return list(at_a), list(at_b)
        finally:
            await a.shutdown()
            await b.shutdown()

    saved = asyncio.get_event_loop_policy()
    asyncio.set_event_loop_policy(verifying_policy())
    try:
        at_a, at_b = _run(main())
    finally:
        asyncio.set_event_loop_policy(saved)
        j_cfg.set_val("osd_wire_codec_native", prior)
    # each side receives the other's corpus as its own codec decodes it
    assert [_plain(x) for x in at_b] == \
        [_plain(j_wire.decode_message(j_wire.encode_message(x)))
         for x in j_msgs]
    assert [_plain(x) for x in at_a] == \
        [_plain(wire.decode_message(wire.encode_message(x))) for x in msgs]
    assert [_plain(x) for x in at_a] == [_plain(x) for x in at_b]

