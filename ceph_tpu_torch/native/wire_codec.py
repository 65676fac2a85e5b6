"""Loader for the batched native wire codec (``_wire_native``).

Port of ``ceph_tpu/native/wire_codec.py``.  The extension
(``native/wire_native.c``) moves the wire's host cost -- typed body
encode/decode, envelope parse, frame seal, burst scan -- into C; this
module owns the contract around it:

* **gates**: the ``native`` option (``CEPH_TPU_TORCH_NATIVE=0``, the
  master switch of the native extensions) or ``osd_wire_codec_native=
  false`` run the Python codec in ``msg/wire.py``.  Both are re-read on
  every :func:`native` call, so a runtime ``config set`` takes effect for
  messengers created after it.  Wire bytes are identical either way.
* **no silent fallback**: with both gates on, a missing compiler, a
  failed build or a failed load raises (the JAX package logs a warning
  and runs the Python codec).  Only a gate turned off by name runs the
  Python codec.  The C encoder's per-value ``FallbackError`` stays: the
  Python codec re-encodes that one message into the same bytes.
* **type registration**: the codec constructs the same dataclasses the
  Python codec does; ``msg/wire.py`` hands them over at import time
  (:func:`initialize`), keeping this module import-cycle-free.

The extension builds at first use (``native/build.py``: ``wire_ext``) into
``ceph_tpu_torch/build/wire_native-<digest>/``.  Its state is exported as
the ``ceph_wire_codec_native`` gauge (mgr ``/metrics``) and by
:func:`status`.
"""

from __future__ import annotations

import importlib.util
from typing import Optional

from ceph_tpu_torch.native import build as native_build

_module = None            #: the loaded extension (None until first use)
_load_error: Optional[str] = None
_types = None             #: kwargs for _wire_native.register()


def initialize(**types) -> None:
    """Hand over the message dataclasses (called by ``msg/wire.py`` at
    import time).  Registration happens at the first load, or now if the
    extension is already loaded."""
    global _types
    _types = types
    if _module is not None:
        _module.register(**_types)


def _config_enabled() -> bool:
    """Both gates, re-read each call: the ``native`` master switch and
    the codec's own option."""
    from ceph_tpu_torch.utils.config import get_config

    cfg = get_config()
    return bool(cfg.get_val("native")) and \
        bool(cfg.get_val("osd_wire_codec_native"))


def load_module(so):
    """Import the extension at ``so`` under the module name
    ``_wire_native`` (the sanitizer twin's file name differs; its init
    function does not)."""
    spec = importlib.util.spec_from_file_location("_wire_native", str(so))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load():
    """Build (if needed) and import the extension; a failure raises (and
    is kept for :func:`status`), the next call tries again."""
    global _module, _load_error
    if _module is not None:
        return _module
    try:
        mod = load_module(native_build.wire_ext())
    except Exception as e:
        _load_error = f"{type(e).__name__}: {e}"
        raise
    if _types is not None:
        mod.register(**_types)
    _load_error = None
    _module = mod
    return _module


def native():
    """The extension module, or None when a gate is off.  Raises where
    both gates are on and the extension cannot be built or loaded.  Each
    messenger calls this once at construction; config changes apply to
    messengers created after them."""
    if not _config_enabled():
        return None
    return _load()


def enabled() -> bool:
    """Whether the native codec serves new messengers (the gauge value)."""
    return native() is not None


def status() -> dict:
    """Loader state for the observability surface."""
    gated_off = not _config_enabled()
    active = False
    if not gated_off:
        try:
            active = _load() is not None
        except Exception:  # noqa: BLE001 -- reported as load_error
            active = False
    return {
        "enabled": active,
        "gated_off": gated_off,
        "load_error": _load_error,
    }


def main(argv=None) -> int:
    """``python -m ceph_tpu_torch.native.wire_codec --smoke``: builds the
    extension, then runs the interop round trip: native and Python codecs
    must produce byte-identical bodies and equal decodes for a typed
    corpus, and a frame must survive a real-TCP hop between a native
    sender and a Python-codec receiver (and back)."""
    import argparse
    import asyncio
    import sys

    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.parse_args(argv)
    # under ``python -m`` this file runs as __main__: go through the
    # canonical module so we see the instance msg/wire.py registered
    # the message types with
    from ceph_tpu_torch.native import wire_codec as _wc
    from ceph_tpu_torch.msg import wire  # registers the types

    nat = _wc.native()
    if nat is None:
        print(f"native wire codec gated off: {_wc.status()}",
              file=sys.stderr)
        return 1
    from ceph_tpu_torch.osd.types import (ECSubRead, ECSubWrite, LogEntry,
                                          Transaction)

    txn = Transaction().write("o@1", 0, b"x" * 9000)
    txn.setattr("o@1", "hinfo", {"crc": [1, 2], "sz": 4096})
    corpus = [
        ECSubWrite(1, 7, "o@1", txn, (3, "osd.1"),
                   [LogEntry(3, "o@1", "append", 16)],
                   reqid=("c", 12, 34), qos_class="gold"),
        ECSubRead(0, 9, to_read={"a": [(0, 512)]}),
        {"op": "client_op", "tid": 5, "data": b"z" * 16384,
         "reqid": ["c", 1, 2], "snapc": None},
        ("committed", 17), "heartbeat",
    ]
    for msg in corpus:
        py = wire.encode_message(msg)
        na = nat.encode_body(msg)
        assert py == na, f"encode mismatch for {type(msg).__name__}"
        assert wire.decode_message(na) == nat.decode_body(py), \
            f"decode mismatch for {type(msg).__name__}"

    async def tcp_roundtrip():
        from ceph_tpu_torch.msg.cluster_bench import free_ports
        from ceph_tpu_torch.msg.tcp import TCPMessenger

        ports = free_ports(2)
        addr = {"a": ("127.0.0.1", ports[0]),
                "b": ("127.0.0.1", ports[1])}
        a, b = TCPMessenger("a", addr), TCPMessenger("b", addr)
        b._native = None  # a Python-codec receiver
        await a.start()
        await b.start()
        got = []
        b.register("b", lambda src, msg: got.append(msg) or asyncio.sleep(0))
        a.register("a", lambda src, msg: got.append(msg) or asyncio.sleep(0))
        try:
            for msg in corpus:
                await a.send_message("a", "b", msg)   # native -> python
            for msg in corpus:
                await b.send_message("b", "a", msg)   # python -> native
            for _ in range(200):
                if len(got) == 2 * len(corpus):
                    break
                await asyncio.sleep(0.01)
            assert got[:len(corpus)] == corpus, "native->python hop"
            assert got[len(corpus):] == corpus, "python->native hop"
        finally:
            await a.shutdown()
            await b.shutdown()

    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(tcp_roundtrip())
    finally:
        loop.close()
    print("native wire codec smoke: interop round-trip ok",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
