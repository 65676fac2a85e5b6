#!/usr/bin/env python3
"""Seeded structured fuzzer for the native wire codec boundary.

Port of the JAX package's ``tools/wire_fuzz.py``: it holds the port's C
codec (``ceph_tpu_torch/native/wire_native.c``) against the port's Python
codec (``ceph_tpu_torch/msg/wire.py``).  The contract is byte-level: the
two must agree on EVERY input, not just the happy path the interop tests
enumerate.  This tool drives that as a differential property over a
seeded corpus:

* **encode**: for every corpus message the two encoders produce
  byte-identical bodies (or the C side raises FallbackError and the
  Python bytes must still decode identically through BOTH decoders --
  the mixed-codec fallback path, where a wide-varint truncation bug
  once lived);
* **decode**: python-decode and native-decode of the same bytes are
  equal, both directions;
* **mutations**: truncated tails (every cut inside the trailing
  compat-tail window, plus random cuts) and byte flips -- the two
  decoders must agree on the OUTCOME: both error, or both succeed
  with equal values;
* **minimizer**: a failing input is shrunk (ddmin-style window
  deletion) before reporting, so the repro in CI output is small;
* **leak gate** (``--leak-passes N``): N identical passes over the
  corpus through the native module; after a warm-up pass the gc object
  count and process RSS must stay flat;
* **ring-framing mutants** (``--ring-cases N``): byte corruption of the
  shm frame ring's layout (msg/shm_ring.py) -- header words (head/
  tail/wseq seqlock) and data-region record bytes.  The consumer-side
  property: ``pop()`` returns the EXACT bytes of a pushed record or
  raises ``RingTear``; it must never crash with anything else and never
  hand back bytes that were not pushed (silent corruption).

``--san`` loads the ASan/UBSan-instrumented twin (``native/build.py``:
``wire_ext(san=True)``); the interpreter itself is uninstrumented, so run
python with libasan preloaded::

    ASAN_OPTIONS=detect_leaks=0 LD_PRELOAD=$(g++ -print-file-name=libasan.so) \
        python -m ceph_tpu_torch.tools.wire_fuzz --san --cases 200

Exit 0 iff every case agrees and the leak gate (when armed) is flat;
the JSON report goes to stdout.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import random
import sys
from typing import Callable, Dict, List, Optional, Tuple

#: first int past the C emitter's u64 fast path: encodes only via the
#: Python fallback, decodes through the wide band both codecs must share
WIDE_INT = (1 << 64) + 3


def load_native(san: bool = False):
    """The codec extension: the production module, or (``san=True``)
    the sanitizer-instrumented twin artifact under the same module
    name (PyInit__wire_native resolves by module name, not filename).
    Raises where the codec is gated off or cannot be built."""
    from ceph_tpu_torch.msg import wire  # noqa: F401  registers the types
    from ceph_tpu_torch.native import build as native_build
    from ceph_tpu_torch.native import wire_codec

    if not san:
        mod = wire_codec.native()
        if mod is None:
            raise RuntimeError(
                f"native codec gated off: {wire_codec.status()}")
        return mod
    mod = wire_codec.load_module(native_build.wire_ext(san=True))
    mod.register(**wire_codec._types)
    return mod


# -- corpus -------------------------------------------------------------------

def _rand_value(rng: random.Random, depth: int = 0):
    kinds = ["int", "negint", "wideint", "str", "bytes", "none", "bool",
             "float"]
    if depth < 3:
        kinds += ["list", "tuple", "dict"]
    kind = rng.choice(kinds)
    if kind == "int":
        return rng.randrange(1 << rng.randrange(1, 63))
    if kind == "negint":
        return -rng.randrange(1, 1 << 40)
    if kind == "wideint":
        # the 64..70-bit fallback band, both signs
        v = rng.randrange(1 << 64, 1 << 70)
        return v if rng.random() < 0.5 else -v
    if kind == "str":
        return "".join(rng.choice("abcé中 xyz")
                       for _ in range(rng.randrange(8)))
    if kind == "bytes":
        return bytes(rng.randrange(256) for _ in range(rng.randrange(32)))
    if kind == "none":
        return None
    if kind == "bool":
        return rng.random() < 0.5
    if kind == "float":
        return rng.random() * 1e6 - 5e5
    if kind == "list":
        return [_rand_value(rng, depth + 1) for _ in range(rng.randrange(4))]
    if kind == "tuple":
        return tuple(_rand_value(rng, depth + 1)
                     for _ in range(rng.randrange(4)))
    return {f"k{i}": _rand_value(rng, depth + 1)
            for i in range(rng.randrange(4))}


def _rand_sub_write(rng: random.Random):
    from ceph_tpu_torch.osd.types import ECSubWrite, LogEntry, Transaction, TxnOp

    txn = Transaction()
    for _ in range(rng.randrange(3)):
        txn.write(f"o{rng.randrange(4)}@1", rng.randrange(1 << 20),
                  bytes(rng.randrange(256)
                        for _ in range(rng.randrange(2000))))
    txn.ops.append(TxnOp("setattr", oid="o@1", attr_name="hinfo",
                         attr_value=_rand_value(rng)))
    return ECSubWrite(
        rng.randrange(8), rng.randrange(1 << 30), f"o{rng.randrange(4)}@1",
        txn, (rng.randrange(100), f"osd.{rng.randrange(8)}"),
        [LogEntry(rng.randrange(100), "o@1",
                  rng.choice(["append", "touch", "delete"]),
                  rng.randrange(1 << 16))
         for _ in range(rng.randrange(3))],
        op_class=rng.choice(["client", "recovery"]),
        rollback=rng.random() < 0.2,
        prev_version=rng.choice([None, (3, "osd.1")]),
        reqid=rng.choice([None, ("c", 12, rng.randrange(1 << 40))]),
        trace=rng.choice([None, [rng.randrange(1 << 30), 4, 1]]),
        qos_class=rng.choice([None, "gold", "bulk"]),
    )


def typed_seeds(rng: random.Random) -> Dict[str, object]:
    """One deterministic instance of EVERY typed message kind the C
    value model dispatches -- the fuzz corpus's guaranteed floor
    (tests/test_torch_wire_fuzz.py pins this map against the C
    decoder's kind dispatch)."""
    from ceph_tpu_torch.mgr.report import MgrBeacon, MgrReport
    from ceph_tpu_torch.osd.types import ECSubRead, ECSubReadReply, ECSubWriteReply

    return {
        "MSG_EC_SUB_WRITE": _rand_sub_write(rng),
        "MSG_EC_SUB_WRITE_REPLY": ECSubWriteReply(
            1, 9, committed=True, applied=False,
            current_version=(5, "osd.0"), missed=False),
        "MSG_EC_SUB_READ": ECSubRead(
            2, 11, to_read={"o1": [(0, 512)]}, attrs_to_read=["hinfo"],
            subchunks={"o1": [(0, 1)]}, trace=(9, 2, 0), qos_class="gold"),
        "MSG_EC_SUB_READ_REPLY": ECSubReadReply(
            3, 13, buffers_read={"o0": [(0, bytes(range(64)))]},
            attrs_read={"o0": {"hinfo": [1, 2, 3]}}, errors={"o1": "EIO"}),
        "MSG_MGR_BEACON": MgrBeacon("mon.0", 44, lag_ms=0.5),
        "MSG_MGR_REPORT": MgrReport(
            "osd.3", 45, 2.5, {"pgs": {"1": [1, 2]}, "perf": {"x": 7}},
            lag_ms=None),
        "MSG_VALUE": {"op": "client_op", "tid": 5, "data": b"z" * 256,
                      "reqid": ["c", 1, 2], "snapc": None},
    }


def typed_fallback_cases(rng: random.Random) -> Dict[str, object]:
    """Per typed kind, a message the C ENCODER must refuse with
    FallbackError (a 64..70-bit int in a value-typed field) while the
    Python encoder emits it and BOTH decoders read it back equal --
    the forced-fallback roundtrip."""
    from ceph_tpu_torch.mgr.report import MgrBeacon, MgrReport
    from ceph_tpu_torch.osd.types import ECSubRead, ECSubReadReply, ECSubWriteReply

    sw = _rand_sub_write(rng)
    sw.reqid = ("c", 1, WIDE_INT)
    return {
        "MSG_EC_SUB_WRITE": sw,
        "MSG_EC_SUB_WRITE_REPLY": ECSubWriteReply(
            1, 9, committed=True, applied=True,
            current_version=(WIDE_INT, "osd.0"), missed=False),
        "MSG_EC_SUB_READ": ECSubRead(
            2, 11, to_read={"o1": [(0, 512)]},
            trace=[WIDE_INT, 1, 0]),
        "MSG_EC_SUB_READ_REPLY": ECSubReadReply(
            3, 13, buffers_read={}, attrs_read={"o0": {"w": WIDE_INT}},
            errors={}),
        "MSG_MGR_BEACON": MgrBeacon("mon.0", 44, lag_ms=WIDE_INT),
        "MSG_MGR_REPORT": MgrReport("osd.3", 45, 2.5,
                                    {"wide": WIDE_INT}, lag_ms=None),
        "MSG_VALUE": {"wide": WIDE_INT},
    }


def corpus(seed: int = 11, n: int = 600) -> List[object]:
    """Deterministic corpus: the typed floor (plain + forced-fallback
    variants of every kind) then a random mix up to ``n``."""
    from ceph_tpu_torch.mgr.report import MgrBeacon, MgrReport
    from ceph_tpu_torch.osd.types import ECSubRead, ECSubReadReply, ECSubWriteReply

    rng = random.Random(seed)
    out: List[object] = list(typed_seeds(rng).values())
    out.extend(typed_fallback_cases(rng).values())
    while len(out) < n:
        roll = rng.random()
        if roll < 0.25:
            out.append(_rand_sub_write(rng))
        elif roll < 0.35:
            out.append(ECSubWriteReply(
                rng.randrange(8), rng.randrange(1 << 30),
                committed=rng.random() < 0.5, applied=rng.random() < 0.5,
                current_version=rng.choice(
                    [None, (5, "osd.0"), [7, "osd.2"]]),
                missed=rng.random() < 0.2))
        elif roll < 0.45:
            out.append(ECSubRead(
                rng.randrange(8), rng.randrange(1 << 30),
                to_read={f"o{i}": [(rng.randrange(1 << 12), 512)]
                         for i in range(rng.randrange(3))},
                attrs_to_read=["hinfo"] if rng.random() < 0.5 else [],
                subchunks={"o0": [(0, 1)]} if rng.random() < 0.3 else {},
                trace=rng.choice([None, (9, 2, 0)]),
                qos_class=rng.choice([None, "gold"])))
        elif roll < 0.55:
            out.append(ECSubReadReply(
                rng.randrange(8), rng.randrange(1 << 30),
                buffers_read={"o0": [(0, bytes(rng.randrange(256)
                                               for _ in range(1024)))]},
                attrs_read={"o0": {"hinfo": _rand_value(rng)}},
                errors={} if rng.random() < 0.7 else {"o1": "KeyError"}))
        elif roll < 0.65:
            out.append(MgrReport(
                f"osd.{rng.randrange(8)}", rng.randrange(1 << 20),
                rng.random() * 5,
                {"pgs": {"1": [1, 2]}, "perf": {"x": rng.randrange(99)}},
                lag_ms=rng.choice([None, rng.random() * 10])))
        elif roll < 0.72:
            out.append(MgrBeacon(f"mon.{rng.randrange(3)}",
                                 rng.randrange(1 << 20),
                                 lag_ms=rng.choice([None, 0.5])))
        else:
            out.append(_rand_value(rng))
    return out


# -- differential check -------------------------------------------------------

def _norm(v: object) -> str:
    """Comparison key for decoded values: repr is deterministic for the
    whole value model (dict order follows wire order on both sides) and
    maps NaN/-0.0 to stable spellings -- mutated buffers can decode to
    floats plain ``==`` mishandles."""
    return repr(v)


def _outcome(decode: Callable[[bytes], object],
             data: bytes) -> Tuple[str, Optional[str]]:
    try:
        return ("ok", _norm(decode(data)))
    except Exception:
        return ("err", None)


def minimize(data: bytes,
             failing: Callable[[bytes], bool],
             budget: int = 400) -> bytes:
    """ddmin-lite: delete windows (halving sizes) while the predicate
    still fails; bounded by ``budget`` predicate calls."""
    cur = data
    size = max(1, len(cur) // 2)
    calls = 0
    while size >= 1 and calls < budget:
        i = 0
        shrunk = False
        while i < len(cur) and calls < budget:
            cand = cur[:i] + cur[i + size:]
            calls += 1
            if cand != cur and failing(cand):
                cur = cand
                shrunk = True
            else:
                i += size
        if not shrunk:
            size //= 2
    return cur


class Divergence(Exception):
    def __init__(self, stage: str, detail: str, body: Optional[bytes]):
        super().__init__(f"{stage}: {detail}")
        self.stage = stage
        self.detail = detail
        self.body = body


def _check_message(wire, nat, msg: object,
                   rng: random.Random,
                   mutations: int) -> Tuple[int, bool]:
    """One corpus case: encode equivalence, cross-decode equality,
    mutation-outcome agreement.  Returns (mutants_run, fell_back)."""
    py = wire.encode_message(msg)
    fell_back = False
    try:
        na = nat.encode_body(msg)
    except nat.FallbackError:
        na = None
        fell_back = True
    if na is not None and py != na:
        raise Divergence(
            "encode", f"byte mismatch for {type(msg).__name__}", py)
    o_py = _outcome(wire.decode_message, py)
    o_na = _outcome(nat.decode_body, py)
    if o_py != o_na:
        raise Divergence(
            "decode", f"cross-decode disagrees for {type(msg).__name__} "
            f"(py={o_py[0]}, native={o_na[0]})", py)
    n_mut = 0
    for _ in range(mutations):
        if len(py) < 2:
            break
        if rng.random() < 0.6:
            # truncated tail: the compat-tail window is the interesting
            # region -- cut inside the trailing quarter mostly
            if rng.random() < 0.7:
                cut = rng.randrange(max(1, len(py) * 3 // 4), len(py))
            else:
                cut = rng.randrange(1, len(py))
            mut = py[:cut]
        else:
            i = rng.randrange(len(py))
            mut = py[:i] + bytes([py[i] ^ (1 << rng.randrange(8))]) + \
                py[i + 1:]
        n_mut += 1
        mo_py = _outcome(wire.decode_message, mut)
        mo_na = _outcome(nat.decode_body, mut)
        if mo_py != mo_na:
            raise Divergence(
                "mutation", f"decoders disagree on mutant of "
                f"{type(msg).__name__} (py={mo_py[0]}, native={mo_na[0]})",
                mut)
    return n_mut, fell_back


# -- ring-framing mutants -----------------------------------------------------

def ring_fuzz(cases: int = 200, seed: int = 11, flips: int = 4) -> dict:
    """Mutation fuzz over the shm frame ring's byte layout.

    Each case walks a ring through interleaved pushes/pops (so records
    wrap the data region at arbitrary offsets), verifies clean FIFO
    fidelity, then flips bits across the raw buffer -- the
    ``[u64 head][u64 tail][u64 wseq]`` header words and the record
    region alike -- and drains.  Every post-corruption ``pop()`` must
    return the exact bytes of some record that was pushed, or raise
    :class:`RingTear`; any other exception (a wild length driving an
    allocation, a struct error) or any byte string that was never
    pushed is a divergence."""
    from collections import Counter

    from ceph_tpu_torch.msg.shm_ring import (_HDR_BYTES, RingTear, ShmRing)

    rng = random.Random(seed ^ 0x51A6)
    report: dict = {"cases": 0, "flips": 0, "pops_clean": 0,
                    "pops_after_flip": 0, "tears": 0, "divergences": []}
    for case in range(cases):
        cap = 1 << rng.choice([10, 12, 14])
        ring = ShmRing(cap)
        fifo: List[bytes] = []
        clean = True
        # interleaved pushes/pops advance head/tail so the flips below
        # land on wrapped records, consumed space and live space alike
        for _ in range(rng.randrange(1, 40)):
            p = rng.randbytes(rng.randrange(0, cap // 4))
            if ring.try_push(p):
                fifo.append(p)
            if fifo and rng.random() < 0.5:
                if ring.pop() != fifo.pop(0):
                    report["divergences"].append({
                        "case": case, "stage": "clean",
                        "detail": "fifo fidelity broken without mutation"})
                    clean = False
                    break
                report["pops_clean"] += 1
        if not clean:
            report["cases"] += 1
            continue
        for _ in range(flips):
            if rng.random() < 0.4:
                i = rng.randrange(_HDR_BYTES)  # head/tail/wseq words
            else:
                i = _HDR_BYTES + rng.randrange(ring.capacity)
            ring._buf[i] ^= 1 << rng.randrange(8)
            report["flips"] += 1
        remaining = Counter(fifo)
        for _ in range(len(fifo) + 8):  # bounded drain
            try:
                got = ring.pop()
            except RingTear:
                report["tears"] += 1
                break
            except Exception as e:  # noqa: BLE001 -- the property under
                # test: corruption may only surface as RingTear
                report["divergences"].append({
                    "case": case, "stage": "mutated",
                    "detail": f"pop raised {type(e).__name__}: {e}"})
                break
            if got is None:
                break
            if remaining[got] <= 0:
                report["divergences"].append({
                    "case": case, "stage": "mutated",
                    "detail": f"pop returned {len(got)}B never pushed"})
                break
            remaining[got] -= 1
            report["pops_after_flip"] += 1
        report["cases"] += 1
    report["ok"] = not report["divergences"]
    return report


# -- leak gate ----------------------------------------------------------------

def _rss_kb() -> int:
    with open("/proc/self/statm") as fh:
        pages = int(fh.read().split()[1])
    return pages * (os.sysconf("SC_PAGESIZE") // 1024)


def leak_gate(wire, nat, msgs: List[object], passes: int,
              max_obj_growth: int = 64,
              max_rss_growth_kb: int = 16 * 1024) -> dict:
    """N identical passes through the native module (encode, decode,
    truncated decodes); after the warm-up pass the gc object count and
    RSS must stay flat.  The sanitizer quarantine makes RSS sticky, so
    --san runs pair this with ASAN_OPTIONS=quarantine_size_mb."""
    bodies = [wire.encode_message(m) for m in msgs]
    samples: List[Tuple[int, int]] = []
    for _ in range(passes):
        for m in msgs:
            try:
                nat.encode_body(m)
            except nat.FallbackError:
                pass
        for b in bodies:
            for data in (b, b[:len(b) * 3 // 4], b[:3]):
                try:
                    nat.decode_body(data)
                except Exception:
                    pass
        gc.collect()
        samples.append((len(gc.get_objects()), _rss_kb()))
    obj_growth = samples[-1][0] - samples[1][0]
    rss_growth = samples[-1][1] - samples[1][1]
    return {
        "passes": passes,
        "gc_objects": [s[0] for s in samples],
        "rss_kb": [s[1] for s in samples],
        "gc_object_growth": obj_growth,
        "rss_growth_kb": rss_growth,
        "flat": obj_growth <= max_obj_growth
        and rss_growth <= max_rss_growth_kb,
    }


# -- the run ------------------------------------------------------------------

def run_fuzz(cases: int = 600, seed: int = 11, san: bool = False,
             mutations: int = 4, leak_passes: int = 0,
             ring_cases: int = 200) -> dict:
    from ceph_tpu_torch.msg import wire

    nat = load_native(san=san)
    rng = random.Random(seed ^ 0x5EED)
    msgs = corpus(seed=seed, n=cases)
    report: dict = {
        "cases": len(msgs), "mutants": 0, "fallbacks": 0,
        "sanitized": san, "divergences": [],
    }
    for msg in msgs:
        try:
            n_mut, fell_back = _check_message(wire, nat, msg, rng, mutations)
        except Divergence as d:
            body = d.body or b""
            if d.stage == "mutation":
                def _fails(data: bytes) -> bool:
                    return _outcome(wire.decode_message, data) != \
                        _outcome(nat.decode_body, data)

                body = minimize(body, _fails)
            report["divergences"].append({
                "stage": d.stage, "detail": d.detail,
                "repro_hex": body.hex(),
            })
            continue
        report["mutants"] += n_mut
        report["fallbacks"] += int(fell_back)
    if leak_passes:
        report["leak_gate"] = leak_gate(
            wire, nat, msgs[:40], passes=leak_passes)
    if ring_cases:
        report["ring"] = ring_fuzz(cases=ring_cases, seed=seed)
    report["ok"] = (not report["divergences"]
                    and (not leak_passes or report["leak_gate"]["flat"])
                    and (not ring_cases or report["ring"]["ok"]))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", type=int, default=600,
                    help="corpus size (default 600)")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--san", action="store_true",
                    help="load the ASan/UBSan-instrumented artifact")
    ap.add_argument("--mutations", type=int, default=4,
                    help="mutants per corpus case (default 4)")
    ap.add_argument("--leak-passes", type=int, default=0,
                    help="arm the repeated-pass leak gate")
    ap.add_argument("--ring-cases", type=int, default=200,
                    help="shm-ring framing mutant cases (0 disables)")
    args = ap.parse_args(argv)
    report = run_fuzz(cases=args.cases, seed=args.seed, san=args.san,
                      mutations=args.mutations,
                      leak_passes=args.leak_passes,
                      ring_cases=args.ring_cases)
    json.dump(report, sys.stdout, indent=2)
    print(file=sys.stdout)
    status = "ok" if report["ok"] else "FAILED"
    ring = report.get("ring")
    print(f"wire_fuzz: {status} -- {report['cases']} cases, "
          f"{report['mutants']} mutants, {report['fallbacks']} fallbacks, "
          f"{len(report['divergences'])} divergences"
          + (", leak gate "
             + ("flat" if report.get("leak_gate", {}).get("flat")
                else "NOT FLAT") if args.leak_passes else "")
          + (f", ring {ring['cases']} cases/{ring['flips']} flips/"
             f"{ring['tears']} tears "
             + ("ok" if ring["ok"] else "DIVERGED") if ring else ""),
          file=sys.stderr)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
