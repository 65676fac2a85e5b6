"""Tier-path benchmark: hot device-resident read vs the cold decode path.

Port of ``ceph_tpu/tier/tier_bench.py``.  The comparison the tier exists for, at the host surface and with no
relay dependency:

* **hot**: the object's shard-major block is tier-resident (on the
  codec's device: the card for the ``cuda`` plugin); a read is one D2H of
  the data rows (``residency.device_get``) + the logical transpose
  (``ECBackend._tier_read``'s exact recipe).
* **cold**: the pre-tier miss path -- per-shard ``np.frombuffer``
  ingest of the stored shard bytes (what the messenger reply hands the
  primary), survivors selected with ``erasures`` data shards withheld,
  codec reconstruction, logical reassembly
  (``ecutil.decode_concat``).

Bit-exactness is gated BEFORE timing: both paths must round-trip every
payload byte-identically or the stage raises.  Promotion itself is also
exercised batched (``put_many``: one concatenated device transfer for
the whole object set).  Used by ``ceph_tpu_torch/tools/ec_benchmark.py
--workload tier-path``, ``chip_smoke.py`` and the CPU smoke test in
tests/test_torch_tier.py.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from ceph_tpu_torch.analysis import residency
from ceph_tpu_torch.device import codec_device
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.tier.device_tier import (DeviceByteAccount, DeviceTierStore,
                                       reassemble_data_rows)


def run_tier_path_bench(ec, *, n_objects: int = 64,
                        obj_bytes: int = 1 << 16, iters: int = 2,
                        erasures: int = 2, seed: int = 1234) -> dict:
    """Returns the JSON-ready comparison dict; raises on any byte
    mismatch between the two paths.  The tier lives on the codec's
    device."""
    k = ec.get_data_chunk_count()
    km = ec.get_chunk_count()
    m = km - k
    sinfo = ecutil.StripeInfo(k, k * ec.get_chunk_size(1))
    erased = list(range(min(m, erasures)))
    rng = np.random.RandomState(seed)
    payloads: List[bytes] = [
        rng.randint(0, 256, size=obj_bytes, dtype=np.uint8).tobytes()
        for _ in range(n_objects)
    ]

    # -- commit every object: shard store (cold source) + tier items ------
    store: Dict[str, bytes] = {}
    items = []
    for idx, data in enumerate(payloads):
        padded = sinfo.logical_to_next_stripe_offset(len(data))
        buf = np.zeros(padded, dtype=np.uint8)
        buf[: len(data)] = np.frombuffer(data, dtype=np.uint8)
        enc = ecutil.encode(sinfo, ec, buf, range(km))
        for s in range(km):
            store[f"obj{idx}@{s}"] = enc[s].tobytes()
        block = np.stack([np.asarray(enc[s], np.uint8) for s in range(km)])
        items.append(("bench", f"obj{idx}", block, (1, "bench"),
                      len(data)))

    # private ledger: the bench must not charge the process budget the
    # real OSD tiers share (and must never be evicted mid-timing)
    tier = DeviceTierStore(account=DeviceByteAccount(), budget=1 << 62,
                           device=codec_device(ec))
    try:
        promoted = tier.put_many(items)
        if promoted != n_objects:
            raise AssertionError(
                f"tier-path: promoted {promoted}/{n_objects}")

        chunk_size = sinfo.chunk_size
        pos = ecutil.data_positions(ec)

        def hot_read(idx: int) -> bytes:
            ent = tier.lookup("bench", f"obj{idx}")
            if pos == list(range(k)):
                rows = residency.device_get(ent.block[:k])
            else:
                host = residency.device_get(ent.block)
                rows = np.stack([host[p] for p in pos])
            return reassemble_data_rows(rows, chunk_size)[:ent.logical_size]

        def cold_read(idx: int) -> bytes:
            chunks = {
                s: np.frombuffer(store[f"obj{idx}@{s}"], dtype=np.uint8)
                for s in range(km) if s not in erased
            }
            data = ecutil.decode_concat(sinfo, ec, chunks)
            return bytes(data[: len(payloads[idx])])

        # -- bit-exactness gate (untimed) ---------------------------------
        for idx, payload in enumerate(payloads):
            if hot_read(idx) != payload:
                raise AssertionError(f"tier-path: hot read of obj{idx} "
                                     "mismatched the payload")
            if cold_read(idx) != payload:
                raise AssertionError(f"tier-path: cold decode of obj{idx} "
                                     "mismatched the payload")

        nbytes = sum(len(p) for p in payloads)

        def timed(fn) -> float:
            fn(0)  # warm (device slice materialization / decode tables)
            best = None
            for _ in range(max(1, iters)):
                t0 = time.perf_counter()
                for idx in range(n_objects):
                    fn(idx)
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
            return nbytes / best / (1 << 30)

        hot = timed(hot_read)
        cold = timed(cold_read)

        return {
            "n_objects": n_objects,
            "obj_bytes": obj_bytes,
            "k": k,
            "m": m,
            "erasures": len(erased),
            "bit_exact": True,  # the gate raised otherwise
            "resident_bytes": tier.resident_bytes,
            "tier_hits": tier.hits,
            "hot_read_GiBs": hot,
            "cold_read_GiBs": cold,
            "read_speedup": round(hot / cold, 3) if cold else None,
        }
    finally:
        tier.clear()
