"""Stripe math + codec dispatch + per-shard hash info (ECUtil equivalent).

Port of ``ceph_tpu/osd/ecutil.py``; reference: src/osd/ECUtil.{h,cc}.

* ``StripeInfo`` -- the logical<->chunk offset algebra (ECUtil.h:26-79).
* ``encode``/``decode`` -- where the reference loops the codec one
  stripe_width at a time (ECUtil.cc:136-148), we hand the codec ALL stripes
  in one call: the chunk arrays are contiguous per shard, and every engine
  (numpy, the CUDA kernels of the ``cuda`` plugin) treats the byte axis as
  the product's lane axis, so the whole object is one device dispatch.
* ``HashInfo`` -- per-shard cumulative crc32c + total size, persisted as a
  shard xattr and checked on every shard read (ECUtil.h:100-158,
  ECUtil.cc:161-235; read-side check ECBackend.cc:1054-1076).  The crc is
  the port's C build (``native/gf_native.py``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ceph_tpu_torch.native.gf_native import crc32c, crc32c_rows
from ceph_tpu_torch.ops import bucketing


class StripeInfo:
    """stripe_info_t: stripe_size = k data chunks per stripe."""

    def __init__(self, stripe_size: int, stripe_width: int):
        assert stripe_width % stripe_size == 0
        self.stripe_width = stripe_width
        self.chunk_size = stripe_width // stripe_size

    def logical_offset_is_stripe_aligned(self, logical: int) -> bool:
        return logical % self.stripe_width == 0

    def logical_to_prev_chunk_offset(self, offset: int) -> int:
        return (offset // self.stripe_width) * self.chunk_size

    def logical_to_next_chunk_offset(self, offset: int) -> int:
        return (
            (offset + self.stripe_width - 1) // self.stripe_width
        ) * self.chunk_size

    def logical_to_prev_stripe_offset(self, offset: int) -> int:
        return offset - (offset % self.stripe_width)

    def logical_to_next_stripe_offset(self, offset: int) -> int:
        rem = offset % self.stripe_width
        return offset - rem + self.stripe_width if rem else offset

    def aligned_logical_offset_to_chunk_offset(self, offset: int) -> int:
        assert offset % self.stripe_width == 0
        return (offset // self.stripe_width) * self.chunk_size

    def aligned_chunk_offset_to_logical_offset(self, offset: int) -> int:
        assert offset % self.chunk_size == 0
        return (offset // self.chunk_size) * self.stripe_width

    def offset_len_to_stripe_bounds(self, off: int, length: int) -> tuple:
        start = self.logical_to_prev_stripe_offset(off)
        length = self.logical_to_next_stripe_offset((off - start) + length)
        return start, length


def as_u8(data) -> np.ndarray:
    """Zero-copy uint8 view of bytes / bytearray / memoryview / ndarray
    input (``np.frombuffer`` shares the caller's buffer; the old
    ``bytes(data)`` round-trip copied memoryviews and bytearrays)."""
    if isinstance(data, np.ndarray):
        return data if data.dtype == np.uint8 else data.view(np.uint8)
    return np.frombuffer(data, dtype=np.uint8)


def to_shard_major(sinfo: StripeInfo, k: int, data) -> np.ndarray:
    """[k, shard_len] shard-major view of a stripe-aligned logical
    buffer: the ONE transpose copy the host write path makes (every
    other step is a view)."""
    buf = as_u8(data)
    assert len(buf) % sinfo.stripe_width == 0, "input must be stripe-aligned"
    n_stripes = len(buf) // sinfo.stripe_width
    # reshape so each shard's stripes are contiguous: [stripes, k, chunk]
    per_stripe = buf.reshape(n_stripes, k, sinfo.chunk_size)
    return np.ascontiguousarray(per_stripe.transpose(1, 0, 2)).reshape(k, -1)


def encode(
    sinfo: StripeInfo,
    ec,
    data: bytes | np.ndarray,
    want: Iterable[int],
) -> Dict[int, np.ndarray]:
    """Encode a stripe-aligned buffer into per-shard chunk arrays.

    One codec call covers every stripe: ec.encode pads/splits per its own
    chunk-size algebra, which for a stripe_width-aligned buffer yields
    chunk_size * n_stripes per shard -- the same bytes as the reference's
    per-stripe loop concatenated (each stripe's chunk is contiguous within
    its shard at offset stripe_index * chunk_size).
    """
    block = to_shard_major(sinfo, ec.get_data_chunk_count(), data)
    return encode_shard_major_many(ec, [block], want)[0]


def encode_shard_major_many(
    ec,
    blocks: List[np.ndarray],
    want: Iterable[int],
) -> List[Dict[int, np.ndarray]]:
    """ONE batched codec dispatch covering many shard-major [k, bs]
    blocks -- the write-path coalescer's dispatch function.

    Pipeline-backed plugins fuse the whole set into granules (one H2D +
    dispatch + D2H ladder covers every block, bounded in-flight depth);
    other codecs fall back to one encode per block.  Same bytes either
    way: each block's flattening is exactly the per-shard chunk split
    the codec's own algebra performs.
    """
    encs, _devs = encode_shard_major_many_resident(ec, blocks, want, None)
    return encs


def encode_shard_major_many_resident(
    ec,
    blocks: List[np.ndarray],
    want: Iterable[int],
    keep_device: Optional[Sequence[bool]] = None,
) -> Tuple[List[Dict[int, np.ndarray]], List[Optional[object]]]:
    """:func:`encode_shard_major_many` plus the device-resident write
    lane: ``keep_device[i]`` asks the codec to ALSO hand back stripe
    i's still-resident ``[k+m, bs]`` device block (promote-from-encode
    -- the cache tier inserts it with zero re-upload).  The second list
    holds those blocks, None wherever the codec/layout cannot compose
    one (callers fall back to the host put path).

    Codecs advertising ``shape_bucketing`` get their blocks padded up
    the shared rung ladder (``ops/bucketing.py``) on the per-block
    fallback path, so an odd blocksize still rides the pipeline's
    whole-lane kernels; parity is trimmed back, so the bytes match
    whatever the rung."""
    want = list(want)
    km = ec.get_chunk_count()
    devs: List[Optional[object]] = [None] * len(blocks)
    if hasattr(ec, "encode_shard_major_batch") and \
            all(b.shape[1] for b in blocks):
        encs, devs = ec.encode_shard_major_batch(blocks, keep_device)
        return [{i: enc[i] for i in want} for enc in encs], devs
    if hasattr(ec, "encode_batch") and all(b.shape[1] for b in blocks):
        encs = ec.encode_batch([b.reshape(-1) for b in blocks])
        return [{i: enc[i] for i in want} for enc in encs], devs
    out = []
    bucket = bool(getattr(ec, "shape_bucketing", False))
    align = getattr(ec, "bucket_align", lambda: 1)() if bucket else 1
    for b in blocks:
        bs = b.shape[1]
        if bs == 0:
            out.append({i: np.zeros(0, dtype=np.uint8) for i in want})
            continue
        if bucket:
            # pad the column axis up the rung ladder (GF parity is
            # columnwise: zero columns encode to zero and trim exactly)
            target = bucketing.bucket_bytes(bs, align)
            if target != bs:
                padded = np.zeros((b.shape[0], target), dtype=np.uint8)
                padded[:, :bs] = b
                enc = ec.encode(set(range(km)), padded.reshape(-1))
                out.append({i: enc[i][:bs] for i in want})
                continue
        enc = ec.encode(set(range(km)), b.reshape(-1))
        out.append({i: enc[i] for i in want})
    return out, devs


def encode_many(
    sinfo: StripeInfo,
    ec,
    bufs: List,
    want: Iterable[int],
) -> List[Dict[int, np.ndarray]]:
    """Batched multi-object encode: one transpose per buffer, one batched
    codec dispatch for the whole set."""
    k = ec.get_data_chunk_count()
    return encode_shard_major_many(
        ec, [to_shard_major(sinfo, k, b) for b in bufs], want
    )


def data_positions(ec) -> List[int]:
    """Positions holding logical data chunks (honors the chunk mapping)."""
    mapping = ec.get_chunk_mapping()
    k = ec.get_data_chunk_count()
    if mapping:
        return list(mapping[:k])
    return list(range(k))


def _reassemble(sinfo: StripeInfo, ec, out: Dict[int, np.ndarray]) -> bytes:
    """Shard-major decode output -> logical bytes (one transpose copy)."""
    k = ec.get_data_chunk_count()
    pos = data_positions(ec)
    shard_len = len(out[pos[0]])
    n_stripes = shard_len // sinfo.chunk_size
    stacked = np.stack([as_u8(out[p]) for p in pos])  # [k, shard_len]
    per_stripe = stacked.reshape(k, n_stripes, sinfo.chunk_size).transpose(
        1, 0, 2
    )
    return per_stripe.tobytes()


def decode_concat(
    sinfo: StripeInfo,
    ec,
    to_decode: Dict[int, np.ndarray],
) -> bytes:
    """Rebuild the logical buffer from per-shard chunk streams."""
    return decode_concat_many(sinfo, ec, [to_decode])[0]


def decode_concat_many(
    sinfo: StripeInfo,
    ec,
    maps: List[Dict[int, np.ndarray]],
) -> List[bytes]:
    """Batched logical reads -- the read-path coalescer's dispatch.

    Stripes sharing an erasure signature share one fused reconstruction
    dispatch (``decode_batch`` groups by available-set and reuses the
    pipeline's per-signature decode stream); codecs without the batched
    API decode per map.  Zero-length maps (zero-byte objects) short-
    circuit without touching the codec.
    """
    pos = data_positions(ec)
    results: List[bytes] = [b""] * len(maps)
    need = [
        i for i, m in enumerate(maps)
        if m and len(next(iter(m.values()))) > 0
    ]
    if not need:
        return results
    if hasattr(ec, "decode_batch"):
        outs = ec.decode_batch([maps[i] for i in need])
    else:
        outs = [ec.decode(set(pos), maps[i]) for i in need]
    for i, out in zip(need, outs):
        results[i] = _reassemble(sinfo, ec, out)
    return results


def decode_shards(
    ec,
    available: Dict[int, np.ndarray],
    want: Iterable[int],
) -> Dict[int, np.ndarray]:
    """Reconstruct specific shards (recovery path)."""
    return ec.decode(set(want), available)


def decode_shards_many(
    ec,
    maps: List[Dict[int, np.ndarray]],
    wants: List[Iterable[int]],
) -> List[Dict[int, np.ndarray]]:
    """Batched shard reconstruction -- the RECOVERY coalescer's fused
    dispatch (peer of :func:`decode_concat_many` on the read path).

    Many objects' source-chunk maps ride one batched codec call;
    ``decode_batch`` groups maps sharing an erasure signature onto one
    reconstruction stream (and the pipeline's fused granules),
    so a rebuild of N same-signature objects costs one fused dispatch,
    not N.  Returns per map a dict covering at least ``wants[i]`` (the
    batched path reconstructs every missing position; recovery uses
    the extras for promote-on-recovery's full-block insert).  Codecs
    without the batched API decode per map."""
    results: List[Dict[int, np.ndarray]] = [{}] * len(maps)
    need = [i for i, m in enumerate(maps)
            if m and len(next(iter(m.values()))) > 0]
    if not need:
        return results
    if hasattr(ec, "decode_batch"):
        outs = ec.decode_batch([maps[i] for i in need])
    else:
        outs = [ec.decode(set(wants[i]), dict(maps[i])) for i in need]
    for i, out in zip(need, outs):
        results[i] = out
    return results


class HashInfo:
    """Per-shard cumulative crc32c + total per-shard size."""

    def __init__(self, num_chunks: int):
        self.total_chunk_size = 0
        self.cumulative_shard_hashes: List[int] = [0xFFFFFFFF] * num_chunks

    def append(self, old_size: int, to_append: Dict[int, np.ndarray]) -> None:
        assert old_size == self.total_chunk_size
        appended = 0
        if self.cumulative_shard_hashes and to_append:
            # hashes survive only on pure-append histories; once an
            # overwrite cleared them (ec_overwrites semantics,
            # reference ECUtil.cc hinfo reset) later appends track
            # sizes only -- indexing the empty list was a crash on
            # the append-after-overwrite path.  One batched FFI loop
            # over the k+m chunks (crc32c_rows): at 2 KiB chunks the
            # per-call wrapper cost ~4x the crc itself on the hot
            # commit path
            shards = sorted(to_append)
            chunks = [to_append[s] for s in shards]
            appended = len(chunks[-1])
            hashes = crc32c_rows(
                chunks, [self.cumulative_shard_hashes[s] for s in shards]
            )
            for s, h in zip(shards, hashes):
                self.cumulative_shard_hashes[s] = h
        else:
            for _shard, chunk in to_append.items():
                appended = len(chunk)
        self.total_chunk_size += appended

    def get_chunk_hash(self, shard: int) -> int:
        return self.cumulative_shard_hashes[shard]

    def has_chunk_hash(self) -> bool:
        return bool(self.cumulative_shard_hashes)

    def get_total_chunk_size(self) -> int:
        return self.total_chunk_size

    def get_total_logical_size(self, sinfo: StripeInfo) -> int:
        return self.total_chunk_size * (
            sinfo.stripe_width // sinfo.chunk_size
        )

    # -- wire form (dict-based; the osd layer stores it as a shard xattr) --

    def to_dict(self) -> dict:
        return {
            "total_chunk_size": self.total_chunk_size,
            "cumulative_shard_hashes": list(self.cumulative_shard_hashes),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "HashInfo":
        h = cls(len(d["cumulative_shard_hashes"]))
        h.total_chunk_size = d["total_chunk_size"]
        h.cumulative_shard_hashes = list(d["cumulative_shard_hashes"])
        return h


HINFO_KEY = "hinfo_key"


def is_hinfo_key_string(key: str) -> bool:
    return key == HINFO_KEY
