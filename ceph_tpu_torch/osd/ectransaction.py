"""Write planning for partial EC writes (ECTransaction equivalent).

Port of ``ceph_tpu/osd/ectransaction.py``.

Reference: src/osd/ECTransaction.h:26-33 WritePlan + :40-90 get_write_plan:
a logical write is stripe-aligned; stripes only partially covered by the
new bytes must be read first (RMW), then the aligned region is re-encoded
and written per shard at the chunk offsets.

Hash-info semantics follow the reference's split: pure appends extend the
per-shard cumulative crc32c; overwrites clear the chunk hashes and keep
only sizes (the reference gates overwrites behind `allows_ecoverwrites`,
which disables hinfo crc tracking -- set_total_chunk_size_clear_hash,
src/osd/ECUtil.h:146-149).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ceph_tpu_torch.osd.ecutil import StripeInfo


@dataclasses.dataclass
class WritePlan:
    #: logical stripe-aligned region to read before writing (None if pure
    #: append / fully-covering write)
    to_read: Optional[Tuple[int, int]]
    #: logical stripe-aligned region that will be written
    will_write: Tuple[int, int]
    #: logical object size after the write
    new_size: int
    #: True when the write only appends past the old aligned end
    is_append: bool


def get_write_plan(
    sinfo: StripeInfo, object_size: int, offset: int, length: int
) -> WritePlan:
    """Compute the RMW plan for writing [offset, offset+length)."""
    write_start, write_len = sinfo.offset_len_to_stripe_bounds(offset, length)
    write_end = write_start + write_len
    old_aligned_end = sinfo.logical_to_next_stripe_offset(object_size)
    new_size = max(object_size, offset + length)

    is_append = write_start >= old_aligned_end or object_size == 0
    if is_append:
        return WritePlan(
            to_read=None,
            will_write=(write_start, write_len),
            new_size=new_size,
            is_append=True,
        )

    # stripes overlapping existing data must be read unless the new bytes
    # fully cover them
    read_start = write_start
    read_end = min(write_end, old_aligned_end)
    fully_covered = (
        offset <= write_start
        and offset + length >= read_end
    )
    to_read = None if fully_covered else (read_start, read_end - read_start)
    return WritePlan(
        to_read=to_read,
        will_write=(write_start, write_len),
        new_size=new_size,
        is_append=False,
    )
