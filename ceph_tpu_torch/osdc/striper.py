"""RAID-0 style striping of a logical byte space over RADOS objects.

Port of ``ceph_tpu/osdc/striper.py``.

Reference: src/osdc/Striper.cc + ``file_layout_t`` (stripe_unit,
stripe_count, object_size) -- used by librbd, CephFS and libradosstriper
to map file/image extents onto object extents and back.

Layout model (identical to the reference):
  * the byte space is cut into *stripe units* of ``su`` bytes;
  * consecutive units go round-robin across ``stripe_count`` objects of
    the current *object set*;
  * each object holds ``object_size / su`` units per pass; when every
    object of the set is full, the next object set begins.

``object_no = set * stripe_count + (unit % stripe_count)`` and the unit's
offset inside its object advances by ``su`` per pass.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class FileLayout:
    object_size: int = 1 << 22   # 4 MiB
    stripe_unit: int = 1 << 22   # == object_size -> simple striping
    stripe_count: int = 1

    def __post_init__(self):
        if self.object_size % self.stripe_unit != 0:
            raise ValueError("object_size must be a multiple of stripe_unit")
        if self.stripe_count < 1:
            raise ValueError("stripe_count >= 1")


class Striper:
    def __init__(self, layout: FileLayout):
        self.layout = layout

    def map_extent(
        self, offset: int, length: int
    ) -> List[Tuple[int, int, int]]:
        """Logical [offset, offset+length) -> [(object_no, obj_off, len)],
        in logical order (Striper::file_to_extents)."""
        lo = self.layout
        su, sc, osz = lo.stripe_unit, lo.stripe_count, lo.object_size
        units_per_obj = osz // su
        out: List[Tuple[int, int, int]] = []
        pos = offset
        end = offset + length
        while pos < end:
            unit = pos // su
            off_in_unit = pos - unit * su
            take = min(su - off_in_unit, end - pos)
            obj_set, in_set = divmod(unit, sc * units_per_obj)
            pass_no, obj_idx = divmod(in_set, sc)
            object_no = obj_set * sc + obj_idx
            obj_off = pass_no * su + off_in_unit
            out.append((object_no, obj_off, take))
            pos += take
        return out

    def coalesce(
        self, extents: List[Tuple[int, int, int]]
    ) -> Dict[int, List[Tuple[int, int]]]:
        """Group per object and merge adjacent extents
        (Striper::file_to_extents' extent map shape)."""
        by_obj: Dict[int, List[Tuple[int, int]]] = {}
        for object_no, obj_off, length in extents:
            lst = by_obj.setdefault(object_no, [])
            if lst and lst[-1][0] + lst[-1][1] == obj_off:
                lst[-1] = (lst[-1][0], lst[-1][1] + length)
            else:
                lst.append((obj_off, length))
        return by_obj

    def object_count(self, total_size: int) -> int:
        """How many objects a byte space of total_size can touch.

        With stripe_count > 1 the last *byte* does not land in the last
        *object* (units go round-robin), so this counts analytically:
        full object sets contribute stripe_count objects each; a partial
        set touches one object per leading unit, capped at stripe_count.
        """
        if total_size == 0:
            return 0
        lo = self.layout
        units = (total_size + lo.stripe_unit - 1) // lo.stripe_unit
        units_per_set = lo.stripe_count * (lo.object_size // lo.stripe_unit)
        full_sets, rem = divmod(units, units_per_set)
        return full_sets * lo.stripe_count + min(rem, lo.stripe_count)
