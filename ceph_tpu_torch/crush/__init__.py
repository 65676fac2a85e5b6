"""CRUSH placement (TPU-native framework port of the reference's C core).

Port of ``ceph_tpu/crush/__init__.py``.

Reference: src/crush/mapper.c (crush_do_rule, crush_choose_firstn/indep,
bucket_straw2_choose), src/crush/hash.c (rjenkins1), src/crush/crush.h
(bucket algorithms).  Reimplemented from the published CRUSH algorithm
(Weil et al., SC'06) and the straw2 exponential-draw derivation; the
fixed-point log table of the reference is replaced by direct 2^44*log2
fixed-point arithmetic (semantic, not bit, parity — see docs/crush.md).
"""

from ceph_tpu_torch.crush.hash import crush_hash32, crush_hash32_2, crush_hash32_3
from ceph_tpu_torch.crush.map import (
    Bucket,
    CrushMap,
    Rule,
    Step,
    build_flat_map,
    build_hierarchy,
)
from ceph_tpu_torch.crush.mapper import Tunables, do_rule

__all__ = [
    "Bucket",
    "CrushMap",
    "Rule",
    "Step",
    "Tunables",
    "build_flat_map",
    "build_hierarchy",
    "crush_hash32",
    "crush_hash32_2",
    "crush_hash32_3",
    "do_rule",
]
