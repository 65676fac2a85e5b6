"""Shared batch-shape bucketing: the granule rung ladder.

Port of ``ceph_tpu/ops/bucketing.py``.  The reference pads every batch
up to the smallest fitting rung so that XLA compiles a handful of
programs.  A CUDA launch compiles nothing per shape, so in the port the
ladder does two things only:

* ``ops/pipeline.py`` -- the top rung caps a granule's width (wider
  stripes split into column segments; parity is columnwise, so exact);
  granules are as wide as their stripes, not padded up to a rung;
* ``osd/ecutil.py`` and ``plugins/cuda.py`` -- odd blocksizes are
  zero-padded up to an aligned rung so they ride the pipeline's
  whole-lane kernels (GF parity is column-independent, so zero-padding
  is bit-exact and trimmed on the way out).

The ladder is configurable (``osd_ec_shape_rungs``: comma/space
separated byte counts) so tests can exercise tiny rungs; the parsed
form is memoized per raw string.  An empty string, or one with no
positive integer, keeps :data:`DEFAULT_RUNGS`.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Tuple

from ceph_tpu_torch.utils.config import get_config

#: default rung ladder: bytes per fused chunk-row, 16 KiB .. 16 MiB.
#: Anything past the top rung is split into column segments by the
#: pipeline (parity is columnwise, so exact).
DEFAULT_RUNGS: Tuple[int, ...] = (
    1 << 14, 1 << 16, 1 << 18, 1 << 20, 1 << 22, 1 << 24,
)

_parse_lock = threading.Lock()
_parsed: dict = {}


def ladder() -> Tuple[int, ...]:
    """The configured rung ladder (``osd_ec_shape_rungs``), ascending;
    :data:`DEFAULT_RUNGS` when unset/unparseable."""
    raw = str(get_config().get_val("osd_ec_shape_rungs")).strip()
    if not raw:
        return DEFAULT_RUNGS
    with _parse_lock:
        rungs = _parsed.get(raw)
        if rungs is None:
            try:
                rungs = tuple(sorted({
                    int(tok) for tok in raw.replace(",", " ").split()
                    if int(tok) > 0
                }))
            except ValueError:
                rungs = ()
            rungs = _parsed[raw] = rungs or DEFAULT_RUNGS
    return rungs


def rung_for(nbytes: int, rungs: Optional[Tuple[int, ...]] = None
             ) -> Optional[int]:
    """Smallest rung >= ``nbytes``; None when past the top rung (the
    caller splits into top-rung column segments)."""
    for b in rungs if rungs is not None else ladder():
        if nbytes <= b:
            return b
    return None


def bucket_bytes(nbytes: int, align: int = 1,
                 rungs: Optional[Tuple[int, ...]] = None) -> int:
    """Padded byte count for a ``nbytes``-wide block: the smallest rung
    that fits, rounded up to ``align`` (codec packet/lane granularity).
    Past the top rung, the next ``align``-ed multiple of the top rung --
    still a bounded shape set, one program per multiple."""
    rungs = rungs if rungs is not None else ladder()
    target = rung_for(nbytes, rungs)
    if target is None:
        top = rungs[-1]
        target = ((nbytes + top - 1) // top) * top
    return target + (-target) % max(1, align)


def bucket_cols(need_cols: int, cols_of: Callable[[int], int],
                rungs: Optional[Tuple[int, ...]] = None) -> Optional[int]:
    """Granule width in device columns: the smallest rung (translated
    through the stream's ``cols_of`` byte->column algebra) that fits
    ``need_cols``; None past the top rung (caller caps at its max).
    The port's pipeline does not pad granules up to it; kept for callers
    that size buffers by rung."""
    for b in rungs if rungs is not None else ladder():
        c = cols_of(b)
        if need_cols <= c:
            return c
    return None
