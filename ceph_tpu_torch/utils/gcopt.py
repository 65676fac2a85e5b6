"""GC tuning for long-lived daemons.

Port of ``ceph_tpu/utils/gcopt.py``.  CPython's generational collector
re-traces the whole boot-time object graph -- codec tables, osdmaps,
config, placement caches -- on every full collection, and that graph only
grows with uptime while never becoming garbage.

:func:`freeze_after_warmup` is called by the daemon entry points
(``daemon/{osd,mon,mgr}.py``) once startup is complete, gated by the
``gc_freeze_on_start`` option (declared in the port's schema, so a daemon
never skips the freeze for want of it):

* ``gc.collect()`` first, so actual boot garbage is reclaimed rather
  than frozen forever;
* ``gc.freeze()`` moves every surviving object into the permanent
  generation -- full collections stop scaling with the boot heap;
* the gen0 threshold rises (700 -> 50k) so the remaining op-scoped
  young-generation churn triggers fewer, not longer, pauses.
"""

from __future__ import annotations

import gc
from typing import Optional

#: thresholds for a frozen daemon heap: young-gen churn is op-scoped,
#: so a higher gen0 trigger amortizes pause COUNT without growing any
#: single pause's traced set
FROZEN_THRESHOLDS = (50_000, 25, 25)

_frozen = False
_prior_thresholds: Optional[tuple] = None


def freeze_after_warmup(force: bool = False) -> bool:
    """Freeze the warm daemon heap; returns whether it was applied
    (False when ``gc_freeze_on_start`` is off and ``force`` unset)."""
    global _frozen, _prior_thresholds
    if not force:
        from ceph_tpu_torch.utils.config import get_config

        if not bool(get_config().get_val("gc_freeze_on_start")):
            return False
    gc.collect()
    gc.freeze()
    if _prior_thresholds is None:
        _prior_thresholds = gc.get_threshold()
    gc.set_threshold(*FROZEN_THRESHOLDS)
    _frozen = True
    return True


def unfreeze() -> None:
    """Undo :func:`freeze_after_warmup` (test isolation: the freeze is
    process-global state)."""
    global _frozen, _prior_thresholds
    gc.unfreeze()
    if _prior_thresholds is not None:
        gc.set_threshold(*_prior_thresholds)
        _prior_thresholds = None
    _frozen = False


def status() -> dict:
    """Freeze state for the admin/observability surface."""
    return {
        "frozen": _frozen,
        "permanent_objects": gc.get_freeze_count(),
        "thresholds": list(gc.get_threshold()),
    }
