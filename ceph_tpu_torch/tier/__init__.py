"""Device-resident cache tier: the card's memory as the cache device.

Port of ``ceph_tpu/tier/``.  Reference: Ceph's cache-tiering subsystem
(src/osd/TierAgentState.h, src/osd/PrimaryLogPG.cc agent_work,
src/mon/OSDMonitor.cc `osd tier` commands) re-targeted at an accelerator deployment: instead of an SSD
cache pool overlaying an HDD base pool, hot objects' ENCODED shards
stay resident in device memory and reads decode without the H2D ingest
step.  ``device_tier`` holds the byte-budgeted store and the
process-wide device ledger; ``agent`` is the promote/flush/evict loop.
The mon's ``osd tier`` commands (``mon/monitor.py``) set a pool's cache
mode and report the budget; the mgr exports each OSD's resident bytes
and budget as gauges (``mgr/mgr.py``).
"""

from ceph_tpu_torch.tier.device_tier import (  # noqa: F401
    DeviceByteAccount,
    DeviceTierStore,
    TierEntry,
    device_byte_account,
)

#: pool cache modes honored by the data path + agent (the pg_pool_t
#: cache_mode subset that makes sense with device residency: writeback
#: keeps write-through copies resident, readproxy promotes on read
#: temperature only, none disables the tier for the pool)
CACHE_MODES = ("writeback", "readproxy", "none")
