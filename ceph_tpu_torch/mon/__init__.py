"""Monitor cluster: Paxos-replicated cluster maps + control plane.

Port of ``ceph_tpu/mon/__init__.py``.

Reference: src/mon — Monitor.cc (daemon), Paxos.cc (the consensus core),
PaxosService subclasses (OSDMonitor for osdmaps/profiles/pools), Elector.cc
(rank-based leader election), MonitorDBStore.h (the replicated KV).
Reimplemented as asyncio daemons over the framework messenger.
"""

from ceph_tpu_torch.mon.monitor import MonCluster, Monitor
from ceph_tpu_torch.mon.osdmap import OSDMap
from ceph_tpu_torch.mon.paxos import Paxos

__all__ = ["MonCluster", "Monitor", "OSDMap", "Paxos"]
