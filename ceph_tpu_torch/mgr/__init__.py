"""Manager daemon (reference: src/mgr + src/pybind/mgr).

The reference mgr aggregates daemon state (DaemonServer/ClusterState +
the mon's PGMap), evaluates health checks, and exports metrics through
python modules (prometheus, status, ...).  Same roles here:

* ``ClusterState`` -- pulls per-OSD perf counters + store usage and the
  cluster's liveness/placement view (the PGMap/DaemonState role);
* ``health_checks`` -- OSD_DOWN / PG_DEGRADED-style checks with the
  reference's HEALTH_OK/WARN/ERR severities (src/mon/health_check.h);
* ``prometheus_text`` -- Prometheus exposition (pybind/mgr/prometheus);
* ``MgrDaemon`` -- an asyncio HTTP endpoint serving /metrics and
  /health (the mgr module HTTP server role).

Port of ``ceph_tpu/mgr/`` (its telemetry bench, ``-w telemetry-path``,
is ROADMAP.md queue 1 item 19).  It watches the port's cluster, whose
codec runs on the card unless the pool asked for the CPU.
"""

from ceph_tpu_torch.mgr.mgr import ClusterState, MgrDaemon, health_checks, \
    prometheus_text
from ceph_tpu_torch.mgr.module_host import MgrModule, PyModuleRegistry
from ceph_tpu_torch.mgr.pgmap import MgrServer, PGMap
from ceph_tpu_torch.mgr.report import (LoopLagProbe, MgrBeacon,
                                       MgrReport, ReportSender)

__all__ = ["ClusterState", "MgrDaemon", "health_checks", "prometheus_text",
           "MgrModule", "PyModuleRegistry", "PGMap", "MgrServer",
           "MgrBeacon", "MgrReport", "ReportSender", "LoopLagProbe"]
