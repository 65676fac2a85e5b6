"""Million-client scale harness: scenario-diverse load generation over
the real-TCP cluster path.

Port of ``ceph_tpu/loadgen/``: the same profiles, arrival processes,
clients and scenarios.  The scenario's pool runs the ``cuda`` plugin by
default (the JAX package's runner hard-codes ``jerasure`` on the host);
``profile={"device": "cpu"}`` runs it on the CPU.

The package composes four layers (docs/qos.md):

* :mod:`profiles` -- named workload shapes (RGW-style object PUT/GET
  mixes, RBD-style small random extent I/O, CephFS-style metadata+data,
  transactional omap_cas/exec traffic) as weighted op/size tables;
* :mod:`arrival` -- open-loop (Poisson) and closed-loop (think-time)
  arrival processes;
* :mod:`clients` -- LoadClient: one Objecter driven by a profile under
  an arrival process, with a per-client in-flight budget semaphore
  (``loadgen_client_inflight``) so a million-client run can never OOM
  the harness, and exactly-once CAS accounting built in;
* :mod:`scenario` -- ScenarioRunner: a real-TCP cluster (client hubs
  multiplex thousands of Objecters over a handful of sockets -- the
  ``name@hub`` messenger aliasing), client groups with per-group QoS
  classes, concurrent chaos (thrash kills, failover, background
  rebuild, tier promotion), and fairness/percentile/exactly-once
  result collection.
"""

from ceph_tpu_torch.loadgen.arrival import (  # noqa: F401
    ClosedLoop, OpenLoop)
from ceph_tpu_torch.loadgen.clients import (  # noqa: F401
    ClientStats, LoadClient)
from ceph_tpu_torch.loadgen.profiles import (  # noqa: F401
    PROFILES, WorkloadProfile)
from ceph_tpu_torch.loadgen.scenario import (  # noqa: F401
    ClientGroup, Scenario, ScenarioResult, ScenarioRunner, run_scenario)
