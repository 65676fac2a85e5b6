"""prometheus module: exposition text (pybind/mgr/prometheus role).

Renders through the module-host ``get()`` surface only -- the module
sees exactly what any third-party module would.

Port of ``ceph_tpu/mgr/mgr_modules/prometheus.py``.
"""

from __future__ import annotations

from ceph_tpu_torch.mgr.mgr import prometheus_text
from ceph_tpu_torch.mgr.module_host import MgrModule


class Module(MgrModule):
    NAME = "prometheus"

    def metrics(self) -> str:
        return prometheus_text(self.get("dump"))

    def handle_command(self, cmd: dict):
        verb = cmd.get("prefix", "").split(" ", 1)[-1]
        if verb == "metrics":
            return 0, self.metrics(), ""
        return -22, "", f"unknown prometheus verb {verb!r}"
