"""status module: cluster summary text (pybind/mgr/status role).

Port of ``ceph_tpu/mgr/mgr_modules/status.py``.
"""

from __future__ import annotations

from ceph_tpu_torch.mgr.module_host import MgrModule


class Module(MgrModule):
    NAME = "status"

    def handle_command(self, cmd: dict):
        verb = cmd.get("prefix", "").split(" ", 1)[-1]
        if verb == "status":
            state = self.get("dump")
            health = self._host.gather_health(dump=state)
            osdmap = state["osdmap"]
            lines = [
                f"health: {health['status']}",
                f"osd: {osdmap['num_osds']} osds: "
                f"{osdmap['num_up_osds']} up",
                f"pools: {state['pools']['num_objects']} objects",
            ]
            for name, chk in health["checks"].items():
                lines.append(f"  {name}: {chk['summary']}")
            if state["degraded_objects"]:
                lines.append(
                    f"degraded: {len(state['degraded_objects'])} objects"
                )
            return 0, "\n".join(lines) + "\n", ""
        return -22, "", f"unknown status verb {verb!r}"
