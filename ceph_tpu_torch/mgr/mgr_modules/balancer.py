"""balancer module: even out shard placement by CRUSH reweighting.

Reference: src/pybind/mgr/balancer (crush-compat mode) -- score the
distribution of placements over OSDs, and nudge CRUSH weights of
overloaded OSDs down (bounded per step) so the mapper moves work away;
recovery then migrates the data.  Commands mirror the reference's
``ceph balancer status / eval / optimize``.

Port of ``ceph_tpu/mgr/mgr_modules/balancer.py``.
"""

from __future__ import annotations

from ceph_tpu_torch.mgr.module_host import MgrModule


class Module(MgrModule):
    NAME = "balancer"

    #: largest single-step weight change (balancer max_misplaced role:
    #: bound churn per optimization round)
    MAX_STEP = 0.25
    MIN_WEIGHT = 0.25

    def _distribution(self):
        stats = self.get("osd_stats")
        up = {name: st for name, st in stats.items() if st["up"]}
        return {name: st["num_shards"] for name, st in up.items()}

    def _score(self, dist) -> float:
        """0 = perfectly even; the reference's eval score is also a
        deviation-from-ideal measure."""
        if not dist or sum(dist.values()) == 0:
            return 0.0
        mean = sum(dist.values()) / len(dist)
        if mean == 0:
            return 0.0
        var = sum((v - mean) ** 2 for v in dist.values()) / len(dist)
        return (var ** 0.5) / mean

    def handle_command(self, cmd: dict):
        verb = cmd.get("prefix", "").split(" ", 1)[-1]
        dist = self._distribution()
        if verb == "status":
            return 0, (
                f"balancer score {self._score(dist):.4f} "
                f"(0 = even) over {len(dist)} up osds\n"
            ), ""
        if verb == "eval":
            mean = (sum(dist.values()) / len(dist)) if dist else 0
            lines = [f"ideal shards/osd: {mean:.1f}"]
            for name in sorted(dist):
                lines.append(f"{name}\t{dist[name]}")
            lines.append(f"score {self._score(dist):.4f}")
            return 0, "\n".join(lines) + "\n", ""
        if verb == "optimize":
            placement = self._host.state.cluster.placement
            if placement is None:
                return -22, "", "cluster has no CRUSH placement"
            if not dist or sum(dist.values()) == 0:
                return 0, "nothing to balance\n", ""
            mean = sum(dist.values()) / len(dist)
            changed = []
            for name, shards in dist.items():
                osd_id = int(name.split(".")[1])
                cur = placement.weights[osd_id] / 0x10000
                if cur <= self.MIN_WEIGHT:
                    # never RAISE a weight: an admin-drained or already-
                    # floored OSD must not be pulled back into placement
                    continue
                if mean == 0:
                    continue
                # dampened correction toward the ideal, bounded per
                # step, in BOTH directions within (MIN_WEIGHT, 1.0] --
                # under-loaded OSDs recover headroom so repeated rounds
                # never ratchet the whole cluster to the floor
                target = cur * (mean / shards) ** 0.5 if shards else 1.0
                new = min(1.0, max(self.MIN_WEIGHT,
                                   max(cur - self.MAX_STEP,
                                       min(cur + self.MAX_STEP, target))))
                if abs(new - cur) < 1e-3:
                    continue
                placement.reweight(osd_id, new)
                changed.append(f"{name}: {cur:.2f} -> {new:.2f}")
            if not changed:
                return 0, "distribution already within bounds\n", ""
            # reweight bumped the placement epoch: the OSDs' background
            # peering ticks observe it and migrate remapped shards
            return 0, "reweighted " + ", ".join(changed) + "\n", ""
        return -22, "", f"unknown balancer verb {verb!r}"
