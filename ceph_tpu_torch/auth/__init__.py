"""Authorization (reference: src/auth, src/osd/OSDCap, src/mon/MonCap).

Port of the caps half of ``ceph_tpu/auth/``: ``caps.py`` (``OSDCap``,
``op_capable``, ``MonCap``), which the OSDs' per-op cap check and the
mon's AuthMonitor gate read.  The JAX package's cephx handshake
(``ceph_tpu/auth/cephx.py``) serves only its TCP messenger and daemons,
which the port does not have (ROADMAP.md queue 1 item 16).
"""

from ceph_tpu_torch.auth.caps import MonCap, OSDCap, op_capable

__all__ = ["MonCap", "OSDCap", "op_capable"]
