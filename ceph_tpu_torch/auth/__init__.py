"""Authentication and authorization (reference: src/auth, src/osd/OSDCap,
src/mon/MonCap).

Port of ``ceph_tpu/auth/``:

* ``caps.py`` (``OSDCap``, ``op_capable``, ``MonCap``), which the OSDs'
  per-op cap check and the mon's AuthMonitor gate read;
* ``cephx.py`` (``KeyRing``, ``AuthHandshake``, ``AuthError``, ``sign``,
  ``sign_parts``, ``verify``): the keyring in the ceph INI format, the
  mutual challenge-response over HMAC-SHA256 and the per-frame
  signatures that ``msg/tcp.py`` runs on every connection when it is
  given a keyring.

Reduction against the reference (the JAX package's): no ticket-granting
service or rotating tickets; every entity authenticates straight
against the shared keyring.
"""

from ceph_tpu_torch.auth.caps import MonCap, OSDCap, op_capable
from ceph_tpu_torch.auth.cephx import (AuthError, AuthHandshake, KeyRing,
                                       sign, sign_parts, verify)

__all__ = ["AuthError", "AuthHandshake", "KeyRing", "MonCap", "OSDCap",
           "op_capable", "sign", "sign_parts", "verify"]
