"""Communication layer (reference: src/msg -- Messenger/Connection stack).

Port of ``ceph_tpu/msg``, so far its fault injector alone
(``ceph_tpu_torch.msg.fault``).  The in-process bus is
``ceph_tpu_torch.osd.messenger.Messenger``; the JAX package's TCP
transport and wire codecs are not ported yet.
"""

from ceph_tpu_torch.msg.fault import FaultInjector

__all__ = ["FaultInjector"]
