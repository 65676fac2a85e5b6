"""Communication layer (reference: src/msg -- Messenger/Connection stack).

Port of ``ceph_tpu/msg``:

* in-process bus: ``ceph_tpu_torch.osd.messenger.Messenger``;
* real transport: ``ceph_tpu_torch.msg.tcp.TCPMessenger`` (localhost/LAN
  TCP with framed, crc-guarded typed messages, cephx, lossless sessions
  and corked bursts), over ``msg/shm_ring.py`` between colocated daemons
  when ``osd_msgr_shm_ring`` is on;
* wire codecs: ``ceph_tpu_torch.msg.wire`` (the pure-Python codec; the
  JAX package's C codec is ROADMAP.md queue 1 item 16b);
* fault injection: ``ceph_tpu_torch.msg.fault``;
* benches over real sockets: ``msg/cluster_bench.py`` (``-w
  cluster-path``) and ``msg/mesh_bench.py`` (``-w mesh-path``).
"""

from ceph_tpu_torch.msg.fault import FaultInjector
from ceph_tpu_torch.msg.tcp import TCPMessenger
from ceph_tpu_torch.msg.wire import decode_message, encode_message

__all__ = ["FaultInjector", "TCPMessenger", "decode_message",
           "encode_message"]
