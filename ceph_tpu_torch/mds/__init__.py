"""CephFS: metadata server + POSIX-style client over RADOS.

Port of ``ceph_tpu/mds/__init__.py``.

Reference: src/mds (MDCache / MDLog / LogEvent journaling, 76.9k LoC) +
src/client (libcephfs, 24.1k LoC), reduced to the architecture:

* **Namespace in RADOS** -- each directory is one RADOS object whose
  omap maps entry name -> encoded dentry with the inode EMBEDDED
  (CephFS's primary-dentry inode embedding); the inode-number table is
  an omap counter allocated through the CAS primitive
  (src/mds/InoTable.h).
* **Journaled mutations** (MDLog/LogEvent): every metadata mutation is
  appended to the MDS journal object BEFORE it is applied to the
  directory objects; a restarted or standby MDS replays the journal
  tail (idempotent events) and trims it -- the up:replay ->
  up:active takeover flow (src/mds/MDLog.cc).
* **File data striped over objects** via the shared Striper
  (src/osdc/Striper.cc, file_layout_t): data object "<ino>.<objno>",
  I/O through the same EC/replicated pool machinery as everything else.

``MDS`` is one rank; ``MultiMDS`` runs several active ranks with the
namespace partitioned by subtree and an MDBalancer-style rebalancer
(src/mds/MDBalancer.cc); ``CephFS`` is the libcephfs-role client
(metadata calls to the MDS, data I/O straight to RADOS -- the
reference's split between MDS requests and OSD file I/O).
"""

from ceph_tpu_torch.mds.mds import MDS
from ceph_tpu_torch.mds.cephfs import CephFS
from ceph_tpu_torch.mds.multimds import MultiMDS

__all__ = ["MDS", "CephFS", "MultiMDS"]
