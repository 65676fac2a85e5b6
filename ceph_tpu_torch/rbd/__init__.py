"""RBD: block images striped over RADOS objects.

Port of ``ceph_tpu/rbd/``: the same header, data, object-map and journal
objects, byte for byte, over the port's backend (the ``cuda`` plugin's
codec on the card).

Reference: src/librbd (58.7k LoC) reduced to the core image model:

* header object ``rbd_header.<name>`` -- size/order/snaps/features in
  omap, managed by the ``rbd`` object class (``cls/cls_rbd.py``,
  reference src/cls/rbd);
* data objects ``rbd_data.<name>.<object_no:016x>`` -- image extents
  mapped by the Striper (object_size = 2^order);
* exclusive-lock via cls_lock, header-change notification via
  watch/notify (the reference's ExclusiveLock + ImageWatcher roles);
* the image directory object ``rbd_directory`` lists images (cls_rbd
  dir methods' role);
* REAL data snapshots via the RADOS self-managed SnapContext, COW
  clone layering with copy-up, flatten (src/librbd/io + Operations);
* image journaling (feature ``journaling``): mutations recorded as
  typed events in a per-image journal before application, crash replay
  on open (src/librbd/Journal.cc over src/journal);
* rbd-mirror: journal replay into a peer cluster with a registered
  journal client pinning trim (src/tools/rbd_mirror).

The object-map + fast-diff features (src/librbd/
ObjectMap.cc): per-object state maps maintained by the write path,
frozen per snapshot, powering stat-free existence checks and
map-only diffs.
"""

from ceph_tpu_torch.rbd.image import RBD, Image
from ceph_tpu_torch.rbd.journal import FEATURE_JOURNALING, ImageJournal
from ceph_tpu_torch.rbd.mirror import (ImageReplayer, MirrorDaemon,
                                       mirror_demote, mirror_disable,
                                       mirror_enable, mirror_is_primary,
                                       mirror_list, mirror_promote)
from ceph_tpu_torch.rbd.objectmap import (FEATURE_FAST_DIFF,
                                          FEATURE_OBJECT_MAP, ObjectMap)

__all__ = ["RBD", "Image", "FEATURE_JOURNALING", "FEATURE_OBJECT_MAP",
           "FEATURE_FAST_DIFF", "ImageJournal", "ImageReplayer",
           "MirrorDaemon", "ObjectMap", "mirror_demote",
           "mirror_disable", "mirror_enable", "mirror_is_primary",
           "mirror_list", "mirror_promote"]
