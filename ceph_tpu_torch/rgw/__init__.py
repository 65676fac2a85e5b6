"""RGW: S3-compatible object gateway over RADOS (reference: src/rgw).

Port of ``ceph_tpu/rgw/__init__.py``.

The reference radosgw terminates S3/Swift HTTP, authenticates requests
(AWS signatures against users kept in RADOS), and maps the bucket/object
model onto RADOS objects: bucket indexes are omap objects, object data
lands in data-pool objects, user/bucket metadata lives in meta objects
(rgw_main.cc, rgw_rados.cc, rgw_bucket.cc).  Same decomposition here:

* ``RGWGateway``   -- asyncio HTTP frontend (the civetweb/beast role)
  serving S3 (AWS-v2 HMAC + SigV4 signing, multipart uploads) and
  Swift (TempAuth tokens, account/container/object ops) over ONE
  bucket namespace, like the reference's dual REST stacks;
* users            -- omap on ``rgw.users`` (access -> secret, display);
* buckets          -- omap on ``rgw.buckets`` (the bucket.instance
  metadata role) + one ``rgw.bucket.<name>`` index object per bucket
  whose omap is the bucket index (key -> size/etag/mtime);
* object data      -- one RADOS object ``rgw.obj.<bucket>/<key>`` on
  the (EC) data pool.
"""

from ceph_tpu_torch.rgw.gateway import RGWGateway, sign_v2, sign_v4
from ceph_tpu_torch.rgw.sync import RGWSyncAgent

__all__ = ["RGWGateway", "RGWSyncAgent", "sign_v2", "sign_v4"]
