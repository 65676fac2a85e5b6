"""Client-side data-path helpers (reference: src/osdc -- Objecter/
Striper/ObjectCacher).  Port of ``ceph_tpu/osdc``: the striper, the
object cacher, the journaler, the key-value store and libradosstriper,
each over a pool backend (``ECCluster(..., plugin="cuda").backend``: the
codec runs on the card).  The Objecter's placement+retry role is fused
into ECBackend; Striper lives here."""

from ceph_tpu_torch.osdc.striper import FileLayout, Striper

__all__ = ["FileLayout", "Striper"]
