"""PyTorch/CUDA hygiene rules for the GF(2^8) codec hot paths (the
``torch`` pack).

Port of ``ceph_tpu/analysis/rules_jax.py``.  The codec lives or dies on
two disciplines: no host<->device round-trips inside the per-stripe
loop, and no silent dtype widening of the GF(2^8) byte domain.  The
transfer discipline is owned by the flow-aware residency rules
(``rules_residency.py`` over ``residency_flow.py``).  What stays here:

* dtype rule: array and tensor constructors without an explicit
  ``dtype=`` default to float64/int64 (numpy) or float32/int64 (torch)
  -- a widening of a byte lane that the kernels' operands must never
  carry; a numpy float64 is never right here.  Unlike the JAX rule, a
  torch float64 is allowed: it is the port's exact detour for 0/1 plane
  products, since integer products do not run on CUDA.
* device-bytes accounting rule: retained device tensors must route
  through the two ledger seams so card memory stays evictable.

Each rule of the JAX package's ``jax`` pack has its ``torch`` rule,
reading what the port does in that role:

======================================= ======================================
JAX package rule                        port rule: what it watches
======================================= ======================================
``jax-gf-dtype-drift``                  ``torch-gf-dtype-drift``: ``np.*`` and
                                        ``torch.*`` constructors without
                                        ``dtype=``, a numpy float64
``jax-device-bytes-unaccounted``        ``torch-device-bytes-unaccounted``: a
                                        ``.to(<card>)`` / ``.cuda()`` /
                                        ``device_put`` / ``torch.*(...,
                                        device=)`` result kept on an
                                        attribute or container
``jax-d2h-in-resident-section``         ``torch-d2h-in-resident-section``:
                                        ``.cpu()`` / ``.numpy()`` /
                                        ``.item()`` / ``.tolist()`` /
                                        ``np.asarray`` / ``device_get`` /
                                        ``note_d2h`` inside a section
``jax-recompile-hazard``                ``torch-recompile-hazard``: per-call
                                        ``torch.compile`` / ``triton.jit``,
                                        a library build or load outside a
                                        cache-miss guard
``jax-donated-after-use``               ``torch-donated-after-use``: a buffer
                                        touched while a ``non_blocking``
                                        copy owns it, before a synchronize
``jax-loop-invariant-transfer``         ``torch-loop-invariant-transfer``:
                                        ``.to(<card>)`` / ``.cuda()`` /
                                        ``device_put`` of an invariant in a
                                        loop, per-call ``self.B.to(dev)``
``jax-percall-sharding-construction``   ``torch-percall-sharding-construction``:
                                        the port's ``Mesh`` / ``Placement``,
                                        ``DeviceMesh``, CUDA streams and
                                        process groups built in a loop
======================================= ======================================
"""

from __future__ import annotations

import ast
from typing import Iterator

from ceph_tpu_torch.analysis import residency_flow as flow
from ceph_tpu_torch.analysis.core import (SEV_WARNING, FileContext, Finding,
                                          call_name, dotted_name, rule)

#: matrices + ops: everything that builds or consumes GF kernel operands
DTYPE_SCOPE_PREFIXES = ("ceph_tpu_torch/matrices/", "ceph_tpu_torch/ops/")

#: constructors whose dtype defaults to float64/int64 (numpy) or
#: float32/int64 (torch)
_DEFAULT_DTYPE_CTORS = {
    "np.zeros", "np.ones", "np.empty", "np.arange", "np.eye",
    "numpy.zeros", "numpy.ones", "numpy.empty", "numpy.arange",
    "numpy.eye",
    "torch.zeros", "torch.ones", "torch.empty", "torch.arange",
    "torch.eye",
}


def _np_float64(expr: ast.AST) -> bool:
    name = dotted_name(expr)
    return name.rsplit(".", 1)[-1] in ("float64", "double") and \
        not name.startswith("torch.")


@rule(
    "torch-gf-dtype-drift", "torch", SEV_WARNING,
    "array or tensor constructor without an explicit dtype (defaults to "
    "float64/int64 in numpy, float32/int64 in torch) or with float64 in "
    "GF kernel scope: the GF(2^8) byte domain must stay uint8 (wider "
    "words are deliberate and explicit: int32 lanes, uint16/uint32 for "
    "w=16/32)",
)
def check_dtype_drift(ctx: FileContext) -> Iterator[Finding]:
    if not any(ctx.path.startswith(p) for p in DTYPE_SCOPE_PREFIXES):
        return
    for node in ctx.walk():
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if name in _DEFAULT_DTYPE_CTORS:
            # numpy's zeros/ones/empty take dtype as the 2nd positional
            # arg; eye's 2nd positional is M and arange's are
            # stop/step, and torch takes dtype by keyword only
            positional_dtype = (
                name.startswith(("np.", "numpy.")) and
                name.rsplit(".", 1)[-1] in ("zeros", "ones", "empty")
                and len(node.args) >= 2
            )
            if not positional_dtype and \
                    not any(kw.arg == "dtype" for kw in node.keywords):
                yield ctx.finding(
                    "torch-gf-dtype-drift", node,
                    f"{name}(...) without dtype= defaults to a wide "
                    "float/int type; GF kernel operands must declare "
                    "their word dtype (uint8 for w<=8)",
                )
        # .astype(np.float64) / dtype=np.float64 anywhere in scope: a
        # numpy lane has integer products, so float64 is never needed
        # there.  A torch float64 (.to(torch.float64)) is the port's
        # sanctioned exact detour for 0/1 plane products (integer
        # products do not run on CUDA; ops/torch_gf.py _gf2_product), so
        # it is not drift.
        if name.rsplit(".", 1)[-1] == "astype" and node.args and \
                _np_float64(node.args[0]):
            yield ctx.finding(
                "torch-gf-dtype-drift", node,
                ".astype(float64) in GF kernel scope: 8x widening of "
                "the byte lane",
            )
        for kw in node.keywords:
            if kw.arg == "dtype" and _np_float64(kw.value):
                yield ctx.finding(
                    "torch-gf-dtype-drift", node,
                    "dtype=float64 in GF kernel scope; use uint8 (or "
                    "the explicit wider word dtype)",
                )


#: the two accounting seams allowed to RETAIN device tensors: every
#: other module must route residency through them so the
#: osd_tier_hbm_bytes ledger (tier/device_tier.py DeviceByteAccount)
#: stays exact and eviction can always reclaim the bytes
DEVICE_BYTES_ACCOUNTING_FILES = (
    "ceph_tpu_torch/tier/device_tier.py",
    "ceph_tpu_torch/ops/pipeline.py",
)


def _device_producer(call: ast.AST) -> bool:
    """A call whose result is a tensor on a card: ``x.to(<card>)``,
    ``x.cuda()``, ``residency.device_put``, ``torch.*(...,
    device=<card>)``."""
    if not isinstance(call, ast.Call):
        return False
    if flow.h2d_operand(call) is not None:
        return True
    return call_name(call).startswith("torch.") and \
        flow.device_keyword(call) == flow.DEVICE


@rule(
    "torch-device-bytes-unaccounted", "torch", SEV_WARNING,
    "device-resident tensor retention (a .to(<card>) / .cuda() / "
    "device_put / torch.*(..., device=) result stored on an attribute "
    "or container) outside the tier/pipeline accounting helpers: card "
    "memory held this way is invisible to the osd_tier_hbm_bytes ledger "
    "and can never be evicted under budget pressure -- route it through "
    "DeviceTierStore or the pipeline's H2D cache",
)
def check_device_bytes_unaccounted(ctx: FileContext) -> Iterator[Finding]:
    if not ctx.path.startswith("ceph_tpu_torch/"):
        return  # tools/tests/bench hold device tensors transiently
    if ctx.path in DEVICE_BYTES_ACCOUNTING_FILES:
        return
    if not ctx.imports_module("torch"):
        return
    for fn in ctx.walk():
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        # names bound to device-producer results in this function
        # (simple single-function local flow; retention, not transfer,
        # is the concern here, so the full residency lattice is not
        # needed)
        put_names = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and \
                    _device_producer(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        put_names.add(tgt.id)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            if not any(isinstance(t, (ast.Attribute, ast.Subscript))
                       for t in node.targets):
                continue  # plain local bind: transient, fine
            v = node.value
            direct = _device_producer(v)
            via_name = isinstance(v, ast.Name) and v.id in put_names
            if direct or via_name:
                yield ctx.finding(
                    "torch-device-bytes-unaccounted", node,
                    "device tensor retained on an attribute/container "
                    "outside the accounting seams (tier/device_tier.py, "
                    "ops/pipeline.py): these bytes bypass the "
                    "osd_tier_hbm_bytes ledger",
                )
