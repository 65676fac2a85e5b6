"""RBD image-header class (reference: src/cls/rbd/cls_rbd.cc).

Port of ``ceph_tpu/cls/cls_rbd.py``: the 16 header methods, each
read-modify-write through ``omap_cas``, with the same ``Encoder`` bytes.

The librbd layer keeps each image's metadata in the omap of a header
object (``rbd_header.<id>``): size, order (object-size shift), snapshot
table, and settable key/value metadata.  These methods manage that state;
the data path (striping image extents over data objects) lives in the
JAX package's ``rbd`` module, which the port has not copied yet.
"""

from __future__ import annotations

from ceph_tpu_torch.cls import register
from ceph_tpu_torch.utils.encoding import Decoder, Encoder


def _enc(v) -> bytes:
    return Encoder().value(v).bytes()


def _dec(b):
    return Decoder(b).value() if b else None


@register("rbd", "create")
async def create(ctx, inp: bytes):
    req = _dec(inp)
    # CAS from absent: racing creates get exactly one winner (a plain
    # get-then-set would let both succeed with interleaved headers)
    ok, _ = await ctx.omap_cas("size", None, _enc(int(req["size"])))
    if not ok:
        return -17, b""  # -EEXIST
    await ctx.omap_set({
        "order": _enc(int(req.get("order", 22))),  # 4 MiB objects
        # seq lives INSIDE the snaps blob: snapshot id allocation and the
        # table update are one CAS, so racing snap_adds cannot reuse ids
        "snaps": _enc({"seq": 0, "by_name": {}}),
        "features": _enc(sorted(req.get("features", []))),
    })
    return 0, b""


@register("rbd", "get_metadata")
async def get_metadata(ctx, inp: bytes):
    omap = await ctx.omap_get(
        ["size", "order", "snaps", "parent", "features"])
    if "size" not in omap:
        return -2, b""
    snaps = _dec(omap.get("snaps")) or {"seq": 0, "by_name": {}}
    return 0, _enc({
        "size": _dec(omap["size"]),
        "order": _dec(omap["order"]),
        "snap_seq": snaps["seq"],
        "snaps": snaps["by_name"],
        "parent": _dec(omap.get("parent")),
        "features": _dec(omap.get("features")) or [],
    })


@register("rbd", "set_size")
async def set_size(ctx, inp: bytes):
    req = _dec(inp)
    if (await ctx.omap_get(["size"])).get("size") is None:
        return -2, b""
    await ctx.omap_set({"size": _enc(int(req["size"]))})
    return 0, b""


@register("rbd", "snap_add")
async def snap_add(ctx, inp: bytes):
    req = _dec(inp)
    name = req["name"]
    for _ in range(16):
        omap = await ctx.omap_get(["snaps", "size"])
        if "size" not in omap:
            return -2, b""
        cur_raw = omap.get("snaps")
        snaps = _dec(cur_raw) or {"seq": 0, "by_name": {}}
        if name in snaps["by_name"]:
            return -17, b""
        seq = snaps["seq"] + 1
        new = {
            "seq": seq,
            "by_name": dict(
                snaps["by_name"],
                **{name: {"id": seq, "size": _dec(omap["size"])}},
            ),
        }
        ok, _ = await ctx.omap_cas("snaps", cur_raw, _enc(new))
        if ok:
            return 0, _enc(seq)
    return -11, b""


@register("rbd", "snap_remove")
async def snap_remove(ctx, inp: bytes):
    req = _dec(inp)
    for _ in range(16):
        cur_raw = (await ctx.omap_get(["snaps"])).get("snaps")
        snaps = _dec(cur_raw) or {"seq": 0, "by_name": {}}
        if req["name"] not in snaps["by_name"]:
            return -2, b""
        by_name = dict(snaps["by_name"])
        del by_name[req["name"]]
        ok, _ = await ctx.omap_cas(
            "snaps", cur_raw, _enc({"seq": snaps["seq"], "by_name": by_name})
        )
        if ok:
            return 0, b""
    return -11, b""


@register("rbd", "set_features")
async def set_features(ctx, inp: bytes):
    """Enable/disable named features (reference cls_rbd set_features:
    librbd dynamic feature toggling, e.g. journaling on/off)."""
    req = _dec(inp)
    for _ in range(16):
        omap = await ctx.omap_get(["features", "size"])
        if "size" not in omap:
            return -2, b""
        cur_raw = omap.get("features")
        feats = set(_dec(cur_raw) or [])
        feats |= set(req.get("enable", []))
        feats -= set(req.get("disable", []))
        # CAS like every RMW in this class: cls methods interleave at
        # awaits, and a lost feature bit silently bypasses journaling
        ok, _ = await ctx.omap_cas("features", cur_raw, _enc(sorted(feats)))
        if ok:
            return 0, b""
    return -11, b""


@register("rbd", "metadata_set")
async def metadata_set(ctx, inp: bytes):
    req = _dec(inp)
    await ctx.omap_set({f"meta.{k}": v for k, v in req.items()})
    return 0, b""


@register("rbd", "metadata_get")
async def metadata_get(ctx, inp: bytes):
    req = _dec(inp)
    omap = await ctx.omap_get([f"meta.{req['key']}"])
    v = omap.get(f"meta.{req['key']}")
    if v is None:
        return -2, b""
    return 0, v


# -- snapshot protection + layering parent/child registry -------------------
# (reference cls_rbd: snapshot_protect/unprotect, set_parent/remove_parent,
# add_child/remove_child/get_children -- the metadata half of librbd
# clone layering; the COW read/copy-up data path is the rbd module's)


@register("rbd", "snap_protect")
async def snap_protect(ctx, inp: bytes):
    req = _dec(inp)
    for _ in range(16):
        cur_raw = (await ctx.omap_get(["snaps"])).get("snaps")
        snaps = _dec(cur_raw) or {"seq": 0, "by_name": {}}
        ent = snaps["by_name"].get(req["name"])
        if ent is None:
            return -2, b""
        by_name = dict(snaps["by_name"])
        by_name[req["name"]] = dict(ent, protected=True)
        ok, _ = await ctx.omap_cas(
            "snaps", cur_raw, _enc({"seq": snaps["seq"], "by_name": by_name})
        )
        if ok:
            return 0, b""
    return -11, b""


@register("rbd", "snap_unprotect")
async def snap_unprotect(ctx, inp: bytes):
    req = _dec(inp)
    for _ in range(16):
        cur_raw = (await ctx.omap_get(["snaps"])).get("snaps")
        snaps = _dec(cur_raw) or {"seq": 0, "by_name": {}}
        ent = snaps["by_name"].get(req["name"])
        if ent is None:
            return -2, b""
        kids = _dec((await ctx.omap_get(
            [f"children.{ent['id']}"])).get(f"children.{ent['id']}")) or []
        if kids:
            return -16, b""  # -EBUSY: clones still reference the snap
        by_name = dict(snaps["by_name"])
        by_name[req["name"]] = {k: v for k, v in ent.items()
                                if k != "protected"}
        # CAS: a concurrent clone re-registering a child bumps nothing in
        # "snaps", but a concurrent snap_add must not be clobbered, and
        # the add_child CAS below makes the child-list check repeatable
        ok, _ = await ctx.omap_cas("snaps", cur_raw, _enc(
            {"seq": snaps["seq"], "by_name": by_name}))
        if ok:
            return 0, b""
    return -11, b""


@register("rbd", "add_child")
async def add_child(ctx, inp: bytes):
    req = _dec(inp)
    key = f"children.{req['snap_id']}"
    for _ in range(16):
        cur = (await ctx.omap_get([key])).get(key)
        kids = _dec(cur) or []
        if req["child"] not in kids:
            kids.append(req["child"])
        ok, _ = await ctx.omap_cas(key, cur, _enc(sorted(kids)))
        if ok:
            return 0, b""
    return -11, b""


@register("rbd", "remove_child")
async def remove_child(ctx, inp: bytes):
    req = _dec(inp)
    key = f"children.{req['snap_id']}"
    for _ in range(16):
        cur = (await ctx.omap_get([key])).get(key)
        kids = _dec(cur) or []
        if req["child"] in kids:
            kids.remove(req["child"])
        ok, _ = await ctx.omap_cas(key, cur, _enc(kids))
        if ok:
            return 0, b""
    return -11, b""


@register("rbd", "get_children")
async def get_children(ctx, inp: bytes):
    req = _dec(inp)
    key = f"children.{req['snap_id']}"
    kids = _dec((await ctx.omap_get([key])).get(key)) or []
    return 0, _enc(kids)


@register("rbd", "set_parent")
async def set_parent(ctx, inp: bytes):
    req = _dec(inp)
    await ctx.omap_set({"parent": _enc({
        "image": req["image"], "snap_id": int(req["snap_id"]),
        "snap_name": req.get("snap_name", ""),
        "overlap": int(req["overlap"]),
    })})
    return 0, b""


@register("rbd", "get_parent")
async def get_parent(ctx, inp: bytes):
    p = _dec((await ctx.omap_get(["parent"])).get("parent"))
    if p is None:
        return -2, b""
    return 0, _enc(p)


@register("rbd", "remove_parent")
async def remove_parent(ctx, inp: bytes):
    await ctx.omap_rm(["parent"])
    return 0, b""
