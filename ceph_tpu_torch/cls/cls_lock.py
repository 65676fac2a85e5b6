"""Advisory object locks (reference: src/cls/lock/cls_lock.cc).

Port of ``ceph_tpu/cls/cls_lock.py``; its outputs are the same
``Encoder`` bytes.

Lock state lives in omap under ``lock.<name>``; exclusive acquisition is
an atomic compare-and-swap on the primary-shard OSD, so two racing
clients cannot both hold an exclusive lock.  Shared locks append the
locker under the same key (CAS on the serialized holder list).

Methods: ``lock`` (type exclusive|shared), ``unlock``, ``break_lock``,
``get_info``.  Payloads are encoding-framework tagged dicts.
"""

from __future__ import annotations

from ceph_tpu_torch.cls import register
from ceph_tpu_torch.utils.encoding import Decoder, Encoder


def _dec(inp: bytes) -> dict:
    return Decoder(inp).value() if inp else {}


def _enc(v) -> bytes:
    return Encoder().value(v).bytes()


def _key(name: str) -> str:
    return f"lock.{name}"


@register("lock", "lock")
async def lock(ctx, inp: bytes):
    req = _dec(inp)
    name = req["name"]
    locker = req["locker"]          # e.g. "client.4213" or a cookie
    ltype = req.get("type", "exclusive")
    for _ in range(16):  # CAS retry loop against racing lockers
        cur_raw = (await ctx.omap_get([_key(name)])).get(_key(name))
        cur = Decoder(cur_raw).value() if cur_raw else None
        if cur is None:
            new = {"type": ltype, "lockers": [locker]}
        elif cur["type"] == "shared" and ltype == "shared":
            if locker in cur["lockers"]:
                return 0, b""  # idempotent re-lock
            new = {"type": "shared", "lockers": cur["lockers"] + [locker]}
        elif cur["lockers"] == [locker] and cur["type"] == ltype:
            return 0, b""      # we already hold it
        else:
            return -16, b""    # -EBUSY
        ok, _ = await ctx.omap_cas(_key(name), cur_raw, _enc(new))
        if ok:
            return 0, b""
    return -11, b""  # -EAGAIN: CAS kept losing


@register("lock", "unlock")
async def unlock(ctx, inp: bytes):
    req = _dec(inp)
    name, locker = req["name"], req["locker"]
    for _ in range(16):
        cur_raw = (await ctx.omap_get([_key(name)])).get(_key(name))
        if cur_raw is None:
            return -2, b""  # -ENOENT
        cur = Decoder(cur_raw).value()
        if locker not in cur["lockers"]:
            return -2, b""
        rest = [x for x in cur["lockers"] if x != locker]
        new_raw = None if not rest else _enc(dict(cur, lockers=rest))
        ok, _ = await ctx.omap_cas(_key(name), cur_raw, new_raw)
        if ok:
            return 0, b""
    return -11, b""


@register("lock", "break_lock")
async def break_lock(ctx, inp: bytes):
    """Forcibly remove another client's lock (operator action)."""
    req = _dec(inp)
    cur_raw = (await ctx.omap_get([_key(req["name"])])).get(_key(req["name"]))
    if cur_raw is None:
        return -2, b""
    ok, _ = await ctx.omap_cas(_key(req["name"]), cur_raw, None)
    return (0 if ok else -11), b""


@register("lock", "get_info")
async def get_info(ctx, inp: bytes):
    req = _dec(inp)
    cur_raw = (await ctx.omap_get([_key(req["name"])])).get(_key(req["name"]))
    if cur_raw is None:
        return 0, _enc({"lockers": [], "type": None})
    cur = Decoder(cur_raw).value()
    return 0, _enc(cur)
