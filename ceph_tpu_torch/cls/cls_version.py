"""Object user-version class (reference: src/cls/version/cls_version.cc --
RGW uses it for conditional bucket-index updates).

Port of ``ceph_tpu/cls/cls_version.py``."""

from __future__ import annotations

from ceph_tpu_torch.cls import register
from ceph_tpu_torch.utils.encoding import Decoder, Encoder

_KEY = "user_version"


def _enc(v) -> bytes:
    return Encoder().value(v).bytes()


def _dec(b):
    return Decoder(b).value() if b else None


@register("version", "set")
async def set_version(ctx, inp: bytes):
    req = _dec(inp) or {}
    await ctx.omap_set({_KEY: _enc(int(req["ver"]))})
    return 0, b""


@register("version", "inc")
async def inc_version(ctx, inp: bytes):
    for _ in range(16):
        cur_raw = (await ctx.omap_get([_KEY])).get(_KEY)
        cur = _dec(cur_raw) or 0
        ok, _ = await ctx.omap_cas(_KEY, cur_raw, _enc(cur + 1))
        if ok:
            return 0, _enc(cur + 1)
    return -11, b""


@register("version", "get")
async def get_version(ctx, inp: bytes):
    cur_raw = (await ctx.omap_get([_KEY])).get(_KEY)
    return 0, _enc(_dec(cur_raw) or 0)


@register("version", "check")
async def check_version(ctx, inp: bytes):
    """-ECANCELED unless the stored version matches (conditional-op guard)."""
    req = _dec(inp) or {}
    cur_raw = (await ctx.omap_get([_KEY])).get(_KEY)
    if (_dec(cur_raw) or 0) != int(req["ver"]):
        return -125, b""  # -ECANCELED
    return 0, b""
