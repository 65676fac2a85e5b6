"""Robert Jenkins 32-bit mix hash, as used by CRUSH.

Port of ``ceph_tpu/crush/hash.py``.

Reference: src/crush/hash.c (crush_hash32_rjenkins1 .. _5).  The mix is the
public-domain Jenkins "evahash" 96-bit mix; the seed constant and the
argument schedule match the reference so that placements computed by this
framework are stable in the same way the reference's are.

All entry points accept plain ints or numpy uint32 arrays (any one argument
may be an array; scalars broadcast), enabling vectorized straw2 draws over a
whole bucket in one shot.
"""

from __future__ import annotations

from typing import Union

import numpy as np

_SEED = np.uint32(1315423911)
_M32 = 0xFFFFFFFF

ArrayOrInt = Union[int, np.ndarray]


def _mix(a, b, c):
    """One Jenkins 96-bit mix round over uint32 lanes (vectorized)."""
    a = (a - b) & _M32
    a = (a - c) & _M32
    a = a ^ (c >> 13)
    b = (b - c) & _M32
    b = (b - a) & _M32
    b = (b ^ (a << 8)) & _M32
    c = (c - a) & _M32
    c = (c - b) & _M32
    c = c ^ (b >> 13)
    a = (a - b) & _M32
    a = (a - c) & _M32
    a = a ^ (c >> 12)
    b = (b - c) & _M32
    b = (b - a) & _M32
    b = (b ^ (a << 16)) & _M32
    c = (c - a) & _M32
    c = (c - b) & _M32
    c = c ^ (b >> 5)
    a = (a - b) & _M32
    a = (a - c) & _M32
    a = a ^ (c >> 3)
    b = (b - c) & _M32
    b = (b - a) & _M32
    b = (b ^ (a << 10)) & _M32
    c = (c - a) & _M32
    c = (c - b) & _M32
    c = c ^ (b >> 15)
    return a, b, c


def _u32(v: ArrayOrInt):
    if isinstance(v, np.ndarray):
        return v.astype(np.uint64) & _M32
    return int(v) & _M32


def crush_hash32(a: ArrayOrInt) -> ArrayOrInt:
    a = _u32(a)
    h = int(_SEED) ^ a
    b = a
    x, y = 231232, 1232
    b, x, h = _mix(b, x, h)
    y, a, h = _mix(y, a, h)
    return h


def crush_hash32_2(a: ArrayOrInt, b: ArrayOrInt) -> ArrayOrInt:
    a, b = _u32(a), _u32(b)
    h = int(_SEED) ^ a ^ b
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def crush_hash32_4(a: ArrayOrInt, b: ArrayOrInt, c: ArrayOrInt,
                   d: ArrayOrInt) -> ArrayOrInt:
    """4-argument schedule (hash.c crush_hash32_rjenkins1_4); used by
    the tree bucket's per-node draws."""
    a, b, c, d = _u32(a), _u32(b), _u32(c), _u32(d)
    h = int(_SEED) ^ a ^ b ^ c ^ d
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, x, h)
    y, b, h = _mix(y, b, h)
    c, x, h = _mix(c, x, h)
    y, d, h = _mix(y, d, h)
    return h


def crush_hash32_3(a: ArrayOrInt, b: ArrayOrInt, c: ArrayOrInt) -> ArrayOrInt:
    a, b, c = _u32(a), _u32(b), _u32(c)
    h = int(_SEED) ^ a ^ b ^ c
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h
