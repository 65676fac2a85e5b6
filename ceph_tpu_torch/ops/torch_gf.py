"""PyTorch GF(2^w) codec engine: bit-sliced GF(2) products.

Port of ``ceph_tpu/ops/xla_gf.py``.  Every jerasure code -- matrix codes over
GF(2^w) words and packetized bitmatrix codes -- is a linear map over GF(2):

    parity_bits = (B @ data_bits) mod 2

with B the (m*w) x (k*w) bitmatrix.  This module holds the plain PyTorch
versions of the reference's three XLA programs (``_encode_words``,
``_encode_bytes``, ``_encode_packet_bits``) and the numpy-in/numpy-out
engine API the ``jerasure`` plugin calls with ``backend=cuda``
(``matrix_encode``/``matrix_decode``/``bitmatrix_encode``/
``bitmatrix_decode``).  The engine API dispatches to the CUDA kernels of
``ops/cuda_gf.py`` where their lane layout fits, as the reference does to
its Pallas kernels on a TPU (``xla_gf._pallas_ok``); their wrappers run the
plain versions for CPU tensors.

PyTorch has no arithmetic on uint16/uint32, so the words program takes its
w-bit words as the little-endian bytes that hold them.
"""

from __future__ import annotations

import functools
import hashlib
import threading
import types
from collections import OrderedDict

import numpy as np
import torch

from ceph_tpu_torch.analysis import residency
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.matrices.bitmatrix import (
    matrix_to_bitmatrix,
    survivor_decode_bitmatrix,
)
from ceph_tpu_torch.ops.gf import gf

# ---------------------------------------------------------------------------
# the plain programs
# ---------------------------------------------------------------------------


def _unpack_bits(data: torch.Tensor) -> torch.Tensor:
    """uint8 [..., n] -> uint8 [..., n, 8] bit planes, LSB first."""
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    return (data.unsqueeze(-1) >> shifts) & 1


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint8 0/1 [..., 8] -> uint8 [...], LSB first."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return (bits << shifts).sum(-1).to(torch.uint8).contiguous()


def _gf2_product(B: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """(B @ bits) mod 2 for 0/1 operands -> uint8 0/1.

    Computed in float64, which is exact: every sum is at most
    ``B.shape[1]`` <= 2^53 (integer products do not run on CUDA).  No
    reduced-precision mode applies to float64 products, so the result does
    not depend on process-global flags such as
    ``torch.backends.cuda.matmul.allow_tf32``, which another thread may set.
    """
    acc = B.to(torch.float64) @ bits.to(torch.float64)
    return (acc.to(torch.int32) & 1).to(torch.uint8)


def _encode_words(B: torch.Tensor, data: torch.Tensor, w: int) -> torch.Tensor:
    """[R, k*w] bitmatrix x [k, N] bytes of LE w-bit words -> [R//w, N] bytes.

    Unpack word bit-planes -> GF(2) product -> repack (``xla_gf.py:46``).
    """
    k, N = data.shape
    n = N // (w // 8)
    # bit s of word q of chunk j is bit s % 8 of byte q*(w/8) + s//8
    bits = _unpack_bits(data).reshape(k, n, w).transpose(1, 2)
    obits = _gf2_product(B, bits.reshape(k * w, n))
    m = obits.shape[0] // w
    return _pack_bits(obits.reshape(m, w, n).transpose(1, 2).reshape(m, N, 8))


def gf8_row_tables(matrix: np.ndarray) -> np.ndarray:
    """[R, k] GF(2^8) coding matrix -> [R, k, 256] uint8 row-times-value
    lookup tables (``tab[r, c, v] == matrix[r, c] * v`` in GF(2^8))."""
    m = np.asarray(matrix, dtype=np.uint32) & 0xFF
    return np.asarray(gf(8).mul_table, dtype=np.uint8)[m]


def _encode_bytes(tab: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """[R, k, 256] GF(2^8) row tables x [k, n] bytes -> [R, n] bytes: one
    table gather per (row, chunk) pair, XOR-folded over k
    (``xla_gf.py:91``)."""
    out = tab[:, 0, :][:, data[0].long()]
    for c in range(1, tab.shape[1]):
        out = out ^ tab[:, c, :][:, data[c].long()]
    return out


def _encode_packet_bits(B: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """[R, C] bitmatrix x [C, n] packet-row bytes -> [R, n] bytes: 8
    independent GF(2) systems, one per bit plane (``xla_gf.py:114``)."""
    c, n = rows.shape
    obits = _gf2_product(B, _unpack_bits(rows).reshape(c, n * 8))
    return _pack_bits(obits.reshape(obits.shape[0], n, 8))


# ---------------------------------------------------------------------------
# uploaded coding matrices
# ---------------------------------------------------------------------------

_MATRIX_CACHE: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
_MATRIX_LOCK = threading.Lock()
_MATRIX_CACHE_ENTRIES = 256


def _device_matrix(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Device copy of a call-invariant coding matrix, cached by content so
    callers that loop the engine per stripe upload it once."""
    a = np.ascontiguousarray(arr)
    key = (a.shape, str(a.dtype), str(device),
           hashlib.blake2b(a, digest_size=16).digest())
    with _MATRIX_LOCK:
        hit = _MATRIX_CACHE.get(key)
        if hit is not None:
            _MATRIX_CACHE.move_to_end(key)
            return hit
    d = residency.device_put(a, device)
    with _MATRIX_LOCK:
        _MATRIX_CACHE[key] = d
        while len(_MATRIX_CACHE) > _MATRIX_CACHE_ENTRIES:
            _MATRIX_CACHE.popitem(last=False)
    return d


@functools.lru_cache(maxsize=256)
def _bitmatrix_cached(raw: bytes, shape: tuple, w: int) -> np.ndarray:
    return matrix_to_bitmatrix(
        np.frombuffer(raw, dtype=np.uint32).reshape(shape), w)


def _bitmatrix_of(matrix: np.ndarray, w: int) -> np.ndarray:
    m = np.ascontiguousarray(matrix, dtype=np.uint32)
    return _bitmatrix_cached(m.tobytes(), m.shape, w)


# ---------------------------------------------------------------------------
# matrix codes (w-bit word semantics, same bytes as cpu_engine.matrix_encode)
# ---------------------------------------------------------------------------


def matrix_encode(matrix: np.ndarray, data: np.ndarray, w: int,
                  device="cuda") -> np.ndarray:
    """data: [k, size] uint8 -> coding [m, size] uint8 (device compute)."""
    from ceph_tpu_torch.ops import cuda_gf

    dev = resolve_device(device)
    m, k = matrix.shape
    size = data.shape[1]
    assert size % (w // 8) == 0
    B = _bitmatrix_of(matrix, w)
    data = np.ascontiguousarray(data)
    if w in (8, 16) and size % cuda_gf.LANE_BYTES == 0:
        if w == 8:
            prep, kern = cuda_gf.prep_matrix_w8, cuda_gf.matrix_encode_w8
        else:
            prep, kern = cuda_gf.prep_matrix_w16, cuda_gf.matrix_encode_w16
        # nibble tables (w=8 and w=16), made from B for encode and for
        # every decode matrix alike
        operand = _device_matrix(prep(B, k), dev)
        d32 = residency.device_put(data.view(np.int32), dev)
        return residency.device_get(kern(operand, d32, k, m)).view(np.uint8)
    out = _encode_words(_device_matrix(B, dev),
                        residency.device_put(data, dev), w)
    return residency.device_get(out)


def matrix_decode(matrix: np.ndarray, chunks: dict, k: int, m: int, w: int,
                  size: int, device="cuda") -> dict:
    """Recover erased chunks; host inverts the k x k system, device
    products."""
    F = gf(w)
    available = sorted(chunks.keys())
    erased = [i for i in range(k + m) if i not in chunks]
    if not erased:
        return dict(chunks)
    if len(available) < k:
        raise ValueError("not enough chunks to decode")
    out = {i: np.asarray(chunks[i], dtype=np.uint8) for i in available}

    erased_data = [e for e in erased if e < k]
    if erased_data:
        sel = available[:k]
        A = np.zeros((k, k), dtype=np.uint32)
        for r, cid in enumerate(sel):
            if cid < k:
                A[r, cid] = 1
            else:
                A[r, :] = matrix[cid - k, :]
        inv = F.mat_invert(A)
        survivors = np.stack([out[cid] for cid in sel])
        rec = matrix_encode(inv[erased_data, :], survivors, w, device)
        for idx, e in enumerate(erased_data):
            out[e] = rec[idx]

    erased_coding = [e for e in erased if e >= k]
    if erased_coding:
        data = np.stack([out[j] for j in range(k)])
        rows = matrix[[e - k for e in erased_coding], :]
        rec = matrix_encode(rows, data, w, device)
        for idx, e in enumerate(erased_coding):
            out[e] = rec[idx]
    return out


# ---------------------------------------------------------------------------
# bitmatrix (packetized) codes
# ---------------------------------------------------------------------------


def _to_packet_rows(data: np.ndarray, w: int, packetsize: int) -> np.ndarray:
    """[k, size] bytes -> [k*w, S*packetsize] packet rows."""
    k, size = data.shape
    assert size % (w * packetsize) == 0
    s = size // (w * packetsize)
    return (
        data.reshape(k, s, w, packetsize)
        .transpose(0, 2, 1, 3)
        .reshape(k * w, s * packetsize)
    )


def _from_packet_rows(rows: np.ndarray, w: int, packetsize: int) -> np.ndarray:
    nw, n = rows.shape
    m = nw // w
    s = n // packetsize
    return (
        rows.reshape(m, w, s, packetsize)
        .transpose(0, 2, 1, 3)
        .reshape(m, s * w * packetsize)
    )


def _encode_packets(B: np.ndarray, rows: np.ndarray,
                    device: torch.device) -> np.ndarray:
    from ceph_tpu_torch.ops import cuda_gf

    rows = np.ascontiguousarray(rows)
    if rows.shape[1] % cuda_gf.LANE_BYTES == 0:
        # the ones of each row of B (an encode or a decode bitmatrix)
        lists = _device_matrix(cuda_gf.prep_packet(B), device)
        r32 = residency.device_put(rows.view(np.int32), device)
        out = cuda_gf.packet_encode(lists, r32, B.shape[0])
        return residency.device_get(out).view(np.uint8)
    out = _encode_packet_bits(_device_matrix(B, device),
                              residency.device_put(rows, device))
    return residency.device_get(out)


def bitmatrix_encode(bitmatrix: np.ndarray, data: np.ndarray, w: int,
                     packetsize: int, device="cuda") -> np.ndarray:
    dev = resolve_device(device)
    rows = _to_packet_rows(np.ascontiguousarray(data), w, packetsize)
    return _from_packet_rows(_encode_packets(bitmatrix, rows, dev), w,
                             packetsize)


def bitmatrix_decode(bitmatrix: np.ndarray, chunks: dict, k: int, m: int,
                     w: int, size: int, packetsize: int,
                     device="cuda") -> dict:
    dev = resolve_device(device)
    available = sorted(chunks.keys())
    erased = [i for i in range(k + m) if i not in chunks]
    if not erased:
        return dict(chunks)
    if len(available) < k:
        raise ValueError("not enough chunks to decode")
    out = {i: np.asarray(chunks[i], dtype=np.uint8) for i in available}

    erased_data = [e for e in erased if e < k]
    if erased_data:
        sel = available[:k]
        rec_rows = survivor_decode_bitmatrix(bitmatrix, k, w, sel,
                                             erased_data)
        survivors = np.stack([out[cid] for cid in sel])
        srows = _to_packet_rows(survivors, w, packetsize)
        rec = _from_packet_rows(_encode_packets(rec_rows, srows, dev), w,
                                packetsize)
        for idx, e in enumerate(erased_data):
            out[e] = rec[idx]

    erased_coding = [e for e in erased if e >= k]
    if erased_coding:
        data = np.stack([out[j] for j in range(k)])
        rows = np.concatenate(
            [bitmatrix[(e - k) * w:(e - k + 1) * w, :] for e in erased_coding]
        )
        rec = bitmatrix_encode(rows, data, w, packetsize, dev)
        for idx, e in enumerate(erased_coding):
            out[e] = rec[idx]
    return out


def on_device(device) -> types.SimpleNamespace:
    """The engine API bound to one device (what ``jerasure._engine()``
    returns for ``backend=cuda``)."""
    dev = resolve_device(device)
    return types.SimpleNamespace(
        matrix_encode=functools.partial(matrix_encode, device=dev),
        matrix_decode=functools.partial(matrix_decode, device=dev),
        bitmatrix_encode=functools.partial(bitmatrix_encode, device=dev),
        bitmatrix_decode=functools.partial(bitmatrix_decode, device=dev),
    )
