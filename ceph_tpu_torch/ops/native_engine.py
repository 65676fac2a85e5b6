"""cpu_engine-compatible adapter over the native C++ kernels.

Port of ``ceph_tpu/ops/native_engine.py``.  Selected with profile key
``backend=native`` (jerasure, isa, shec); the AVX2 kernels of
``native/gf_kernels.cpp`` handle the bulk region math on the host (the role
of jerasure/isa-l SIMD in the reference), host matrix prep/inversion stays
in numpy/gf.  Matrix codes at w=8 and every packet code run the kernels;
matrix codes at other widths take the numpy engine, as in the reference.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.matrices.bitmatrix import invert_bitmatrix
from ceph_tpu_torch.native import gf_native
from ceph_tpu_torch.ops import cpu_engine
from ceph_tpu_torch.ops.gf import gf


def matrix_encode(matrix: np.ndarray, data: np.ndarray, w: int) -> np.ndarray:
    if w != 8:
        return cpu_engine.matrix_encode(matrix, data, w)
    return gf_native.matrix_encode(matrix, data)


def matrix_decode(matrix, chunks, k, m, w, size):
    if w != 8:
        return cpu_engine.matrix_decode(matrix, chunks, k, m, w, size)
    F = gf(8)
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
        rec = gf_native.matrix_encode(inv[erased_data, :], survivors)
        for idx, e in enumerate(erased_data):
            out[e] = rec[idx]
    erased_coding = [e for e in erased if e >= k]
    if erased_coding:
        data = np.stack([out[j] for j in range(k)])
        rec = gf_native.matrix_encode(
            matrix[[e - k for e in erased_coding], :], data
        )
        for idx, e in enumerate(erased_coding):
            out[e] = rec[idx]
    return out


def bitmatrix_encode(
    bitmatrix: np.ndarray, data: np.ndarray, w: int, packetsize: int
) -> np.ndarray:
    rows = cpu_engine._to_packet_rows(
        np.ascontiguousarray(data), w, packetsize
    ).reshape(data.shape[0] * w, -1)
    out = gf_native.bitmatrix_packet_encode(bitmatrix, rows)
    s = data.shape[1] // (w * packetsize)
    return cpu_engine._from_packet_rows(
        out.reshape(out.shape[0], s, packetsize), w, packetsize
    )


def bitmatrix_decode(bitmatrix, chunks, k, m, w, size, packetsize):
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
        A = np.zeros((k * w, k * w), dtype=np.uint8)
        for r, cid in enumerate(sel):
            if cid < k:
                A[r * w : (r + 1) * w, cid * w : (cid + 1) * w] = np.eye(
                    w, dtype=np.uint8
                )
            else:
                A[r * w : (r + 1) * w, :] = bitmatrix[
                    (cid - k) * w : (cid - k + 1) * w, :
                ]
        inv = invert_bitmatrix(A)
        rec_rows = np.concatenate(
            [inv[e * w : (e + 1) * w, :] for e in erased_data]
        )
        survivors = np.stack([out[cid] for cid in sel])
        srows = cpu_engine._to_packet_rows(survivors, w, packetsize).reshape(
            k * w, -1
        )
        rec = gf_native.bitmatrix_packet_encode(rec_rows, srows)
        s = size // (w * packetsize)
        rec = cpu_engine._from_packet_rows(
            rec.reshape(rec.shape[0], s, packetsize), w, packetsize
        )
        for idx, e in enumerate(erased_data):
            out[e] = rec[idx]
    erased_coding = [e for e in erased if e >= k]
    if erased_coding:
        data = np.stack([out[j] for j in range(k)])
        rows = np.concatenate(
            [bitmatrix[(e - k) * w : (e - k + 1) * w, :] for e in erased_coding]
        )
        rec = bitmatrix_encode(rows, data, w, packetsize)
        for idx, e in enumerate(erased_coding):
            out[e] = rec[idx]
    return out
