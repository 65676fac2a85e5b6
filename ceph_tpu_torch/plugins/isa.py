"""isa-equivalent plugin: Intel ISA-L semantics on the shared engines.

Port of ``ceph_tpu/plugins/isa.py``.  Compute runs on the numpy CPU engine
by default; profile key ``backend=cuda`` routes the GF(2^8) products
through the PyTorch engine (``ops/torch_gf.py``, the ``gf2_matrix_w8``
kernel) on the profile's ``device`` (default ``cuda``; ``cpu`` runs the
kernel's plain PyTorch version), as the ``jerasure`` plugin does.
``backend=native`` runs the host's AVX2 kernels
(``ops/native_engine.py``); ``backend=tpu`` is refused with EINVAL.

Mirrors the reference isa plugin (reference: src/erasure-code/isa/
ErasureCodeIsa.{h,cc}, ErasureCodePluginIsa.cc):

* techniques ``reed_sol_van`` (Vandermonde-by-generator, gf_gen_rs_matrix)
  and ``cauchy`` (gf_gen_cauchy1_matrix), both over GF(2^8)/0x11D
  (ceph_tpu/matrices/isa.py);
* parameter guard rails: Vandermonde requires k<=32, m<=4 and m==4 -> k<=21
  (ErasureCodeIsa.cc:322-363);
* per-chunk alignment EC_ISA_ADDRESS_ALIGNMENT=32 (:59-78, :314-318);
* m==1 encodes/decodes via pure XOR (region_xor, :124-126);
* Vandermonde single-erasure with id < k+1 decodes via XOR (:205-215) --
  same bytes as the general path since coding row 0 is all ones;
* decode tables are LRU-cached per erasure signature
  (ErasureCodeIsaTableCache.h:48); here the cached object is the inverted
  row block keyed the same way.
"""

from __future__ import annotations

import errno as _errno
from collections import OrderedDict
from typing import Dict, Iterable, Mapping

import numpy as np

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.matrices import isa as isa_matrices
from ceph_tpu_torch.ops import cpu_engine
from ceph_tpu_torch.ops.gf import gf
from ceph_tpu_torch.plugins import registry as registry_mod
from ceph_tpu_torch.plugins.interface import (
    ErasureCode,
    ErasureCodeError,
    ErasureCodeProfile,
    backend_tpu_error,
)

EC_ISA_ADDRESS_ALIGNMENT = 32


class ErasureCodeIsaTableCache:
    """LRU of decode row-blocks keyed by (matrixtype, k, m, signature)."""

    MAX_ENTRIES = 2516  # ErasureCodeIsaTableCache.h:48

    def __init__(self):
        self._lru: "OrderedDict[tuple, np.ndarray]" = OrderedDict()

    def get(self, key):
        rows = self._lru.get(key)
        if rows is not None:
            self._lru.move_to_end(key)
        return rows

    def put(self, key, rows):
        self._lru[key] = rows
        self._lru.move_to_end(key)
        while len(self._lru) > self.MAX_ENTRIES:
            self._lru.popitem(last=False)


_TABLE_CACHE = ErasureCodeIsaTableCache()


class ErasureCodeIsaDefault(ErasureCode):
    DEFAULT_K = "7"
    DEFAULT_M = "3"

    def __init__(self, matrixtype: str = "reed_sol_van"):
        super().__init__()
        self.technique = matrixtype
        self.k = 0
        self.m = 0
        self.w = 8
        self._backend = "cpu"
        self._device = None
        self.matrix: np.ndarray | None = None  # coding rows only [m, k]
        self.tcache = _TABLE_CACHE

    # -- contract ----------------------------------------------------------

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_alignment(self) -> int:
        return EC_ISA_ADDRESS_ALIGNMENT

    def get_chunk_size(self, object_size: int) -> int:
        alignment = self.get_alignment()
        chunk_size = (object_size + self.k - 1) // self.k
        modulo = chunk_size % alignment
        if modulo:
            chunk_size += alignment - modulo
        return chunk_size

    def init(self, profile: ErasureCodeProfile) -> None:
        profile["technique"] = self.technique
        self.parse(profile)
        self.prepare()
        ErasureCode.init(self, profile)

    def parse(self, profile: ErasureCodeProfile) -> None:
        ErasureCode.parse(self, profile)
        self.k = self.to_int("k", profile, self.DEFAULT_K)
        self.m = self.to_int("m", profile, self.DEFAULT_M)
        self._backend = self.to_string("backend", profile, "cpu")
        if self._backend == "tpu":
            raise backend_tpu_error("isa")
        if self._backend == "cuda":
            self._device = resolve_device(
                self.to_string("device", profile, "cuda"))
        self.sanity_check_k(self.k)
        if self.technique == "reed_sol_van":
            if self.k > 32:
                raise ErasureCodeError(
                    _errno.EINVAL, "Vandermonde: k=%d must be <= 32" % self.k
                )
            if self.m > 4:
                raise ErasureCodeError(
                    _errno.EINVAL, "Vandermonde: m=%d must be <= 4" % self.m
                )
            if self.m == 4 and self.k > 21:
                raise ErasureCodeError(
                    _errno.EINVAL, "Vandermonde: m=4 -> k must be <= 21"
                )

    def prepare(self) -> None:
        if self.technique == "cauchy":
            A = isa_matrices.gen_cauchy1_matrix(self.k, self.m)
        else:
            A = isa_matrices.gen_rs_matrix(self.k, self.m)
        self.matrix = np.ascontiguousarray(A[self.k :, :])

    # -- compute -----------------------------------------------------------

    def _engine(self):
        if self._backend == "cuda":
            from ceph_tpu_torch.ops import torch_gf

            return torch_gf.on_device(self._device)
        if self._backend == "native":
            from ceph_tpu_torch.ops import native_engine

            return native_engine
        return cpu_engine

    def encode_chunks(
        self, want_to_encode: Iterable[int], encoded: Dict[int, np.ndarray]
    ) -> None:
        data = np.stack([encoded[i] for i in range(self.k)])
        if self.m == 1:
            # region_xor fast path (ErasureCodeIsa.cc:124-126)
            coding = np.bitwise_xor.reduce(data, axis=0)[None, :]
        else:
            coding = self._engine().matrix_encode(self.matrix, data, self.w)
        for i in range(self.m):
            encoded[self.k + i][:] = coding[i]

    def decode_chunks(
        self,
        want_to_read: Iterable[int],
        chunks: Mapping[int, np.ndarray],
        decoded: Dict[int, np.ndarray],
    ) -> None:
        have = {i: decoded[i] for i in range(self.k + self.m) if i in chunks}
        erased = [i for i in range(self.k + self.m) if i not in chunks]
        if len(have) < self.k:
            raise ErasureCodeError(_errno.EIO, "not enough chunks to decode")
        blocksize = len(next(iter(have.values())))

        # XOR fast paths: m==1, or Vandermonde single erasure of a chunk
        # that the all-ones first coding row covers (id < k+1)
        if len(erased) == 1 and (
            self.m == 1
            or (self.technique == "reed_sol_van" and erased[0] < self.k + 1)
        ):
            e = erased[0]
            srcs = [i for i in range(self.k + 1) if i != e][: self.k]
            acc = np.zeros(blocksize, dtype=np.uint8)
            for s in srcs:
                acc ^= decoded[s]
            decoded[e][:] = acc
            return

        rec = self._decode_general(have, blocksize)
        for i in erased:
            decoded[i][:] = rec[i]

    def _decode_general(self, have, blocksize):
        """General path with signature-keyed decode-row cache."""
        erased = tuple(
            i for i in range(self.k + self.m) if i not in have
        )
        key = (self.technique, self.k, self.m, erased)
        rows = self.tcache.get(key)
        available = sorted(have.keys())
        sel = available[: self.k]
        if rows is None:
            F = gf(8)
            A = np.zeros((self.k, self.k), dtype=np.uint32)
            for r, cid in enumerate(sel):
                if cid < self.k:
                    A[r, cid] = 1
                else:
                    A[r, :] = self.matrix[cid - self.k, :]
            rows = F.mat_invert(A)
            self.tcache.put(key, rows)
        out = {i: np.asarray(have[i], dtype=np.uint8) for i in available}
        erased_data = [e for e in erased if e < self.k]
        if erased_data:
            survivors = np.stack([out[cid] for cid in sel])
            rec = self._engine().matrix_encode(
                np.ascontiguousarray(rows[erased_data, :]), survivors, 8
            )
            for idx, e in enumerate(erased_data):
                out[e] = rec[idx]
        erased_coding = [e for e in erased if e >= self.k]
        if erased_coding:
            data = np.stack([out[j] for j in range(self.k)])
            sub = np.ascontiguousarray(
                self.matrix[[e - self.k for e in erased_coding], :]
            )
            rec = self._engine().matrix_encode(sub, data, 8)
            for idx, e in enumerate(erased_coding):
                out[e] = rec[idx]
        return out


class ErasureCodePluginIsa(registry_mod.ErasureCodePlugin):
    def factory(self, directory: str, profile: ErasureCodeProfile):
        technique = profile.get("technique") or "reed_sol_van"
        profile["technique"] = technique
        if technique not in ("reed_sol_van", "cauchy"):
            raise ErasureCodeError(
                _errno.ENOENT,
                f"technique={technique} is not a valid coding technique",
            )
        ec = ErasureCodeIsaDefault(technique)
        ec.init(profile)
        return ec


def __erasure_code_version__() -> str:
    from ceph_tpu_torch import __version__

    return __version__


def __erasure_code_init__(name: str, directory: str) -> int:
    registry_mod.instance().add(name, ErasureCodePluginIsa())
    return 0
