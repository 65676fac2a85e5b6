"""shec-equivalent plugin: Shingled Erasure Code.

Port of ``ceph_tpu/plugins/shec.py``.  Compute runs on the numpy CPU
engine by default; profile key ``backend=cuda`` routes the GF(2^w)
products of encode and of the coding-chunk re-encode through the PyTorch
engine (``ops/torch_gf.py``: ``gf2_matrix_w8`` at w=8, ``gf2_matrix_w16``
at w=16) on the profile's ``device`` (default ``cuda``; ``cpu`` runs the
kernels' plain PyTorch versions).  ``backend=native`` is refused (the
port has no native engine).

Mirrors the reference shec plugin (reference: src/erasure-code/shec/
ErasureCodeShec.{h,cc}, ErasureCodePluginShec.cc):

* profile (k, m, c) with guards k<=12, k+m<=20, c<=m<=k
  (ErasureCodeShec.cc:271-342); w in {8,16,32} (bad w falls back to 8);
* technique ``single`` / ``multiple`` (default multiple,
  ErasureCodePluginShec.cc:45-58);
* coding matrix = reed_sol vandermonde matrix with shingle windows zeroed;
  ``multiple`` splits (m, c) into (m1, c1)+(m2, c2) minimizing the
  recovery-efficiency functional shec_calc_recovery_efficiency1
  (ErasureCodeShec.cc:415-524);
* ``minimum_to_decode`` searches parity subsets for the smallest recovery
  set (shec_make_decoding_matrix, :526-718) -- SHEC is not MDS; locality is
  the point: single-chunk recovery touches ~k*c/m chunks, not k.
"""

from __future__ import annotations

import errno as _errno
from typing import Dict, Iterable, List, Mapping, Tuple

import numpy as np

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.matrices import reed_sol
from ceph_tpu_torch.ops import cpu_engine
from ceph_tpu_torch.ops.gf import gf
from ceph_tpu_torch.plugins import registry as registry_mod
from ceph_tpu_torch.plugins.interface import (
    ErasureCode,
    ErasureCodeError,
    ErasureCodeProfile,
)
from ceph_tpu_torch.utils.unported import refuse


def calc_recovery_efficiency1(k: int, m1: int, m2: int, c1: int, c2: int) -> float:
    """Faithful port of shec_calc_recovery_efficiency1."""
    if m1 < c1 or m2 < c2:
        return -1.0
    if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
        return -1.0
    r_eff_k = [100000000] * k
    r_e1 = 0.0
    for mm, cc_ in ((m1, c1), (m2, c2)):
        for rr in range(mm):
            start = ((rr * k) // mm) % k
            end = (((rr + cc_) * k) // mm) % k
            cc = start
            first = True
            while first or cc != end:
                first = False
                r_eff_k[cc] = min(
                    r_eff_k[cc], ((rr + cc_) * k) // mm - (rr * k) // mm
                )
                cc = (cc + 1) % k
            r_e1 += ((rr + cc_) * k) // mm - (rr * k) // mm
    r_e1 += sum(r_eff_k)
    return r_e1 / (k + m1 + m2)


def shec_matrix(k: int, m: int, c: int, w: int, is_single: bool) -> np.ndarray:
    """shec_reedsolomon_coding_matrix (ErasureCodeShec.cc:456-524)."""
    if is_single:
        m1, c1, m2, c2 = 0, 0, m, c
    else:
        c1_best, m1_best, min_r = -1, -1, 100.0
        for c1 in range(c // 2 + 1):
            for m1 in range(m + 1):
                c2, m2 = c - c1, m - m1
                if m1 < c1 or m2 < c2:
                    continue
                if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
                    continue
                if (m1 != 0 and c1 == 0) or (m2 != 0 and c2 == 0):
                    continue
                r = calc_recovery_efficiency1(k, m1, m2, c1, c2)
                if min_r - r > np.finfo(float).eps and r < min_r:
                    min_r, c1_best, m1_best = r, c1, m1
        m1, c1 = m1_best, c1_best
        m2, c2 = m - m1, c - c1

    M = reed_sol.vandermonde_coding_matrix(k, m, w).astype(np.uint32)
    for rr in range(m1):
        end = ((rr * k) // m1) % k
        start = (((rr + c1) * k) // m1) % k
        cc = start
        while cc != end:
            M[rr, cc] = 0
            cc = (cc + 1) % k
    for rr in range(m2):
        end = ((rr * k) // m2) % k
        start = (((rr + c2) * k) // m2) % k
        cc = start
        while cc != end:
            M[m1 + rr, cc] = 0
            cc = (cc + 1) % k
    return M


class ErasureCodeShec(ErasureCode):
    DEFAULT_K, DEFAULT_M, DEFAULT_C, DEFAULT_W = 4, 3, 2, 8

    def __init__(self, technique: str = "multiple"):
        super().__init__()
        self.technique = technique
        self.k = 0
        self.m = 0
        self.c = 0
        self.w = 8
        self._backend = "cpu"
        self._device = None
        self.matrix: np.ndarray | None = None

    # -- contract ----------------------------------------------------------

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_alignment(self) -> int:
        return self.k * self.w * 4  # ErasureCodeShec.cc:266-269

    def get_chunk_size(self, object_size: int) -> int:
        alignment = self.get_alignment()
        tail = object_size % alignment
        padded = object_size + (alignment - tail if tail else 0)
        assert padded % self.k == 0
        return padded // self.k

    def init(self, profile: ErasureCodeProfile) -> None:
        self.parse(profile)
        self.prepare()
        ErasureCode.init(self, profile)

    def parse(self, profile: ErasureCodeProfile) -> None:
        ErasureCode.parse(self, profile)
        has = [n for n in ("k", "m", "c") if profile.get(n)]
        if not has:
            self.k, self.m, self.c = self.DEFAULT_K, self.DEFAULT_M, self.DEFAULT_C
            profile["k"], profile["m"], profile["c"] = "4", "3", "2"
        elif len(has) != 3:
            raise ErasureCodeError(_errno.EINVAL, "(k, m, c) must be chosen")
        else:
            try:
                self.k = int(profile["k"])
                self.m = int(profile["m"])
                self.c = int(profile["c"])
            except ValueError:
                raise ErasureCodeError(_errno.EINVAL, "k/m/c must be integers")
        if self.k <= 0 or self.m <= 0 or self.c <= 0:
            raise ErasureCodeError(_errno.EINVAL, "k, m, c must be positive")
        if self.m < self.c:
            raise ErasureCodeError(_errno.EINVAL, f"c={self.c} must be <= m={self.m}")
        if self.k > 12:
            raise ErasureCodeError(_errno.EINVAL, f"k={self.k} must be <= 12")
        if self.k + self.m > 20:
            raise ErasureCodeError(_errno.EINVAL, "k+m must be <= 20")
        if self.k < self.m:
            raise ErasureCodeError(_errno.EINVAL, f"m={self.m} must be <= k={self.k}")
        w = profile.get("w")
        self.w = self.DEFAULT_W
        if w:
            try:
                wv = int(w)
                if wv in (8, 16, 32):
                    self.w = wv
            except ValueError:
                pass
        profile["w"] = str(self.w)
        self._backend = self.to_string("backend", profile, "cpu")
        if self._backend == "native":
            refuse("shec backend=native", "native")
        if self._backend == "cuda":
            self._device = resolve_device(
                self.to_string("device", profile, "cuda"))

    def prepare(self) -> None:
        self.matrix = shec_matrix(
            self.k, self.m, self.c, self.w, self.technique == "single"
        )

    # -- compute -----------------------------------------------------------

    def _engine(self):
        if self._backend == "cuda":
            from ceph_tpu_torch.ops import torch_gf

            return torch_gf.on_device(self._device)
        return cpu_engine

    def encode_chunks(
        self, want_to_encode: Iterable[int], encoded: Dict[int, np.ndarray]
    ) -> None:
        data = np.stack([encoded[i] for i in range(self.k)])
        coding = self._engine().matrix_encode(self.matrix, data, self.w)
        for i in range(self.m):
            encoded[self.k + i][:] = coding[i]

    # -- minimum-recovery search (shec_make_decoding_matrix) ---------------

    def _search(self, want: List[int], avail: List[int]):
        """Returns (minimum ids, dm_row ids) or raises EIO."""
        k, m = self.k, self.m
        F = gf(self.w)
        want = list(want)
        for i in range(m):
            if want[k + i] and not avail[k + i]:
                for j in range(k):
                    if self.matrix[i, j] > 0:
                        want[j] = 1

        mindup, minp = k + 1, k + 1
        best_rows: List[int] | None = None
        best_cols: List[int] | None = None
        for pp in range(1 << m):
            p = [i for i in range(m) if pp & (1 << i)]
            ek = len(p)
            if ek > minp:
                continue
            if not all(avail[k + pi] for pi in p):
                continue
            tmprow = [0] * (k + m)
            tmpcol = [0] * k
            for i in range(k):
                if want[i] and not avail[i]:
                    tmpcol[i] = 1
            for pi in p:
                tmprow[k + pi] = 1
                for j in range(k):
                    e = int(self.matrix[pi, j])
                    if e != 0:
                        tmpcol[j] = 1
                        if avail[j]:
                            tmprow[j] = 1
            dup_row, dup_col = sum(tmprow), sum(tmpcol)
            if dup_row != dup_col:
                continue
            dup = dup_row
            if dup == 0:
                mindup = 0
                best_rows, best_cols = [], []
                break
            if dup < mindup:
                rows = [i for i in range(k + m) if tmprow[i]]
                cols = [j for j in range(k) if tmpcol[j]]
                A = np.zeros((dup, dup), dtype=np.uint32)
                for r, rid in enumerate(rows):
                    for cidx, cid in enumerate(cols):
                        if rid < k:
                            A[r, cidx] = 1 if rid == cid else 0
                        else:
                            A[r, cidx] = self.matrix[rid - k, cid]
                try:
                    F.mat_invert(A)
                except np.linalg.LinAlgError:
                    continue
                mindup = dup
                best_rows, best_cols = rows, cols
                minp = ek

        if mindup == k + 1:
            raise ErasureCodeError(_errno.EIO, "can't find recover matrix")

        minimum = set(best_rows or [])
        for i in range(k):
            if want[i] and avail[i]:
                minimum.add(i)
        for i in range(m):
            if want[k + i] and avail[k + i] and (k + i) not in minimum:
                for j in range(k):
                    if self.matrix[i, j] > 0 and not want[j]:
                        minimum.add(k + i)
                        break
        return sorted(minimum), best_rows or [], best_cols or []

    def _minimum_to_decode(
        self, want_to_read: Iterable[int], available_chunks: Iterable[int]
    ) -> List[int]:
        km = self.k + self.m
        for ids in (want_to_read, available_chunks):
            for i in ids:
                if i < 0 or i >= km:
                    raise ErasureCodeError(_errno.EINVAL, "chunk id out of range")
        want = [1 if i in set(want_to_read) else 0 for i in range(km)]
        avail = [1 if i in set(available_chunks) else 0 for i in range(km)]
        minimum, _, _ = self._search(want, avail)
        return minimum

    # -- decode ------------------------------------------------------------

    def decode_chunks(
        self,
        want_to_read: Iterable[int],
        chunks: Mapping[int, np.ndarray],
        decoded: Dict[int, np.ndarray],
    ) -> None:
        k, m = self.k, self.m
        F = gf(self.w)
        km = k + m
        avail = [1 if i in chunks else 0 for i in range(km)]
        want = [1 if i in set(want_to_read) or i not in chunks else 0 for i in range(km)]
        _, rows, cols = self._search(want, avail)
        blocksize = len(next(iter(chunks.values())))

        if cols:
            # solve A x = b where x are the unknown data chunks `cols`
            dup = len(rows)
            A = np.zeros((dup, dup), dtype=np.uint32)
            for r, rid in enumerate(rows):
                for cidx, cid in enumerate(cols):
                    A[r, cidx] = (
                        (1 if rid == cid else 0)
                        if rid < k
                        else int(self.matrix[rid - k, cid])
                    )
            inv = F.mat_invert(A)
            # rhs: available chunk minus known-data contributions
            rhs = np.zeros((dup, blocksize), dtype=np.uint8)
            known = [j for j in range(k) if avail[j] and j not in cols]
            for r, rid in enumerate(rows):
                b = np.array(decoded[rid], dtype=np.uint8)
                if rid >= k and known:
                    words = b.view(F.word_dtype).copy()
                    for j in known:
                        cco = int(self.matrix[rid - k, j])
                        if cco:
                            words ^= F.mul_region(
                                cco, decoded[j].view(F.word_dtype)
                            )
                    b = words.view(np.uint8)
                rhs[r] = b
            # x = inv @ rhs over GF(2^w)
            for cidx, cid in enumerate(cols):
                if avail[cid]:
                    continue
                acc = np.zeros(blocksize // (self.w // 8), dtype=F.word_dtype)
                for r in range(dup):
                    cco = int(inv[cidx, r])
                    if cco:
                        acc ^= F.mul_region(cco, rhs[r].view(F.word_dtype))
                decoded[cid][:] = acc.view(np.uint8)

        # re-encode erased coding chunks
        data = np.stack([decoded[j] for j in range(k)])
        for i in range(m):
            if (k + i) not in chunks:
                row = np.ascontiguousarray(self.matrix[i : i + 1, :])
                decoded[k + i][:] = self._engine().matrix_encode(
                    row, data, self.w
                )[0]


class ErasureCodePluginShec(registry_mod.ErasureCodePlugin):
    def factory(self, directory: str, profile: ErasureCodeProfile):
        technique = profile.get("technique") or "multiple"
        profile["technique"] = technique
        if technique not in ("single", "multiple"):
            raise ErasureCodeError(
                _errno.ENOENT,
                f"technique={technique} is not a valid coding technique",
            )
        ec = ErasureCodeShec(technique)
        ec.init(profile)
        return ec


def __erasure_code_version__() -> str:
    from ceph_tpu_torch import __version__

    return __version__


def __erasure_code_init__(name: str, directory: str) -> int:
    registry_mod.instance().add(name, ErasureCodePluginShec())
    return 0
