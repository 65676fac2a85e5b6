"""jerasure-equivalent plugin: the canonical GF(2^w) technique family.

Mirrors the reference plugin's seven techniques and their parameter/alignment
semantics (reference: src/erasure-code/jerasure/ErasureCodeJerasure.{h,cc},
ErasureCodePluginJerasure.cc:34-72 technique dispatch):

    reed_sol_van, reed_sol_r6_op          -- GF(2^w) matrix codes
    cauchy_orig, cauchy_good              -- bitmatrix + packetsize codes
    liberation, blaum_roth, liber8tion    -- RAID-6 bitmatrix codes

Compute runs on the numpy CPU engine by default; profile key
``backend=cuda`` routes encode/decode through the PyTorch GF(2) engine
(ceph_tpu_torch/ops/torch_gf.py) on the profile's ``device`` (default
``cuda``; ``cpu`` runs the plain torch versions), and ``backend=native``
through the host's AVX2 kernels (ceph_tpu_torch/ops/native_engine.py) --
same bytes either way.  ``backend=tpu`` (the JAX package's accelerator) is
refused with EINVAL; any other value runs the numpy engine, as in the
reference.
"""

from __future__ import annotations

import errno as _errno
from typing import Dict, Iterable, Mapping

import numpy as np

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.matrices import cauchy, liberation, reed_sol
from ceph_tpu_torch.matrices.bitmatrix import matrix_to_bitmatrix
from ceph_tpu_torch.ops import cpu_engine
from ceph_tpu_torch.plugins import registry as registry_mod
from ceph_tpu_torch.plugins.interface import (
    ErasureCode,
    ErasureCodeError,
    ErasureCodeProfile,
    backend_tpu_error,
)

LARGEST_VECTOR_WORDSIZE = 16  # ErasureCodeJerasure.cc:30

_PRIMES = {
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67,
    71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149,
    151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211, 223, 227,
    229, 233, 239, 241, 251, 257,
}


class ErasureCodeJerasure(ErasureCode):
    DEFAULT_K = "2"
    DEFAULT_M = "1"
    DEFAULT_W = "8"

    def __init__(self, technique: str):
        super().__init__()
        self.technique = technique
        self.k = 0
        self.m = 0
        self.w = 0
        self.per_chunk_alignment = False
        self._backend = "cpu"
        self._device = None

    # -- contract ----------------------------------------------------------

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_chunk_size(self, object_size: int) -> int:
        """ErasureCodeJerasure.cc:73-96."""
        alignment = self.get_alignment()
        if self.per_chunk_alignment:
            chunk_size = object_size // self.k
            if object_size % self.k:
                chunk_size += 1
            if chunk_size < alignment:
                chunk_size = alignment
            modulo = chunk_size % alignment
            if modulo:
                chunk_size += alignment - modulo
            return chunk_size
        tail = object_size % alignment
        padded = object_size + (alignment - tail if tail else 0)
        assert padded % self.k == 0
        return padded // self.k

    def init(self, profile: ErasureCodeProfile) -> None:
        profile["technique"] = self.technique
        self.parse(profile)
        self.prepare()
        ErasureCode.init(self, profile)

    def parse(self, profile: ErasureCodeProfile) -> None:
        ErasureCode.parse(self, profile)
        self.k = self.to_int("k", profile, self.DEFAULT_K)
        self.m = self.to_int("m", profile, self.DEFAULT_M)
        self.w = self.to_int("w", profile, self.DEFAULT_W)
        self._backend = self.to_string("backend", profile, "cpu")
        if self._backend == "tpu":
            raise backend_tpu_error("jerasure")
        if self._backend == "cuda":
            self._device = resolve_device(
                self.to_string("device", profile, "cuda"))
        if self.chunk_mapping and len(self.chunk_mapping) != self.k + self.m:
            self.chunk_mapping = []
            raise ErasureCodeError(
                _errno.EINVAL,
                f"mapping maps {len(self.chunk_mapping)} chunks != k+m",
            )
        self.sanity_check_k(self.k)

    def encode_chunks(
        self, want_to_encode: Iterable[int], encoded: Dict[int, np.ndarray]
    ) -> None:
        data = np.stack([encoded[i] for i in range(self.k)])
        coding = self.jerasure_encode(data)
        for i in range(self.m):
            encoded[self.k + i][:] = coding[i]

    def decode_chunks(
        self,
        want_to_read: Iterable[int],
        chunks: Mapping[int, np.ndarray],
        decoded: Dict[int, np.ndarray],
    ) -> None:
        have = {
            i: decoded[i] for i in range(self.k + self.m) if i in chunks
        }
        if len(have) < self.k:
            raise ErasureCodeError(_errno.EIO, "not enough chunks to decode")
        recovered = self.jerasure_decode(have, len(next(iter(have.values()))))
        for i in range(self.k + self.m):
            if i not in chunks:
                decoded[i][:] = recovered[i]

    # -- technique hooks ---------------------------------------------------

    def prepare(self) -> None:
        raise NotImplementedError

    def get_alignment(self) -> int:
        raise NotImplementedError

    def jerasure_encode(self, data: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def jerasure_decode(
        self, have: Dict[int, np.ndarray], blocksize: int
    ) -> Dict[int, np.ndarray]:
        raise NotImplementedError

    @staticmethod
    def is_prime(v: int) -> bool:
        return v in _PRIMES

    # -- backend dispatch --------------------------------------------------

    def _engine(self):
        if self._backend == "cuda":
            from ceph_tpu_torch.ops import torch_gf

            return torch_gf.on_device(self._device)
        if self._backend == "native":
            from ceph_tpu_torch.ops import native_engine

            return native_engine
        return None  # numpy/CPU path


class _MatrixCode(ErasureCodeJerasure):
    """Shared implementation for the plain-matrix techniques."""

    def __init__(self, technique: str):
        super().__init__(technique)
        self.matrix: np.ndarray | None = None

    def get_alignment(self) -> int:
        if self.per_chunk_alignment:
            return self.w * LARGEST_VECTOR_WORDSIZE
        alignment = self.k * self.w * 4
        if (self.w * 4) % LARGEST_VECTOR_WORDSIZE:
            alignment = self.k * self.w * LARGEST_VECTOR_WORDSIZE
        return alignment

    def jerasure_encode(self, data: np.ndarray) -> np.ndarray:
        eng = self._engine()
        if eng is not None:
            return eng.matrix_encode(self.matrix, data, self.w)
        return cpu_engine.matrix_encode(self.matrix, data, self.w)

    def jerasure_decode(self, have, blocksize):
        eng = self._engine()
        if eng is not None:
            return eng.matrix_decode(
                self.matrix, have, self.k, self.m, self.w, blocksize
            )
        return cpu_engine.matrix_decode(
            self.matrix, have, self.k, self.m, self.w, blocksize
        )


class ErasureCodeJerasureReedSolomonVandermonde(_MatrixCode):
    DEFAULT_K = "7"
    DEFAULT_M = "3"
    DEFAULT_W = "8"

    def __init__(self):
        super().__init__("reed_sol_van")

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        if self.w not in (8, 16, 32):
            profile["w"] = "8"
            self.w = 8
            raise ErasureCodeError(
                _errno.EINVAL, "w must be one of {8, 16, 32}"
            )
        self.per_chunk_alignment = self.to_bool(
            "jerasure-per-chunk-alignment", profile, "false"
        )

    def prepare(self) -> None:
        self.matrix = reed_sol.vandermonde_coding_matrix(self.k, self.m, self.w)


class ErasureCodeJerasureReedSolomonRAID6(_MatrixCode):
    DEFAULT_K = "7"
    DEFAULT_W = "8"

    def __init__(self):
        super().__init__("reed_sol_r6_op")

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        profile.pop("m", None)
        profile["m"] = "2"
        self.m = 2
        if self.w not in (8, 16, 32):
            profile["w"] = "8"
            self.w = 8
            raise ErasureCodeError(
                _errno.EINVAL, "w must be one of {8, 16, 32}"
            )

    def prepare(self) -> None:
        self.matrix = reed_sol.r6_coding_matrix(self.k, self.w)


class _BitmatrixCode(ErasureCodeJerasure):
    """Shared implementation for packetized bitmatrix techniques."""

    DEFAULT_PACKETSIZE = "2048"

    def __init__(self, technique: str):
        super().__init__(technique)
        self.packetsize = 0
        self.bitmatrix: np.ndarray | None = None

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        self.packetsize = self.to_int(
            "packetsize", profile, self.DEFAULT_PACKETSIZE
        )

    def jerasure_encode(self, data: np.ndarray) -> np.ndarray:
        eng = self._engine()
        if eng is not None:
            return eng.bitmatrix_encode(
                self.bitmatrix, data, self.w, self.packetsize
            )
        return cpu_engine.bitmatrix_encode(
            self.bitmatrix, data, self.w, self.packetsize
        )

    def jerasure_decode(self, have, blocksize):
        eng = self._engine()
        if eng is not None:
            return eng.bitmatrix_decode(
                self.bitmatrix, have, self.k, self.m, self.w, blocksize,
                self.packetsize,
            )
        return cpu_engine.bitmatrix_decode(
            self.bitmatrix, have, self.k, self.m, self.w, blocksize,
            self.packetsize,
        )


class ErasureCodeJerasureCauchy(_BitmatrixCode):
    DEFAULT_K = "7"
    DEFAULT_M = "3"
    DEFAULT_W = "8"

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        self.per_chunk_alignment = self.to_bool(
            "jerasure-per-chunk-alignment", profile, "false"
        )

    def get_alignment(self) -> int:
        """ErasureCodeJerasure.cc:272-286."""
        if self.per_chunk_alignment:
            alignment = self.w * self.packetsize
            modulo = alignment % LARGEST_VECTOR_WORDSIZE
            if modulo:
                alignment += LARGEST_VECTOR_WORDSIZE - modulo
            return alignment
        alignment = self.k * self.w * self.packetsize * 4
        if (self.w * self.packetsize * 4) % LARGEST_VECTOR_WORDSIZE:
            alignment = self.k * self.w * self.packetsize * LARGEST_VECTOR_WORDSIZE
        return alignment

    def prepare_schedule(self, matrix: np.ndarray) -> None:
        self.bitmatrix = matrix_to_bitmatrix(matrix, self.w)


class ErasureCodeJerasureCauchyOrig(ErasureCodeJerasureCauchy):
    def __init__(self):
        super().__init__("cauchy_orig")

    def prepare(self) -> None:
        self.prepare_schedule(
            cauchy.original_coding_matrix(self.k, self.m, self.w)
        )


class ErasureCodeJerasureCauchyGood(ErasureCodeJerasureCauchy):
    def __init__(self):
        super().__init__("cauchy_good")

    def prepare(self) -> None:
        self.prepare_schedule(
            cauchy.good_general_coding_matrix(self.k, self.m, self.w)
        )


class ErasureCodeJerasureLiberation(_BitmatrixCode):
    DEFAULT_K = "2"
    DEFAULT_M = "2"
    DEFAULT_W = "7"

    def __init__(self, technique: str = "liberation"):
        super().__init__(technique)

    def get_alignment(self) -> int:
        alignment = self.k * self.w * self.packetsize * 4
        if (self.w * self.packetsize * 4) % LARGEST_VECTOR_WORDSIZE:
            alignment = self.k * self.w * self.packetsize * LARGEST_VECTOR_WORDSIZE
        return alignment

    def check_k(self) -> bool:
        return self.k <= self.w

    def check_w(self) -> bool:
        return self.w > 2 and self.is_prime(self.w)

    def check_packetsize(self) -> bool:
        return self.packetsize > 0 and self.packetsize % 4 == 0

    def revert_to_default(self, profile: ErasureCodeProfile) -> None:
        profile["k"] = self.DEFAULT_K
        profile["w"] = self.DEFAULT_W
        profile["packetsize"] = self.DEFAULT_PACKETSIZE
        self.k = int(self.DEFAULT_K)
        self.w = int(self.DEFAULT_W)
        self.packetsize = int(self.DEFAULT_PACKETSIZE)

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        self.m = 2
        profile["m"] = "2"
        if not (self.check_k() and self.check_w() and self.check_packetsize()):
            self.revert_to_default(profile)
            raise ErasureCodeError(
                _errno.EINVAL,
                "invalid liberation parameters; reverted to defaults",
            )

    def prepare(self) -> None:
        self.bitmatrix = liberation.liberation_coding_bitmatrix(self.k, self.w)


class ErasureCodeJerasureBlaumRoth(ErasureCodeJerasureLiberation):
    def __init__(self):
        super().__init__("blaum_roth")

    def check_w(self) -> bool:
        # w=7 tolerated for backward compat (ErasureCodeJerasure.cc:453-466)
        if self.w == 7:
            return True
        return self.w > 2 and self.is_prime(self.w + 1)

    def prepare(self) -> None:
        self.bitmatrix = liberation.blaum_roth_coding_bitmatrix(self.k, self.w)


class ErasureCodeJerasureLiber8tion(ErasureCodeJerasureLiberation):
    DEFAULT_K = "2"
    DEFAULT_M = "2"
    DEFAULT_W = "8"

    def __init__(self):
        super().__init__("liber8tion")

    def parse(self, profile: ErasureCodeProfile) -> None:
        _BitmatrixCode.parse(self, profile)
        profile["m"] = "2"
        self.m = 2
        profile["w"] = "8"
        self.w = 8
        if not (self.check_k() and self.packetsize > 0):
            self.revert_to_default(profile)
            raise ErasureCodeError(
                _errno.EINVAL,
                "invalid liber8tion parameters; reverted to defaults",
            )

    def prepare(self) -> None:
        self.bitmatrix = liberation.liber8tion_coding_bitmatrix(self.k)


TECHNIQUES = {
    "reed_sol_van": ErasureCodeJerasureReedSolomonVandermonde,
    "reed_sol_r6_op": ErasureCodeJerasureReedSolomonRAID6,
    "cauchy_orig": ErasureCodeJerasureCauchyOrig,
    "cauchy_good": ErasureCodeJerasureCauchyGood,
    "liberation": ErasureCodeJerasureLiberation,
    "blaum_roth": ErasureCodeJerasureBlaumRoth,
    "liber8tion": ErasureCodeJerasureLiber8tion,
}


class ErasureCodePluginJerasure(registry_mod.ErasureCodePlugin):
    def factory(self, directory: str, profile: ErasureCodeProfile):
        technique = profile.get("technique", "reed_sol_van")
        profile["technique"] = technique
        cls = TECHNIQUES.get(technique)
        if cls is None:
            raise ErasureCodeError(
                _errno.ENOENT, f"technique={technique} is not a valid technique"
            )
        ec = cls()
        ec.init(profile)
        return ec


def __erasure_code_version__() -> str:
    from ceph_tpu_torch import __version__

    return __version__


def __erasure_code_init__(name: str, directory: str) -> int:
    registry_mod.instance().add(name, ErasureCodePluginJerasure())
    return 0
