"""Minimal XOR example plugin (k=2, m=1) -- test fixture.

Port of ``ceph_tpu/plugins/example.py`` (host XOR; no device work).

Mirrors the reference's example plugin used by registry/unit tests
(reference: src/test/erasure-code/ErasureCodeExample.h,
ErasureCodePluginExample.cc): parity chunk = XOR of the two data chunks.
"""

from __future__ import annotations

import errno as _errno
from typing import Dict, Iterable, Mapping

import numpy as np

from ceph_tpu_torch.plugins import registry as registry_mod
from ceph_tpu_torch.plugins.interface import (
    ErasureCode,
    ErasureCodeError,
    ErasureCodeProfile,
)


class ErasureCodeExample(ErasureCode):
    k = 2
    m = 1

    def init(self, profile: ErasureCodeProfile) -> None:
        self.parse(profile)
        ErasureCode.init(self, profile)

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_chunk_size(self, object_size: int) -> int:
        return (object_size + self.k - 1) // self.k

    def minimum_to_decode_with_cost(self, want_to_read, available):
        # prefer the cheapest k chunks (reference ErasureCodeExample.h)
        if set(want_to_read) <= set(available.keys()):
            ranked = sorted(available.items(), key=lambda kv: kv[1])
            return [c for c, _ in ranked[: self.k]]
        return self._minimum_to_decode(want_to_read, available.keys())

    def encode_chunks(
        self, want_to_encode: Iterable[int], encoded: Dict[int, np.ndarray]
    ) -> None:
        encoded[2][:] = encoded[0] ^ encoded[1]

    def decode_chunks(
        self,
        want_to_read: Iterable[int],
        chunks: Mapping[int, np.ndarray],
        decoded: Dict[int, np.ndarray],
    ) -> None:
        have = sorted(chunks.keys())
        if len(have) < 2:
            raise ErasureCodeError(_errno.EIO, "need 2 of 3 chunks")
        missing = [i for i in range(3) if i not in chunks]
        for i in missing:
            others = [j for j in range(3) if j != i]
            decoded[i][:] = decoded[others[0]] ^ decoded[others[1]]


class ErasureCodePluginExample(registry_mod.ErasureCodePlugin):
    def factory(self, directory: str, profile: ErasureCodeProfile):
        ec = ErasureCodeExample()
        ec.init(profile)
        return ec


def __erasure_code_version__() -> str:
    from ceph_tpu_torch import __version__

    return __version__


def __erasure_code_init__(name: str, directory: str) -> int:
    registry_mod.instance().add(name, ErasureCodePluginExample())
    return 0
