"""Compressor plugin registry (src/compressor equivalent).

Port of ``ceph_tpu/compressor.py``.

Reference: src/compressor/Compressor.cc:83 Compressor::create with
zlib/snappy/zstd/lz4/brotli plugins loaded through the generic
PluginRegistry (the same dlopen pattern as EC plugins,
src/common/PluginRegistry.cc).  Here: the same factory surface with the
backends available in-image (zlib, bz2, lzma via stdlib; passthrough);
unavailable algorithms raise like a missing plugin would.
"""

from __future__ import annotations

import bz2
import lzma
import zlib
from typing import Dict, Optional


class Compressor:
    name = "none"

    def compress(self, data: bytes) -> bytes:
        raise NotImplementedError

    def decompress(self, data: bytes) -> bytes:
        raise NotImplementedError


class ZlibCompressor(Compressor):
    name = "zlib"

    def __init__(self, level: int = 5):
        self.level = level

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)

    def decompress(self, data: bytes) -> bytes:
        return zlib.decompress(data)


class Bz2Compressor(Compressor):
    name = "bz2"

    def compress(self, data: bytes) -> bytes:
        return bz2.compress(data)

    def decompress(self, data: bytes) -> bytes:
        return bz2.decompress(data)


class LzmaCompressor(Compressor):
    name = "lzma"

    def compress(self, data: bytes) -> bytes:
        return lzma.compress(data)

    def decompress(self, data: bytes) -> bytes:
        return lzma.decompress(data)


class PassthroughCompressor(Compressor):
    name = "none"

    def compress(self, data: bytes) -> bytes:
        return bytes(data)

    def decompress(self, data: bytes) -> bytes:
        return bytes(data)


_REGISTRY: Dict[str, type] = {
    "zlib": ZlibCompressor,
    "bz2": Bz2Compressor,
    "lzma": LzmaCompressor,
    "none": PassthroughCompressor,
}

#: algorithms the reference ships that this image has no backend for
_KNOWN_UNAVAILABLE = {"snappy", "zstd", "lz4", "brotli"}


def create(alg: str) -> Compressor:
    """Compressor::create: factory by algorithm name."""
    cls = _REGISTRY.get(alg)
    if cls is None:
        if alg in _KNOWN_UNAVAILABLE:
            raise ModuleNotFoundError(
                f"compression algorithm {alg} has no backend in this build"
            )
        raise ValueError(f"unknown compression algorithm {alg}")
    return cls()


def get_supported() -> list:
    return sorted(_REGISTRY)
