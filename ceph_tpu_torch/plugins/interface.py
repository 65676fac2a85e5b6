"""Erasure-code codec contract and shared base class.

Python rendering of the reference's pure-virtual codec contract
(reference: src/erasure-code/ErasureCodeInterface.h:170-464) and the shared
base class logic (src/erasure-code/ErasureCode.{h,cc}): profile parsing,
chunk-mapping permutation, padding/preparation (`encode_prepare`), generic
encode/decode driving `encode_chunks`/`decode_chunks`, and the default
`minimum_to_decode` (want-if-available else first k available, with
(offset, count) sub-chunk ranges).

Chunks are numpy uint8 arrays; `ErasureCodeError` carries the reference's
-errno convention in `.errno`.
"""

from __future__ import annotations

import errno as _errno
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

import numpy as np

ErasureCodeProfile = Dict[str, str]

#: alignment every prepared chunk honors (reference ErasureCode.cc:29;
#: 32 is also a multiple of the kernels' 16-byte vector loads)
SIMD_ALIGN = 32


class ErasureCodeError(Exception):
    """Codec error carrying a negative errno like the reference's int codes."""

    def __init__(self, err: int, msg: str = ""):
        self.errno = -abs(err)
        super().__init__(f"{msg} (errno {self.errno})")


def backend_tpu_error(plugin: str) -> ErasureCodeError:
    """The refusal of ``backend=tpu``: in the JAX package that key runs the
    TPU engine; the port's device backend is ``backend=cuda``, and running
    ``tpu`` on the host instead would move the work off the device unseen."""
    return ErasureCodeError(
        _errno.EINVAL,
        f"{plugin}: backend=tpu names the TPU engine, which ceph_tpu_torch "
        f"does not have; use backend=cuda for the card (backend=cpu or "
        f"backend=native for the host)")


class ErasureCodeInterface:
    """Abstract codec contract (ErasureCodeInterface.h:170).

    Systematic codes only: an object is padded and split into k equal data
    chunks; m coding chunks are computed from them.  Chunk i of the encode
    output lands at position ``chunk_mapping[i]`` when a mapping is set.
    """

    def init(self, profile: ErasureCodeProfile) -> None:
        raise NotImplementedError

    def get_profile(self) -> ErasureCodeProfile:
        raise NotImplementedError

    def get_chunk_count(self) -> int:
        raise NotImplementedError

    def get_data_chunk_count(self) -> int:
        raise NotImplementedError

    def get_coding_chunk_count(self) -> int:
        return self.get_chunk_count() - self.get_data_chunk_count()

    def get_sub_chunk_count(self) -> int:
        return 1

    def get_chunk_size(self, object_size: int) -> int:
        raise NotImplementedError

    def minimum_to_decode(
        self, want_to_read: Iterable[int], available: Iterable[int]
    ) -> Dict[int, List[Tuple[int, int]]]:
        raise NotImplementedError

    def minimum_to_decode_with_cost(
        self, want_to_read: Iterable[int], available: Mapping[int, int]
    ) -> List[int]:
        raise NotImplementedError

    def encode(
        self, want_to_encode: Iterable[int], data: bytes | np.ndarray
    ) -> Dict[int, np.ndarray]:
        raise NotImplementedError

    def encode_chunks(
        self, want_to_encode: Iterable[int], encoded: Dict[int, np.ndarray]
    ) -> None:
        raise NotImplementedError

    def decode(
        self,
        want_to_read: Iterable[int],
        chunks: Mapping[int, np.ndarray],
        chunk_size: int = 0,
    ) -> Dict[int, np.ndarray]:
        raise NotImplementedError

    def decode_chunks(
        self,
        want_to_read: Iterable[int],
        chunks: Mapping[int, np.ndarray],
        decoded: Dict[int, np.ndarray],
    ) -> None:
        raise NotImplementedError

    def get_chunk_mapping(self) -> List[int]:
        raise NotImplementedError

    def decode_concat(self, chunks: Mapping[int, np.ndarray]) -> bytes:
        raise NotImplementedError


def _as_u8(buf: bytes | bytearray | memoryview | np.ndarray) -> np.ndarray:
    if isinstance(buf, np.ndarray):
        return np.ascontiguousarray(buf, dtype=np.uint8).ravel()
    return np.frombuffer(bytes(buf), dtype=np.uint8)


class ErasureCode(ErasureCodeInterface):
    """Shared logic (reference src/erasure-code/ErasureCode.cc)."""

    def __init__(self):
        self.chunk_mapping: List[int] = []
        self._profile: ErasureCodeProfile = {}
        self.rule_root = "default"
        self.rule_failure_domain = "host"
        self.rule_device_class = ""

    # -- profile plumbing --------------------------------------------------

    def init(self, profile: ErasureCodeProfile) -> None:
        self.rule_root = self.to_string("crush-root", profile, "default")
        self.rule_failure_domain = self.to_string(
            "crush-failure-domain", profile, "host"
        )
        self.rule_device_class = self.to_string("crush-device-class", profile, "")
        self._profile = profile

    def get_profile(self) -> ErasureCodeProfile:
        return self._profile

    def parse(self, profile: ErasureCodeProfile) -> None:
        self.to_mapping(profile)

    def to_mapping(self, profile: ErasureCodeProfile) -> None:
        """Parse a 'DD_D...' mapping string: D positions take data chunks in
        order, the rest take coding chunks in order (ErasureCode.cc:258-277)."""
        if "mapping" in profile:
            mapping = profile["mapping"]
            data_pos = [i for i, ch in enumerate(mapping) if ch == "D"]
            coding_pos = [i for i, ch in enumerate(mapping) if ch != "D"]
            self.chunk_mapping = data_pos + coding_pos

    @staticmethod
    def to_int(
        name: str, profile: ErasureCodeProfile, default: str
    ) -> int:
        if not profile.get(name):
            profile[name] = default
        try:
            return int(profile[name])
        except ValueError:
            raise ErasureCodeError(
                _errno.EINVAL, f"could not convert {name}={profile[name]} to int"
            )

    @staticmethod
    def to_bool(
        name: str, profile: ErasureCodeProfile, default: str
    ) -> bool:
        if not profile.get(name):
            profile[name] = default
        return profile[name] in ("yes", "true")

    @staticmethod
    def to_string(
        name: str, profile: ErasureCodeProfile, default: str
    ) -> str:
        if not profile.get(name):
            profile[name] = default
        return profile[name]

    @staticmethod
    def sanity_check_k(k: int) -> None:
        if k < 2:
            raise ErasureCodeError(_errno.EINVAL, f"k={k} must be >= 2")

    def chunk_index(self, i: int) -> int:
        return self.chunk_mapping[i] if len(self.chunk_mapping) > i else i

    def get_chunk_mapping(self) -> List[int]:
        return self.chunk_mapping

    # -- minimum_to_decode -------------------------------------------------

    def _minimum_to_decode(
        self, want_to_read: Iterable[int], available_chunks: Iterable[int]
    ) -> List[int]:
        want = sorted(set(want_to_read))
        avail = sorted(set(available_chunks))
        if set(want) <= set(avail):
            return want
        k = self.get_data_chunk_count()
        if len(avail) < k:
            raise ErasureCodeError(_errno.EIO, "not enough chunks to decode")
        return avail[:k]

    def minimum_to_decode(
        self, want_to_read: Iterable[int], available: Iterable[int]
    ) -> Dict[int, List[Tuple[int, int]]]:
        ids = self._minimum_to_decode(want_to_read, available)
        sub = [(0, self.get_sub_chunk_count())]
        return {i: list(sub) for i in ids}

    def minimum_to_decode_with_cost(
        self, want_to_read: Iterable[int], available: Mapping[int, int]
    ) -> List[int]:
        return self._minimum_to_decode(want_to_read, available.keys())

    # -- encode ------------------------------------------------------------

    def encode_prepare(self, raw: np.ndarray) -> Dict[int, np.ndarray]:
        """Split+pad input into k zero-padded chunks and allocate m coding
        chunks, honoring the chunk mapping (ErasureCode.cc:138-173)."""
        k = self.get_data_chunk_count()
        m = self.get_chunk_count() - k
        blocksize = self.get_chunk_size(len(raw))
        padded_chunks = k - len(raw) // blocksize
        encoded: Dict[int, np.ndarray] = {}
        for i in range(k - padded_chunks):
            encoded[self.chunk_index(i)] = np.array(
                raw[i * blocksize : (i + 1) * blocksize]
            )
        if padded_chunks:
            remainder = len(raw) - (k - padded_chunks) * blocksize
            buf = np.zeros(blocksize, dtype=np.uint8)
            buf[:remainder] = raw[(k - padded_chunks) * blocksize :]
            encoded[self.chunk_index(k - padded_chunks)] = buf
            for i in range(k - padded_chunks + 1, k):
                encoded[self.chunk_index(i)] = np.zeros(blocksize, dtype=np.uint8)
        for i in range(k, k + m):
            encoded[self.chunk_index(i)] = np.zeros(blocksize, dtype=np.uint8)
        return encoded

    def encode(
        self, want_to_encode: Iterable[int], data: bytes | np.ndarray
    ) -> Dict[int, np.ndarray]:
        raw = _as_u8(data)
        encoded = self.encode_prepare(raw)
        self.encode_chunks(set(want_to_encode), encoded)
        for i in list(encoded):
            if i not in want_to_encode:
                del encoded[i]
        return encoded

    # -- decode ------------------------------------------------------------

    def _decode(
        self,
        want_to_read: Iterable[int],
        chunks: Mapping[int, np.ndarray],
    ) -> Dict[int, np.ndarray]:
        want = set(want_to_read)
        if want <= set(chunks.keys()):
            return {i: np.asarray(chunks[i], dtype=np.uint8) for i in want}
        k = self.get_data_chunk_count()
        m = self.get_chunk_count() - k
        if not chunks:
            raise ErasureCodeError(_errno.EIO, "no chunks to decode from")
        blocksize = len(next(iter(chunks.values())))
        decoded: Dict[int, np.ndarray] = {}
        for i in range(k + m):
            if i in chunks:
                decoded[i] = np.array(chunks[i], dtype=np.uint8)
            else:
                decoded[i] = np.zeros(blocksize, dtype=np.uint8)
        self.decode_chunks(want, chunks, decoded)
        return {i: decoded[i] for i in want} if want else decoded

    def decode(
        self,
        want_to_read: Iterable[int],
        chunks: Mapping[int, np.ndarray],
        chunk_size: int = 0,
    ) -> Dict[int, np.ndarray]:
        return self._decode(want_to_read, chunks)

    def decode_concat(self, chunks: Mapping[int, np.ndarray]) -> bytes:
        k = self.get_data_chunk_count()
        want = [self.chunk_index(i) for i in range(k)]
        decoded = self._decode(want, chunks)
        return b"".join(decoded[i].tobytes() for i in want)

    # -- placement hook (CRUSH analogue wired up by the osd layer) ---------

    def create_rule(self, name: str, crush) -> int:
        """Register an 'indep'-mode placement rule with a crush-like object
        (reference ErasureCode.cc:54-73). The osd layer supplies `crush`."""
        return crush.add_simple_rule(
            name,
            self.rule_root,
            self.rule_failure_domain,
            self.rule_device_class,
            "indep",
            num_chunks=self.get_chunk_count(),
        )
