"""ErasureCodePluginCuda: the CUDA codec plugin of the port.

Port of ``ceph_tpu/plugins/tpu.py``: a drop-in peer to the ``jerasure``
plugin behind the same registry.  Profile ``plugin=cuda technique=<any
jerasure technique> k=.. m=..`` yields a codec whose encode/decode run as
bit-sliced GF(2) products in the CUDA kernels of ``ops/cuda_gf.py``,
bit-exact with the numpy oracle for every technique.  Profile key
``device`` (default ``cuda``) picks the device; ``device=cpu`` runs the
kernels' plain PyTorch versions.

All device work routes through the persistent pipeline
(``ops/pipeline.py``): the coding matrix is uploaded once per codec
instance, every sync encode()/decode() is one fused dispatch, and the
batched entry points (``encode_batch``/``decode_batch``/
``encode_shard_major_batch``) stream granules through the device with
bounded in-flight depth.

Mesh profiles (``mesh_data``/``mesh_shard``/``mesh_sub`` > 1) are refused
with EINVAL until the port has its multi-device slice.
"""

from __future__ import annotations

import errno
import math
from typing import Dict, List, Sequence

import numpy as np

from ceph_tpu_torch.ops import bucketing, cuda_gf
from ceph_tpu_torch.ops.pipeline import DeviceCodec, EncodePipeline
from ceph_tpu_torch.plugins import jerasure as jer
from ceph_tpu_torch.plugins import registry as registry_mod
from ceph_tpu_torch.plugins.interface import (
    ErasureCodeError,
    ErasureCodeProfile,
)

_MESH_KEYS = ("mesh_data", "mesh_shard", "mesh_sub")


class _CudaMixin:
    """Routes codec math through the persistent device pipeline."""

    _device_codec: DeviceCodec | None = None
    _shared_pipe: EncodePipeline | None = None
    #: the shard-major helpers (``osd/ecutil.py``) may pad this codec's
    #: odd blocks up the shared rung ladder (ops/bucketing.py), so that
    #: they ride the pipeline's whole-lane kernels; parity is trimmed back
    shape_bucketing = True

    def init(self, profile: ErasureCodeProfile) -> None:
        for key in _MESH_KEYS:
            if int(profile.get(key, 1) or 1) > 1:
                raise ErasureCodeError(
                    errno.EINVAL,
                    f"{key} > 1 needs the multi-device slice of the port")
        super().init(profile)

    def _dc(self) -> DeviceCodec:
        if self._device_codec is None:
            matrix = getattr(self, "matrix", None)
            self._device_codec = DeviceCodec(
                matrix=matrix,
                bitmatrix=getattr(self, "bitmatrix", None)
                if matrix is None else None,
                k=self.k, m=self.m, w=self.w,
                packetsize=getattr(self, "packetsize", 0),
                device=self._device,
            )
        return self._device_codec

    def _pipe(self) -> EncodePipeline:
        """The persistent encode pipeline of this codec instance, shared by
        every batched entry point so the overlap slots span calls.
        Tickets are claimed within each call, so reuse is state-free."""
        if self._shared_pipe is None:
            self._shared_pipe = EncodePipeline(self._dc().encode_stream())
        return self._shared_pipe

    def bucket_align(self) -> int:
        """Zero-padding granularity that keeps a padded blocksize both
        bit-exact (whole words / whole packet groups) and acceptable to
        the pipeline's lane kernels."""
        lane = cuda_gf.LANE_BYTES
        if getattr(self, "matrix", None) is not None:
            return math.lcm(lane, self.w // 8)
        return math.lcm(self.w * max(1, getattr(self, "packetsize", 0)),
                        lane * self.w)

    def _pipeline_ok(self, blocksize: int) -> bool:
        """The kernels want whole int32 lanes (matrix codes) or whole
        packet groups whose packet rows are whole lanes (bitmatrix codes);
        odd sizes take the engine path, same bytes either way."""
        lane = cuda_gf.LANE_BYTES
        if getattr(self, "matrix", None) is not None:
            return blocksize % lane == 0
        pw = self.w * getattr(self, "packetsize", 0)
        return pw > 0 and blocksize % pw == 0 and \
            (blocksize // self.w) % lane == 0

    # -- sync contract (one fused dispatch per call) -----------------------

    def jerasure_encode(self, data: np.ndarray) -> np.ndarray:
        bs = data.shape[1]
        if self._pipeline_ok(bs):
            return self._dc().encode(np.ascontiguousarray(data))
        # odd blocksize: zero-pad the column axis up the rung ladder (whole
        # words / packet groups, so parity of the padded block is the
        # original parity plus zero columns) and ride the pipeline
        target = bucketing.bucket_bytes(bs, self.bucket_align())
        if self._pipeline_ok(target):
            padded = np.zeros((data.shape[0], target), dtype=np.uint8)
            padded[:, :bs] = data
            return self._dc().encode(padded)[:, :bs]
        return super().jerasure_encode(data)

    def jerasure_decode(self, have, blocksize):
        if self._pipeline_ok(blocksize):
            return self._dc().decode(have, blocksize)
        target = bucketing.bucket_bytes(blocksize, self.bucket_align())
        if self._pipeline_ok(target):
            # reconstruction is columnwise too: decode the zero-padded
            # survivors, trim every chunk back to the true blocksize
            padded_have = {}
            for c, arr in have.items():
                buf = np.zeros(target, dtype=np.uint8)
                buf[:blocksize] = np.asarray(arr, dtype=np.uint8)
                padded_have[c] = buf
            out = self._dc().decode(padded_have, target)
            return {c: arr[:blocksize] for c, arr in out.items()}
        return super().jerasure_decode(have, blocksize)

    # -- batched / async API -----------------------------------------------

    def encode_batch(self, stripes: Sequence[bytes | np.ndarray]
                     ) -> List[Dict[int, np.ndarray]]:
        """Encode many stripes, granule-fused and pipelined: stripes ride
        the lane axis; up to `depth` granules stream through the device
        concurrently."""
        if not stripes:
            return []
        prepared = [self.encode_prepare(_to_u8(s)) for s in stripes]
        k, m = self.k, self.m
        blocksize = len(prepared[0][0])
        if not self._pipeline_ok(blocksize):
            out = []
            for p in prepared:
                # jerasure_encode buckets odd blocksizes into the pipeline
                coding = self.jerasure_encode(np.stack([p[j] for j in range(k)]))
                enc = dict(p)
                for i in range(m):
                    enc[k + i][:] = coding[i]
                out.append(enc)
            return out
        pipe = self._pipe()
        tickets = [
            pipe.submit(np.stack([p[j] for j in range(k)])) for p in prepared
        ]
        pipe.flush()
        out = []
        for p, t in zip(prepared, tickets):
            coding = pipe.result(t)
            enc = dict(p)
            for i in range(m):
                enc[k + i] = coding[i]
            out.append(enc)
        return out

    def encode_shard_major_batch(
        self,
        blocks: Sequence[np.ndarray],
        keep_device: Sequence[bool] | None = None,
    ):
        """Shard-major fast lane for the write-path helpers: ``[k, bs]``
        uint8 blocks in, ``(chunk_maps, device_blocks)`` out.  The blocks
        ARE the prepared chunk rows, so this skips encode_batch's flatten
        -> encode_prepare -> restack round-trip.  ``keep_device[i]`` asks
        for stripe i's still-resident ``[k+m, bs]`` uint8 device block;
        entries are None when the layout cannot compose one."""
        k, m = self.k, self.m
        keep = list(keep_device) if keep_device is not None \
            else [False] * len(blocks)
        out: List = [None] * len(blocks)
        devs: List = [None] * len(blocks)
        pipe_idx = [i for i, b in enumerate(blocks)
                    if self._pipeline_ok(b.shape[1])]
        if pipe_idx:
            pipe = self._pipe()
            tickets = [
                pipe.submit(np.asarray(blocks[i], dtype=np.uint8),
                            keep_device=keep[i])
                for i in pipe_idx
            ]
            pipe.flush()
            for i, t in zip(pipe_idx, tickets):
                coding = pipe.result(t)
                enc = {self.chunk_index(j): blocks[i][j] for j in range(k)}
                for j in range(m):
                    enc[self.chunk_index(k + j)] = coding[j]
                out[i] = enc
                if keep[i]:
                    devs[i] = pipe.device_result(t)
        rest = [i for i in range(len(blocks)) if out[i] is None]
        if rest:
            # odd shapes: the generic batched path (buckets inside
            # jerasure_encode)
            encs = self.encode_batch([blocks[i].reshape(-1) for i in rest])
            for i, enc in zip(rest, encs):
                out[i] = enc
        return out, devs

    def decode_batch(
        self,
        chunk_maps: Sequence[Dict[int, np.ndarray]],
    ) -> List[Dict[int, np.ndarray]]:
        """Reconstruct every stripe; stripes sharing an erasure signature
        share one reconstruction matrix (decode-stream LRU) and ride the
        same pipelined granule stream."""
        if not chunk_maps:
            return []
        km = self.k + self.m
        groups: Dict[tuple, List[int]] = {}
        for idx, cm in enumerate(chunk_maps):
            groups.setdefault(tuple(sorted(cm.keys())), []).append(idx)
        results: List[Dict[int, np.ndarray]] = [None] * len(chunk_maps)  # type: ignore
        for sig, idxs in groups.items():
            blocksize = len(next(iter(chunk_maps[idxs[0]].values())))
            erased = [i for i in range(km) if i not in sig]
            if not erased:
                for i in idxs:
                    results[i] = {
                        c: np.asarray(a, dtype=np.uint8)
                        for c, a in chunk_maps[i].items()
                    }
                continue
            if not self._pipeline_ok(blocksize):
                for i in idxs:
                    results[i] = self.jerasure_decode(
                        dict(chunk_maps[i]), blocksize)
                continue
            sel, stream = self._dc().decode_stream(list(sig), erased)
            pipe = EncodePipeline(stream)
            tickets = [
                pipe.submit(np.stack([chunk_maps[i][c] for c in sel]))
                for i in idxs
            ]
            pipe.flush()
            for pos, i in enumerate(idxs):
                rec = pipe.result(tickets[pos])
                full = {
                    c: np.asarray(a, dtype=np.uint8)
                    for c, a in chunk_maps[i].items()
                }
                for j, e in enumerate(erased):
                    full[e] = rec[j]
                results[i] = full
        return results


def _to_u8(buf) -> np.ndarray:
    if isinstance(buf, np.ndarray):
        return np.ascontiguousarray(buf, dtype=np.uint8).ravel()
    return np.frombuffer(bytes(buf), dtype=np.uint8)


def _make_cuda_class(base):
    return type("Cuda" + base.__name__, (_CudaMixin, base), {})


TECHNIQUES = {
    tech: _make_cuda_class(cls) for tech, cls in jer.TECHNIQUES.items()
}


class ErasureCodePluginCuda(registry_mod.ErasureCodePlugin):
    def factory(self, directory: str, profile: ErasureCodeProfile):
        technique = profile.get("technique") or "reed_sol_van"
        profile["technique"] = technique
        cls = TECHNIQUES.get(technique)
        if cls is None:
            raise ErasureCodeError(
                errno.ENOENT, f"technique={technique} is not a valid technique"
            )
        ec = cls()
        profile["backend"] = "cuda"
        ec.init(profile)
        return ec


def __erasure_code_version__() -> str:
    from ceph_tpu_torch import __version__

    return __version__


def __erasure_code_init__(name: str, directory: str) -> int:
    registry_mod.instance().add(name, ErasureCodePluginCuda())
    return 0
