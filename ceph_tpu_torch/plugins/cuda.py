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

Profile keys ``mesh_shard`` / ``mesh_sub`` / ``mesh_data`` (all default 1)
additionally split the device work over a (data, shard, sub) grid of
devices (``parallel/distributed.py``): each shard cell multiplies its
block of k/mesh_shard chunks and the partial parities are XOR-reduced
over the shard axis (the fan-out/gather role of the reference's
ECBackend, src/osd/ECBackend.cc:1976-2030), and chunk columns ride the
``sub`` axis (sub-chunk parallelism, ErasureCodeInterface.h:251-300).
Mesh mode requires a matrix technique with w=8 and k divisible by
mesh_shard.  The grid's devices are the mesh data plane's when it is up
and large enough, else ``parallel.local_devices()``; they must be of the
profile's ``device`` type.
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

class _CudaMixin:
    """Routes codec math through the persistent device pipeline, or over
    a device grid for a mesh profile."""

    _device_codec: DeviceCodec | None = None
    _shared_pipe: EncodePipeline | None = None
    _mesh_codec = None
    _mesh_spec = (1, 1, 1)
    #: the shard-major helpers (``osd/ecutil.py``) may pad this codec's
    #: odd blocks up the shared rung ladder (ops/bucketing.py), so that
    #: they ride the pipeline's whole-lane kernels; parity is trimmed back
    shape_bucketing = True

    def init(self, profile: ErasureCodeProfile) -> None:
        self._mesh_spec = (
            int(profile.get("mesh_data", 1) or 1),
            int(profile.get("mesh_shard", 1) or 1),
            int(profile.get("mesh_sub", 1) or 1),
        )
        super().init(profile)
        if self._mesh_active():
            if getattr(self, "matrix", None) is None:
                raise ErasureCodeError(
                    errno.EINVAL,
                    "mesh_shard/mesh_sub need a matrix technique "
                    "(reed_sol_van / reed_sol_r6_op / cauchy as matrix)",
                )
            if self.w != 8:
                raise ErasureCodeError(
                    errno.EINVAL, f"mesh mode supports w=8, not w={self.w}"
                )
            if self.k % self._mesh_spec[1]:
                raise ErasureCodeError(
                    errno.EINVAL,
                    f"k={self.k} must be divisible by "
                    f"mesh_shard={self._mesh_spec[1]}",
                )

    def _mesh_active(self) -> bool:
        return any(n > 1 for n in self._mesh_spec)

    @property
    def mesh_plane_capable(self) -> bool:
        """Can the OSD mesh data plane (``osd_mesh_data_plane``,
        ``parallel/mesh_plane.py``) take this codec's coalesced
        encode/decode batches?  Matrix techniques at w=8 qualify (the
        plane's ``gf2_matrix_w8`` lanes are bit-exact for them); a
        profile that ALREADY splits over its own grid (``mesh_shard``/
        ``mesh_sub``) keeps that path -- the plane must not re-split a
        split codec."""
        return (getattr(self, "matrix", None) is not None
                and self.w == 8 and not self._mesh_active())

    def _mesh(self):
        if self._mesh_codec is None:
            from ceph_tpu_torch import parallel
            from ceph_tpu_torch.parallel import mesh_plane as mesh_mod
            from ceph_tpu_torch.parallel.distributed import (
                DistributedCodec,
                make_mesh,
            )

            nd, ns, nb = self._mesh_spec
            # when the OSD mesh data plane is up, the profile's grid
            # rides the SAME slots (one process, one ownership map),
            # else the process device list
            plane = mesh_mod.current_plane()
            if plane is not None and len(plane.devices) >= nd * ns * nb:
                devices = plane.devices
            else:
                devices = parallel.local_devices()
            want = self._device.type
            if any(d.type != want for d in devices):
                raise ValueError(
                    f"the mesh profile runs on {want} devices, the device "
                    f"list holds {sorted({str(d) for d in devices})}")
            mesh = make_mesh(n_data=nd, n_shard=ns, n_sub=nb,
                             devices=devices)
            self._mesh_codec = DistributedCodec(self.matrix, self.w, mesh)
        return self._mesh_codec

    # -- mesh (grid) data path ---------------------------------------------

    def _mesh_stack(self, stacks: List[np.ndarray]) -> np.ndarray:
        """[B, k, bs] stripes stacked, the column axis padded to the
        sub-axis size and the batch axis to the data-axis size (GF
        products are column-independent, so zero padding is exact and
        trimmed on the way out)."""
        nd, _ns, nb = self._mesh_spec
        arr = np.stack(stacks)
        return np.pad(arr, ((0, (-arr.shape[0]) % nd), (0, 0),
                            (0, (-arr.shape[2]) % nb)))

    def _mesh_encode_many(self, stacks: List[np.ndarray]) -> List[np.ndarray]:
        """Encode a list of [k, bs] stripes in one grid dispatch."""
        bs = stacks[0].shape[1]
        parity = self._mesh().encode(self._mesh_stack(stacks))
        return [parity[i, :, :bs] for i in range(len(stacks))]

    def _mesh_decode_many(
        self, sig: Sequence[int], erased: Sequence[int],
        survivor_stacks: List[np.ndarray],
    ) -> List[np.ndarray]:
        """Reconstruct erased chunks for stripes sharing one erasure
        signature: host-side row inversion (the ISA decode-table role),
        a grid product on the devices."""
        from ceph_tpu_torch.ops.pipeline import matrix_reconstruct_rows

        _, rows = matrix_reconstruct_rows(
            self.matrix, self.k, self.m, self.w, list(sig), list(erased)
        )
        bs = survivor_stacks[0].shape[1]
        rec = self._mesh().reconstruct(rows,
                                       self._mesh_stack(survivor_stacks))
        return [rec[i, :, :bs] for i in range(len(survivor_stacks))]

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
        if self._mesh_active():
            return self._mesh_encode_many([np.ascontiguousarray(data)])[0]
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
        if self._mesh_active():
            km = self.k + self.m
            available = sorted(have.keys())
            erased = [i for i in range(km) if i not in have]
            out = {c: np.asarray(a, dtype=np.uint8) for c, a in have.items()}
            if not erased:
                return out
            if len(available) < self.k:
                raise ValueError("not enough chunks to decode")
            sel = available[:self.k]
            rec = self._mesh_decode_many(
                available, erased, [np.stack([out[c] for c in sel])]
            )[0]
            for j, e in enumerate(erased):
                out[e] = rec[j]
            return out
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
        if self._mesh_active():
            # sub-group by blocksize: one stacked grid dispatch per size
            by_size: Dict[int, List[int]] = {}
            for idx, p in enumerate(prepared):
                by_size.setdefault(len(p[0]), []).append(idx)
            out: List[Dict[int, np.ndarray]] = [None] * len(prepared)  # type: ignore
            for idxs in by_size.values():
                codings = self._mesh_encode_many(
                    [np.stack([prepared[i][j] for j in range(k)])
                     for i in idxs]
                )
                for i, coding in zip(idxs, codings):
                    enc = dict(prepared[i])
                    for j in range(m):
                        enc[k + j] = coding[j]
                    out[i] = enc
            return out
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
                    if not self._mesh_active()
                    and self._pipeline_ok(b.shape[1])]
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
            # mesh / odd shapes: the generic batched path (mesh splits
            # the dispatch; odd shapes bucket inside jerasure_encode)
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
            if self._mesh_active():
                sel = sorted(sig)[:self.k]
                by_size: Dict[int, List[int]] = {}
                for i in idxs:
                    by_size.setdefault(
                        len(next(iter(chunk_maps[i].values()))), []
                    ).append(i)
                for sized_idxs in by_size.values():
                    recs = self._mesh_decode_many(
                        list(sig), erased,
                        [
                            np.stack([
                                np.asarray(chunk_maps[i][c], dtype=np.uint8)
                                for c in sel
                            ])
                            for i in sized_idxs
                        ],
                    )
                    for pos, i in enumerate(sized_idxs):
                        full = {
                            c: np.asarray(a, dtype=np.uint8)
                            for c, a in chunk_maps[i].items()
                        }
                        for j, e in enumerate(erased):
                            full[e] = recs[pos][j]
                        results[i] = full
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
