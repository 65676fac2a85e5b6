"""ErasureCodePluginRegen: repair-bandwidth-optimal regenerating codes.

Port of ``ceph_tpu/plugins/regen.py``.  Product-matrix MSR (d = 2k-2)
behind the standard plugin registry (profile ``plugin=regen k=.. m=..``),
built on the construction in ``matrices/product_matrix.py``.  Because
B = k*alpha exactly, the whole code linearizes to ONE systematic GF(2^8)
generator over *virtual rows* (node i's sub-chunk j = virtual row
``i*alpha + j``), so encode, decode AND repair are all plain GF matmuls
riding the same device pipeline (``ops/pipeline.py``) as the ``cuda``
plugin, whose w=8 product is the ``gf2_matrix_w8`` kernel.

Profile key ``device`` (default ``cuda``) picks the device, as the
``jerasure`` plugin's ``backend=cuda`` does: the pipeline lanes of encode
and decode run there (``device=cpu`` runs the kernels' plain PyTorch
versions), and the repair lanes (:meth:`regenerate_batch`,
:func:`compute_helpers`) take the pipeline on the card and the host LUT
engine (``ops/cpu_engine.py``) on the CPU, as the JAX package gates them
on its backend.  Asking for the card without one raises.

What the plugin adds over the classic MDS family:

* ``get_sub_chunk_count() == alpha`` and a :meth:`minimum_to_decode`
  that, for a SINGLE lost shard with >= d survivors, returns a
  d-helper plan of ONE sub-chunk each (beta = chunk/alpha bytes) --
  the recovery coalescer turns that into beta-extent ``ECSubRead``
  bursts instead of whole-shard reads (d*beta = 2*chunk bytes moved,
  ratio 2/k of the full-stripe gather);
* :func:`compute_helpers` -- the survivor-side dot of its alpha stored
  sub-chunks with the wire-carried ``phi_f`` coefficients, batched
  over every object of a sub-read message as one pipelined dispatch;
* :meth:`regenerate_batch` -- the primary-side fused regenerating
  matmul: d stacked helper symbols -> the lost shard, one device
  dispatch per (lost, helper-set) signature for the whole batch.

Multi-loss falls back to the classic full-stripe decode (the virtual-
row generator is MDS over whole nodes), and fewer than d helpers are
REFUSED rather than mis-combined -- the repair matrix is only defined
for exactly d of them.  With the process mesh data plane up
(``osd_mesh_data_plane``), both repair lanes run on the daemon's own mesh
slot instead (:func:`_mesh_run_tab`).
"""

from __future__ import annotations

import errno as _errno
import threading
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

import torch

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.matrices.product_matrix import ProductMatrixMSR
from ceph_tpu_torch.ops import cpu_engine
from ceph_tpu_torch.ops.pipeline import (DeviceCodec, EncodePipeline,
                                         matrix_reconstruct_rows)
from ceph_tpu_torch.plugins import registry as registry_mod
from ceph_tpu_torch.plugins.interface import (SIMD_ALIGN, ErasureCode,
                                              ErasureCodeError,
                                              ErasureCodeProfile)


def _pipeline_lane(device: torch.device) -> bool:
    """Whether the repair lanes take the device pipeline: on the card;
    the CPU runs the host LUT engine (the JAX package's non-TPU path)."""
    return device.type == "cuda"


class ErasureCodeRegen(ErasureCode):
    DEFAULT_K = "4"
    DEFAULT_M = "3"
    DEFAULT_W = "8"

    #: the recovery coalescer's capability probe: minimum_to_decode may
    #: return plans covering FEWER than get_sub_chunk_count() sub-chunks,
    #: served by computed helper symbols (repair_coeffs + regenerate_batch)
    fractional_repair = True
    #: shard-major helpers may pad blocks up the shared rung ladder
    shape_bucketing = True

    def __init__(self, technique: str = "product_matrix"):
        super().__init__()
        self.technique = technique
        self.k = 0
        self.m = 0
        self.w = 8
        self.pm: ProductMatrixMSR | None = None
        #: systematic generator over virtual rows, (m*alpha, k*alpha)
        self.matrix: np.ndarray | None = None
        self._device: torch.device | None = None
        self._device_codec: DeviceCodec | None = None
        self._shared_pipe: EncodePipeline | None = None
        #: (lost, helper-sig) -> DeviceCodec(matrix=R_f, k=d, m=alpha)
        self._regen_codecs: Dict[tuple, DeviceCodec] = {}
        self._lock = threading.Lock()

    # -- profile -----------------------------------------------------------

    def init(self, profile: ErasureCodeProfile) -> None:
        profile["technique"] = self.technique
        self.parse(profile)
        try:
            self.pm = ProductMatrixMSR(self.k, self.m, self.w)
        except ValueError as e:
            raise ErasureCodeError(_errno.EINVAL, str(e))
        self.matrix = self.pm.generator
        profile["d"] = str(self.d)
        ErasureCode.init(self, profile)

    def parse(self, profile: ErasureCodeProfile) -> None:
        ErasureCode.parse(self, profile)
        self.k = self.to_int("k", profile, self.DEFAULT_K)
        self.m = self.to_int("m", profile, self.DEFAULT_M)
        self.w = self.to_int("w", profile, self.DEFAULT_W)
        self._device = resolve_device(
            self.to_string("device", profile, "cuda"))
        self.sanity_check_k(self.k)
        if self.w != 8:
            raise ErasureCodeError(
                _errno.EINVAL,
                f"w={self.w}: the product-matrix construction runs the "
                f"GF(2^8) byte lanes; only w=8 is supported",
            )
        if self.m < self.k - 1:
            raise ErasureCodeError(
                _errno.EINVAL,
                f"m={self.m} must be >= k-1={self.k - 1}: d=2k-2 repair "
                f"helpers must exist among the n-1 survivors",
            )
        if "d" in profile and str(profile["d"]) != "":
            d = self.to_int("d", profile, str(2 * self.k - 2))
            if d != 2 * self.k - 2:
                raise ErasureCodeError(
                    _errno.EINVAL,
                    f"d={d} is out of range: the product-matrix MSR "
                    f"construction requires d=2k-2={2 * self.k - 2}",
                )
        if self.chunk_mapping and len(self.chunk_mapping) != self.k + self.m:
            self.chunk_mapping = []
            raise ErasureCodeError(
                _errno.EINVAL,
                f"mapping maps {len(self.chunk_mapping)} chunks != k+m",
            )

    # -- geometry ----------------------------------------------------------

    @property
    def alpha(self) -> int:
        return self.k - 1

    @property
    def d(self) -> int:
        return 2 * self.k - 2

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_sub_chunk_count(self) -> int:
        return self.alpha

    def get_chunk_size(self, object_size: int) -> int:
        """Chunks stay divisible into alpha SIMD-aligned sub-chunks, so
        beta extents keep the int32-lane pipeline kernels happy."""
        alignment = self.k * self.alpha * SIMD_ALIGN
        tail = object_size % alignment
        padded = object_size + (alignment - tail if tail else 0)
        return padded // self.k

    # -- virtual-row plumbing ---------------------------------------------

    @property
    def kv(self) -> int:
        return self.k * self.alpha

    @property
    def mv(self) -> int:
        return self.m * self.alpha

    def _virtual_rows(self, nodes: Iterable[int]) -> List[int]:
        a = self.alpha
        return [n * a + j for n in sorted(nodes) for j in range(a)]

    def _stack_virtual(
        self, chunks: Mapping[int, np.ndarray], nodes: Sequence[int]
    ) -> np.ndarray:
        """[len(nodes)*alpha, sub_len] virtual-row stack of whole chunks."""
        a = self.alpha
        return np.vstack([
            np.asarray(chunks[n], dtype=np.uint8).reshape(a, -1)
            for n in nodes
        ])

    def _dc(self) -> DeviceCodec:
        if self._device_codec is None:
            self._device_codec = DeviceCodec(
                matrix=self.matrix, k=self.kv, m=self.mv, w=self.w,
                device=self._device)
        return self._device_codec

    def _pipe(self) -> EncodePipeline:
        if self._shared_pipe is None:
            self._shared_pipe = EncodePipeline(self._dc().encode_stream())
        return self._shared_pipe

    def bucket_align(self) -> int:
        # whole sub-chunks of int32 lanes: padding must not shear the
        # virtual-row reshape
        return 4 * self.alpha

    def _pipeline_ok(self, chunk_len: int) -> bool:
        return chunk_len % (4 * self.alpha) == 0 and chunk_len > 0

    # -- sync contract -----------------------------------------------------

    def encode_chunks(
        self, want_to_encode: Iterable[int], encoded: Dict[int, np.ndarray]
    ) -> None:
        data = self._stack_virtual(encoded, range(self.k))
        if self._pipeline_ok(len(next(iter(encoded.values())))):
            parity = self._dc().encode(np.ascontiguousarray(data))
        else:
            parity = cpu_engine.matrix_encode(self.matrix, data, self.w)
        a = self.alpha
        for i in range(self.m):
            encoded[self.k + i][:] = np.ascontiguousarray(
                parity[i * a:(i + 1) * a]).reshape(-1)

    def decode_chunks(
        self,
        want_to_read: Iterable[int],
        chunks: Mapping[int, np.ndarray],
        decoded: Dict[int, np.ndarray],
    ) -> None:
        km = self.k + self.m
        have = sorted(c for c in range(km) if c in chunks)
        erased = [c for c in range(km) if c not in chunks]
        if not erased:
            return
        if len(have) < self.k:
            raise ErasureCodeError(_errno.EIO, "not enough chunks to decode")
        # whole-node virtual erasure: the first kv of the sorted
        # available virtual rows are exactly k whole survivor nodes, so
        # the composed reconstruction matrix is invertible (MDS)
        sel, rows = matrix_reconstruct_rows(
            self.matrix, self.kv, self.mv, self.w,
            self._virtual_rows(have), self._virtual_rows(erased))
        src_nodes = sorted({v // self.alpha for v in sel})
        vin = self._stack_virtual(decoded, src_nodes)
        rec = cpu_engine.matrix_encode(rows, vin, self.w)
        a = self.alpha
        for j, node in enumerate(erased):
            decoded[node][:] = np.ascontiguousarray(
                rec[j * a:(j + 1) * a]).reshape(-1)

    # -- minimum_to_decode: the beta/d repair plan -------------------------

    def minimum_to_decode(
        self, want_to_read: Iterable[int], available: Iterable[int]
    ) -> Dict[int, List[Tuple[int, int]]]:
        """Single-loss plans name d helpers at ONE sub-chunk (beta)
        each; everything else is the classic first-k full-chunk plan.
        Plan schema: {chunk: [(sub_chunk_offset, sub_chunk_count)]} --
        a count below get_sub_chunk_count() marks a fractional plan
        served by computed helper symbols, not raw extents."""
        want = sorted(set(want_to_read))
        avail = sorted(set(available))
        missing = [c for c in want if c not in avail]
        helpers_avail = [c for c in avail if c not in missing]
        if (len(missing) == 1 and self.alpha > 1
                and len(helpers_avail) >= self.d):
            return {h: [(0, 1)] for h in helpers_avail[: self.d]}
        return super().minimum_to_decode(want_to_read, available)

    # -- repair lane -------------------------------------------------------

    def repair_coeffs(self, lost: int) -> List[int]:
        """phi_f for the wire: every helper dots its own alpha
        sub-chunks with these (beta-symbol compute, not a raw read)."""
        assert self.pm is not None
        return self.pm.repair_coeffs(lost)

    def _regen_codec(self, lost: int, helpers: Tuple[int, ...]) -> DeviceCodec:
        key = (lost, helpers)
        with self._lock:
            codec = self._regen_codecs.get(key)
            if codec is None:
                assert self.pm is not None
                rf = self.pm.repair_matrix(lost, helpers)
                codec = DeviceCodec(
                    matrix=rf, k=self.d, m=self.alpha, w=self.w,
                    device=self._device)
                if len(self._regen_codecs) >= 32:
                    _release_codecs(self._regen_codecs)  # bounded cache
                self._regen_codecs[key] = codec
            return codec

    def regenerate_batch(
        self,
        lost: int,
        helpers: Sequence[int],
        helper_stacks: Sequence[np.ndarray],
    ) -> List[np.ndarray]:
        """Regenerate the lost chunk for MANY objects sharing one
        (lost, helper-set) signature: each stack is [d, beta] uint8
        (helper symbols in ``helpers`` order); returns the [chunk_len]
        regenerated shard per object -- ONE fused device dispatch for
        the whole batch (per rung bucket), the mesh plane's slot when
        the process plane is up.

        Fewer (or duplicate) helpers REFUSE via the repair-matrix
        validation: combining < d helper symbols has no consistent
        solution and must never fabricate shard bytes.
        """
        helpers = tuple(int(h) for h in helpers)
        assert self.pm is not None
        rf = self.pm.repair_matrix(lost, helpers)  # validates the set
        if not helper_stacks:
            return []
        beta = int(helper_stacks[0].shape[1])
        plane = _mesh_plane()
        if plane is not None and beta > 0:
            outs = _mesh_run_tab(
                plane, rf, self.d, self.alpha,
                [np.asarray(s, dtype=np.uint8) for s in helper_stacks])
            return [np.ascontiguousarray(o).reshape(-1) for o in outs]
        if beta % 4 == 0 and beta > 0 and _pipeline_lane(self._device):
            codec = self._regen_codec(lost, helpers)
            pipe = EncodePipeline(codec.encode_stream())
            tickets = [pipe.submit(np.asarray(s, dtype=np.uint8))
                       for s in helper_stacks]
            pipe.flush()
            outs = [pipe.result(t) for t in tickets]
            pipe.drain()
            return [np.ascontiguousarray(o).reshape(-1) for o in outs]
        stacks = [np.asarray(s, dtype=np.uint8) for s in helper_stacks]
        if beta > 0 and all(s.shape[1] == beta for s in stacks):
            # host LUT lane: one fused pass across the whole batch
            outs = cpu_engine.matrix_encode(
                rf, np.ascontiguousarray(np.hstack(stacks)), self.w)
            return [
                np.ascontiguousarray(
                    outs[:, i * beta:(i + 1) * beta]).reshape(-1)
                for i in range(len(stacks))
            ]
        return [
            np.ascontiguousarray(cpu_engine.matrix_encode(
                rf, s, self.w)).reshape(-1)
            for s in stacks
        ]

    # -- batched API (the coalescer/ecutil fast lanes) ---------------------

    def encode_batch(
        self, stripes: Sequence[bytes | np.ndarray]
    ) -> List[Dict[int, np.ndarray]]:
        if not stripes:
            return []
        prepared = [
            self.encode_prepare(np.frombuffer(s, dtype=np.uint8)
                                if isinstance(s, (bytes, bytearray))
                                else np.asarray(s, dtype=np.uint8))
            for s in stripes
        ]
        pipe_idx = [i for i, p in enumerate(prepared)
                    if self._pipeline_ok(len(p[0]))]
        results: List[Optional[Dict[int, np.ndarray]]] = \
            [None] * len(prepared)
        if pipe_idx:
            pipe = self._pipe()
            tickets = [
                pipe.submit(self._stack_virtual(
                    prepared[i], range(self.k)))
                for i in pipe_idx
            ]
            pipe.flush()
            a = self.alpha
            for i, t in zip(pipe_idx, tickets):
                parity = pipe.result(t)
                enc = dict(prepared[i])
                for j in range(self.m):
                    enc[self.k + j] = np.ascontiguousarray(
                        parity[j * a:(j + 1) * a]).reshape(-1)
                results[i] = enc
        for i, p in enumerate(prepared):
            if results[i] is None:
                enc = dict(p)
                self.encode_chunks(set(range(self.k + self.m)), enc)
                results[i] = enc
        return results  # type: ignore[return-value]

    def decode_batch(
        self, chunk_maps: Sequence[Dict[int, np.ndarray]],
    ) -> List[Dict[int, np.ndarray]]:
        """Signature-grouped fused decode: maps sharing an available
        set share one composed virtual-row stream (decode-stream LRU)
        and ride the same pipelined granules."""
        if not chunk_maps:
            return []
        km = self.k + self.m
        groups: Dict[tuple, List[int]] = {}
        for idx, cm in enumerate(chunk_maps):
            groups.setdefault(tuple(sorted(cm.keys())), []).append(idx)
        results: List[Dict[int, np.ndarray]] = \
            [None] * len(chunk_maps)  # type: ignore[list-item]
        for sig, idxs in groups.items():
            erased = [c for c in range(km) if c not in sig]
            if not erased:
                for i in idxs:
                    results[i] = {c: np.asarray(v, dtype=np.uint8)
                                  for c, v in chunk_maps[i].items()}
                continue
            if len(sig) < self.k:
                raise ErasureCodeError(
                    _errno.EIO, "not enough chunks to decode")
            chunk_len = len(next(iter(chunk_maps[idxs[0]].values())))
            if not self._pipeline_ok(chunk_len):
                for i in idxs:
                    results[i] = self._decode(
                        set(range(km)), dict(chunk_maps[i]))
                continue
            sel, stream = self._dc().decode_stream(
                self._virtual_rows(sig), self._virtual_rows(erased))
            src_nodes = sorted({v // self.alpha for v in sel})
            pipe = EncodePipeline(stream)
            tickets = [
                pipe.submit(self._stack_virtual(chunk_maps[i], src_nodes))
                for i in idxs
            ]
            pipe.flush()
            a = self.alpha
            for i, t in zip(idxs, tickets):
                rec = pipe.result(t)
                full = {c: np.asarray(v, dtype=np.uint8)
                        for c, v in chunk_maps[i].items()}
                for j, node in enumerate(erased):
                    full[node] = np.ascontiguousarray(
                        rec[j * a:(j + 1) * a]).reshape(-1)
                results[i] = full
            pipe.drain()
        return results


# -- survivor-side helper compute (the beta-symbol lane) ------------------

#: (coefficients, device) -> DeviceCodec(matrix=[phi_f], k=alpha, m=1)
_HELPER_CODECS: Dict[Tuple, DeviceCodec] = {}
_HELPER_LOCK = threading.Lock()


def _release_codecs(codecs: Dict) -> None:
    """Drop a bounded codec cache, settling what its streams hold on the
    device ledger now rather than whenever GC runs their finalizers."""
    for codec in codecs.values():
        if codec._encode_stream is not None:
            codec._encode_stream.release_h2d()
    codecs.clear()


def _mesh_plane():
    """The process mesh data plane (None with ``osd_mesh_data_plane``
    off)."""
    from ceph_tpu_torch.parallel import mesh_plane as mesh_mod

    return mesh_mod.current_plane()


def _mesh_run_tab(plane, matrix: np.ndarray, k_in: int, rows_out: int,
                  blocks: List[np.ndarray],
                  slot_name: Optional[str] = None) -> List[np.ndarray]:
    """Dispatch ``matrix`` over [k_in, bs] blocks on the process mesh
    plane (the in-collective lane: survivors/primaries that are mesh
    members run their repair products on their OWN mesh slot, and
    distinct daemons' launches overlap across slots' streams)."""

    class _Shim:
        """mesh_plane._codec keys its tables by (matrix bytes, w)."""
        mesh_plane_capable = True

        def __init__(self):
            self.matrix = np.asarray(matrix, dtype=np.uint32)
            self.w = 8

        def get_data_chunk_count(self):
            return k_in

        def get_chunk_count(self):
            return k_in + rows_out

    slot = plane.slot_of(slot_name) if slot_name else None
    if slot is None:
        slot = 0
    bs = int(blocks[0].shape[1])
    bs_pad = plane._bucket_bs(bs)
    codec = plane._codec(_Shim())
    outs = codec.run_tab(
        codec._enc_tab, blocks, [0] * len(blocks), bs_pad, slot=slot)
    return [o[:, :bs] for o in outs]


def compute_helpers(
    coeffs: Sequence[int],
    shards: Sequence[np.ndarray],
    slot_name: Optional[str] = None,
    device="cuda",
) -> List[np.ndarray]:
    """Survivor-side helper symbols: dot each full shard's alpha
    sub-chunks with ``phi_f`` (the wire-carried ``regen`` coefficients)
    -- [shard_len] -> [shard_len/alpha] per object, every object of a
    sub-read message fused into one pipelined GF matmul dispatch (the
    mesh plane's slot for mesh-member daemons).

    ``device`` is the caller's codec's (the serving shard's pool codec):
    the card takes the pipeline, the CPU the host LUT engine.  The
    1 x alpha coefficient matrix is uploaded ONCE per coefficient
    signature and device (a bounded DeviceCodec cache), never per shard.
    """
    dev = resolve_device(device)
    coeffs = tuple(int(c) for c in coeffs)
    alpha = len(coeffs)
    if alpha == 0 or not shards:
        return []
    blocks = []
    for s in shards:
        arr = np.asarray(s, dtype=np.uint8).reshape(-1)
        if arr.size % alpha:
            raise ValueError(
                f"shard of {arr.size} bytes is not divisible into "
                f"alpha={alpha} sub-chunks")
        blocks.append(arr.reshape(alpha, -1))
    beta = blocks[0].shape[1]
    matrix = np.array([coeffs], dtype=np.uint32)
    plane = _mesh_plane()
    if plane is not None and beta > 0:
        outs = _mesh_run_tab(plane, matrix, alpha, 1, blocks, slot_name)
        return [np.ascontiguousarray(o[0]) for o in outs]
    if beta % 4 or beta == 0 or not _pipeline_lane(dev):
        # host LUT lane (the CPU, or widths that are not whole int32
        # lanes): ONE fused pass over the concatenated blocks
        if all(b.shape[1] == beta for b in blocks):
            fused = np.ascontiguousarray(np.hstack(blocks))
            out = cpu_engine.matrix_encode(matrix, fused, 8)[0]
            return [
                np.ascontiguousarray(out[i * beta:(i + 1) * beta])
                for i in range(len(blocks))
            ]
        return [
            np.ascontiguousarray(cpu_engine.matrix_encode(
                matrix, b, 8)[0]) for b in blocks
        ]
    key = (coeffs, str(dev))
    with _HELPER_LOCK:
        codec = _HELPER_CODECS.get(key)
        if codec is None:
            if len(_HELPER_CODECS) >= 64:
                _release_codecs(_HELPER_CODECS)  # bounded program cache
            codec = _HELPER_CODECS[key] = DeviceCodec(
                matrix=matrix, k=alpha, m=1, w=8, device=dev)
    pipe = EncodePipeline(codec.encode_stream())
    tickets = [pipe.submit(b) for b in blocks]
    pipe.flush()
    outs = [np.ascontiguousarray(pipe.result(t)[0]) for t in tickets]
    pipe.drain()
    return outs


# -- plugin registration ---------------------------------------------------

class ErasureCodePluginRegen(registry_mod.ErasureCodePlugin):
    def factory(self, directory: str, profile: ErasureCodeProfile):
        technique = profile.get("technique", "product_matrix")
        if technique != "product_matrix":
            raise ErasureCodeError(
                _errno.EINVAL,
                f"technique={technique} is not a valid regenerating "
                f"technique (product_matrix)",
            )
        ec = ErasureCodeRegen(technique)
        ec.init(profile)
        return ec


def __erasure_code_version__() -> str:
    from ceph_tpu_torch import __version__

    return __version__


def __erasure_code_init__(name: str, directory: str) -> int:
    registry_mod.instance().add(name, ErasureCodePluginRegen())
    return 0
