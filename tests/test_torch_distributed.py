"""The port's grid codec (``parallel/distributed.py``), its mesh profiles in
the ``cuda`` plugin and its entry twin (``ceph_tpu_torch/entry.py``),
against the JAX package's, on the CPU.

Counterparts of ``tests/test_distributed.py``, ``tests/test_mesh_plugin.py``
and the ``__graft_entry__`` dry run.  The JAX side runs over the conftest's
8 virtual CPU devices; the port over ``parallel.configure_devices([cpu] *
8)``, its own counterpart of them.  Each case feeds both packages the same
bytes, made with numpy from a seed, on grids of 1, 2, 4 and 8 slots; the
tolerance is zero: parity, scatter slices, scrub verdicts, reconstructions,
chunks and stored shards are compared byte for byte.
"""

import asyncio
import contextlib
import errno
import io
import itertools
import re

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as j_entry
from ceph_tpu.matrices import reed_sol as j_reed_sol
from ceph_tpu.osd import cluster as j_cluster
from ceph_tpu.parallel import distributed as j_dist
from ceph_tpu.plugins import registry as j_registry
from ceph_tpu.plugins.interface import ErasureCodeError as JErasureCodeError
from ceph_tpu_torch import entry, parallel
from ceph_tpu_torch.matrices import reed_sol
from ceph_tpu_torch.ops import cpu_engine
from ceph_tpu_torch.ops.gf import gf
from ceph_tpu_torch.osd import cluster, cluster_bench
from ceph_tpu_torch.parallel import distributed
from ceph_tpu_torch.plugins import registry
from ceph_tpu_torch.plugins.interface import ErasureCodeError
from torch_verify import port_verifiers

#: (data, shard, sub) grids of 1, 2, 4 and 8 slots (shard divides k=8)
GRIDS = [(1, 1, 1), (1, 2, 1), (2, 1, 1), (1, 4, 1), (2, 2, 1), (1, 2, 2),
         (2, 2, 2), (1, 4, 2), (2, 4, 1)]


@pytest.fixture(autouse=True, scope="module")
def cpu_slots():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    parallel.configure_devices([torch.device("cpu")] * 8)
    yield
    parallel.configure_devices(None)


@pytest.fixture(autouse=True)
def _loop_policy():
    """Both packages' loops run under the port's verifiers
    (``tests/torch_verify.py``): its atomic-section verifier, which holds
    both packages' sections, and its residency verifier."""
    with port_verifiers():
        yield


def _codecs(grid, k=8, m=4):
    M = reed_sol.vandermonde_coding_matrix(k, m, 8)
    assert np.array_equal(M, j_reed_sol.vandermonde_coding_matrix(k, m, 8))
    mine = distributed.DistributedCodec(M, 8, distributed.make_mesh(*grid))
    theirs = j_dist.DistributedCodec(M, 8, j_dist.make_mesh(*grid))
    return M, mine, theirs


def _jax(x):
    return np.asarray(jax.device_get(x))


# -- tests/test_distributed.py ---------------------------------------------


@pytest.mark.parametrize("grid", GRIDS)
def test_distributed_encode_matches_oracle(grid):
    M, mine, theirs = _codecs(grid)
    rng = np.random.RandomState(0)
    batch, n = 4, 256
    data = rng.randint(0, 256, size=(batch, 8, n)).astype(np.uint8)
    parity = mine.encode(data)
    assert np.array_equal(parity, _jax(theirs.encode(data)))
    for b in range(batch):
        assert np.array_equal(parity[b], cpu_engine.matrix_encode(M, data[b],
                                                                  8))
    # a tensor input gives the same bytes
    assert np.array_equal(mine.encode(torch.from_numpy(data)), parity)


@pytest.mark.parametrize("grid", GRIDS)
def test_distributed_scrub_and_reconstruct(grid):
    M, mine, theirs = _codecs(grid)
    k, m = 8, 4
    F = gf(8)
    rng = np.random.RandomState(1)
    batch, n = 2, 128
    data = rng.randint(0, 256, size=(batch, k, n)).astype(np.uint8)
    parity = mine.encode(data)

    ok = mine.verify(data, parity)
    assert ok.all() and np.array_equal(ok, _jax(theirs.verify(data, parity)))
    corrupted = parity.copy()
    corrupted[1, 0, 5] ^= 0xFF
    ok = mine.verify(data, corrupted)
    assert ok[0] and not ok[1]
    assert np.array_equal(ok, _jax(theirs.verify(data, corrupted)))

    # degraded read: lose data chunks 2 and 5, read k survivors
    erased = [2, 5]
    sel = [i for i in range(k + m) if i not in erased][:k]
    A = np.zeros((k, k), dtype=np.uint32)
    for r, cid in enumerate(sel):
        if cid < k:
            A[r, cid] = 1
        else:
            A[r, :] = M[cid - k, :]
    rows = F.mat_invert(A)[erased, :]
    survivors = np.concatenate([data, parity], axis=1)[:, sel, :]
    rec = mine.reconstruct(rows, survivors)
    assert np.array_equal(rec, _jax(theirs.reconstruct(rows, survivors)))
    for b in range(batch):
        for idx, e in enumerate(erased):
            assert np.array_equal(rec[b, idx], data[b, e])


@pytest.mark.parametrize("grid", GRIDS)
def test_encode_scatter_matches_encode(grid):
    """The reduce-scatter gives the same bytes as the all-reduce, and each
    owner cell holds exactly the slice the JAX package's psum_scatter
    leaves on the device at the same grid position."""
    _M, mine, theirs = _codecs(grid)
    rng = np.random.RandomState(3)
    data = rng.randint(0, 256, size=(4, 8, 256)).astype(np.uint8)
    full = mine.encode(data)
    scat = mine.encode_scatter(data)
    assert scat.shape == full.shape and np.array_equal(scat, full)
    assert np.array_equal(scat, _jax(theirs.encode_scatter(data)))
    assert list(mine.parity_owner_slots()) == \
        list(theirs.parity_owner_slots())
    # JAX: each addressable shard's device sits at a grid position and
    # holds an index of the global parity
    jmesh = theirs.mesh
    where = {d.id: pos for pos, d in np.ndenumerate(jmesh.devices)}
    jshards = {where[s.device.id]: (s.index, np.asarray(s.data))
               for s in theirs.encode_scatter(data).addressable_shards}
    cells = mine.encode_scatter_shards(data)
    assert len(cells) == len(jshards)
    for cell, index, t in cells:
        assert t.device == mine.mesh.devices[cell]
        jindex, jdata = jshards[cell]
        norm = tuple(slice(*s.indices(dim)) for s, dim in
                     zip(jindex, full.shape))
        assert norm == tuple(slice(*s.indices(dim)) for s, dim in
                             zip(index, full.shape)), (cell, index, jindex)
        assert np.array_equal(t.numpy(), jdata)


@pytest.mark.parametrize("grid", [(1, 2, 1), (1, 4, 1), (2, 2, 2)])
def test_encode_scatter_refuses_where_m_does_not_split(grid):
    """m % shard != 0: neither package scatters (the plane then keeps its
    slot-local lane)."""
    k, m = 8, 3 if grid[1] == 2 else 2
    M = reed_sol.vandermonde_coding_matrix(k, m, 8)
    mine = distributed.DistributedCodec(M, 8, distributed.make_mesh(*grid))
    theirs = j_dist.DistributedCodec(M, 8, j_dist.make_mesh(*grid))
    data = np.random.RandomState(4).randint(0, 256, size=(2, k, 64),
                                            dtype=np.uint8)
    for codec in (mine, theirs):
        with pytest.raises(ValueError, match="m must divide"):
            codec.encode_scatter(data)
        with pytest.raises(ValueError, match="m must divide"):
            codec.parity_owner_slots()
    assert np.array_equal(mine.encode(data), _jax(theirs.encode(data)))


def test_codec_refuses_as_the_jax_codec_does():
    M = reed_sol.vandermonde_coding_matrix(6, 2, 8)
    for make, codec in ((distributed.make_mesh, distributed.DistributedCodec),
                        (j_dist.make_mesh, j_dist.DistributedCodec)):
        with pytest.raises(ValueError, match="must divide over shard axis"):
            codec(M, 8, make(1, 4, 1))
    with pytest.raises(ValueError, match="need 16 devices"):
        distributed.make_mesh(2, 4, 2)
    mine = distributed.DistributedCodec(M, 8, distributed.make_mesh(2, 2, 1))
    with pytest.raises(ValueError, match="does not split"):
        mine.encode(np.zeros((3, 6, 64), np.uint8))


def test_device_list_is_explicit():
    assert parallel.local_devices() == [torch.device("cpu")] * 8
    parallel.configure_devices(None)
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                parallel.local_devices()
        with pytest.raises(ValueError):
            parallel.configure_devices([])
    finally:
        parallel.configure_devices([torch.device("cpu")] * 8)


# -- tests/test_mesh_plugin.py ---------------------------------------------


def _pair(prof):
    mine = registry.instance().factory("cuda", dict(prof, device="cpu"))
    theirs = j_registry.instance().factory("tpu", dict(prof), "")
    return mine, theirs


def test_mesh_encode_bit_exact_vs_jerasure():
    prof = {"technique": "reed_sol_van", "k": "4", "m": "2",
            "mesh_shard": "4", "mesh_sub": "2"}
    mine, theirs = _pair(prof)
    cpu = registry.instance().factory("jerasure", dict(prof))
    want = set(range(6))
    rng = np.random.RandomState(7)
    for size in (4096, 24_000, 100_001):  # odd size: pad+trim path
        payload = rng.randint(0, 256, size=size, dtype=np.uint8)
        a = mine.encode(want, payload)
        b = cpu.encode(want, payload)
        c = theirs.encode(want, payload)
        for ch in want:
            assert np.array_equal(a[ch], b[ch]), f"chunk {ch} size {size}"
            assert np.array_equal(a[ch], c[ch]), f"chunk {ch} size {size}"


def test_mesh_decode_all_two_erasure_signatures():
    prof = {"technique": "reed_sol_van", "k": "4", "m": "2",
            "mesh_shard": "2"}
    mine, theirs = _pair(prof)
    rng = np.random.RandomState(8)
    payload = rng.randint(0, 256, size=16384, dtype=np.uint8)
    want = set(range(6))
    enc = mine.encode(want, payload)
    jenc = theirs.encode(want, payload)
    for erased in itertools.combinations(range(6), 2):
        have = {c: a for c, a in enc.items() if c not in erased}
        dec = mine.decode(want, have)
        jdec = theirs.decode(want, {c: a for c, a in jenc.items()
                                    if c not in erased})
        for c in want:
            assert np.array_equal(dec[c], enc[c]), f"erased={erased} chunk={c}"
            assert np.array_equal(dec[c], jdec[c])


def test_mesh_encode_batch_and_decode_batch():
    prof = {"technique": "reed_sol_van", "k": "8", "m": "4",
            "mesh_shard": "4", "mesh_sub": "2"}
    mine, theirs = _pair(prof)
    cpu = registry.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": "8", "m": "4"})
    rng = np.random.RandomState(9)
    # mixed sizes: the mesh batch paths must sub-group by blocksize
    stripes = [rng.randint(0, 256, size=sz, dtype=np.uint8)
               for sz in (32768, 16000, 32768, 16000, 8192)]
    encs = mine.encode_batch(stripes)
    jencs = theirs.encode_batch(stripes)
    want = set(range(12))
    for s, enc, jenc in zip(stripes, encs, jencs):
        ref = cpu.encode(want, s)
        for c in want:
            assert np.array_equal(enc[c], ref[c])
            assert np.array_equal(enc[c], jenc[c])
    maps = [{c: a for c, a in enc.items() if c not in (0, 9)} for enc in encs]
    decs = mine.decode_batch(maps)
    jdecs = theirs.decode_batch(maps)
    for enc, dec, jdec in zip(encs, decs, jdecs):
        for c in want:
            assert np.array_equal(dec[c], enc[c])
            assert np.array_equal(dec[c], jdec[c])
    # the shard-major lane (ecutil's) takes the grid too
    blocks = [np.stack([enc[j] for j in range(8)]) for enc in encs[:2]]
    got, devs = mine.encode_shard_major_batch(blocks)
    assert devs == [None, None]
    for g, enc in zip(got, encs):
        for c in want:
            assert np.array_equal(g[c], enc[c])


@pytest.mark.parametrize("extra", [
    {"technique": "reed_sol_van", "k": "3", "m": "2", "mesh_shard": "2"},
    {"technique": "cauchy_good", "k": "4", "m": "2", "mesh_shard": "2"},
    {"technique": "reed_sol_van", "w": "16", "k": "4", "m": "2",
     "mesh_shard": "2"},
])
def test_mesh_profile_validation(extra):
    """k % shard != 0, a bitmatrix technique, w != 8: EINVAL with the
    JAX plugin's words."""
    with pytest.raises(ErasureCodeError) as mine:
        registry.instance().factory("cuda", dict(extra, device="cpu"))
    with pytest.raises(JErasureCodeError) as theirs:
        j_registry.instance().factory("tpu", dict(extra), "")
    assert mine.value.errno == theirs.value.errno == -errno.EINVAL
    assert str(mine.value) == str(theirs.value)


def test_mesh_profile_refuses_a_device_list_of_another_type():
    ec = registry.instance().factory(
        "cuda", {"k": "4", "m": "2", "mesh_shard": "2", "device": "cpu"})
    assert not ec.mesh_plane_capable
    ec._device = torch.device("meta")  # a profile of another device type
    with pytest.raises(ValueError, match="runs on meta devices"):
        ec.encode(set(range(6)), np.zeros(4096, np.uint8))


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def test_mesh_plugin_through_storage_engine():
    """ECCluster with a grid pool profile: write -> kill -> degraded read
    -> revive -> auto-recovery, every product on the grid; the stores
    after each step equal the JAX package's with the same profile."""
    prof = {"technique": "reed_sol_van", "k": "4", "m": "2",
            "mesh_shard": "4", "mesh_sub": "2"}
    rng = np.random.RandomState(21)
    payloads = {f"obj{i}": rng.randint(0, 256, 20_000 + 137 * i,
                                       dtype=np.uint8).tobytes()
                for i in range(4)}
    overwrites = {oid: rng.randint(0, 256, 22_000, dtype=np.uint8).tobytes()
                  for oid in list(payloads)[:2]}
    snaps = {}

    def hook(tag):
        def snap(c, step, when):
            if when == "end":
                snaps[tag, step] = cluster_bench.store_snapshot(c)
        return snap

    mine = cluster_bench.run_storage_cycle(
        lambda: cluster.ECCluster(8, dict(prof, device="cpu"),
                                  plugin="cuda"),
        payloads, overwrites, writers=4, hook=hook("port"))
    theirs = cluster_bench.run_storage_cycle(
        lambda: j_cluster.ECCluster(8, dict(prof), plugin="tpu"),
        payloads, overwrites, writers=4, hook=hook("jax"))
    assert mine["cluster"].ec._mesh_codec is not None
    assert mine["victim"] == theirs["victim"]
    assert mine["rebuilt_bytes"] == theirs["rebuilt_bytes"] > 0
    for step in cluster_bench.STEPS:
        assert snaps["port", step] == snaps["jax", step], step


# -- the entry twin (__graft_entry__) ---------------------------------------


def test_entry_flagship_matches_jax():
    fn, args = entry.entry(device="cpu")
    jfn, jargs = j_entry.entry()
    got = fn(*args).numpy()
    assert got.shape == (4, 64 * 1024)
    assert np.array_equal(got, _jax(jax.jit(jfn)(*jargs)))
    assert np.array_equal(args[1].numpy(), _jax(jargs[1]))


def _mask(line: str) -> str:
    """The dry-run line with its timings masked and the one renamed gate
    (JAX retraces -> library builds) mapped."""
    line = line.replace("0 steady retraces", "0 steady library builds")
    return re.sub(r"(\d+): [0-9.]+", r"\1: T", line)


def _lines(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue().strip().splitlines()


@pytest.mark.parametrize("n", [1, 4, 8])
def test_dryrun_multichip_fast_matches_jax(n):
    mine = _lines(entry.dryrun_multichip, n, fast=True)
    theirs = _lines(j_entry.dryrun_multichip, n, fast=True)
    assert len(mine) == len(theirs) == 1
    assert _mask(mine[0]) == _mask(theirs[0])
    sizes = [s for s in (1, 2, 4, 8) if s <= n]
    assert f"by mesh size {{{', '.join(f'{s}: T' for s in sizes)}}}" \
        in _mask(mine[0])


def test_dryrun_multichip_full_matches_jax():
    mine = _lines(entry.dryrun_multichip, 8)
    theirs = _lines(j_entry.dryrun_multichip, 8)
    assert [_mask(x) for x in mine] == [_mask(x) for x in theirs]
    assert "storage cycle (write/degraded-read/auto-recover) ok on " \
        "mesh_shard=4" in mine[-1]


def test_dryrun_refuses_more_slots_than_the_list_holds():
    with pytest.raises(RuntimeError, match="needs 16 devices, have 8"):
        entry.dryrun_multichip(16, fast=True)
    assert entry.main(["2", "--device", "cpu", "--fast"]) == 0
    assert parallel.local_devices() == [torch.device("cpu")] * 2
    parallel.configure_devices([torch.device("cpu")] * 8)
