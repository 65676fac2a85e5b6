"""The port's ``cuda`` plugin on ``device=cpu`` against the JAX package's
``tpu`` plugin, for every jerasure technique: sync encode, decode of every
erasure pattern up to m, the batched API, the shard-major lane and odd
blocksizes (the bucketing path) -- all bit-exact.  Also the port's
registry and its ec_benchmark tool."""

import contextlib
import errno
import io
from itertools import combinations

import numpy as np
import pytest
import torch

from ceph_tpu.plugins import jerasure as j_jerasure
from ceph_tpu.plugins import registry as j_registry
from ceph_tpu_torch.plugins import jerasure, registry
from ceph_tpu_torch.plugins.interface import ErasureCodeError
from ceph_tpu_torch.tools import ec_benchmark

#: one small profile per technique (plus the other word sizes and a
#: packetsize that is no multiple of the 4-byte lane)
PROFILES = {
    "reed_sol_van": {"technique": "reed_sol_van", "k": "4", "m": "2"},
    "reed_sol_van_w16": {"technique": "reed_sol_van", "k": "4", "m": "2",
                         "w": "16"},
    "reed_sol_van_w32": {"technique": "reed_sol_van", "k": "3", "m": "3",
                         "w": "32"},
    "reed_sol_r6_op": {"technique": "reed_sol_r6_op", "k": "4"},
    "cauchy_orig": {"technique": "cauchy_orig", "k": "3", "m": "2",
                    "packetsize": "8"},
    "cauchy_good": {"technique": "cauchy_good", "k": "4", "m": "2",
                    "packetsize": "8"},
    "cauchy_good_ps3": {"technique": "cauchy_good", "k": "4", "m": "2",
                        "packetsize": "3"},
    "liberation": {"technique": "liberation", "k": "4", "w": "7",
                   "packetsize": "8"},
    "blaum_roth": {"technique": "blaum_roth", "k": "4", "w": "6",
                   "packetsize": "8"},
    "liber8tion": {"technique": "liber8tion", "k": "4", "packetsize": "8"},
}


def test_every_jerasure_technique_is_covered():
    assert {p["technique"] for p in PROFILES.values()} == \
        set(jerasure.TECHNIQUES) == set(j_jerasure.TECHNIQUES)


def _pair(name):
    ours = registry.instance().factory(
        "cuda", {**PROFILES[name], "device": "cpu"})
    theirs = j_registry.instance().factory("tpu", dict(PROFILES[name]))
    return ours, theirs


def _same_maps(a, b):
    assert set(a) == set(b)
    for c in a:
        assert np.array_equal(np.asarray(a[c]), np.asarray(b[c])), c


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_encode_and_every_decode_pattern_match_jax(name):
    ours, theirs = _pair(name)
    n, k = ours.get_chunk_count(), ours.get_data_chunk_count()
    rs = np.random.RandomState(len(name))
    want = set(range(n))
    for size in (1000, ours.get_chunk_size(1) * k * 2):
        payload = rs.randint(0, 256, size, dtype=np.uint8)
        enc = ours.encode(want, payload)
        _same_maps(enc, theirs.encode(want, payload))
        for n_lost in range(1, n - k + 1):
            for lost in combinations(range(n), n_lost):
                have = {c: a for c, a in enc.items() if c not in lost}
                got = ours.decode(want, have)
                _same_maps(got, enc)
                _same_maps(got, theirs.decode(want, have))
        assert ours.decode_concat(
            {c: a for c, a in enc.items() if c != 0})[:size] == payload.tobytes()


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_batched_api_matches_jax(name):
    ours, theirs = _pair(name)
    n, k = ours.get_chunk_count(), ours.get_data_chunk_count()
    rs = np.random.RandomState(17 + len(name))
    size = ours.get_chunk_size(1) * k * 3
    stripes = [rs.randint(0, 256, size, dtype=np.uint8) for _ in range(3)]
    enc = ours.encode_batch(stripes)
    for a, b in zip(enc, theirs.encode_batch(stripes)):
        _same_maps(a, b)
    maps = [{c: a for c, a in e.items() if c not in lost}
            for e, lost in zip(enc, [(0,), (1, n - 1), (0,)])]
    for a, b, e in zip(ours.decode_batch(maps), theirs.decode_batch(maps), enc):
        _same_maps(a, b)
        _same_maps(a, e)


@pytest.mark.parametrize("name", ["reed_sol_van", "reed_sol_van_w16",
                                  "cauchy_good", "liberation"])
def test_shard_major_batch_matches_jax(name):
    ours, theirs = _pair(name)
    k = ours.get_data_chunk_count()
    rs = np.random.RandomState(5)
    bs = ours.get_chunk_size(1) * 2
    blocks = [rs.randint(0, 256, (k, bs), dtype=np.uint8) for _ in range(3)]
    keep = [True, False, True]
    got, devs = ours.encode_shard_major_batch(blocks, keep)
    want, _ = theirs.encode_shard_major_batch(blocks, keep)
    for a, b in zip(got, want):
        _same_maps(a, b)
    packet_code = getattr(ours, "bitmatrix", None) is not None
    for blk, kept, enc in zip(devs, keep, got):
        if not kept or packet_code:
            assert blk is None  # packet codes keep no plain-byte block
            continue
        assert isinstance(blk, torch.Tensor) and blk.dtype == torch.uint8
        assert np.array_equal(blk.numpy(),
                              np.stack([enc[c] for c in range(len(enc))]))


@pytest.mark.parametrize("name,bs", [("reed_sol_van", 18), ("reed_sol_van", 1030),
                                     ("reed_sol_van_w16", 34),
                                     ("cauchy_good_ps3", 24 * 5)])
def test_odd_blocksizes_ride_the_bucketed_pipeline(name, bs):
    ours, theirs = _pair(name)
    k, n = ours.get_data_chunk_count(), ours.get_chunk_count()
    assert not ours._pipeline_ok(bs)
    rs = np.random.RandomState(bs)
    data = rs.randint(0, 256, (k, bs), dtype=np.uint8)
    parity = ours.jerasure_encode(data)
    assert np.array_equal(parity, theirs.jerasure_encode(data))
    chunks = {i: c for i, c in enumerate(list(data) + list(parity))}
    for lost in combinations(range(n), 2):
        have = {i: c for i, c in chunks.items() if i not in lost}
        got = ours.jerasure_decode(have, bs)
        _same_maps(got, theirs.jerasure_decode(have, bs))
        _same_maps(got, chunks)


@pytest.mark.parametrize("profile", [
    {"technique": "cauchy_good", "k": "32", "m": "8", "packetsize": "8"},
    {"technique": "liberation", "k": "17", "w": "31", "packetsize": "4"},
], ids=["cauchy_good_k32", "liberation_w31"])
def test_wide_packet_profiles_match_jax(profile):
    ours = registry.instance().factory("cuda", {**profile, "device": "cpu"})
    theirs = j_registry.instance().factory("tpu", dict(profile))
    n, k = ours.get_chunk_count(), ours.get_data_chunk_count()
    rs = np.random.RandomState(n)
    want = set(range(n))
    payload = rs.randint(0, 256, ours.get_chunk_size(1) * k, dtype=np.uint8)
    enc = ours.encode(want, payload)
    _same_maps(enc, theirs.encode(want, payload))
    have = {c: a for c, a in enc.items() if c not in (1, n - 1)}
    got = ours.decode(want, have)
    _same_maps(got, enc)
    _same_maps(got, theirs.decode(want, have))


# -- registry ----------------------------------------------------------------


def test_cuda_plugin_is_registered_and_checks_profiles():
    reg = registry.instance()
    ec = reg.factory("cuda", {"k": "2", "m": "1", "device": "cpu"})
    assert ec.get_profile()["technique"] == "reed_sol_van"
    assert ec.get_profile()["backend"] == "cuda"
    with pytest.raises(ErasureCodeError) as err:
        reg.factory("cuda", {"technique": "nope", "device": "cpu"})
    assert err.value.errno == -errno.ENOENT
    # a mesh profile is taken (the grid codec, parallel/distributed.py);
    # one whose k does not split over mesh_shard is EINVAL, as in the
    # JAX tpu plugin
    assert reg.factory("cuda", {"k": "4", "m": "2", "mesh_shard": "2",
                                "device": "cpu"})._mesh_active()
    with pytest.raises(ErasureCodeError) as err:
        reg.factory("cuda", {"k": "3", "m": "2", "mesh_shard": "2",
                             "device": "cpu"})
    assert err.value.errno == -errno.EINVAL
    with pytest.raises(ErasureCodeError) as err:
        reg.factory("nope", {})
    assert err.value.errno == -errno.ENOENT


def test_cuda_plugin_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        registry.instance().factory("cuda", {"k": "2", "m": "1"})
    # the numpy jerasure plugin needs no device
    ec = registry.instance().factory("jerasure", {"k": "2", "m": "1"})
    assert len(ec.encode({0, 1, 2}, b"x" * 100)) == 3


def test_directory_plugins_load_with_the_handshake(tmp_path):
    (tmp_path / "ec_mine.py").write_text(
        "from ceph_tpu_torch.plugins import registry, jerasure\n"
        "def __erasure_code_version__():\n"
        "    from ceph_tpu_torch import __version__\n"
        "    return __version__\n"
        "def __erasure_code_init__(name, directory):\n"
        "    registry.instance().add(name, jerasure.ErasureCodePluginJerasure())\n"
        "    return 0\n")
    (tmp_path / "ec_old.py").write_text(
        "def __erasure_code_version__():\n    return '0.0.1'\n")
    (tmp_path / "ec_silent.py").write_text(
        "def __erasure_code_version__():\n"
        "    from ceph_tpu_torch import __version__\n"
        "    return __version__\n"
        "def __erasure_code_init__(name, directory):\n    return 0\n")
    reg = registry.ErasureCodePluginRegistry()
    ec = reg.factory("mine", {"k": "3", "m": "2"}, str(tmp_path))
    assert ec.get_chunk_count() == 5
    with pytest.raises(ErasureCodeError) as err:
        reg.factory("old", {}, str(tmp_path))
    assert err.value.errno == -errno.EXDEV
    with pytest.raises(ErasureCodeError) as err:
        reg.factory("silent", {}, str(tmp_path))
    assert err.value.errno == -errno.EBADF


# -- ec_benchmark --------------------------------------------------------------


def _bench(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ec_benchmark.main(argv)
    return rc, buf.getvalue().strip().splitlines()


@pytest.mark.parametrize("argv,kib", [
    (["-w", "encode", "-i", "2"], 2 * 64),
    (["-w", "encode", "-i", "2", "-b", "3"], 2 * 3 * 64),
    (["-w", "decode", "-i", "2", "-b", "3", "--erased", "1", "--erased", "4"],
     2 * 3 * 64),
    (["-w", "decode", "-i", "1", "-E", "exhaustive", "-e", "2"], 64),
    (["-w", "decode", "-i", "2", "-e", "2", "--payload", "random"], 2 * 64),
])
def test_ec_benchmark_cuda_plugin_on_cpu(argv, kib):
    rc, out = _bench(["-p", "cuda", "-s", str(64 << 10), "-P", "k=4",
                      "-P", "m=2", "-P", "device=cpu", *argv])
    assert rc == 0
    seconds, got_kib = out[-1].split("\t")
    assert float(seconds) > 0 and int(got_kib) == kib


def test_ec_benchmark_rejects_bad_k():
    rc, out = _bench(["-p", "cuda", "-P", "k=0", "-P", "device=cpu"])
    assert rc == -22 and "k needs to be > 0" in out[0]


def test_ec_benchmark_defaults_to_the_card(monkeypatch):
    made = []
    factory = registry.ErasureCodePluginRegistry.factory

    def spy(self, name, profile, *args, **kwargs):
        made.append(name)
        return factory(self, name, profile, *args, **kwargs)

    monkeypatch.setattr(registry.ErasureCodePluginRegistry, "factory", spy)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _bench(["-s", "4096", "-P", "k=2", "-P", "m=1"])
    assert made == ["cuda"]
    # the CPU only where the caller asks for it
    rc, out = _bench(["-s", "4096", "-P", "k=2", "-P", "m=1",
                      "-P", "device=cpu"])
    assert rc == 0 and made == ["cuda", "cuda"]
