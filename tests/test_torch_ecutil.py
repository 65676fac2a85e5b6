"""The port's ``osd/ecutil.py`` and its crc32c against the JAX package.

Each input is made with numpy from a seed and goes through the JAX
package's ``ecutil`` with the ``tpu`` plugin (on the CPU) and through the
port's with the ``cuda`` plugin on ``device=cpu`` (the kernels' plain
versions).  Tolerance zero: every byte, crc and ``HashInfo`` dict must be
identical.  Covered: the three encode routes (shard-major batch,
``encode_many``, per block with rung padding for a zero-width block), the
resident lane (``keep_device``), ``decode_concat_many`` over every erasure
pattern at k=4 m=2, ``decode_shards_many``, ``HashInfo`` and the stripe
algebra; crc32c's C build against its plain version and the JAX package's
native build, chained and split.
"""

from itertools import combinations

import numpy as np
import pytest

from ceph_tpu.native import gf_native as j_native
from ceph_tpu.osd import ecutil as j_ecutil
from ceph_tpu.plugins import registry as j_registry
from ceph_tpu_torch.native import gf_native
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.plugins import registry

PROFILES = {
    "rs_w8_k4m2": {"technique": "reed_sol_van", "k": "4", "m": "2"},
    "rs_w8_k8m4": {"technique": "reed_sol_van", "k": "8", "m": "4"},
    "rs_w16_k4m2": {"technique": "reed_sol_van", "k": "4", "m": "2",
                    "w": "16"},
    "rs_w16_k8m4": {"technique": "reed_sol_van", "k": "8", "m": "4",
                    "w": "16"},
    "cauchy_good_k4m2": {"technique": "cauchy_good", "k": "4", "m": "2",
                         "packetsize": "8"},
    "cauchy_good_k8m4": {"technique": "cauchy_good", "k": "8", "m": "4",
                         "packetsize": "8"},
}


def _pair(name):
    ours = registry.instance().factory(
        "cuda", dict(PROFILES[name], device="cpu"))
    theirs = j_registry.instance().factory("tpu", dict(PROFILES[name]))
    return ours, theirs


def _sinfo(ec, mod):
    k = ec.get_data_chunk_count()
    return mod.StripeInfo(k, k * ec.get_chunk_size(1))


def _payloads(n, seed, zero_byte=True):
    """Odd object sizes (16_000 + 97 i) and, first, a zero-byte object."""
    rs = np.random.RandomState(seed)
    out = [np.zeros(0, np.uint8)] if zero_byte else []
    out += [rs.randint(0, 256, 16_000 + 97 * i, dtype=np.uint8)
            for i in range(n)]
    return out


def _padded(sinfo, data):
    buf = np.zeros(sinfo.logical_to_next_stripe_offset(len(data)), np.uint8)
    buf[:len(data)] = data
    return buf


def _same(a, b):
    assert set(a) == set(b)
    for key in a:
        assert np.array_equal(np.asarray(a[key]), np.asarray(b[key])), key


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_encode_routes_match_jax(name):
    ours, theirs = _pair(name)
    km, k = ours.get_chunk_count(), ours.get_data_chunk_count()
    sinfo = _sinfo(ours, ecutil)
    j_sinfo = _sinfo(theirs, j_ecutil)
    assert sinfo.stripe_width == j_sinfo.stripe_width
    bufs = [_padded(sinfo, p) for p in _payloads(4, seed=len(name))]
    blocks = [ecutil.to_shard_major(sinfo, k, b) for b in bufs]
    for block, b in zip(blocks, bufs):
        assert np.array_equal(block, j_ecutil.to_shard_major(j_sinfo, k, b))
    # the batch holds a zero-width block: the per-block route (rung
    # padding, parity trimmed) for every block of it
    assert blocks[0].shape[1] == 0
    got = ecutil.encode_shard_major_many(ours, blocks, range(km))
    want = j_ecutil.encode_shard_major_many(theirs, blocks, range(km))
    for g, w in zip(got, want):
        _same(g, w)
    # without it: the shard-major batch route
    got = ecutil.encode_shard_major_many(ours, blocks[1:], range(km))
    for g, w in zip(got, want[1:]):
        _same(g, w)
    # encode_many (transpose + batch) and encode (one object)
    got = ecutil.encode_many(sinfo, ours, bufs, range(km))
    for g, w in zip(got, want):
        _same(g, w)
    _same(ecutil.encode(sinfo, ours, bufs[2], range(km)),
          j_ecutil.encode(j_sinfo, theirs, bufs[2], range(km)))


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_encode_resident_lane_matches_jax(name):
    ours, theirs = _pair(name)
    km, k = ours.get_chunk_count(), ours.get_data_chunk_count()
    sinfo = _sinfo(ours, ecutil)
    blocks = [ecutil.to_shard_major(sinfo, k, _padded(sinfo, p))
              for p in _payloads(3, seed=7, zero_byte=False)]
    keep = [True, False, True]
    got, gdev = ecutil.encode_shard_major_many_resident(
        ours, blocks, range(km), keep)
    want, wdev = j_ecutil.encode_shard_major_many_resident(
        theirs, blocks, range(km), keep)
    for g, w in zip(got, want):
        _same(g, w)
    # matrix codes compose the [k+m, bs] block on the device; packet
    # codes cannot (their device bytes are packet rows), in both packages
    assert [d is None for d in gdev] == [d is None for d in wdev]
    for g, w, g_enc in zip(gdev, wdev, got):
        if g is not None:
            assert np.array_equal(g.numpy(), np.asarray(w))
            assert np.array_equal(g.numpy(),
                                  np.stack([g_enc[c] for c in range(km)]))


def test_bucketed_route_takes_odd_blocks_through_the_pipeline():
    # the per-block route pads an odd blocksize up the rung ladder
    ours, theirs = _pair("rs_w8_k4m2")
    assert ours.shape_bucketing and theirs.shape_bucketing
    rs = np.random.RandomState(5)
    blocks = [np.zeros((4, 0), np.uint8),
              rs.randint(0, 256, (4, 1000), dtype=np.uint8),
              rs.randint(0, 256, (4, 37), dtype=np.uint8)]
    got = ecutil.encode_shard_major_many(ours, blocks, range(6))
    want = j_ecutil.encode_shard_major_many(theirs, blocks, range(6))
    for g, w, b in zip(got, want, blocks):
        _same(g, w)
        assert all(len(g[c]) == b.shape[1] for c in g)


def _encode_all(ec, sinfo, payloads):
    km, k = ec.get_chunk_count(), ec.get_data_chunk_count()
    return [ecutil.encode_shard_major_many(
        ec, [ecutil.to_shard_major(sinfo, k, _padded(sinfo, p))],
        range(km))[0] for p in payloads]


def test_decode_concat_many_every_erasure_pattern_k4m2():
    ours, theirs = _pair("rs_w8_k4m2")
    sinfo, j_sinfo = _sinfo(ours, ecutil), _sinfo(theirs, j_ecutil)
    payloads = _payloads(2, seed=11)
    encs = _encode_all(ours, sinfo, payloads)
    maps = []
    for n_lost in range(0, 3):
        for lost in combinations(range(6), n_lost):
            maps += [{c: a for c, a in e.items() if c not in lost}
                     for e in encs]
    got = ecutil.decode_concat_many(sinfo, ours, maps)
    want = j_ecutil.decode_concat_many(j_sinfo, theirs, maps)
    assert got == want
    for i, data in enumerate(got):
        p = payloads[i % len(payloads)]
        assert data[:len(p)] == p.tobytes()
    assert ecutil.decode_concat(sinfo, ours, maps[-1]) == want[-1]


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_decode_shards_many_matches_jax(name):
    ours, theirs = _pair(name)
    km, k = ours.get_chunk_count(), ours.get_data_chunk_count()
    sinfo, j_sinfo = _sinfo(ours, ecutil), _sinfo(theirs, j_ecutil)
    payloads = _payloads(3, seed=13)
    encs = _encode_all(ours, sinfo, payloads)
    rs = np.random.RandomState(17)
    maps, wants = [], []
    for e in encs:
        lost = sorted(rs.choice(km, km - k, replace=False).tolist())
        maps.append({c: a for c, a in e.items() if c not in lost})
        wants.append(lost)
    got = ecutil.decode_shards_many(ours, maps, wants)
    want = j_ecutil.decode_shards_many(theirs, maps, wants)
    for g, w, e, lost in zip(got, want, encs, wants):
        _same(g, w)
        for c in lost if len(e[0]) else ():
            assert np.array_equal(g[c], e[c])
    assert ecutil.decode_concat_many(sinfo, ours, maps) == \
        j_ecutil.decode_concat_many(j_sinfo, theirs, maps)


@pytest.mark.parametrize("name", ["rs_w8_k4m2", "rs_w16_k8m4",
                                  "cauchy_good_k8m4"])
def test_hashinfo_matches_jax(name):
    ours, theirs = _pair(name)
    km = ours.get_chunk_count()
    sinfo = _sinfo(ours, ecutil)
    encs = _encode_all(ours, sinfo, _payloads(3, seed=19))
    h, jh = ecutil.HashInfo(km), j_ecutil.HashInfo(km)
    size = 0
    for enc in encs:  # chained appends, the zero-byte object first
        h.append(size, enc)
        jh.append(size, enc)
        size += len(enc[0])
        assert h.to_dict() == jh.to_dict()
    assert h.get_total_logical_size(sinfo) == \
        jh.get_total_logical_size(_sinfo(theirs, j_ecutil))
    assert ecutil.HashInfo.from_dict(h.to_dict()).to_dict() == h.to_dict()
    # after an overwrite cleared the hashes, appends track sizes only
    h.cumulative_shard_hashes = []
    jh.cumulative_shard_hashes = []
    h.append(size, encs[1])
    jh.append(size, encs[1])
    assert h.to_dict() == jh.to_dict()
    assert not h.has_chunk_hash()
    assert ecutil.is_hinfo_key_string(ecutil.HINFO_KEY)


def test_stripe_info_algebra_matches_jax():
    rs = np.random.RandomState(23)
    for k, chunk in ((4, 32), (8, 64), (8, 65536), (3, 7)):
        s, js = ecutil.StripeInfo(k, k * chunk), \
            j_ecutil.StripeInfo(k, k * chunk)
        for off in rs.randint(0, 10 * k * chunk, 50).tolist() + [0]:
            for fn in ("logical_to_prev_chunk_offset",
                       "logical_to_next_chunk_offset",
                       "logical_to_prev_stripe_offset",
                       "logical_to_next_stripe_offset",
                       "logical_offset_is_stripe_aligned"):
                assert getattr(s, fn)(off) == getattr(js, fn)(off), fn
            assert s.offset_len_to_stripe_bounds(off, 1000) == \
                js.offset_len_to_stripe_bounds(off, 1000)


# -- crc32c ------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 4096, 100_003])
def test_crc32c_build_plain_and_jax_agree(n):
    data = np.random.RandomState(n).randint(0, 256, n, dtype=np.uint8)
    want = j_native.crc32c(data)
    assert gf_native.crc32c(data) == want
    assert gf_native.crc32c_plain(data) == want
    for kind in (bytes, bytearray, memoryview):
        assert gf_native.crc32c(kind(data.tobytes())) == want
    for seed in (0, 0x12345678):
        assert gf_native.crc32c(data, seed) == j_native.crc32c(data, seed)


def test_crc32c_chains_and_splits():
    data = np.random.RandomState(29).randint(0, 256, 10_007, dtype=np.uint8)
    whole = gf_native.crc32c(data)
    for cut in (0, 1, 8, 333, 5000, 10_007):
        a = gf_native.crc32c(data[:cut])
        assert gf_native.crc32c(data[cut:], a) == whole
        assert gf_native.crc32c_plain(data[cut:],
                                      gf_native.crc32c_plain(data[:cut])) \
            == whole
    # a strided (non-contiguous) view hashes its bytes
    strided = data[::3]
    assert gf_native.crc32c(strided) == j_native.crc32c(strided.copy())


def test_crc32c_rows_matches_jax():
    rs = np.random.RandomState(31)
    chunks = [rs.randint(0, 256, n, dtype=np.uint8)
              for n in (0, 5, 2048, 2049, 65536)]
    chunks.append(chunks[-1].tobytes())
    chunks.append(np.arange(64, dtype=np.uint8)[::2])
    seeds = rs.randint(0, 2**32, len(chunks), dtype=np.uint64).tolist()
    got = gf_native.crc32c_rows(chunks, seeds)
    assert got == j_native.crc32c_rows(chunks, seeds)
    assert got == [gf_native.crc32c_plain(np.asarray(
        np.frombuffer(c, np.uint8) if isinstance(c, bytes) else c).tobytes(),
        s) for c, s in zip(chunks, seeds)]
