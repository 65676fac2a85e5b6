"""The port's stripe-batching pipeline (ceph_tpu_torch.ops.pipeline) on the
CPU against the JAX package's (ceph_tpu.ops.pipeline): the same coding
arrays and the same input bytes must give the same parity and
reconstructed chunks, including granule fusing, top-rung segment splits,
reconstruction rows and the on-device [k+m, bs] block."""

from itertools import combinations

import numpy as np
import pytest
import torch

from ceph_tpu.matrices import bitmatrix as j_bitmatrix
from ceph_tpu.matrices import cauchy as j_cauchy
from ceph_tpu.matrices import reed_sol as j_reed_sol
from ceph_tpu.ops import pipeline as j_pipeline
from ceph_tpu_torch.analysis import residency
from ceph_tpu_torch.ops import pipeline

#: (name, JAX DeviceCodec kwargs): the coding arrays come from the JAX
#: package and are handed to the port unchanged
CODECS = {
    "w8": dict(matrix=j_reed_sol.vandermonde_coding_matrix(4, 3, 8),
               k=4, m=3, w=8),
    "w16": dict(matrix=j_reed_sol.vandermonde_coding_matrix(4, 2, 16),
                k=4, m=2, w=16),
    "w32": dict(matrix=j_reed_sol.vandermonde_coding_matrix(3, 2, 32),
                k=3, m=2, w=32),
    "packet": dict(bitmatrix=j_bitmatrix.matrix_to_bitmatrix(
        j_cauchy.good_general_coding_matrix(4, 2, 8), 8),
        k=4, m=2, w=8, packetsize=16),
}


def _codecs(name):
    kw = CODECS[name]
    return (pipeline.DeviceCodec(**kw, device="cpu"),
            j_pipeline.DeviceCodec(**kw))


def _block_bytes(name, n):
    """A chunk size both pipelines take: whole lanes, whole packet groups."""
    kw = CODECS[name]
    unit = kw["w"] * kw["packetsize"] * 4 if "packetsize" in kw else 4
    return unit * n


@pytest.mark.parametrize("name", sorted(CODECS))
def test_encode_and_decode_match_jax(name):
    ours, theirs = _codecs(name)
    k, m = ours.k, ours.m
    rs = np.random.RandomState(len(name))
    bs = _block_bytes(name, 5)
    data = rs.randint(0, 256, (k, bs), dtype=np.uint8)
    parity = ours.encode(data)
    assert parity.shape == (m, bs)
    assert np.array_equal(parity, theirs.encode(data))
    chunks = {i: c for i, c in enumerate(list(data) + list(parity))}
    for n_lost in range(1, m + 1):
        for lost in combinations(range(k + m), n_lost):
            have = {i: c for i, c in chunks.items() if i not in lost}
            got = ours.decode(have, bs)
            assert all(np.array_equal(got[i], chunks[i]) for i in range(k + m))
            want = theirs.decode(have, bs)
            assert all(np.array_equal(got[i], want[i]) for i in range(k + m))


@pytest.mark.parametrize("name", sorted(CODECS))
def test_fused_granules_and_segment_splits_match_jax(name):
    ours, theirs = _codecs(name)
    k = ours.k
    rs = np.random.RandomState(7)
    unit = _block_bytes(name, 1)
    # stripes of mixed sizes, several wider than the tiny top rung, so both
    # pipelines fuse some stripes and split others into column segments
    stripes = [rs.randint(0, 256, (k, unit * n), dtype=np.uint8)
               for n in (1, 3, 9, 2, 17, 1)]
    max_granule = unit * 4
    ours_pipe = pipeline.EncodePipeline(ours.encode_stream(), depth=1,
                                        max_granule=max_granule)
    theirs_pipe = j_pipeline.EncodePipeline(theirs.encode_stream(), depth=1,
                                            max_granule=max_granule)
    got = ours_pipe.encode_many(stripes)
    want = theirs_pipe.encode_many(stripes)
    for g, w_, s in zip(got, want, stripes):
        assert np.array_equal(g, w_)
        assert np.array_equal(g, ours.encode(s))


def test_decode_stream_reuses_signature_and_matches_jax():
    ours, theirs = _codecs("w8")
    sel, stream = ours.decode_stream([0, 2, 3, 4, 5, 6], [1])
    again = ours.decode_stream([6, 5, 4, 3, 2, 0], [1])
    assert again[1] is stream and sel == [0, 2, 3, 4]
    jsel, _ = theirs.decode_stream([0, 2, 3, 4, 5, 6], [1])
    assert sel == jsel
    rs = np.random.RandomState(3)
    survivors = [rs.randint(0, 256, (4, 64), dtype=np.uint8) for _ in range(3)]
    pipe = pipeline.EncodePipeline(stream)
    rec = pipe.encode_many(survivors)
    jpipe = j_pipeline.EncodePipeline(theirs.decode_stream(
        [0, 2, 3, 4, 5, 6], [1])[1])
    for a, b in zip(rec, jpipe.encode_many(survivors)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("w", [8, 16])
def test_reconstruct_rows_match_jax(w):
    M = j_reed_sol.vandermonde_coding_matrix(5, 3, w)
    for avail in combinations(range(8), 5):
        erased = [i for i in range(8) if i not in avail]
        ours = pipeline.matrix_reconstruct_rows(M, 5, 3, w, avail, erased)
        theirs = j_pipeline.matrix_reconstruct_rows(M, 5, 3, w, avail, erased)
        assert ours[0] == theirs[0] and np.array_equal(ours[1], theirs[1])
    B = CODECS["packet"]["bitmatrix"]
    for avail in combinations(range(6), 4):
        erased = [i for i in range(6) if i not in avail]
        ours = pipeline.bitmatrix_reconstruct_rows(B, 4, 2, 8, avail, erased)
        theirs = j_pipeline.bitmatrix_reconstruct_rows(B, 4, 2, 8, avail,
                                                       erased)
        assert ours[0] == theirs[0] and np.array_equal(ours[1], theirs[1])


@pytest.mark.parametrize("name", ["w8", "w16", "w32"])
def test_device_block_matches_jax(name):
    ours, theirs = _codecs(name)
    k = ours.k
    rs = np.random.RandomState(9)
    unit = _block_bytes(name, 1)
    stripes = [rs.randint(0, 256, (k, unit * n), dtype=np.uint8)
               for n in (3, 6)]
    pipe = pipeline.EncodePipeline(ours.encode_stream(), max_granule=unit * 4)
    jpipe = j_pipeline.EncodePipeline(theirs.encode_stream(),
                                      max_granule=unit * 4)
    for s in stripes:
        t, jt = pipe.submit(s, keep_device=True), jpipe.submit(s,
                                                               keep_device=True)
        parity = pipe.result(t)
        jpipe.result(jt)
        block = pipe.device_result(t)
        assert isinstance(block, torch.Tensor) and block.dtype == torch.uint8
        assert np.array_equal(block.numpy(), np.concatenate([s, parity]))
        assert np.array_equal(block.numpy(), np.asarray(jpipe.device_result(jt)))
        assert pipe.device_result(t) is None  # single-shot


def test_packet_stream_composes_no_device_block():
    ours, _ = _codecs("packet")
    pipe = pipeline.EncodePipeline(ours.encode_stream())
    t = pipe.submit(np.zeros((4, _block_bytes("packet", 1)), np.uint8),
                    keep_device=True)
    pipe.result(t)
    assert pipe.device_result(t) is None


def test_discarded_ticket_is_not_retained():
    ours, _ = _codecs("w8")
    pipe = pipeline.EncodePipeline(ours.encode_stream())
    data = np.arange(4 * 64, dtype=np.uint8).reshape(4, 64)
    t0, t1 = pipe.submit(data), pipe.submit(data[::-1].copy())
    pipe.discard(t0)
    pipe.drain()
    assert np.array_equal(pipe.result(t1), ours.encode(data[::-1].copy()))
    with pytest.raises(KeyError):
        pipe.result(t0)


def test_transfers_are_counted():
    ours, _ = _codecs("w8")
    stream = ours.encode_stream()
    before = residency.counters().snapshot()
    pipe = pipeline.EncodePipeline(stream)
    pipe.encode_many([np.ones((4, 256), np.uint8)] * 2)
    after = residency.counters().snapshot()
    delta = {key: after[key] - before[key] for key in after}
    assert delta["h2d_ops"] == 1 and delta["d2h_ops"] == 1
    # one granule as wide as the two stripes (no rung padding): k rows in,
    # m rows out
    assert delta["h2d_bytes"] == 4 * 512
    assert delta["d2h_bytes"] == 3 * 512


def test_segment_alignment_follows_the_lane_width():
    ours, _ = _codecs("packet")
    stream = ours.encode_stream()
    assert stream.seg_align_bytes() == 8 * 16  # lcm(w*packetsize, w*4)
    assert stream.cols_of(8 * 16 * 3) == 3 * 16 // 4
    w8, _ = _codecs("w8")
    assert w8.encode_stream().seg_align_bytes() == 4


@pytest.mark.parametrize("name", ["w8", "w16", "w32"])
def test_unpack_hands_matrix_codes_a_view_of_the_granule_output(name):
    """A fused granule's stripes come back as views of its host output
    (no strided copy), with each chunk row contiguous, and keep their
    bytes after later granules land."""
    ours, theirs = _codecs(name)
    k = ours.k
    stream = ours.encode_stream()
    outputs = []
    start_d2h = stream.start_d2h

    def capture(out):
        host, done = start_d2h(out)
        outputs.append(host.numpy())
        return host, done

    stream.start_d2h = capture
    rs = np.random.RandomState(13)
    unit = _block_bytes(name, 1)
    stripes = [rs.randint(0, 256, (k, unit * n), dtype=np.uint8)
               for n in (2, 3, 1, 4, 2, 3)]
    pipe = pipeline.EncodePipeline(stream, depth=1, max_granule=unit * 6)
    got = pipe.encode_many(stripes)
    assert len(outputs) > 1
    for g, s in zip(got, stripes):
        owners = [o for o in outputs if np.shares_memory(g, o)]
        assert len(owners) == 1
        assert all(row.flags.c_contiguous for row in g)
        assert np.array_equal(g, theirs.encode(s))
    # a whole-granule stripe and a slice of one give the same bytes as a
    # contiguous copy
    host = outputs[0]
    cols = stream.cols_of(unit * 2)
    view = stream.unpack(host, 0, unit * 2)
    assert np.shares_memory(view, host)
    assert np.array_equal(
        view, np.ascontiguousarray(host[:, :cols]).view(np.uint8))


def test_unpack_copies_packet_rows():
    """Packet codes reorder packet rows into chunks: a new array."""
    ours, theirs = _codecs("packet")
    stream = ours.encode_stream()
    unit = _block_bytes("packet", 1)
    data = np.random.RandomState(5).randint(0, 256, (4, unit * 2),
                                            dtype=np.uint8)
    host = stream.compute(torch.from_numpy(np.zeros(
        (stream.rows_in(), stream.cols_of(unit * 2)), np.int32)))
    host = host.numpy()
    block = stream.unpack(host, 0, unit * 2)
    assert block.shape == (2, unit * 2)
    assert not np.shares_memory(block, host)
    pipe = pipeline.EncodePipeline(stream)
    parity = pipe.result(pipe.submit(data))
    assert np.array_equal(parity, theirs.encode(data))


# -- config-driven rungs and overlap depth ------------------------------------


@pytest.fixture
def rungs_config():
    """Set ``osd_ec_shape_rungs`` in both packages' configs, restored
    after the test."""
    from ceph_tpu.utils import config as j_config
    from ceph_tpu_torch.utils import config

    cfgs = (config.get_config(), j_config.get_config())
    saved = [c.get_val("osd_ec_shape_rungs") for c in cfgs]

    def set_both(raw):
        for c in cfgs:
            c.set_val("osd_ec_shape_rungs", raw)

    yield set_both
    for c, raw in zip(cfgs, saved):
        c.set_val("osd_ec_shape_rungs", raw)


@pytest.mark.parametrize("raw", ["", "4096, 65536 1048576", "64 16 64,32",
                                 "abc,16384", "0 -4096"])
def test_bucketing_ladder_matches_jax(rungs_config, raw):
    """The default ladder, two configured ones and two malformed strings
    (a non-integer token, no positive rung), which fall back to the
    default ladder exactly as the JAX package's do."""
    from ceph_tpu.ops import bucketing as j_bucketing
    from ceph_tpu_torch.ops import bucketing

    rungs_config(raw)
    assert bucketing.ladder() == j_bucketing.ladder()
    if raw in ("", "abc,16384", "0 -4096"):
        assert bucketing.ladder() == bucketing.DEFAULT_RUNGS
    rs = np.random.RandomState(len(raw))
    sizes = [1, 15, 16, 17, 4096, 4097, 65536, 1 << 20, (1 << 24) + 1,
             *rs.randint(1, 40 << 20, 40).tolist()]
    for n in sizes:
        assert bucketing.rung_for(n) == j_bucketing.rung_for(n)
        for align in (1, 4, 16, 24, 4096):
            assert bucketing.bucket_bytes(n, align) == \
                j_bucketing.bucket_bytes(n, align)
        for per_col in (1, 4, 32):
            def cols_of(b, per_col=per_col):
                return b // per_col
            assert bucketing.bucket_cols(n, cols_of) == \
                j_bucketing.bucket_cols(n, cols_of)
    explicit = (16, 4096)
    assert bucketing.bucket_bytes(5000, 8, rungs=explicit) == \
        j_bucketing.bucket_bytes(5000, 8, rungs=explicit)


def test_configured_top_rung_caps_the_granule(rungs_config):
    """A configured ladder's top rung caps the port's granules, as it caps
    the JAX package's: stripes wider than it split into column segments
    and the parity is the same."""
    rungs_config("256 1024")
    ours, theirs = _codecs("w8")
    rs = np.random.RandomState(9)
    stripes = [rs.randint(0, 256, (4, 4 * n), dtype=np.uint8)
               for n in (1, 300, 64, 700)]
    pipe = pipeline.EncodePipeline(ours.encode_stream(), depth=1)
    assert pipe._max_seg_bytes == 1024
    got = pipe.encode_many(stripes)
    want = j_pipeline.EncodePipeline(theirs.encode_stream(),
                                     depth=1).encode_many(stripes)
    for g, w_ in zip(got, want):
        assert np.array_equal(g, w_)


@pytest.mark.parametrize("name", ["w8", "packet"])
def test_overlap_depth_gives_identical_parity(name):
    """``osd_ec_overlap_depth`` 1, 2 and 4 (from the config, read when a
    pipeline is built, and as an argument) give the same parity, equal to
    the JAX package's."""
    from ceph_tpu_torch.utils import config

    ours, theirs = _codecs(name)
    unit = _block_bytes(name, 1)
    rs = np.random.RandomState(11)
    stripes = [rs.randint(0, 256, (ours.k, unit * n), dtype=np.uint8)
               for n in (3, 1, 8, 2, 5, 4, 1, 6)]
    want = [theirs.encode(s) for s in stripes]
    cfg = config.get_config()
    saved = cfg.get_val("osd_ec_overlap_depth")
    try:
        for depth in (1, 2, 4):
            cfg.set_val("osd_ec_overlap_depth", depth)
            pipe = pipeline.EncodePipeline(ours.encode_stream(), depth=2,
                                           max_granule=unit * 4)
            assert pipe.overlap == depth
            explicit = pipeline.EncodePipeline(
                ours.encode_stream(), depth=2, max_granule=unit * 4,
                overlap=depth)
            for p in (pipe, explicit):
                for g, w_ in zip(p.encode_many(stripes), want):
                    assert np.array_equal(g, w_)
    finally:
        cfg.set_val("osd_ec_overlap_depth", saved)
