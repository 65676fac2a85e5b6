"""The operands of the three redesigned codec kernels against the bitmatrix
they come from, and their plain versions against the JAX package.

``cuda_gf.prep_packet`` turns a packet bitmatrix into per-row lists of
ones; ``cuda_gf.prep_matrix_w8`` and ``prep_matrix_w16`` turn a w=8 or
w=16 bitmatrix into nibble tables.  Each must rebuild its bitmatrix
exactly -- the lists by their indices, the tables by applying them to the
8k or 16k unit vectors -- for any bitmatrix: random ones with odd shapes
and all-zero rows, reed_sol_van, cauchy_good and r6, and decode
matrices.  The plain versions compute through those
operands, so matching ``pallas_gf`` (in interpret mode) and ``xla_gf``
byte for byte proves the host prep as well as the arithmetic.

All comparisons are exact.  Inputs are made with numpy from a seed;
data bytes are uniform over 0..255, so half of them are >= 0x80.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ceph_tpu.matrices import bitmatrix as j_bitmatrix
from ceph_tpu.matrices import cauchy as j_cauchy
from ceph_tpu.matrices import reed_sol as j_reed_sol
from ceph_tpu.ops import gf as j_gf
from ceph_tpu.ops import pallas_gf, xla_gf
from ceph_tpu_torch.matrices import bitmatrix, cauchy, reed_sol
from ceph_tpu_torch.ops import cuda_gf


def _bytes(rs, *shape):
    return rs.randint(0, 256, shape, dtype=np.uint8)


def _random_bits(rs, rows, cols, zero_rows=()):
    B = rs.randint(0, 2, (rows, cols)).astype(np.uint8)
    B[list(zero_rows)] = 0
    return B


def _w16_bits(code, k, m, rs):
    if code == "reed_sol_van":
        return bitmatrix.matrix_to_bitmatrix(
            reed_sol.vandermonde_coding_matrix(k, m, 16), 16)
    if code == "r6":
        return bitmatrix.matrix_to_bitmatrix(reed_sol.r6_coding_matrix(k, 16),
                                             16)
    return _random_bits(rs, m * 16, k * 16, zero_rows=(0, m * 16 - 1))


def _rsv_decode_bits(k, m, erased, w):
    """The w-bit bitmatrix that rebuilds the erased data chunks of
    reed_sol_van k, m from the first k survivors (as ``matrix_decode``
    builds it), made with the JAX package's field."""
    M = j_reed_sol.vandermonde_coding_matrix(k, m, w)
    sel = [c for c in range(k + m) if c not in erased][:k]
    A = np.zeros((k, k), dtype=np.uint32)
    for r, cid in enumerate(sel):
        if cid < k:
            A[r, cid] = 1
        else:
            A[r] = M[cid - k]
    inv = j_gf.gf(w).mat_invert(A)
    return j_bitmatrix.matrix_to_bitmatrix(inv[list(erased), :], w)


def _w8_bits(code, k, m, rs):
    if code == "reed_sol_van":
        return bitmatrix.matrix_to_bitmatrix(
            reed_sol.vandermonde_coding_matrix(k, m, 8), 8)
    if code == "cauchy_good":
        return bitmatrix.matrix_to_bitmatrix(
            cauchy.good_general_coding_matrix(k, m, 8), 8)
    if code == "r6":
        return bitmatrix.matrix_to_bitmatrix(reed_sol.r6_coding_matrix(k, 8),
                                             8)
    if code == "decode":  # reed_sol_van k=8 m=4, chunks 1 and 6 erased
        return _rsv_decode_bits(8, 4, (1, 6), 8)
    zero_rows = (0, m * 8 - 1, m * 4) if code == "zero rows" else ()
    return _random_bits(rs, m * 8, k * 8, zero_rows)


def _cauchy_decode_bits(k, m, w, erased):
    """cauchy_good's decoding bitmatrix for the erased data chunks, from
    the first k survivors (as ``bitmatrix_decode`` builds it)."""
    B = j_bitmatrix.matrix_to_bitmatrix(
        j_cauchy.good_general_coding_matrix(k, m, w), w)
    sel = [c for c in range(k + m) if c not in erased][:k]
    return j_bitmatrix.survivor_decode_bitmatrix(B, k, w, sel, list(erased))


# -- the operands rebuild their bitmatrix -------------------------------------


@pytest.mark.parametrize("r,c,zero_rows", [
    (13, 27, ()), (31, 64, (0, 30)), (1, 1, ()), (7, 5, (0, 1, 2, 3, 4, 5, 6)),
    (3, 527, (1,)),
])
def test_packet_lists_rebuild_the_bitmatrix(r, c, zero_rows):
    rs = np.random.RandomState(r * 1000 + c)
    B = _random_bits(rs, r, c, zero_rows)
    lists = cuda_gf.prep_packet(B)
    assert lists.dtype == np.int32 and lists.shape == (r + 1 + B.sum(),)
    off, idx = lists[:r + 1], lists[r + 1:]
    assert off[0] == 0 and np.all(np.diff(off) >= 0)
    rebuilt = np.zeros_like(B)
    for i in range(r):
        row = idx[off[i]:off[i + 1]]
        assert np.all(np.diff(row) > 0)  # ascending, no repeats
        rebuilt[i, row] = 1
    assert np.array_equal(rebuilt, B)


def _apply_tables(tables, k, m, words):
    """The tables applied to one 16-bit word per input row: [k] -> [m]."""
    t = tables.view(np.uint32).reshape(-1, k, 4, 16, 2)
    out = np.zeros(m, dtype=np.uint32)
    for i in range(m):
        g, q = divmod(i, 4)
        for j in range(k):
            for p in range(4):
                e = t[g, j, p, (int(words[j]) >> (4 * p)) & 15, q // 2]
                out[i] ^= (e >> (16 * (q % 2))) & 0xFFFF
    return out


@pytest.mark.parametrize("code,k,m", [
    ("random", 3, 5), ("random", 1, 1), ("random", 5, 9),
    ("reed_sol_van", 8, 4), ("reed_sol_van", 3, 2), ("r6", 6, 2),
    ("decode", 8, 2),
])
def test_nibble_tables_rebuild_the_bitmatrix(code, k, m):
    rs = np.random.RandomState(k * 100 + m)
    B = (_rsv_decode_bits(8, 4, (1, 6), 16) if code == "decode"
         else _w16_bits(code, k, m, rs))
    assert B.shape == (m * 16, k * 16)
    tables = cuda_gf.prep_matrix_w16(B, k)
    assert tables.dtype == np.int32
    assert tables.shape == (-(-m // 4), 128 * k)
    # column 16j + s of B is the image of the unit vector with bit s of
    # word j set
    rebuilt = np.zeros_like(B)
    for j in range(k):
        for s in range(16):
            words = np.zeros(k, dtype=np.uint32)
            words[j] = 1 << s
            image = _apply_tables(tables, k, m, words)
            for i in range(m):
                rebuilt[i * 16:(i + 1) * 16, j * 16 + s] = (
                    image[i] >> np.arange(16)) & 1
    assert np.array_equal(rebuilt, B)
    # rows past m (the last group's padding) are zero
    t = tables.view(np.uint32).reshape(-1, k, 4, 16, 2)
    for i in range(m, -(-m // 4) * 4):
        q = i % 4
        assert not np.any((t[-1, ..., q // 2] >> (16 * (q % 2))) & 0xFFFF)


def _apply_w8_tables(tables, k, m, bytes_):
    """The w=8 tables applied to one byte per input row: [k] -> [m]."""
    t = tables.view(np.uint32).reshape(-1, k, 2, 16)
    out = np.zeros(m, dtype=np.uint32)
    for i in range(m):
        g, r = divmod(i, 4)
        for j in range(k):
            for p in range(2):
                e = t[g, j, p, (int(bytes_[j]) >> (4 * p)) & 15]
                out[i] ^= (e >> (8 * r)) & 0xFF
    return out


@pytest.mark.parametrize("code,k,m", [
    ("random", 3, 5), ("random", 1, 1), ("random", 5, 3), ("random", 7, 8),
    ("random", 1, 12), ("zero rows", 5, 4), ("zero rows", 3, 1),
    ("reed_sol_van", 8, 4), ("reed_sol_van", 3, 2), ("cauchy_good", 8, 4),
    ("cauchy_good", 5, 3), ("r6", 6, 2), ("decode", 8, 2),
])
def test_w8_tables_rebuild_the_bitmatrix(code, k, m):
    rs = np.random.RandomState(k * 100 + m + 7)
    B = _w8_bits(code, k, m, rs)
    assert B.shape == (m * 8, k * 8)
    tables = cuda_gf.prep_matrix_w8(B, k)
    assert tables.dtype == np.int32
    assert tables.shape == (-(-m // 4), 32 * k)
    # column 8j + s of B is the image of the unit vector with bit s of
    # byte j set
    rebuilt = np.zeros_like(B)
    for j in range(k):
        for s in range(8):
            bytes_ = np.zeros(k, dtype=np.uint32)
            bytes_[j] = 1 << s
            image = _apply_w8_tables(tables, k, m, bytes_)
            for i in range(m):
                rebuilt[i * 8:(i + 1) * 8, j * 8 + s] = (
                    image[i] >> np.arange(8)) & 1
    assert np.array_equal(rebuilt, B)
    # bytes of rows past m (the last group's padding) are zero
    t = tables.view(np.uint32).reshape(-1, k, 2, 16)
    for i in range(m, -(-m // 4) * 4):
        assert not np.any((t[-1] >> (8 * (i % 4))) & 0xFF)


# -- the plain versions against the JAX package, encode and decode -----------


@pytest.mark.parametrize("n4", [1, 257, 1003])
@pytest.mark.parametrize("code", ["reed_sol_van", "decode"])
def test_w8_plain_matches_pallas_and_xla(code, n4):
    # reed_sol_van k=8 m=4, and its decode matrix with chunks 1 and 6
    # erased (2 rows out)
    rs = np.random.RandomState(n4 + 3)
    B = _w8_bits(code, 8, 4, rs)
    k, m = 8, B.shape[0] // 8
    data = _bytes(rs, k, n4 * 4)
    tables = torch.from_numpy(cuda_gf.prep_matrix_w8(B, k))
    ours = cuda_gf.matrix_encode_w8(
        tables, torch.from_numpy(data.view(np.int32)), k, m)
    assert ours.dtype == torch.int32 and ours.shape == (m, n4)
    ours = ours.numpy().view(np.uint8)
    with pltpu.force_tpu_interpret_mode():
        theirs = pallas_gf.matrix_encode_w8(B, data, k, m)
    assert np.array_equal(ours, theirs)
    xla = np.asarray(xla_gf._encode_words_kernel(B, data, 8))
    assert np.array_equal(ours, xla)


@pytest.mark.parametrize("code,k,m,n4", [
    ("decode", 8, 2, 257),  # reed_sol_van k=8 m=4, chunks 1 and 6 erased
    ("reed_sol_van", 5, 3, 131), ("r6", 6, 2, 128), ("random", 3, 5, 129),
    ("random", 1, 1, 130),
])
def test_w16_plain_matches_pallas_and_xla(code, k, m, n4):
    rs = np.random.RandomState(n4)
    B = (_rsv_decode_bits(8, 4, (1, 6), 16) if code == "decode"
         else _w16_bits(code, k, m, rs))
    data = _bytes(rs, k, n4 * 4)
    tables = torch.from_numpy(cuda_gf.prep_matrix_w16(B, k))
    ours = cuda_gf.matrix_encode_w16(
        tables, torch.from_numpy(data.view(np.int32)), k, m)
    assert ours.dtype == torch.int32 and ours.shape == (m, n4)
    ours = ours.numpy().view(np.uint8)
    with pltpu.force_tpu_interpret_mode():
        theirs = pallas_gf.matrix_encode_w16(B, data, k, m)
    assert np.array_equal(ours, theirs)
    xla = np.asarray(xla_gf._encode_words_kernel(B, data.view(np.uint16), 16))
    assert np.array_equal(ours, xla.view(np.uint8))


@pytest.mark.parametrize("case,n4", [
    ((0, 4), 129),  # cauchy_good k=6 m=3 w=8, decoding bitmatrices
    ((2,), 128),
    ("zero rows", 131), ("one row", 1),
])
def test_packet_plain_matches_pallas_and_xla(case, n4):
    rs = np.random.RandomState(n4)
    if case == "zero rows":
        B = _random_bits(rs, 15, 37, zero_rows=(0, 7, 14))
    elif case == "one row":
        B = _random_bits(rs, 1, 9)
    else:
        B = _cauchy_decode_bits(6, 3, 8, case)
    r, c = B.shape
    rows = _bytes(rs, c, n4 * 4)
    lists = torch.from_numpy(cuda_gf.prep_packet(B))
    ours = cuda_gf.packet_encode(lists, torch.from_numpy(rows.view(np.int32)),
                                 r)
    assert ours.dtype == torch.int32 and ours.shape == (r, n4)
    ours = ours.numpy().view(np.uint8)
    with pltpu.force_tpu_interpret_mode():
        theirs = pallas_gf.packet_encode(B, rows)
    assert np.array_equal(ours, theirs)
    xla = np.asarray(xla_gf._encode_packets_kernel(B, rows))
    assert np.array_equal(ours, xla)


def test_packet_probe_builds_change_only_their_constants():
    # the probe's builds are the kernel's source with the constants it
    # names replaced, or with the tile copies removed; a change to the
    # source that drops an anchor raises instead of timing the wrong build
    from ceph_tpu_torch.tools import packet_probe

    shipped = cuda_gf.SOURCE.read_text()
    assert packet_probe.setting_source(
        *packet_probe.SHIPPED.values()) == shipped
    for setting in packet_probe.SETTINGS:
        changed = packet_probe.setting_source(*setting)
        assert changed != shipped
        assert len(changed.splitlines()) == len(shipped.splitlines())
    no_copy = packet_probe.no_copy_source()
    assert no_copy.count("cp_async_lanes<VEC>(") == 1
    assert "if (false)" in no_copy and "if (false)" not in shipped


def test_w8_probe_builds_change_only_their_constants():
    # the probe's builds are the kernel's source and header with the
    # constants it names replaced, or with the lookups or the input loads
    # replaced; a change to the source that drops an anchor raises instead
    # of timing the wrong build
    from ceph_tpu_torch.tools import w8_probe

    shipped = cuda_gf.SOURCE.read_text()
    header = (cuda_gf.CSRC / w8_probe.HEADER).read_text()
    assert w8_probe.setting_source(*w8_probe.SHIPPED.values()) == shipped
    for setting in w8_probe.SETTINGS:
        changed = w8_probe.setting_source(*setting)
        assert changed != shipped
        assert len(changed.splitlines()) == len(shipped.splitlines())
    builds = w8_probe.builds()
    assert builds["kernel"] == (shipped, header)
    source, no_lookup = builds["loads+stores"]
    assert source == shipped and no_lookup != header
    assert no_lookup.count("return;") == header.count("return;") + 1
    no_load, same = builds["lookups+stores"]
    assert same == header
    assert "load_lanes<VEC>(x +" in shipped
    assert "load_lanes<VEC>(x +" not in no_load
    assert len(builds) == 3 + len(w8_probe.SETTINGS)


def test_main_path_trace_counts_every_codec_kernel():
    # trace_main_path sums the device time of the codec kernels by name;
    # every __global__ function of gf_kernels.cu must be counted there
    import re

    from ceph_tpu_torch.tools import trace_main_path

    kernels = re.findall(
        r"__global__ void __launch_bounds__\([^)]*\)\n(\w+)\(",
        cuda_gf.SOURCE.read_text())
    assert len(kernels) >= 2
    for name in kernels:
        assert trace_main_path._classify(
            f"void (anonymous namespace)::{name}<4>(...)") == "gf2_kernels"
    assert trace_main_path._classify("Memcpy HtoD (Pinned -> Device)") == \
        "h2d"
