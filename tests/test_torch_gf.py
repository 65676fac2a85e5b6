"""The port's GF(2^w) engine (ceph_tpu_torch.ops / .matrices) against the
JAX package: field tables, coding matrices, the numpy oracle, the plain
versions of the three CUDA kernels against the Pallas kernels run in
interpret mode, the plain XLA-program twins, and the engine API.

All comparisons are exact: the codecs are integer maps, so every byte must
match.  Inputs are made with numpy from a seed and handed to both sides;
data bytes are uniform over 0..255, so half of them are >= 0x80.
"""

from itertools import combinations

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ceph_tpu.matrices import bitmatrix as j_bitmatrix
from ceph_tpu.matrices import cauchy as j_cauchy
from ceph_tpu.matrices import liberation as j_liberation
from ceph_tpu.matrices import reed_sol as j_reed_sol
from ceph_tpu.ops import cpu_engine as j_cpu_engine
from ceph_tpu.ops import gf as j_gf
from ceph_tpu.ops import pallas_gf, xla_gf
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.matrices import bitmatrix, cauchy, liberation, reed_sol
from ceph_tpu_torch.ops import cpu_engine, cuda_gf, gf, torch_gf

CPU = torch.device("cpu")


def _bytes(rs, *shape):
    return rs.randint(0, 256, shape, dtype=np.uint8)


# -- host tables and matrices (copied modules stay identical) ---------------


@pytest.mark.parametrize("w", [4, 8, 16])
def test_field_tables_match(w):
    a, b = gf.gf(w), j_gf.gf(w)
    assert np.array_equal(a.exp_table, b.exp_table)
    assert np.array_equal(a.log_table, b.log_table)
    if w == 8:
        assert np.array_equal(a.mul_table, b.mul_table)


def test_field_w32_scalar_ops_match():
    rs = np.random.RandomState(0)
    a, b = gf.gf(32), j_gf.gf(32)
    for x, y in rs.randint(1, 2**32, (50, 2), dtype=np.uint64):
        assert a.mul(int(x), int(y)) == b.mul(int(x), int(y))
        assert a.inv(int(x)) == b.inv(int(x))


@pytest.mark.parametrize("k,m,w", [(2, 1, 8), (4, 2, 8), (8, 4, 8),
                                   (6, 3, 16), (4, 2, 32), (10, 4, 8)])
def test_reed_sol_and_cauchy_matrices_match(k, m, w):
    pairs = [
        (reed_sol.vandermonde_coding_matrix(k, m, w),
         j_reed_sol.vandermonde_coding_matrix(k, m, w)),
        (reed_sol.r6_coding_matrix(k, w), j_reed_sol.r6_coding_matrix(k, w)),
        (cauchy.original_coding_matrix(k, m, w),
         j_cauchy.original_coding_matrix(k, m, w)),
        (cauchy.good_general_coding_matrix(k, m, w),
         j_cauchy.good_general_coding_matrix(k, m, w)),
    ]
    for ours, theirs in pairs:
        assert ours.dtype == theirs.dtype
        assert np.array_equal(ours, theirs)
        if w <= 16:
            assert np.array_equal(bitmatrix.matrix_to_bitmatrix(ours, w),
                                  j_bitmatrix.matrix_to_bitmatrix(theirs, w))


@pytest.mark.parametrize("k,w", [(2, 5), (4, 7), (6, 7), (3, 11)])
def test_raid6_bitmatrices_match(k, w):
    assert np.array_equal(liberation.liberation_coding_bitmatrix(k, w),
                          j_liberation.liberation_coding_bitmatrix(k, w))
    assert np.array_equal(liberation.blaum_roth_coding_bitmatrix(k, w - 1),
                          j_liberation.blaum_roth_coding_bitmatrix(k, w - 1))
    kk = min(k, 8)
    assert np.array_equal(liberation.liber8tion_coding_bitmatrix(kk),
                          j_liberation.liber8tion_coding_bitmatrix(kk))


def test_survivor_decode_bitmatrix_matches():
    B = liberation.liberation_coding_bitmatrix(4, 7)
    for sel in combinations(range(6), 4):
        erased = [e for e in range(4) if e not in sel]
        if not erased:
            continue
        assert np.array_equal(
            bitmatrix.survivor_decode_bitmatrix(B, 4, 7, list(sel), erased),
            j_bitmatrix.survivor_decode_bitmatrix(B, 4, 7, list(sel), erased))


@pytest.mark.parametrize("w", [8, 16, 32])
def test_cpu_engine_matches(w):
    rs = np.random.RandomState(w)
    M = reed_sol.vandermonde_coding_matrix(5, 3, w)
    data = _bytes(rs, 5, 96)
    coding = cpu_engine.matrix_encode(M, data, w)
    assert np.array_equal(coding, j_cpu_engine.matrix_encode(M, data, w))
    chunks = {i: c for i, c in enumerate(list(data) + list(coding))}
    for lost in [(0,), (1, 6), (2, 5, 7)]:
        have = {i: c for i, c in chunks.items() if i not in lost}
        ours = cpu_engine.matrix_decode(M, have, 5, 3, w, 96)
        theirs = j_cpu_engine.matrix_decode(M, have, 5, 3, w, 96)
        assert all(np.array_equal(ours[i], theirs[i]) for i in range(8))
    B = bitmatrix.matrix_to_bitmatrix(cauchy.good_general_coding_matrix(4, 2, 8), 8)
    data = _bytes(rs, 4, 8 * 16 * 3)
    assert np.array_equal(cpu_engine.bitmatrix_encode(B, data, 8, 16),
                          j_cpu_engine.bitmatrix_encode(B, data, 8, 16))


# -- the kernels' plain versions against the Pallas kernels ----------------


@pytest.mark.parametrize("k,m,n4", [(8, 4, 257), (3, 2, 129), (4, 5, 384)])
def test_matrix_w8_plain_matches_pallas(k, m, n4):
    rs = np.random.RandomState(k * 100 + n4)
    B = bitmatrix.matrix_to_bitmatrix(
        reed_sol.vandermonde_coding_matrix(k, m, 8), 8)
    data = _bytes(rs, k, n4 * 4)
    d32 = torch.from_numpy(data.view(np.int32))
    tables = torch.from_numpy(cuda_gf.prep_matrix_w8(B, k))
    ours = cuda_gf.matrix_encode_w8(tables, d32, k, m)
    assert ours.dtype == torch.int32 and ours.shape == (m, n4)
    with pltpu.force_tpu_interpret_mode():
        theirs = pallas_gf.matrix_encode_w8(B, data, k, m)
    assert np.array_equal(ours.numpy().view(np.uint8), theirs)
    xla = np.asarray(xla_gf._encode_words_kernel(B, data, 8))
    assert np.array_equal(ours.numpy().view(np.uint8), xla)


@pytest.mark.parametrize("k,m,n4", [(8, 4, 257), (3, 2, 130)])
def test_matrix_w16_plain_matches_pallas(k, m, n4):
    rs = np.random.RandomState(k * 100 + n4 + 1)
    B = bitmatrix.matrix_to_bitmatrix(
        reed_sol.vandermonde_coding_matrix(k, m, 16), 16)
    data = _bytes(rs, k, n4 * 4)
    d32 = torch.from_numpy(data.view(np.int32))
    tables = torch.from_numpy(cuda_gf.prep_matrix_w16(B, k))
    ours = cuda_gf.matrix_encode_w16(tables, d32, k, m).numpy().view(np.uint8)
    with pltpu.force_tpu_interpret_mode():
        theirs = pallas_gf.matrix_encode_w16(B, data, k, m)
    assert np.array_equal(ours, theirs)
    xla = np.asarray(xla_gf._encode_words_kernel(B, data.view(np.uint16), 16))
    assert np.array_equal(ours, xla.view(np.uint8))


@pytest.mark.parametrize("r,c,n4", [(32, 64, 257), (14, 28, 129), (3, 10, 128)])
def test_packet_plain_matches_pallas(r, c, n4):
    rs = np.random.RandomState(r * 1000 + c + n4)
    B = rs.randint(0, 2, (r, c)).astype(np.uint8)
    rows = _bytes(rs, c, n4 * 4)
    lists = torch.from_numpy(cuda_gf.prep_packet(B))
    # offsets for r rows, then one input-row index per 1 of B
    assert lists.shape == (r + 1 + B.sum(),)
    ours = cuda_gf.packet_encode(lists, torch.from_numpy(rows.view(np.int32)),
                                 r).numpy().view(np.uint8)
    with pltpu.force_tpu_interpret_mode():
        theirs = pallas_gf.packet_encode(B, rows)
    assert np.array_equal(ours, theirs)
    xla = np.asarray(xla_gf._encode_packets_kernel(B, rows))
    assert np.array_equal(ours, xla)


def test_lane_masks_encode_the_bitmatrix():
    rs = np.random.RandomState(5)
    # w=8: byte r of entry (g, j, p, v) of the nibble tables holds, for
    # output row 4g + r, the XOR of the columns 8j + 4p + s of its bit-rows
    # over the bits s of v
    B = rs.randint(0, 2, (3 * 8, 5 * 8)).astype(np.uint8)
    tables = cuda_gf.prep_matrix_w8(B, 5).view(np.uint32)
    assert tables.shape == (1, 32 * 5)
    t8 = tables.reshape(1, 5, 2, 16)
    for i in range(3):
        for j in range(5):
            for p in range(2):
                for v in range(16):
                    byte = 0
                    for s in range(4):
                        if v >> s & 1:
                            col = B[8 * i:8 * i + 8, 8 * j + 4 * p + s]
                            byte ^= sum(int(b) << t_ for t_, b in
                                        enumerate(col))
                    assert t8[0, j, p, v] >> (8 * i) & 0xFF == byte
    assert not np.any(t8 >> 24)  # byte 3: no fourth output row
    # w=16: entry (g, j, p, v) of the nibble tables holds, for output
    # words 4g .. 4g+3, the XOR of the columns 16j + 4p + s of their
    # bit-rows over the bits s of v
    B = rs.randint(0, 2, (3 * 16, 5 * 16)).astype(np.uint8)
    tables = cuda_gf.prep_matrix_w16(B, 5).view(np.uint32)
    t = tables.reshape(1, 5, 4, 16, 2)
    for i in range(3):
        for j in range(5):
            for p in range(4):
                for v in range(16):
                    word = 0
                    for s in range(4):
                        if v >> s & 1:
                            col = B[16 * i:16 * i + 16, 16 * j + 4 * p + s]
                            word ^= sum(int(b) << t_ for t_, b in
                                        enumerate(col))
                    entry = t[0, j, p, v, i // 2] >> (16 * (i % 2)) & 0xFFFF
                    assert entry == word
    assert not np.any(t[0, ..., 1] >> 16)  # word 3: no fourth output row


# -- the XLA programs' plain twins ------------------------------------------


@pytest.mark.parametrize("w", [8, 16, 32])
def test_encode_words_matches_xla(w):
    rs = np.random.RandomState(w + 7)
    B = bitmatrix.matrix_to_bitmatrix(
        reed_sol.vandermonde_coding_matrix(4, 3, w), w)
    data = _bytes(rs, 4, 4 * 37)
    words = data.view({8: np.uint8, 16: np.uint16, 32: np.uint32}[w])
    theirs = np.asarray(xla_gf._encode_words_kernel(B, words, w))
    ours = torch_gf._encode_words(torch.from_numpy(B), torch.from_numpy(data),
                                  w)
    assert np.array_equal(ours.numpy(), theirs.view(np.uint8))


def test_encode_bytes_and_row_tables_match_xla():
    rs = np.random.RandomState(11)
    M = reed_sol.vandermonde_coding_matrix(6, 3, 8)
    tab = torch_gf.gf8_row_tables(M)
    assert np.array_equal(tab, xla_gf.gf8_row_tables(M))
    data = _bytes(rs, 6, 301)
    ours = torch_gf._encode_bytes(torch.from_numpy(tab),
                                  torch.from_numpy(data)).numpy()
    assert np.array_equal(ours, np.asarray(xla_gf._encode_bytes_kernel(tab, data)))
    assert np.array_equal(ours, cpu_engine.matrix_encode(M, data, 8))


def test_encode_packet_bits_matches_xla():
    rs = np.random.RandomState(12)
    B = rs.randint(0, 2, (14, 35)).astype(np.uint8)
    rows = _bytes(rs, 35, 77)
    ours = torch_gf._encode_packet_bits(torch.from_numpy(B),
                                        torch.from_numpy(rows)).numpy()
    assert np.array_equal(ours, np.asarray(xla_gf._encode_packets_kernel(B, rows)))


# -- the engine API (jerasure backend=cuda) ----------------------------------


@pytest.mark.parametrize("w,size", [(8, 96), (8, 98), (16, 96), (16, 98),
                                    (32, 96)])
def test_matrix_engine_matches_xla_gf(w, size):
    rs = np.random.RandomState(w * size)
    k, m = 5, 3
    M = reed_sol.vandermonde_coding_matrix(k, m, w)
    data = _bytes(rs, k, size)
    coding = torch_gf.matrix_encode(M, data, w, device="cpu")
    assert np.array_equal(coding, xla_gf.matrix_encode(M, data, w))
    chunks = {i: c for i, c in enumerate(list(data) + list(coding))}
    for lost in [(1,), (0, 7), (2, 3, 6)]:
        have = {i: c for i, c in chunks.items() if i not in lost}
        ours = torch_gf.matrix_decode(M, have, k, m, w, size, device="cpu")
        theirs = xla_gf.matrix_decode(M, have, k, m, w, size)
        assert all(np.array_equal(ours[i], theirs[i]) for i in range(k + m))


@pytest.mark.parametrize("technique,k,w,packetsize", [
    ("cauchy_good", 4, 8, 8), ("liberation", 4, 7, 4), ("cauchy_orig", 3, 4, 3),
])
def test_bitmatrix_engine_matches_xla_gf(technique, k, w, packetsize):
    rs = np.random.RandomState(k * w + packetsize)
    m = 2
    if technique == "liberation":
        B = liberation.liberation_coding_bitmatrix(k, w)
    else:
        make = cauchy.good_general_coding_matrix if technique == "cauchy_good" \
            else cauchy.original_coding_matrix
        B = bitmatrix.matrix_to_bitmatrix(make(k, m, w), w)
    size = w * packetsize * 3
    data = _bytes(rs, k, size)
    coding = torch_gf.bitmatrix_encode(B, data, w, packetsize, device="cpu")
    assert np.array_equal(coding, xla_gf.bitmatrix_encode(B, data, w, packetsize))
    chunks = {i: c for i, c in enumerate(list(data) + list(coding))}
    for lost in combinations(range(k + m), 2):
        have = {i: c for i, c in chunks.items() if i not in lost}
        ours = torch_gf.bitmatrix_decode(B, have, k, m, w, size, packetsize,
                                         device="cpu")
        theirs = xla_gf.bitmatrix_decode(B, have, k, m, w, size, packetsize)
        assert all(np.array_equal(ours[i], theirs[i]) for i in range(k + m))


# -- wrapper contract --------------------------------------------------------


def test_wrappers_check_their_operands():
    B = bitmatrix.matrix_to_bitmatrix(reed_sol.vandermonde_coding_matrix(4, 2, 8), 8)
    tables8 = torch.from_numpy(cuda_gf.prep_matrix_w8(B, 4))
    d32 = torch.zeros((4, 16), dtype=torch.int32)
    with pytest.raises(TypeError):
        cuda_gf.matrix_encode_w8(tables8, d32.to(torch.int64), 4, 2)
    with pytest.raises(ValueError):
        cuda_gf.matrix_encode_w8(tables8, d32[:3], 4, 2)
    with pytest.raises(ValueError):
        cuda_gf.matrix_encode_w8(tables8, d32[:, ::2], 4, 2)
    with pytest.raises(ValueError):
        cuda_gf.matrix_encode_w8(tables8[:, :96].contiguous(), d32, 4, 2)
    # w=8: the tables are staged in slices, so k over the 7264 that one
    # 227 KiB group of 8 mask rows held is taken
    B8 = np.zeros((8, 8000 * 8), np.uint8)
    B8[:, :8] = np.eye(8, dtype=np.uint8)
    d8 = torch.from_numpy(np.arange(8000 * 4, dtype=np.int32).reshape(8000, 4))
    out8 = cuda_gf.matrix_encode_w8(
        torch.from_numpy(cuda_gf.prep_matrix_w8(B8, 8000)), d8, 8000, 1)
    assert torch.equal(out8, d8[:1])
    with pytest.raises(ValueError):  # tables of another k
        cuda_gf.matrix_encode_w8(
            torch.from_numpy(cuda_gf.prep_matrix_w8(B8[:, :64], 8)), d8,
            8000, 1)
    # packet: a tile of all c input rows x 8 lanes must fit in the 227 KiB
    # (c <= 7264, as a group of 8 mask rows had to); the widest is taken
    zeros8 = np.zeros((8, 7265), np.uint8)
    with pytest.raises(ValueError):
        cuda_gf.packet_encode(torch.from_numpy(cuda_gf.prep_packet(zeros8)),
                              torch.zeros((7265, 4), dtype=torch.int32), 8)
    assert cuda_gf.packet_encode(
        torch.from_numpy(cuda_gf.prep_packet(zeros8[:, :7264])),
        torch.zeros((7264, 4), dtype=torch.int32), 8).shape == (8, 4)
    with pytest.raises(ValueError):  # a list too short for r = 9 rows
        cuda_gf.packet_encode(torch.zeros(9, dtype=torch.int32),
                              torch.zeros((10, 4), dtype=torch.int32), 9)
    # w=16: the tables are staged in slices, so k over the 3632 that one
    # 227 KiB group of 16 word masks held is taken
    B16 = np.zeros((16, 3700 * 16), np.uint8)
    B16[:, :16] = np.eye(16, dtype=np.uint8)
    d16 = torch.from_numpy(np.arange(3700 * 2, dtype=np.int32).reshape(3700, 2))
    out16 = cuda_gf.matrix_encode_w16(
        torch.from_numpy(cuda_gf.prep_matrix_w16(B16, 3700)), d16, 3700, 1)
    assert torch.equal(out16, d16[:1])
    with pytest.raises(ValueError):  # tables of another k
        cuda_gf.matrix_encode_w16(
            torch.from_numpy(cuda_gf.prep_matrix_w16(B16[:, :64], 4)), d16,
            3700, 1)
    assert cuda_gf.matrix_encode_w8(tables8, d32, 4, 2).shape == (2, 16)


def test_cpu_runs_plain_versions_without_counting_launches():
    before = dict(cuda_gf.launches)
    B = bitmatrix.matrix_to_bitmatrix(reed_sol.vandermonde_coding_matrix(4, 2, 16), 16)
    tables = torch.from_numpy(cuda_gf.prep_matrix_w16(B, 4))
    cuda_gf.matrix_encode_w16(tables, torch.zeros((4, 8), dtype=torch.int32), 4, 2)
    assert cuda_gf.launches == before


def test_card_is_default_and_never_silently_replaced(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_gf.matrix_encode(reed_sol.vandermonde_coding_matrix(2, 1, 8),
                               np.zeros((2, 8), np.uint8), 8)
    assert resolve_device("cpu") == CPU

