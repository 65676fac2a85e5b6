"""The port on the card: each CUDA kernel against its plain PyTorch version,
the ``cuda`` plugin against the numpy ``jerasure`` plugin, the port's
kernel sweep and its split-chain and split-cost probes.

Marked ``cuda``; every test skips without a card.  Imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from ceph_tpu_torch.matrices import bitmatrix, cauchy, reed_sol
from ceph_tpu_torch.ops import cuda_gf, gf, sweep_gf
from ceph_tpu_torch.plugins import registry
from ceph_tpu_torch.tools import ec_kernel_sweep, kernel_r4_probe, kernel_r4_split

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


def _lanes(rs, rows, n4, dev):
    data = rs.randint(0, 256, (rows, n4 * 4), dtype=np.uint8)
    return torch.from_numpy(data.view(np.int32)).to(dev)


def _decode_matrix(k, m, w, erased):
    """The [len(erased), k] matrix that rebuilds the erased data chunks of
    reed_sol_van k, m from the first k survivors (as ``matrix_decode``)."""
    M = reed_sol.vandermonde_coding_matrix(k, m, w)
    sel = [c for c in range(k + m) if c not in erased][:k]
    A = np.zeros((k, k), dtype=np.uint32)
    for r, cid in enumerate(sel):
        if cid < k:
            A[r, cid] = 1
        else:
            A[r] = M[cid - k]
    return gf.gf(w).mat_invert(A)[list(erased)]


@pytest.mark.parametrize("k,m,n4,aligned,code", [
    (8, 4, 4096, True, "encode"),
    (3, 5, 1003, True, "encode"),     # odd m
    (8, 3, 4099, True, "encode"),     # odd m, n4 no multiple of 4
    (4, 2, 1, True, "encode"),
    (1, 4, 4096, True, "encode"),     # k = 1
    (8, 4, 131072, True, "encode"),   # the main path's granule width
    (8, 4, 4096, False, "encode"),    # a pointer off the 16-byte grid
    (7, 3, 1003, False, "encode"),
    (100, 3, 1003, True, "encode"),   # w=16 tables staged in two slices
    (50, 8, 4096, True, "encode"),    # two slices of two output groups
    (8, 12, 4096, True, "encode"),    # m = 12: two passes of output groups
    (400, 4, 1003, True, "random"),   # w=8 tables staged in two slices
    (8, 4, 4096, True, "decode"),     # chunks 1 and 6 erased: 2 rows out
])
def test_matrix_kernels_match_plain_versions(dev, k, m, n4, aligned, code):
    rs = np.random.RandomState(n4 + k)
    d = _lanes(rs, k, n4, dev)
    if not aligned:
        d = _unaligned(d)
    for w, prep, kern, plain in (
            (8, cuda_gf.prep_matrix_w8, cuda_gf.matrix_encode_w8,
             cuda_gf.matrix_encode_w8_plain),
            (16, cuda_gf.prep_matrix_w16, cuda_gf.matrix_encode_w16,
             cuda_gf.matrix_encode_w16_plain)):
        if code == "random":  # k + m over the 2^8 of a w=8 Vandermonde code
            B = rs.randint(0, 2, (m * w, k * w)).astype(np.uint8)
        else:
            matrix = (_decode_matrix(k, m, w, (1, 6)) if code == "decode"
                      else reed_sol.vandermonde_coding_matrix(k, m, w))
            B = bitmatrix.matrix_to_bitmatrix(matrix, w)
        rows = B.shape[0] // w
        op = torch.from_numpy(prep(B, k)).to(dev)
        assert torch.equal(kern(op, d, k, rows), plain(op, d, k, rows))


def _packet_bits(code, r, c, rs):
    if code == "cauchy_good":  # k=8 m=4 w=8
        return bitmatrix.matrix_to_bitmatrix(
            cauchy.good_general_coding_matrix(8, 4, 8), 8)
    if code == "decode":  # cauchy_good k=8 m=4, chunks 1 and 6 erased
        B = _packet_bits("cauchy_good", r, c, rs)
        sel = [0, 2, 3, 4, 5, 7, 8, 9]
        return bitmatrix.survivor_decode_bitmatrix(B, 8, 8, sel, [1, 6])
    B = rs.randint(0, 2, (r, c)).astype(np.uint8)
    if code == "zero rows":
        B[::4] = 0
    return B


@pytest.mark.parametrize("r,c,n4,aligned,code", [
    (32, 64, 4096, True, "random"),
    (13, 24, 1003, True, "random"),      # odd r
    (2, 7, 1, True, "random"),
    (32, 64, 131072, True, "cauchy_good"),  # the main path's code and width
    (32, 64, 4096, False, "random"),     # a pointer off the 16-byte grid
    (13, 27, 1003, False, "zero rows"),
    (31, 5, 3, True, "random"),
    (3, 7264, 1003, True, "random"),     # the widest: one stage of 8 lanes
    (16, 64, 4096, True, "decode"),      # cauchy_good's decoding bitmatrix
])
def test_packet_kernel_matches_plain_version(dev, r, c, n4, aligned, code):
    rs = np.random.RandomState(r + n4)
    B = _packet_bits(code, r, c, rs)
    r, c = B.shape
    lists = torch.from_numpy(cuda_gf.prep_packet(B)).to(dev)
    d = _lanes(rs, c, n4, dev)
    if not aligned:
        d = _unaligned(d)
    assert torch.equal(cuda_gf.packet_encode(lists, d, r),
                       cuda_gf.packet_encode_plain(lists, d, r))


@pytest.mark.parametrize("r,c,n4", [(12, 1800, 4096), (5, 1800, 1003)])
def test_packet_kernel_opts_in_to_wide_mask_tables(dev, r, c, n4):
    # two stages of 1800 rows x 8 lanes and the list take 115 KiB and more
    # of shared memory, over the 48 KiB a block gets without the opt-in
    # attribute
    rs = np.random.RandomState(c + n4)
    B = rs.randint(0, 2, (r, c)).astype(np.uint8)
    lists = torch.from_numpy(cuda_gf.prep_packet(B)).to(dev)
    d = _lanes(rs, c, n4, dev)
    assert torch.equal(cuda_gf.packet_encode(lists, d, r),
                       cuda_gf.packet_encode_plain(lists, d, r))


def test_wrappers_count_launches_and_refuse_mixed_devices(dev):
    B = bitmatrix.matrix_to_bitmatrix(
        reed_sol.vandermonde_coding_matrix(4, 2, 8), 8)
    w8_tables = torch.from_numpy(cuda_gf.prep_matrix_w8(B, 4))
    d = torch.zeros((4, 64), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        cuda_gf.matrix_encode_w8(w8_tables, d, 4, 2)  # tables on the CPU
    before = cuda_gf.launches["gf2_matrix_w8"]
    cuda_gf.matrix_encode_w8(w8_tables.to(dev), d, 4, 2)
    assert cuda_gf.launches["gf2_matrix_w8"] == before + 1


@pytest.mark.parametrize("profile", [
    {"technique": "reed_sol_van", "k": "8", "m": "4"},
    {"technique": "reed_sol_van", "k": "6", "m": "3", "w": "16"},
    {"technique": "reed_sol_van", "k": "4", "m": "2", "w": "32"},
    {"technique": "cauchy_good", "k": "6", "m": "3", "packetsize": "64"},
    {"technique": "liberation", "k": "5", "w": "7", "packetsize": "16"},
    # wide packet tables: k*w = 256 and 527 input rows
    {"technique": "cauchy_good", "k": "32", "m": "8", "packetsize": "32"},
    {"technique": "liberation", "k": "17", "w": "31", "packetsize": "8"},
])
def test_cuda_plugin_matches_numpy_jerasure(dev, profile):
    reg = registry.instance()
    ec, ref = reg.factory("cuda", dict(profile)), reg.factory("jerasure",
                                                              dict(profile))
    n = ec.get_chunk_count()
    rs = np.random.RandomState(n)
    stripes = [rs.randint(0, 256, 300_000, dtype=np.uint8) for _ in range(3)]
    want = [ref.encode(set(range(n)), s) for s in stripes]
    for got, exp in zip(ec.encode_batch(stripes), want):
        assert all(np.array_equal(got[c], exp[c]) for c in exp)
    maps = [{c: a for c, a in e.items() if c not in (0, n - 1)} for e in want]
    for got, exp in zip(ec.decode_batch(maps), want):
        assert all(np.array_equal(got[c], exp[c]) for c in exp)


# -- the kernel sweep's seven kernels ----------------------------------------


def _sweep_operands(k, m, dev):
    B = bitmatrix.matrix_to_bitmatrix(
        reed_sol.vandermonde_coding_matrix(k, m, 8), 8)
    w8_tables = torch.from_numpy(cuda_gf.prep_matrix_w8(B, k)).to(dev)
    bp = torch.from_numpy(
        sweep_gf.prep_shift_major_w8(B, k).astype(np.int8)).to(dev)
    return w8_tables, bp


def _unaligned(x):
    """A contiguous copy of ``x`` whose data starts 4 bytes past a 16-byte
    boundary (the kernels then take their one-lane-per-load form)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 == 4
    return y


@pytest.mark.parametrize("k,m,n4,aligned", [
    (8, 4, 4096, True),    # whole tiles
    (8, 4, 1003, True),    # n4 not a multiple of 4 lanes or of a tile
    (8, 4, 4096, False),   # a pointer off the 16-byte grid
    (3, 2, 4099, False),   # int8 contraction padded: 24 plane rows in 32
    (12, 6, 1, True),      # one lane
    (16, 8, 333, True),    # the widest code the int8 kernel takes
    (7, 5, 4096, True),    # odd m: half of the last 16-row tile of Bp
])
def test_sweep_kernels_match_plain_versions(dev, k, m, n4, aligned):
    rs = np.random.RandomState(k * 1000 + n4)
    d = _lanes(rs, k, n4, dev)
    if not aligned:
        d = _unaligned(d)
    w8_tables, bp = _sweep_operands(k, m, dev)
    pairs = (
        (sweep_gf.copy_rows(d, m), sweep_gf.copy_plain(d, m)),
        (sweep_gf.extract_rows(d, m), sweep_gf.extract_plain(d, m)),
        (sweep_gf.pipelined_w8(w8_tables, d, k, m),
         sweep_gf.pipelined_w8_plain(w8_tables, d, k, m)),
        (sweep_gf.int8_4dot(bp, d, k, m),
         sweep_gf.int8_4dot_plain(bp, d, k, m)),
    )
    for got, want in pairs:
        assert torch.equal(got, want)


@pytest.mark.parametrize("k,m,n4,aligned", [
    (8, 4, 2097152, True),     # the sweep's shape: 2048 blocks of 16 KiB
    (8, 1, 1003, True),        # one row: 1003 lanes, the 4-byte form
    (8, 4, 1003, True),        # one partial block
    (1, 1, 262148, True),      # a last block of one 16-byte element
    (8, 3, 4097, True),        # a ragged total: the 4-byte form
    (8, 4, 4096, False),       # a pointer off the 16-byte grid
    (12, 8, 1, True),          # 8 lanes, two 16-byte elements
])
def test_copy_kernel_matches_plain_version(dev, k, m, n4, aligned):
    rs = np.random.RandomState(k * 100 + m + n4)
    d = _lanes(rs, k, n4, dev)
    if not aligned:
        d = _unaligned(d)
    before = sweep_gf.launches["sweep_copy"]
    got = sweep_gf.copy_rows(d, m)
    assert sweep_gf.launches["sweep_copy"] == before + 1
    assert torch.equal(got, sweep_gf.copy_plain(d, m))
    assert torch.equal(got, d[:m])


def _tensor_core_cases(k, m, dev):
    """name -> (kernel wrapper, plain version, table on the card)."""
    B = bitmatrix.matrix_to_bitmatrix(
        reed_sol.vandermonde_coding_matrix(k, m, 8), 8)
    bp = torch.from_numpy(sweep_gf.prep_shift_major_w8(B, k)).to(dev)
    bblk = torch.from_numpy(sweep_gf.prep_blockdiag_w8(B, k, m)).to(
        dev, torch.bfloat16)
    return {
        "sweep_bf16_4dot": (sweep_gf.bf16_4dot, sweep_gf.bf16_4dot_plain,
                            bp.to(torch.bfloat16)),
        "sweep_f32_4dot": (sweep_gf.f32_4dot, sweep_gf.f32_4dot_plain, bp),
        "sweep_bf16_blockdiag": (sweep_gf.bf16_blockdiag,
                                 sweep_gf.bf16_blockdiag_plain, bblk),
    }


@pytest.mark.parametrize("kernel", ["sweep_bf16_4dot", "sweep_f32_4dot",
                                    "sweep_bf16_blockdiag"])
@pytest.mark.parametrize("k,m,n4,aligned", [
    (8, 4, 4096, True),    # the sweep's code
    (8, 4, 100003, True),  # ragged: no multiple of a warp's 32 lanes
    (8, 4, 4096, False),   # a pointer off the 16-byte grid
    (3, 2, 4099, False),   # K-steps half padded, one m-tile
    (5, 3, 1000, True),    # k not a multiple of 4, half of the last m-tile
    (8, 4, 1, True),       # one lane
    (None, None, 777, True),  # the widest code the wrapper takes
])
def test_tensor_core_kernels_match_plain_versions(dev, kernel, k, m, n4,
                                                   aligned):
    if k is None:
        k, m = {"sweep_bf16_4dot": (16, 4), "sweep_f32_4dot": (8, 4),
                "sweep_bf16_blockdiag": (28, 4)}[kernel]
    rs = np.random.RandomState(k * 1000 + n4)
    d = _lanes(rs, k, n4, dev)
    if not aligned:
        d = _unaligned(d)
    wrapper, plain, table = _tensor_core_cases(k, m, dev)[kernel]
    assert torch.equal(wrapper(table, d, k, m), plain(table, d, k, m))


@pytest.mark.parametrize("tile", [4, 1000, 3072, 3616, 3632])
def test_pipelined_kernel_at_any_tile(dev, tile):
    # a tile smaller than a block's threads, one that is no multiple of
    # the 1024 lanes a block covers, one that opts in to 193 KiB of
    # shared memory, the widest whose stages and tables fit, and the
    # widest whose stages fit (the tables then read through L1)
    rs = np.random.RandomState(tile)
    d = _lanes(rs, 8, 20000, dev)
    w8_tables, _ = _sweep_operands(8, 4, dev)
    assert torch.equal(sweep_gf.pipelined_w8(w8_tables, d, 8, 4, tile),
                       cuda_gf.matrix_encode_w8(w8_tables, d, 8, 4))


def test_sweep_wrappers_count_launches_and_refuse_mixed_devices(dev):
    w8_tables, bp = _sweep_operands(4, 2, dev)
    d = torch.zeros((4, 64), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        sweep_gf.int8_4dot(bp.cpu(), d, 4, 2)
    with pytest.raises(ValueError):
        sweep_gf.pipelined_w8(w8_tables.cpu(), d, 4, 2)
    bp32 = bp.to(torch.float32)
    with pytest.raises(ValueError):
        sweep_gf.prec_product(bp32.cpu(), d, 4, 2, "HIGH")
    xornet = sweep_gf.make_xornet(_code_bits("reed_sol_van", 4, 2), 4, 2)
    before = dict(sweep_gf.launches)
    sweep_gf.copy_rows(d, 2)
    sweep_gf.extract_rows(d, 2)
    sweep_gf.pipelined_w8(w8_tables, d, 4, 2)
    sweep_gf.int8_4dot(bp, d, 4, 2)
    for wrapper, _, table in _tensor_core_cases(4, 2, dev).values():
        wrapper(table, d, 4, 2)
    xornet(d)
    for prec in sweep_gf.PREC_KERNELS:
        sweep_gf.prec_product(bp32, d, 4, 2, prec)
    sweep_gf.split_product(bp32, d, 4, 2, "HIGHEST", 2, 64)
    sweep_gf.extract_fold(d, 4, 2)
    sweep_gf.planes_product(bp32, sweep_gf.field_planes(d, 4), 4, 2)
    assert all(sweep_gf.launches[n] == before[n] + 1 for n in before)


# -- the static XOR network and the precision stage ---------------------------


def _code_bits(code, k, m):
    coding = {"reed_sol_van": reed_sol.vandermonde_coding_matrix,
              "cauchy_good": cauchy.good_general_coding_matrix}[code]
    return bitmatrix.matrix_to_bitmatrix(coding(k, m, 8), 8)


@pytest.mark.parametrize("code", ["reed_sol_van", "cauchy_good"])
@pytest.mark.parametrize("k,m,n4,aligned", [
    (8, 4, 4096, True),     # 16-byte loads and stores
    (8, 4, 100003, True),   # ragged: the one-lane form
    (8, 4, 4096, False),    # a pointer off the 16-byte grid
    (3, 2, 1001, True),
    (16, 8, 777, True),     # the widest network
])
def test_xornet_kernel_matches_plain_version(dev, code, k, m, n4, aligned):
    rs = np.random.RandomState(k * 1000 + n4)
    d = _lanes(rs, k, n4, dev)
    if not aligned:
        d = _unaligned(d)
    bits = _code_bits(code, k, m)
    w8_tables = torch.from_numpy(cuda_gf.prep_matrix_w8(bits, k)).to(dev)
    got = sweep_gf.make_xornet(bits, k, m)(d)
    assert torch.equal(got, sweep_gf.xornet_plain(bits, d, k, m))
    assert torch.equal(got, cuda_gf.matrix_encode_w8(w8_tables, d, k, m))


def test_xornet_builds_one_library_per_bitmatrix(dev):
    d = _lanes(np.random.RandomState(1), 8, 4096, dev)
    libs = set()
    for code in ("reed_sol_van", "cauchy_good"):
        fn = sweep_gf.make_xornet(_code_bits(code, 8, 4), 8, 4)
        fn(d)
        libs.add(cuda_gf.build(sweep_gf.XORNET_SOURCE, fn.generated).name)
    assert len(libs) == 2
    assert all(name.startswith("libxornet_kernel-") for name in libs)


@pytest.mark.parametrize("prec", ["HIGHEST", "HIGH", "DEFAULT"])
@pytest.mark.parametrize("tile", [4096, 16384])
@pytest.mark.parametrize("k,m,n4,aligned", [
    (8, 4, 4096, True),      # the sweep's code
    (8, 4, 100003, True),    # ragged: no multiple of a tile or of 32 lanes
    (8, 4, 4096, False),     # a pointer off the 16-byte grid
    (3, 2, 4099, True),      # K-steps half padded, one m-tile
    (5, 3, 1000, True),      # half of the last m-tile
    (8, 4, 1, True),         # one lane
])
def test_precision_kernels_match_prec_plain(dev, prec, tile, k, m, n4,
                                            aligned):
    rs = np.random.RandomState(k * 1000 + n4)
    d = _lanes(rs, k, n4, dev)
    if not aligned:
        d = _unaligned(d)
    bp = torch.from_numpy(sweep_gf.prep_shift_major_w8(
        _code_bits("reed_sol_van", k, m), k)).to(dev)
    got = sweep_gf.prec_product(bp, d, k, m, prec, tile)
    assert torch.equal(got, sweep_gf.prec_plain(bp, d, k, m, prec))
    w8_tables = torch.from_numpy(cuda_gf.prep_matrix_w8(
        _code_bits("reed_sol_van", k, m), k)).to(dev)
    exact = torch.equal(got, cuda_gf.matrix_encode_w8(w8_tables, d, k, m))
    # one TF32 pass loses the plane value 65537's low field
    assert exact if prec != "DEFAULT" else (n4 == 1 or not exact)


def test_precision_f32_kernel_at_its_widest_code(dev):
    d = _lanes(np.random.RandomState(7), 16, 5000, dev)
    bp = torch.from_numpy(sweep_gf.prep_shift_major_w8(
        _code_bits("cauchy_good", 16, 8), 16)).to(dev)
    assert torch.equal(sweep_gf.prec_product(bp, d, 16, 8, "HIGHEST", 4096),
                       sweep_gf.prec_plain(bp, d, 16, 8, "HIGHEST"))


def test_sweep_wrappers_refuse_what_their_kernels_do_not_take(dev):
    d9 = torch.zeros((9, 64), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="the kernel takes"):
        sweep_gf.prec_product(torch.zeros((32, 72), device=dev), d9, 9, 4,
                              "HIGH")
    d = torch.zeros((8, 64), dtype=torch.int32, device=dev)
    bp = torch.zeros((32, 64), device=dev)
    with pytest.raises(ValueError, match="multiple of 32"):
        sweep_gf.prec_product(bp, d, 8, 4, "DEFAULT", tile=100)
    with pytest.raises(ValueError, match="only 0 and 1"):
        sweep_gf.prec_product(bp + 0.5, d, 8, 4, "HIGH")
    with pytest.raises(ValueError, match="k <= 16 and m <= 8"):
        sweep_gf.make_xornet(np.zeros((8, 136), np.uint8), 17, 1)
    with pytest.raises(ValueError, match="do not fit"):
        sweep_gf.make_xornet(_code_bits("reed_sol_van", 8, 4), 8, 4)(
            d[:4].contiguous())


def test_kernel_sweep_runs_on_the_card(dev, capsys):
    assert ec_kernel_sweep.main(["--size-mib", "1", "--iters", "4"]) == 0
    out = capsys.readouterr().out
    for row in (*ec_kernel_sweep.VARIANTS, *ec_kernel_sweep.PROBES):
        assert f"{row:14s} bit-exact" in out
    prec_rows = [line.split() for line in out.splitlines()
                 if line.startswith("prec=")]
    assert [r[:2] for r in prec_rows] == [
        [f"prec={p}", f"tile={t}"] for p, t in ec_kernel_sweep.PRECISION_ROWS]
    for r in prec_rows:
        assert r[2] == ("MISMATCH" if r[0] == "prec=DEFAULT" else "bit-exact")


# -- the split-chain and split-cost probes --------------------------------------


def _prec_operands(code, k, m, dev):
    bits = _code_bits(code, k, m)
    bp = torch.from_numpy(sweep_gf.prep_shift_major_w8(bits, k)).to(dev)
    w8_tables = torch.from_numpy(cuda_gf.prep_matrix_w8(bits, k)).to(dev)
    return bp, w8_tables


@pytest.mark.parametrize("parts", [2, 4, 8])
@pytest.mark.parametrize("k,m,n4,aligned", [
    (8, 4, 4096, True),      # the probe's code
    (8, 4, 100003, True),    # ragged: a last tile with empty chunks
    (8, 4, 4096, False),     # a pointer off the 16-byte grid
    (3, 2, 4099, True),
    (5, 3, 1000, True),      # odd m: the last pass covers one row
    (8, 4, 1, True),         # one lane
    (16, 8, 777, True),      # the widest code the kernel takes
    (7, 5, 333, False),
    (1, 4, 1003, True),      # one input row
    (8, 1, 1003, False),     # one output row
    (8, 3, 100003, True),    # odd m, ragged
    (16, 8, 100003, False),  # the widest code, 256 threads a block
])
def test_split_kernel_matches_split_plain(dev, parts, k, m, n4, aligned):
    rs = np.random.RandomState(k * 1000 + n4)
    d = _lanes(rs, k, n4, dev)
    if not aligned:
        d = _unaligned(d)
    bp, w8_tables = _prec_operands("cauchy_good", k, m, dev)
    want = sweep_gf.split_plain(bp, d, k, m, parts)
    assert torch.equal(want, cuda_gf.matrix_encode_w8(w8_tables, d, k, m))
    # the smallest tile (chunks of one warp's 32 lanes, fewer than a
    # block's threads) and the probe's two
    for tile in (32 * parts, 8192, 16384):
        got = sweep_gf.split_product(bp, d, k, m, "HIGHEST", parts, tile)
        assert torch.equal(got, want), tile


@pytest.mark.parametrize("parts", [2, 4, 8])
@pytest.mark.parametrize("k", [15, 16])
@pytest.mark.parametrize("m", [2, 4, 8])  # 512 threads a block at m <= 4
def test_split_kernel_counts_past_2_to_the_23(dev, parts, k, m):
    # all-ones rows of Bp over lanes whose high halves are all ones: the
    # high field counts 8k, so a sum reaches 8k * 65537 (at k = 16 past
    # 2^23, where the kernel reads its counts through F2I), and the low
    # field's count is odd in about half the lanes
    rs = np.random.RandomState(k + parts)
    d = _lanes(rs, k, 4099, dev)
    d[:, :2048] = (d[:, :2048] & 0xFFFF) | -65536
    bp = torch.from_numpy(rs.randint(0, 2, (8 * m, 8 * k)).astype(
        np.float32)).to(dev)
    bp[::3] = 1.0
    got = sweep_gf.split_product(bp, d, k, m, "HIGHEST", parts, 32 * parts)
    assert torch.equal(got, sweep_gf.split_plain(bp, d, k, m, parts))


def test_split_kernel_reads_bp_at_each_launch(dev):
    # one library serves every code of k <= 16 and m <= 8, Bp read from
    # device memory at each launch: a table written in place is read anew
    d = _lanes(np.random.RandomState(7), 8, 5000, dev)
    for code, k, m in (("reed_sol_van", 8, 4), ("cauchy_good", 8, 4),
                       ("cauchy_good", 8, 3), ("cauchy_good", 8, 5)):
        bp, _ = _prec_operands(code, k, m, dev)
        before = sweep_gf.launches["sweep_split_f32"]
        got = sweep_gf.split_product(bp, d[:k], k, m, "HIGHEST", 4, 4096)
        assert sweep_gf.launches["sweep_split_f32"] == before + 1
        assert torch.equal(got, sweep_gf.split_plain(bp, d[:k], k, m, 4))
    bp, _ = _prec_operands("reed_sol_van", 8, 4, dev)
    sweep_gf.split_product(bp, d, 8, 4, "HIGHEST", 2, 8192)
    bp.copy_(_prec_operands("cauchy_good", 8, 4, dev)[0])
    assert torch.equal(sweep_gf.split_product(bp, d, 8, 4, "HIGHEST", 2, 8192),
                       sweep_gf.split_plain(bp, d, 8, 4, 2))


@pytest.mark.parametrize("prec", ["HIGHEST", "DEFAULT"])
def test_split_parts_1_runs_the_precision_kernel(dev, prec):
    d = _lanes(np.random.RandomState(3), 8, 5000, dev)
    bp, _ = _prec_operands("reed_sol_van", 8, 4, dev)
    name = sweep_gf.PREC_KERNELS[prec]
    before = sweep_gf.launches[name]
    got = sweep_gf.split_product(bp, d, 8, 4, prec, 1, 16384)
    assert sweep_gf.launches[name] == before + 1
    assert torch.equal(got, sweep_gf.prec_plain(bp, d, 8, 4, prec))


@pytest.mark.parametrize("k,m,n4,aligned", [
    (8, 4, 4096, True),      # the probe's code: m divides k
    (8, 4, 100003, True),    # ragged
    (8, 4, 4096, False),     # a pointer off the 16-byte grid
    (3, 2, 4099, True),      # k = 1 (mod m): a plane's class follows s
    (6, 3, 1000, True),
    (2, 4, 50, True),        # k = 2 (mod 4)
    (3, 8, 31, True),        # k = 3 (mod 8)
    (9, 8, 333, False),
    (15, 8, 777, True),      # 30 fields a class, the most at m = 8
    (1, 1, 1, True),         # one lane, one class
    (7, 7, 100, True),
])
def test_extract_fold_kernel_matches_plain_version(dev, k, m, n4, aligned):
    rs = np.random.RandomState(k * 1000 + n4)
    d = _lanes(rs, k, n4, dev)
    if not aligned:
        d = _unaligned(d)
    assert torch.equal(sweep_gf.extract_fold(d, k, m),
                       sweep_gf.extract_fold_plain(d, k, m))


@pytest.mark.parametrize("tile", [4096, 16384])
@pytest.mark.parametrize("k,m,n4,aligned", [
    (8, 4, 4096, True),
    (8, 4, 100003, True),    # ragged
    (8, 4, 4096, False),     # planes off the 16-byte grid
    (3, 2, 4099, True),
    (5, 3, 1000, True),
    (8, 4, 1, True),
    (16, 8, 777, True),      # the widest code the kernel takes
])
def test_planes_kernel_matches_plain_version(dev, tile, k, m, n4, aligned):
    rs = np.random.RandomState(k * 1000 + n4)
    d = _lanes(rs, k, n4, dev)
    bp, w8_tables = _prec_operands("reed_sol_van", k, m, dev)
    planes = sweep_gf.field_planes(d, k)
    if not aligned:
        planes = _unaligned(planes)
    got = sweep_gf.planes_product(bp, planes, k, m, tile)
    assert torch.equal(got, sweep_gf.planes_plain(bp, planes, k, m))
    assert torch.equal(got, cuda_gf.matrix_encode_w8(w8_tables, d, k, m))


def test_probe_wrappers_refuse_what_their_kernels_do_not_take(dev):
    d = torch.zeros((8, 64), dtype=torch.int32, device=dev)
    bp = torch.zeros((32, 64), device=dev)
    with pytest.raises(ValueError, match="HIGHEST only"):
        sweep_gf.split_product(bp, d, 8, 4, "HIGH", 2)
    with pytest.raises(ValueError, match="parts 3"):
        sweep_gf.split_product(bp, d, 8, 4, "HIGHEST", 3)
    with pytest.raises(ValueError, match="multiple of 32 \\* parts"):
        sweep_gf.split_product(bp, d, 8, 4, "HIGHEST", 4, 4096 + 64)
    with pytest.raises(ValueError, match="does not divide"):
        sweep_gf.extract_fold(d[:3].contiguous(), 3, 5)
    with pytest.raises(ValueError, match="not exact"):
        sweep_gf.extract_fold(torch.zeros((16, 8), dtype=torch.int32,
                                          device=dev), 16, 1)
    with pytest.raises(ValueError, match="the kernel takes"):
        sweep_gf.planes_product(torch.zeros((8, 136), device=dev),
                                torch.zeros((2, 136, 8), device=dev), 17, 1)
    with pytest.raises(ValueError):
        sweep_gf.planes_product(bp.cpu(), sweep_gf.field_planes(d, 8), 8, 4)


def test_probe_tools_run_on_the_card(dev, capsys):
    assert kernel_r4_split.main(["--size-mib", "1", "--iters", "4"]) == 0
    rows = [line.split() for line in capsys.readouterr().out.splitlines()
            if line.startswith("split")]
    assert [r[:4] for r in rows] == [
        [f"split{p}", f"tile={t}", prec,
         "MISMATCH" if prec == "DEFAULT" else "bit-exact"]
        for p, t, prec in kernel_r4_split.ROWS]
    assert kernel_r4_probe.main(["--size-mib", "1", "--iters", "4"]) == 0
    out = capsys.readouterr().out
    for row in kernel_r4_probe.ROWS:
        assert f"{row:30s} bit-exact" in out
