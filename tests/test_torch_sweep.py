"""The port's kernel sweep (``ceph_tpu_torch.ops.sweep_gf`` and
``ceph_tpu_torch.tools.ec_kernel_sweep``) against the JAX sweep
(``tools/ec_kernel_sweep.py``, ``experiments/kernel_r4.py``).

The Pallas kernels run in interpret mode on the CPU, at lanes [8, 4096]
with tile 1024; the port's wrappers run their plain versions on CPU
tensors.  All comparisons are exact: every map here is an integer map.
Inputs are made with numpy from a seed; data bytes are uniform over
0..255, so half of them are >= 0x80.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ceph_tpu.matrices import bitmatrix as j_bitmatrix
from ceph_tpu.matrices import reed_sol as j_reed_sol
from ceph_tpu.ops import pallas_gf
from ceph_tpu_torch.matrices import bitmatrix, reed_sol
from ceph_tpu_torch.ops import cuda_gf, sweep_gf
from ceph_tpu_torch.tools import ec_kernel_sweep
from experiments import kernel_r4
from tools import ec_kernel_sweep as j_sweep

N4, TILE = 4096, 1024


def _bits(k, m):
    return bitmatrix.matrix_to_bitmatrix(
        reed_sol.vandermonde_coding_matrix(k, m, 8), 8)


def _data(seed, k, n4=N4):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, (k, n4 * 4), dtype=np.uint8).view(np.int32)


def _tables(bits, k, m):
    """Tensor-core row -> (wrapper, plain version, its table on the CPU)."""
    bp = torch.from_numpy(sweep_gf.prep_shift_major_w8(bits, k))
    bblk = torch.from_numpy(sweep_gf.prep_blockdiag_w8(bits, k, m))
    return {
        "bf16_4dot": (sweep_gf.bf16_4dot, sweep_gf.bf16_4dot_plain,
                      bp.to(torch.bfloat16)),
        "f32_4dot": (sweep_gf.f32_4dot, sweep_gf.f32_4dot_plain, bp),
        "bf16_blockdiag": (sweep_gf.bf16_blockdiag,
                           sweep_gf.bf16_blockdiag_plain,
                           bblk.to(torch.bfloat16)),
    }


def _production(bits, d32, k, m, tile=TILE):
    """The JAX package's production w=8 kernel (``_matrix_kernel``)."""
    Bp = jnp.asarray(pallas_gf.prep_matrix_w8(bits, k))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pallas_gf._matrix_encode_call(
            Bp, jnp.asarray(d32), k, m, tile))


# -- host prep ---------------------------------------------------------------


@pytest.mark.parametrize("k,m", [(8, 4), (3, 2)])
def test_prep_shift_major_matches_pallas_prep(k, m):
    ours = sweep_gf.prep_shift_major_w8(_bits(k, m), k)
    theirs = pallas_gf.prep_matrix_w8(
        j_bitmatrix.matrix_to_bitmatrix(
            j_reed_sol.vandermonde_coding_matrix(k, m, 8), 8), k)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


@pytest.mark.parametrize("k,m", [(8, 4), (3, 2)])
def test_prep_blockdiag_matches_kernel_r4_table(k, m):
    # kernel_r4.build_variants builds its table inline (:188-192); rebuilt
    # here the same way from the JAX package's prep
    Bp = pallas_gf.prep_matrix_w8(
        j_bitmatrix.matrix_to_bitmatrix(
            j_reed_sol.vandermonde_coding_matrix(k, m, 8), 8), k)
    theirs = np.zeros((4 * m * 8, 4 * 8 * k), np.float32)
    for b in range(4):
        theirs[b * m * 8:(b + 1) * m * 8, b * 8 * k:(b + 1) * 8 * k] = Bp
    ours = sweep_gf.prep_blockdiag_w8(_bits(k, m), k, m)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


# -- plain versions against the Pallas kernels --------------------------------


def test_copy_and_extract_plain_match_build_split():
    d32 = _data(1, 8)
    with pltpu.force_tpu_interpret_mode():
        split = j_sweep.build_split(TILE)
        copy = np.asarray(split["copy_control"](jnp.asarray(d32)))
        extract = np.asarray(split["extract_only"](jnp.asarray(d32)))
    x = torch.from_numpy(d32)
    assert np.array_equal(sweep_gf.copy_rows(x, 4).numpy(), copy)
    assert np.array_equal(sweep_gf.copy_plain(x, 4).numpy(), copy)
    ours = sweep_gf.extract_rows(x, 4).numpy()
    assert np.array_equal(ours, extract)
    assert np.array_equal(sweep_gf.extract_plain(x, 4).numpy(), extract)
    # the fields collect up to 16 each, so both halves of a lane count
    assert (ours >> 16).max() > 8 and (ours & 0xFFFF).max() > 8


def test_int8_4dot_plain_matches_kernel_r4_and_production():
    bits, d32 = _bits(8, 4), _data(2, 8)
    with pltpu.force_tpu_interpret_mode():
        theirs = np.asarray(kernel_r4.build_variants(bits, TILE)["int8_4dot"](
            jnp.asarray(d32)))
    bp = torch.from_numpy(
        sweep_gf.prep_shift_major_w8(bits, 8).astype(np.int8))
    ours = sweep_gf.int8_4dot(bp, torch.from_numpy(d32), 8, 4).numpy()
    assert np.array_equal(ours, theirs)
    assert np.array_equal(ours, _production(bits, d32, 8, 4))


@pytest.mark.parametrize("k,m,n4", [(3, 2, 1000), (5, 3, 129)])
def test_int8_4dot_plain_pads_other_shapes(k, m, n4):
    # kernel_r4 builds k=8 m=4 only; at other shapes the production
    # kernel is the int8 formulation's oracle, as in the JAX sweep's gate
    bits, d32 = _bits(k, m), _data(k + n4, k, n4)
    bp = torch.from_numpy(
        sweep_gf.prep_shift_major_w8(bits, k).astype(np.int8))
    ours = sweep_gf.int8_4dot_plain(bp, torch.from_numpy(d32), k, m).numpy()
    assert np.array_equal(ours, _production(bits, d32, k, m, 128))


@pytest.mark.parametrize("row", ["bf16_4dot", "f32_4dot", "bf16_blockdiag"])
def test_tensor_core_rows_match_kernel_r4_and_production(row):
    bits, d32 = _bits(8, 4), _data(4, 8)
    with pltpu.force_tpu_interpret_mode():
        theirs = np.asarray(kernel_r4.build_variants(bits, TILE)[row](
            jnp.asarray(d32)))
    wrapper, plain, table = _tables(bits, 8, 4)[row]
    x = torch.from_numpy(d32)
    ours = wrapper(table, x, 8, 4).numpy()
    assert np.array_equal(ours, theirs)
    assert np.array_equal(plain(table, x, 8, 4).numpy(), theirs)
    assert np.array_equal(ours, _production(bits, d32, 8, 4))


@pytest.mark.parametrize("row", ["bf16_4dot", "f32_4dot", "bf16_blockdiag"])
@pytest.mark.parametrize("k,m,n4", [(3, 2, 1000), (5, 3, 129)])
def test_tensor_core_plain_versions_pad_other_shapes(row, k, m, n4):
    # odd K-steps (k not a multiple of 4) and half an m-tile (odd m)
    bits, d32 = _bits(k, m), _data(k + n4, k, n4)
    _, plain, table = _tables(bits, k, m)[row]
    ours = plain(table, torch.from_numpy(d32), k, m).numpy()
    assert np.array_equal(ours, _production(bits, d32, k, m, 128))


@pytest.mark.parametrize("k,m,n4", [(8, 4, N4), (3, 2, 1000)])
def test_pipelined_plain_matches_production_kernel(k, m, n4):
    # Oracle: the production kernel ``_matrix_encode_call``, not
    # ``build_pipelined``.  ``_pipelined_call`` runs ``emit_pipeline``,
    # which raises in interpret mode on the CPU ("Unsupported TPU device
    # kind: cpu").  Its contract is the production kernel's output, the
    # same gate the JAX tool applies to it (tools/ec_kernel_sweep.py:215-231).
    bits, d32 = _bits(k, m), _data(k * n4, k, n4)
    tables = torch.from_numpy(cuda_gf.prep_matrix_w8(bits, k))
    x = torch.from_numpy(d32)
    want = _production(bits, d32, k, m, 128 if n4 % TILE else TILE)
    assert np.array_equal(sweep_gf.pipelined_w8(tables, x, k, m).numpy(),
                          want)
    assert np.array_equal(
        sweep_gf.pipelined_w8_plain(tables, x, k, m).numpy(), want)


# -- wrapper contract ----------------------------------------------------------


def test_sweep_wrappers_check_their_operands():
    bits = _bits(4, 2)
    tables = torch.from_numpy(cuda_gf.prep_matrix_w8(bits, 4))
    bp = torch.from_numpy(
        sweep_gf.prep_shift_major_w8(bits, 4).astype(np.int8))
    d = torch.zeros((4, 16), dtype=torch.int32)
    with pytest.raises(TypeError):
        sweep_gf.copy_rows(d.to(torch.int64), 2)
    with pytest.raises(ValueError):
        sweep_gf.extract_rows(d, 5)  # more rows than the input has
    with pytest.raises(ValueError):
        sweep_gf.copy_rows(d[:, ::2], 2)
    with pytest.raises(TypeError):
        sweep_gf.int8_4dot(bp.to(torch.float32), d, 4, 2)
    with pytest.raises(ValueError):
        sweep_gf.int8_4dot(bp[:8].contiguous(), d, 4, 2)
    with pytest.raises(ValueError):
        sweep_gf.pipelined_w8(tables, d[:3], 4, 2)
    # the int8 kernel's register fragments take k <= 16 and m <= 8
    with pytest.raises(ValueError):
        sweep_gf.int8_4dot(torch.zeros((8, 8 * 17), dtype=torch.int8),
                           torch.zeros((17, 16), dtype=torch.int32), 17, 1)
    with pytest.raises(ValueError):
        sweep_gf.int8_4dot(torch.zeros((72, 8), dtype=torch.int8),
                           torch.zeros((1, 16), dtype=torch.int32), 1, 9)
    with pytest.raises(ValueError):
        sweep_gf.pipelined_w8(tables, d, 4, 2, tile=6)  # not a multiple of 4
    # two stages of [4, 8000] lanes are over the 227 KiB of shared memory
    with pytest.raises(ValueError):
        sweep_gf.pipelined_w8(tables, d, 4, 2, tile=8000)
    with pytest.raises(ValueError):  # tables of another m
        sweep_gf.pipelined_w8(tables, d, 4, 5)
    assert sweep_gf.pipelined_w8(tables, d, 4, 2, tile=4).shape == (2, 16)
    # the widest tile whose two stages fit is taken: the tables, which no
    # longer fit beside them, are read through L1
    widest = cuda_gf.SMEM_LIMIT // (2 * 4 * 4) // 4 * 4
    assert sweep_gf.pipelined_smem_bytes(4, 2, widest) == 2 * 4 * widest * 4
    assert sweep_gf.pipelined_smem_bytes(4, 2, 1024) == 2 * 4 * 1024 * 4 + 512
    assert sweep_gf.pipelined_w8(tables, d, 4, 2, tile=widest).shape == \
        (2, 16)


def test_tensor_core_wrappers_check_their_operands():
    tables = _tables(_bits(4, 2), 4, 2)
    d = torch.zeros((4, 16), dtype=torch.int32)
    for row, (wrapper, _, table) in tables.items():
        with pytest.raises(TypeError):  # no kernel takes float16
            wrapper(table.to(torch.float16), d, 4, 2)
        with pytest.raises(ValueError):  # the table of another m
            wrapper(table[:8].contiguous(), d, 4, 2)
        with pytest.raises(ValueError):
            wrapper(table, d[:3], 4, 2)
        assert wrapper(table, d, 4, 2).shape == (2, 16), row

    def zeros(rows, cols, dtype, k):
        return (torch.zeros((rows, cols), dtype=dtype),
                torch.zeros((k, 8), dtype=torch.int32))

    # the wgmma kernel: every 4-dot type k <= 16 m <= 8; the block-diagonal
    # accumulators m <= 4, its staged table and one warpgroup's ring
    # <= 227 KiB
    for wrapper, dtype, k, m in ((sweep_gf.bf16_4dot, torch.bfloat16, 17, 1),
                                 (sweep_gf.bf16_4dot, torch.bfloat16, 4, 9),
                                 (sweep_gf.f32_4dot, torch.float32, 17, 1),
                                 (sweep_gf.f32_4dot, torch.float32, 4, 9)):
        with pytest.raises(ValueError, match="the kernel takes"):
            wrapper(*zeros(8 * m, 8 * k, dtype, k), k, m)
    with pytest.raises(ValueError, match="the kernel takes"):
        sweep_gf.bf16_blockdiag(*zeros(160, 128, torch.bfloat16, 4), 4, 5)
    with pytest.raises(ValueError, match="bytes of table"):
        sweep_gf.bf16_blockdiag(*zeros(128, 32 * 25, torch.bfloat16, 25), 25,
                                4)
    # the widest k of each, which the card tests run
    assert sweep_gf.bf16_4dot(*zeros(64, 128, torch.bfloat16, 16), 16,
                              8).shape == (8, 8)
    assert sweep_gf.f32_4dot(*zeros(64, 128, torch.float32, 16), 16,
                             8).shape == (8, 8)
    assert sweep_gf.bf16_blockdiag(*zeros(128, 32 * 24, torch.bfloat16, 24),
                                   24, 4).shape == (4, 8)


@pytest.mark.parametrize("k,m,n4", [(8, 4, 2048), (8, 1, 1003),
                                    (8, 3, 4097), (1, 1, 65541)])
@pytest.mark.parametrize("aligned", [True, False])
def test_copy_rows_takes_every_shape(k, m, n4, aligned):
    # any m of the rows, a ragged total, a pointer off the 16-byte grid
    x = torch.from_numpy(_data(k + n4, k, n4))
    if not aligned:
        buf = torch.empty(x.numel() + 1, dtype=torch.int32)
        x = buf[1:].view(x.shape)
        x.copy_(torch.from_numpy(_data(k + n4, k, n4)))
        assert x.data_ptr() % 16 == 4
    got = sweep_gf.copy_rows(x, m)
    assert got.shape == (m, n4) and torch.equal(got, x[:m])
    assert got.data_ptr() != x.data_ptr()


def test_cpu_runs_plain_versions_without_counting_launches():
    before = dict(sweep_gf.launches)
    d = torch.from_numpy(_data(3, 4, 8))
    sweep_gf.copy_rows(d, 2)
    sweep_gf.extract_rows(d, 2)
    for wrapper, _, table in _tables(_bits(4, 2), 4, 2).values():
        wrapper(table, d, 4, 2)
    assert sweep_gf.launches == before


def test_bounds_of_the_sweep_shape():
    # lanes [8, 2097152]: 64 MiB in, 32 MiB out, at 3.35 TB/s
    n4 = 2097152
    for kernel, ms in (("sweep_copy", 0.0200), ("sweep_extract", 0.0200),
                       ("sweep_pipelined_w8", 0.0300),
                       ("sweep_int8_4dot", 0.0300)):
        got, by = ec_kernel_sweep.bound_ms(
            *ec_kernel_sweep.work(kernel, 8, 4, n4))
        assert by == "bytes" and round(got, 4) == ms
    _, ops = ec_kernel_sweep.work("sweep_int8_4dot", 8, 4, n4)
    assert round(ec_kernel_sweep.bound_ms(0, ops)[0], 4) == 0.0174


@pytest.mark.parametrize("kernel,table_bytes,ms", [
    ("sweep_int8_4dot", 2048, 0.0300),
    ("sweep_bf16_4dot", 4096, 0.0347),
    ("sweep_f32_4dot", 8192, 0.0694),
    # the function's operations, not the dense product's 4x
    ("sweep_bf16_blockdiag", 65536, 0.0347),
])
def test_tensor_core_bounds_at_their_rates(kernel, table_bytes, ms):
    got, by, nbytes, ops = ec_kernel_sweep.kernel_bound_ms(
        kernel, 8, 4, 2097152, table_bytes)
    assert ops == 2 * 4 * 32 * 64 * 2097152
    assert nbytes == 12 * (8 << 20) + table_bytes
    assert round(got, 4) == ms
    assert by == ("bytes" if kernel == "sweep_int8_4dot" else "operations")


# -- the port's tool -------------------------------------------------------------


def test_sweep_tool_on_the_cpu_is_bit_exact(capsys):
    assert ec_kernel_sweep.main(
        ["--device", "cpu", "--size-mib", "1", "--iters", "1"]) == 0
    out = capsys.readouterr().out
    assert "NOT the card" in out
    for row in (*ec_kernel_sweep.VARIANTS, *ec_kernel_sweep.PROBES):
        assert f"{row:14s} bit-exact" in out


def test_sweep_tool_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ec_kernel_sweep.main(["--iters", "1"])


@pytest.mark.parametrize("argv", [
    ["--stage", "nonesuch"],
    ["--only", "nonesuch"],
    ["--tile", "8000"],
])
def test_sweep_tool_refuses_what_is_not_ported(argv, capsys):
    assert ec_kernel_sweep.main(["--device", "cpu", *argv]) == 2
    captured = capsys.readouterr()
    assert "bit-exact" not in captured.out
    assert "nonesuch" in captured.err or "--tile" in captured.err


@pytest.mark.parametrize("argv", [
    ["--stage", "precision"],
    ["--stage", "variants,precision"],
    ["--only", "xornet"],
])
def test_sweep_tool_runs_the_precision_stage_and_xornet(argv, capsys):
    assert ec_kernel_sweep.main(["--device", "cpu", "--size-mib", "1",
                                 "--iters", "1", *argv]) == 0
    out = capsys.readouterr().out
    prec_rows = [line for line in out.splitlines()
                 if line.startswith("prec=")]
    if "--only" in argv:
        assert f"{'xornet':14s} bit-exact" in out and not prec_rows
        return
    assert len(prec_rows) == len(ec_kernel_sweep.PRECISION_ROWS) == 6
    for (prec, tile), line in zip(ec_kernel_sweep.PRECISION_ROWS, prec_rows):
        assert line.split()[:3] == [
            f"prec={prec}", f"tile={tile}",
            "MISMATCH" if prec == "DEFAULT" else "bit-exact"], line
    variants = "variants" in argv[1]
    for row in ec_kernel_sweep.VARIANTS:
        assert (f"{row:14s} bit-exact" in out) == variants


@pytest.mark.parametrize("argv", [
    ["--only", "bf16_4dot"],
    ["--only", "f32_4dot"],
    ["--only", "base,bf16_blockdiag"],
])
def test_sweep_tool_runs_the_tensor_core_rows(argv, capsys):
    assert ec_kernel_sweep.main(["--device", "cpu", "--size-mib", "1",
                                 "--iters", "1", *argv]) == 0
    out = capsys.readouterr().out
    for row in argv[1].split(","):
        assert f"{row:14s} bit-exact" in out
    assert "MISMATCH" not in out


def test_sweep_tool_exits_1_on_a_mismatch(monkeypatch, capsys):
    def wrong(bp, x, k, m):
        return sweep_gf.int8_4dot_plain(bp, x, k, m) ^ 1

    monkeypatch.setattr(sweep_gf, "int8_4dot", wrong)
    assert ec_kernel_sweep.main(["--device", "cpu", "--iters", "1",
                                 "--only", "base,int8_4dot"]) == 1
    out = capsys.readouterr().out
    assert "int8_4dot      MISMATCH" in out and "base           bit-exact" in out
