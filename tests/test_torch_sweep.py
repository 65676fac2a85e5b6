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


@pytest.mark.parametrize("k,m,n4", [(8, 4, N4), (3, 2, 1000)])
def test_pipelined_plain_matches_production_kernel(k, m, n4):
    # Oracle: the production kernel ``_matrix_encode_call``, not
    # ``build_pipelined``.  ``_pipelined_call`` runs ``emit_pipeline``,
    # which raises in interpret mode on the CPU ("Unsupported TPU device
    # kind: cpu").  Its contract is the production kernel's output, the
    # same gate the JAX tool applies to it (tools/ec_kernel_sweep.py:215-231).
    bits, d32 = _bits(k, m), _data(k * n4, k, n4)
    masks = torch.from_numpy(cuda_gf.prep_matrix_w8(bits, k))
    x = torch.from_numpy(d32)
    want = _production(bits, d32, k, m, 128 if n4 % TILE else TILE)
    assert np.array_equal(sweep_gf.pipelined_w8(masks, x, k, m).numpy(), want)
    assert np.array_equal(
        sweep_gf.pipelined_w8_plain(masks, x, k, m).numpy(), want)


# -- wrapper contract ----------------------------------------------------------


def test_sweep_wrappers_check_their_operands():
    bits = _bits(4, 2)
    masks = torch.from_numpy(cuda_gf.prep_matrix_w8(bits, 4))
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
        sweep_gf.pipelined_w8(masks, d[:3], 4, 2)
    # the int8 kernel's register fragments take k <= 16 and m <= 8
    with pytest.raises(ValueError):
        sweep_gf.int8_4dot(torch.zeros((8, 8 * 17), dtype=torch.int8),
                           torch.zeros((17, 16), dtype=torch.int32), 17, 1)
    with pytest.raises(ValueError):
        sweep_gf.int8_4dot(torch.zeros((72, 8), dtype=torch.int8),
                           torch.zeros((1, 16), dtype=torch.int32), 1, 9)
    with pytest.raises(ValueError):
        sweep_gf.pipelined_w8(masks, d, 4, 2, tile=6)  # not a multiple of 4
    # two stages of [4, 8000] lanes are over the 227 KiB of shared memory
    with pytest.raises(ValueError):
        sweep_gf.pipelined_w8(masks, d, 4, 2, tile=8000)
    assert sweep_gf.pipelined_w8(masks, d, 4, 2, tile=4).shape == (2, 16)


def test_cpu_runs_plain_versions_without_counting_launches():
    before = dict(sweep_gf.launches)
    d = torch.from_numpy(_data(3, 4, 8))
    sweep_gf.copy_rows(d, 2)
    sweep_gf.extract_rows(d, 2)
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
    ["--stage", "precision"],
    ["--stage", "variants,precision"],
    ["--only", "bf16_4dot"],
    ["--only", "f32_4dot"],
    ["--only", "base,bf16_blockdiag"],
    ["--only", "xornet"],
    ["--stage", "nonesuch"],
    ["--only", "nonesuch"],
    ["--tile", "8000"],
])
def test_sweep_tool_refuses_what_is_not_ported(argv, capsys):
    assert ec_kernel_sweep.main(["--device", "cpu", *argv]) == 2
    captured = capsys.readouterr()
    assert "bit-exact" not in captured.out
    if "nonesuch" not in argv and "--tile" not in argv:
        assert "ROADMAP.md" in captured.err


def test_sweep_tool_exits_1_on_a_mismatch(monkeypatch, capsys):
    def wrong(bp, x, k, m):
        return sweep_gf.int8_4dot_plain(bp, x, k, m) ^ 1

    monkeypatch.setattr(sweep_gf, "int8_4dot", wrong)
    assert ec_kernel_sweep.main(["--device", "cpu", "--iters", "1",
                                 "--only", "base,int8_4dot"]) == 1
    out = capsys.readouterr().out
    assert "int8_4dot      MISMATCH" in out and "base           bit-exact" in out
