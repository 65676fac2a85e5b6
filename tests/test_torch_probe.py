"""The port's split-cost probes (``sweep_gf.extract_fold``,
``field_planes``, ``planes_product`` and
``ceph_tpu_torch.tools.kernel_r4_probe``) against the JAX script's
``experiments/kernel_r4_probe._extract_kernel`` and ``_mxu_kernel``.

Both Pallas kernels run through ``pl.pallas_call`` in interpret mode as
``kernel_r4_probe.main`` builds them, at lanes [8, 4096] with tile 1024
(other codes at narrower lanes); the port's wrappers run their plain
versions on CPU tensors.  All comparisons are exact.  Inputs are seeded
numpy bytes, uniform over 0..255.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ceph_tpu.ops import pallas_gf
from ceph_tpu_torch.matrices import bitmatrix, reed_sol
from ceph_tpu_torch.ops import sweep_gf
from ceph_tpu_torch.tools import ec_kernel_sweep, kernel_r4_probe
from experiments import kernel_r4_probe as j_probe

K, M, N4, TILE = 8, 4, 4096, 1024


def _bits(k=K, m=M):
    return bitmatrix.matrix_to_bitmatrix(
        reed_sol.vandermonde_coding_matrix(k, m, 8), 8)


def _data(seed, k=K, n4=N4):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, (k, n4 * 4), dtype=np.uint8).view(np.int32)


def _extract_kernel(d32, k, m, tile=TILE):
    """``_extract_kernel`` as ``kernel_r4_probe.main`` (:116-126) builds
    it, in interpret mode."""
    n4 = d32.shape[1]
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pl.pallas_call(
            functools.partial(j_probe._extract_kernel, k=k, m=m),
            out_shape=jax.ShapeDtypeStruct((m, n4), jnp.int32),
            grid=(-(-n4 // tile),),
            in_specs=[pl.BlockSpec((k, tile), lambda i: (0, i),
                                   memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((m, tile), lambda i: (0, i),
                                   memory_space=pltpu.VMEM),
        )(jnp.asarray(d32)))


def _mxu_kernel(bp, planes, k, m, tile=TILE):
    """``_mxu_kernel`` as ``kernel_r4_probe.main`` (:141-155) builds it, in
    interpret mode."""
    n4 = planes.shape[2]
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pl.pallas_call(
            functools.partial(j_probe._mxu_kernel, k=k, m=m),
            out_shape=jax.ShapeDtypeStruct((m, n4), jnp.int32),
            grid=(-(-n4 // tile),),
            in_specs=[
                pl.BlockSpec((m * 8, k * 8), lambda i: (0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((2, 8 * k, tile), lambda i: (0, 0, i),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((m, tile), lambda i: (0, i),
                                   memory_space=pltpu.VMEM),
        )(jnp.asarray(bp), jnp.asarray(planes)))


def _numpy_planes(d32, k):
    """The host loop of ``kernel_r4_probe.main`` (:132-139), for any k."""
    planes_np = np.zeros((2, 8 * k, d32.shape[1]), np.float32)
    x = d32.astype(np.int64)
    for s in range(8):
        planes_np[0, s * k:(s + 1) * k, :] = ((x >> s) & 0x00010001)
        planes_np[1, s * k:(s + 1) * k, :] = ((x >> (8 + s)) & 0x00010001)
    return planes_np


def _production(bits, d32, k, m, tile):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pallas_gf._matrix_encode_call(
            jnp.asarray(pallas_gf.prep_matrix_w8(bits, k)), jnp.asarray(d32),
            k, m, tile))


# -- the extraction fold ---------------------------------------------------------


@pytest.mark.parametrize("k,m,n4,tile", [
    (8, 4, N4, TILE),    # the script's code: m divides k
    (3, 2, 1000, 128),   # k = 1 (mod m): a plane's class follows its shift
    (6, 3, 1000, 128),
    (16, 8, 512, 128),
])
def test_extract_fold_plain_matches_extract_kernel(k, m, n4, tile):
    d32 = _data(k * 10 + m, k, n4)
    theirs = _extract_kernel(d32, k, m, tile)
    x = torch.from_numpy(d32)
    assert np.array_equal(sweep_gf.extract_fold_plain(x, k, m).numpy(),
                          theirs)
    assert np.array_equal(sweep_gf.extract_fold(x, k, m).numpy(), theirs)
    # both fields of a lane count: up to 16k/m each
    assert (theirs >> 16).max() > 8 and (theirs & 0xFFFF).max() > 8


def test_extract_fold_refuses_what_the_tpu_does_not_compute_exactly():
    # m must divide 8k, or the JAX slicing fails
    with pytest.raises(ValueError, match="does not divide"):
        sweep_gf.extract_fold(torch.zeros((3, 8), dtype=torch.int32), 3, 5)
    # 16k/m = 256 fields of up to 65537 reach 2^24: the TPU's f32 sum is
    # no longer exact, so an integer sum would not match it
    with pytest.raises(ValueError, match="not exact"):
        sweep_gf.extract_fold(torch.zeros((16, 8), dtype=torch.int32), 16, 1)
    # the kernel keeps m accumulators indexed at compile time
    with pytest.raises(ValueError, match="the kernel takes m <= 8"):
        sweep_gf.extract_fold(torch.zeros((8, 8), dtype=torch.int32), 8, 16)
    with pytest.raises(ValueError, match="do not fit"):
        sweep_gf.extract_fold(torch.zeros((8, 8), dtype=torch.int32), 4, 2)
    with pytest.raises(TypeError):
        sweep_gf.extract_fold(torch.zeros((8, 8), dtype=torch.int64), 8, 4)
    # the widest exact sum at m = 1: 16k = 240 fields
    x = torch.from_numpy(_data(5, 15, 64))
    assert np.array_equal(sweep_gf.extract_fold(x, 15, 1).numpy(),
                          _extract_kernel(x.numpy(), 15, 1, 64))


# -- the products over planes made beforehand ----------------------------------


@pytest.mark.parametrize("k,n4", [(8, N4), (3, 1000), (16, 33)])
def test_field_planes_match_the_host_loop(k, n4):
    d32 = _data(k + n4, k, n4)
    ours = sweep_gf.field_planes(torch.from_numpy(d32), k)
    assert ours.dtype == torch.float32
    assert np.array_equal(ours.numpy(), _numpy_planes(d32, k))
    with pytest.raises(ValueError, match="do not fit"):
        sweep_gf.field_planes(torch.from_numpy(d32), k + 1)


@pytest.mark.parametrize("k,m,n4,tile", [
    (8, 4, N4, TILE),    # the script's code
    (3, 2, 1000, 128),
    (16, 8, 256, 128),
])
def test_planes_plain_matches_mxu_kernel_and_production(k, m, n4, tile):
    bits, d32 = _bits(k, m), _data(k * 7 + m, k, n4)
    bp = sweep_gf.prep_shift_major_w8(bits, k)
    planes = _numpy_planes(d32, k)
    theirs = _mxu_kernel(bp, planes, k, m, tile)
    bpt = torch.from_numpy(bp)
    ours = sweep_gf.planes_plain(bpt, torch.from_numpy(planes), k, m).numpy()
    assert np.array_equal(ours, theirs)
    assert np.array_equal(ours, _production(bits, d32, k, m, tile))
    got = sweep_gf.planes_product(
        bpt, sweep_gf.field_planes(torch.from_numpy(d32), k), k, m)
    assert np.array_equal(got.numpy(), theirs)


def test_planes_product_checks_its_operands():
    bp = torch.from_numpy(sweep_gf.prep_shift_major_w8(_bits(4, 2), 4))
    planes = sweep_gf.field_planes(torch.from_numpy(_data(1, 4, 64)), 4)
    with pytest.raises(TypeError):
        sweep_gf.planes_product(bp, planes.double(), 4, 2)
    with pytest.raises(TypeError):
        sweep_gf.planes_product(bp.to(torch.bfloat16), planes, 4, 2)
    for bad in (planes[0], planes[:, :16], planes[:, :, ::2]):
        with pytest.raises(ValueError, match="contiguous"):
            sweep_gf.planes_product(bp, bad, 4, 2)
    with pytest.raises(ValueError, match="does not fit"):
        sweep_gf.planes_product(bp[:8].contiguous(), planes, 4, 2)
    with pytest.raises(ValueError, match="multiple of 32"):
        sweep_gf.planes_product(bp, planes, 4, 2, tile=1000)
    with pytest.raises(ValueError, match="only 0 and 1"):
        sweep_gf.planes_product(bp * 2, planes, 4, 2)
    # sweep_prec_f32's limits
    with pytest.raises(ValueError, match="the kernel takes"):
        sweep_gf.planes_product(torch.zeros((72, 32)),
                                torch.zeros((2, 32, 8)), 4, 9)
    assert sweep_gf.planes_product(bp, planes[:, :, :0].contiguous(), 4,
                                   2).shape == (2, 0)


def test_cpu_probe_wrappers_count_no_launches():
    before = dict(sweep_gf.launches)
    x = torch.from_numpy(_data(3, 4, 64))
    bp = torch.from_numpy(sweep_gf.prep_shift_major_w8(_bits(4, 2), 4))
    sweep_gf.extract_fold(x, 4, 2)
    sweep_gf.planes_product(bp, sweep_gf.field_planes(x, 4), 4, 2)
    assert sweep_gf.launches == before


@pytest.mark.parametrize("kernel,table_bytes,nbytes,ms", [
    # all k rows in, m rows out
    ("sweep_extract_fold", 0, 12 * (8 << 20), 0.0300),
    # 2 * 8k rows of float32 planes in: 64 times the payload
    ("sweep_planes_f32", 8192, 1_107_304_448, 0.3305),
])
def test_probe_bounds_are_bytes(kernel, table_bytes, nbytes, ms):
    got, by, n, ops = ec_kernel_sweep.kernel_bound_ms(kernel, 8, 4, 2097152,
                                                      table_bytes)
    assert (n, by, round(got, 4)) == (nbytes, "bytes", ms)
    # the planes' product does sweep_prec_f32's operations, 0.2564 ms
    if kernel == "sweep_planes_f32":
        assert round(ec_kernel_sweep.bound_ms(
            0, ops, ec_kernel_sweep.FP32_OPS_PER_S)[0], 4) == 0.2564
    else:
        assert ops == 0


# -- the port's tool -------------------------------------------------------------


def test_probe_tool_on_the_cpu(capsys):
    assert kernel_r4_probe.main(["--device", "cpu", "--iters", "1"]) == 0
    out = capsys.readouterr().out
    assert "NOT the card" in out
    for row in kernel_r4_probe.ROWS:
        assert f"{row:30s} bit-exact" in out
    assert "no tile sweep" in out


def test_probe_tool_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kernel_r4_probe.main(["--iters", "1"])


@pytest.mark.parametrize("wrapper,row", [
    ("extract_fold", "extract-only"),
    ("planes_product", "mxu-only (per data-byte equiv)"),
])
def test_probe_tool_exits_1_on_a_mismatch(monkeypatch, capsys, wrapper, row):
    real = getattr(sweep_gf, wrapper)
    monkeypatch.setattr(sweep_gf, wrapper, lambda *a: real(*a) ^ 1)
    assert kernel_r4_probe.main(["--device", "cpu", "--iters", "1"]) == 1
    out = capsys.readouterr().out
    assert f"{row:30s} MISMATCH" in out
    assert f"{'full':30s} bit-exact" in out
