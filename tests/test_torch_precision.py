"""The port's precision stage (``sweep_gf.prec_plain``, ``prec_product``)
against the JAX sweep's ``experiments/kernel_r4._kernel_prec``.

``_kernel_prec`` runs through ``pl.pallas_call`` in interpret mode as
``main_prec`` builds it, at lanes [8, 4096] with tile 1024.  On the CPU the
JAX product is exact at every precision (the CPU ignores ``precision``), so
the DEFAULT row is held against a model of one bf16 pass written here with
``jnp``: planes cast to bf16, float32 accumulation.  All comparisons are
exact.  Inputs are seeded numpy bytes, uniform over 0..255.
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
from ceph_tpu_torch.tools import ec_kernel_sweep
from experiments import kernel_r4

K, M, N4, TILE = 8, 4, 4096, 1024


def _bits(k=K, m=M):
    return bitmatrix.matrix_to_bitmatrix(
        reed_sol.vandermonde_coding_matrix(k, m, 8), 8)


def _data(seed, k=K, n4=N4):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, (k, n4 * 4), dtype=np.uint8).view(np.int32)


def _kernel_prec(bp, d32, prec, k=K, m=M, tile=TILE):
    """``_kernel_prec`` through ``pl.pallas_call`` as ``main_prec``
    (kernel_r4.py:362-376) builds it, in interpret mode."""
    n4 = d32.shape[1]
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pl.pallas_call(
            functools.partial(kernel_r4._kernel_prec, k=k, m=m, prec=prec),
            out_shape=jax.ShapeDtypeStruct((m, n4), jnp.int32),
            grid=(-(-n4 // tile),),
            in_specs=[
                pl.BlockSpec((m * 8, k * 8), lambda i: (0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((k, tile), lambda i: (0, i),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((m, tile), lambda i: (0, i),
                                   memory_space=pltpu.VMEM),
        )(jnp.asarray(bp), jnp.asarray(d32)))


def _one_bf16_pass(bp, d32, m=M):
    """The TPU's DEFAULT precision as one bf16 pass: ``_kernel_prec``'s
    planes cast to bfloat16, products accumulated in float32."""
    x = jnp.asarray(d32)
    mask = jnp.int32(0x00010001)
    B = jnp.asarray(bp).astype(jnp.bfloat16)
    acc = []
    for base in (0, 8):
        planes = jnp.concatenate(
            [((x >> (base + s)) & mask).astype(jnp.float32) for s in range(8)],
            axis=0).astype(jnp.bfloat16)
        acc.append(jnp.dot(B, planes, preferred_element_type=jnp.float32
                           ).astype(jnp.int32))
    pb = (acc[0] + (acc[1] << 8)) & jnp.int32(0x01010101)
    ob = pb.reshape(m, 8, x.shape[1])
    out = ob[:, 0]
    for l in range(1, 8):
        out = out | (ob[:, l] << l)
    return np.asarray(out)


def _production(bits, d32):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pallas_gf._matrix_encode_call(
            jnp.asarray(pallas_gf.prep_matrix_w8(bits, K)), jnp.asarray(d32),
            K, M, TILE))


@pytest.mark.parametrize("prec", ["HIGHEST", "HIGH"])
def test_prec_plain_matches_kernel_prec(prec):
    bits, d32 = _bits(), _data(11)
    bp = sweep_gf.prep_shift_major_w8(bits, K)
    theirs = _kernel_prec(bp, d32, getattr(jax.lax.Precision, prec))
    x = torch.from_numpy(d32)
    ours = sweep_gf.prec_plain(torch.from_numpy(bp), x, K, M, prec).numpy()
    assert np.array_equal(ours, theirs)
    assert np.array_equal(ours, _production(bits, d32))
    for tile in sweep_gf.PREC_TILES:
        assert np.array_equal(sweep_gf.prec_product(
            torch.from_numpy(bp), x, K, M, prec, tile).numpy(), theirs)


def test_prec_plain_default_is_one_reduced_pass():
    bits, d32 = _bits(), _data(12)
    bp = sweep_gf.prep_shift_major_w8(bits, K)
    ours = sweep_gf.prec_plain(torch.from_numpy(bp), torch.from_numpy(d32),
                               K, M, "DEFAULT").numpy()
    assert np.array_equal(ours, _one_bf16_pass(bp, d32))
    # the CPU's JAX DEFAULT row is exact, so it is no oracle for this one
    exact = _kernel_prec(bp, d32, jax.lax.Precision.DEFAULT)
    assert np.array_equal(exact, _production(bits, d32))
    differs = (ours != exact).mean()
    assert differs > 0.99, differs


def test_tf32_rounding_takes_65537_to_65536():
    v = torch.tensor([0.0, 1.0, 65536.0, 65537.0, 65539.0, 1.5])
    assert sweep_gf._tf32_rna(v).tolist() == [0.0, 1.0, 65536.0, 65536.0,
                                              65536.0, 1.5]
    # ties go away from zero: 2^11 + 1 lies halfway between TF32 neighbours
    assert sweep_gf._tf32_rna(torch.tensor([2049.0])).item() == 2050.0


@pytest.mark.parametrize("k,m,n4", [(3, 2, 1000), (5, 3, 129), (16, 8, 33)])
def test_prec_plain_other_shapes(k, m, n4):
    bits, d32 = _bits(k, m), _data(k + n4, k, n4)
    bp = sweep_gf.prep_shift_major_w8(bits, k)
    theirs = _kernel_prec(bp, d32, jax.lax.Precision.HIGHEST, k, m, 128)
    ours = sweep_gf.prec_plain(torch.from_numpy(bp), torch.from_numpy(d32),
                               k, m, "HIGH").numpy()
    assert np.array_equal(ours, theirs)


def test_prec_product_checks_its_operands():
    bp = torch.from_numpy(sweep_gf.prep_shift_major_w8(_bits(4, 2), 4))
    d = torch.zeros((4, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="precision"):
        sweep_gf.prec_product(bp, d, 4, 2, "FAST")
    with pytest.raises(ValueError, match="precision"):
        sweep_gf.prec_plain(bp, d, 4, 2, "highest")
    with pytest.raises(TypeError):
        sweep_gf.prec_product(bp.to(torch.bfloat16), d, 4, 2, "HIGH")
    with pytest.raises(ValueError, match="do not fit"):
        sweep_gf.prec_product(bp[:8].contiguous(), d, 4, 2, "HIGH")
    with pytest.raises(ValueError, match="multiple of 32"):
        sweep_gf.prec_product(bp, d, 4, 2, "HIGH", tile=1000)
    with pytest.raises(ValueError, match="only 0 and 1"):
        sweep_gf.prec_product(bp * 2, d, 4, 2, "DEFAULT")
    # Bp's register fragments take k <= 8, m <= 4 (TF32); the FFMA kernel's
    # accumulators and shared table take k <= 16, m <= 8
    for prec, k, m in (("HIGH", 9, 1), ("DEFAULT", 4, 5), ("HIGHEST", 17, 1),
                       ("HIGHEST", 4, 9)):
        with pytest.raises(ValueError, match="the kernel takes"):
            sweep_gf.prec_product(torch.zeros((8 * m, 8 * k)),
                                  torch.zeros((k, 8), dtype=torch.int32), k,
                                  m, prec)
    assert sweep_gf.prec_product(torch.zeros((64, 128)),
                                 torch.zeros((16, 8), dtype=torch.int32), 16,
                                 8, "HIGHEST").shape == (8, 8)


def test_cpu_prec_product_counts_no_launches():
    before = dict(sweep_gf.launches)
    bp = torch.from_numpy(sweep_gf.prep_shift_major_w8(_bits(4, 2), 4))
    for prec in sweep_gf.PREC_KERNELS:
        sweep_gf.prec_product(bp, torch.from_numpy(_data(3, 4, 64)), 4, 2,
                              prec)
    assert sweep_gf.launches == before


@pytest.mark.parametrize("kernel,ms", [("sweep_prec_f32", 0.2564),
                                       ("sweep_prec_tf32x3", 0.0347),
                                       ("sweep_prec_tf32", 0.0347)])
def test_precision_bounds(kernel, ms):
    got, by, nbytes, ops = ec_kernel_sweep.kernel_bound_ms(
        kernel, 8, 4, 2097152, 8192)
    assert ops == 2 * 2 * 32 * 64 * 2097152 == 17_179_869_184
    assert nbytes == 12 * (8 << 20) + 8192
    assert by == "operations" and round(got, 4) == ms
    # the lanes' bytes alone would take 0.0300 ms; the table adds 8 KiB
    assert round(ec_kernel_sweep.bound_ms(nbytes - 8192)[0], 4) == 0.0300
