"""The port's split-chain probe (``sweep_gf.split_plain``, ``split_product``
and ``ceph_tpu_torch.tools.kernel_r4_split``) against the JAX script's
``experiments/kernel_r4_split._kernel_split``.

``_kernel_split`` runs through ``pl.pallas_call`` in interpret mode as
``kernel_r4_split.main`` builds it, at lanes [8, 4096] with tile 1024.  On
the CPU the JAX product is exact at every precision (the CPU ignores
``precision``), so the DEFAULT parts-1 row is held against
``prec_plain(..., "DEFAULT")`` and a model of one bf16 pass written here
with ``jnp``.  All comparisons are exact.  Inputs are seeded numpy bytes,
uniform over 0..255.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ceph_tpu.ops import pallas_gf
from ceph_tpu_torch.matrices import bitmatrix, reed_sol
from ceph_tpu_torch.ops import cuda_gf, sweep_gf
from ceph_tpu_torch.tools import (ec_kernel_sweep, kernel_r4_split,
                                  split_probe)
from experiments import kernel_r4_split as j_split

K, M, N4, TILE = 8, 4, 4096, 1024


def _bits(k=K, m=M):
    return bitmatrix.matrix_to_bitmatrix(
        reed_sol.vandermonde_coding_matrix(k, m, 8), 8)


def _data(seed, k=K, n4=N4):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, (k, n4 * 4), dtype=np.uint8).view(np.int32)


def _kernel_split(bp, d32, parts, prec, k=K, m=M, tile=TILE):
    """``_kernel_split`` through ``pl.pallas_call`` as
    ``kernel_r4_split.main`` (:101-117) builds it, in interpret mode."""
    n4 = d32.shape[1]
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pl.pallas_call(
            functools.partial(j_split._kernel_split, k=k, m=m, parts=parts,
                              prec=prec),
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


def _production(bits, d32, k=K, m=M, tile=TILE):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pallas_gf._matrix_encode_call(
            jnp.asarray(pallas_gf.prep_matrix_w8(bits, k)), jnp.asarray(d32),
            k, m, tile))


def _one_bf16_pass(bp, d32, m=M):
    """The TPU's DEFAULT precision as one bf16 pass: ``_half``'s planes
    cast to bfloat16, products accumulated in float32."""
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


@pytest.mark.parametrize("parts", [1, 2, 4, 8])
def test_split_plain_matches_kernel_split(parts):
    bits, d32 = _bits(), _data(20 + parts)
    bp = sweep_gf.prep_shift_major_w8(bits, K)
    theirs = _kernel_split(bp, d32, parts, jax.lax.Precision.HIGHEST)
    x, bpt = torch.from_numpy(d32), torch.from_numpy(bp)
    ours = sweep_gf.split_plain(bpt, x, K, M, parts).numpy()
    assert np.array_equal(ours, theirs)
    assert np.array_equal(ours, _production(bits, d32))
    got = sweep_gf.split_product(bpt, x, K, M, "HIGHEST", parts, TILE)
    assert np.array_equal(got.numpy(), theirs)


@pytest.mark.parametrize("parts", [2, 4, 8])
@pytest.mark.parametrize("k,m,n4", [(3, 2, 1000), (5, 3, 129), (16, 8, 33)])
def test_split_plain_other_shapes(parts, k, m, n4):
    bits, d32 = _bits(k, m), _data(k + n4 + parts, k, n4)
    bp = sweep_gf.prep_shift_major_w8(bits, k)
    theirs = _kernel_split(bp, d32, parts, jax.lax.Precision.HIGHEST, k, m,
                           128)
    got = sweep_gf.split_product(torch.from_numpy(bp), torch.from_numpy(d32),
                                 k, m, "HIGHEST", parts, 32 * parts)
    assert np.array_equal(got.numpy(), theirs)


def test_split_default_parts_1_is_one_reduced_pass():
    bits, d32 = _bits(), _data(31)
    bp = sweep_gf.prep_shift_major_w8(bits, K)
    x, bpt = torch.from_numpy(d32), torch.from_numpy(bp)
    ours = sweep_gf.split_product(bpt, x, K, M, "DEFAULT", 1, TILE).numpy()
    assert np.array_equal(
        ours, sweep_gf.prec_plain(bpt, x, K, M, "DEFAULT").numpy())
    assert np.array_equal(ours, _one_bf16_pass(bp, d32))
    # the CPU's JAX DEFAULT row is exact, so it is no oracle for this one
    exact = _kernel_split(bp, d32, 1, jax.lax.Precision.DEFAULT)
    assert np.array_equal(exact, _production(bits, d32))
    assert (ours != exact).mean() > 0.99


def test_split_product_checks_its_operands():
    bp = torch.from_numpy(sweep_gf.prep_shift_major_w8(_bits(4, 2), 4))
    d = torch.zeros((4, 256), dtype=torch.int32)
    for prec in ("HIGH", "DEFAULT"):
        with pytest.raises(ValueError, match="HIGHEST only"):
            sweep_gf.split_product(bp, d, 4, 2, prec, 2)
    with pytest.raises(ValueError, match="precision"):
        sweep_gf.split_product(bp, d, 4, 2, "FAST", 1)
    for parts in (0, 3, 16):
        with pytest.raises(ValueError, match=f"parts {parts} is not one of"):
            sweep_gf.split_product(bp, d, 4, 2, "HIGHEST", parts)
        with pytest.raises(ValueError, match=f"parts {parts} is not one of"):
            sweep_gf.split_plain(bp, d, 4, 2, parts)
    # a chunk is a whole number of warps' 32 lanes
    for parts, tile in ((2, 96), (4, 4096 + 64), (8, 128), (8, 0)):
        with pytest.raises(ValueError, match=r"multiple of 32 \* parts"):
            sweep_gf.split_product(bp, d, 4, 2, "HIGHEST", parts, tile)
    with pytest.raises(TypeError):
        sweep_gf.split_product(bp.to(torch.bfloat16), d, 4, 2, "HIGHEST", 2)
    with pytest.raises(ValueError, match="do not fit"):
        sweep_gf.split_product(bp[:8].contiguous(), d, 4, 2, "HIGHEST", 2)
    with pytest.raises(ValueError, match="only 0 and 1"):
        sweep_gf.split_product(bp * 2, d, 4, 2, "HIGHEST", 4)
    # sweep_prec_f32's limits: 64 accumulators a thread, a shared table of
    # at most 16 * 8 * 64 floats
    for k, m in ((17, 1), (4, 9)):
        with pytest.raises(ValueError, match="the kernel takes"):
            sweep_gf.split_product(torch.zeros((8 * m, 8 * k)),
                                   torch.zeros((k, 8), dtype=torch.int32), k,
                                   m, "HIGHEST", 2)
    assert sweep_gf.split_product(torch.zeros((64, 128)),
                                  torch.zeros((16, 8), dtype=torch.int32), 16,
                                  8, "HIGHEST", 8, 256).shape == (8, 8)


@pytest.mark.parametrize("k,m", [(8, 4), (3, 2), (16, 2), (7, 5)])
def test_split_params_hold_bp_for_the_kernel_split(k, m):
    # the probe tool's kernel parameter for the constant-bank route, read
    # back in the order split_f32.cuh reads Bp (row j*8 + s, bit-row r),
    # gives the JAX product through the plain route
    bits, d32 = _bits(k, m), _data(40 + k, k, 512)
    bp = sweep_gf.prep_shift_major_w8(bits, k)
    params = split_probe.split_params(torch.from_numpy(bp), k, m)
    assert params.dtype == torch.float32 and params.device.type == "cpu"
    assert params.shape == (64 * k * m,) and params.is_contiguous()
    table = params.view(k, 8, 8 * m)
    for j, s, r in ((0, 0, 0), (k - 1, 7, 8 * m - 1), (k // 2, 3, 5)):
        assert table[j, s, r] == bp[r, s * k + j]
    unpacked = table.permute(2, 1, 0).reshape(8 * m, 8 * k)
    x = torch.from_numpy(d32)
    ours = sweep_gf.split_plain(unpacked, x, k, m, 4).numpy()
    theirs = _kernel_split(bp, d32, 4, jax.lax.Precision.HIGHEST, k, m, 128)
    assert np.array_equal(ours, theirs)
    assert np.array_equal(
        ours, sweep_gf.split_plain(torch.from_numpy(bp), x, k, m, 4).numpy())


def test_split_source_holds_the_shape_and_no_bitmatrix():
    # the probe tool's frame fixes k and m and holds nothing of a bitmatrix
    # (Bp arrives with each launch); every edit of the shipped header that
    # it builds finds its statement there once
    for k, m in ((8, 4), (16, 2), (3, 5)):
        gen = split_probe.param_frame(k, m)
        assert f"#define SPLIT_K {k}" in gen
        assert f"float v[64 * SPLIT_K * {m}];" in gen
        assert f"launch_split_f32<{m}>" in gen
        # its only numbers are k, m and the 64 bit-rows x planes of a unit
        assert set(re.findall(r"\b\d+\b", gen)) == {str(k), str(m), "64"}
    shipped = (cuda_gf.CSRC / split_probe.HEADER).read_text()
    builds = split_probe.split_builds()
    assert set(builds) == {"ffma alone", "no products", "256 threads",
                           "constant bank", "pure ffma",
                           "register coefficients", "one-shift fields",
                           "lo, then hi"}
    assert "col[q]" not in builds["pure ffma"]
    assert "__ldg" not in builds["pure ffma"]
    for name, header in builds.items():
        assert header != shipped, name
    assert "__grid_constant__ SplitParam bp" in builds["constant bank"]
    assert "stage_bp_t(bp" not in builds["constant bank"]
    # the copy rows edit sweep_kernels.cu and the bulk ring's source
    copies = split_probe.copy_builds()
    assert set(copies) == set(split_probe.COPY_SETTINGS)
    assert {name for name, _ in copies.values()} == {
        sweep_gf.SOURCE, split_probe.BULK_SOURCE}
    # the shipped header is hashed into sweep_kernels.cu's digest
    assert "split_f32.cuh" in cuda_gf._local_headers(
        (cuda_gf.CSRC / sweep_gf.SOURCE).read_text())


@pytest.mark.parametrize("parts", [2, 4, 8])
@pytest.mark.parametrize("k,m", [(1, 1), (16, 8), (1, 8), (16, 1), (4, 8)])
def test_split_product_takes_every_shape_it_took(parts, k, m):
    # k <= 16 and m <= 8, any tile that is a multiple of
    # 32 * parts, ragged n4
    bits = np.random.RandomState(k * m).randint(0, 2, (8 * m, 8 * k))
    bp = torch.from_numpy(sweep_gf.prep_shift_major_w8(bits, k))
    x = torch.from_numpy(_data(k + m, k, 97))
    want = sweep_gf.split_plain(bp, x, k, m, parts)
    for tile in (32 * parts, 16384):
        got = sweep_gf.split_product(bp, x, k, m, "HIGHEST", parts, tile)
        assert torch.equal(got, want)


def test_cpu_split_product_counts_no_launches():
    before = dict(sweep_gf.launches)
    bp = torch.from_numpy(sweep_gf.prep_shift_major_w8(_bits(4, 2), 4))
    for parts in sweep_gf.SPLIT_PARTS:
        sweep_gf.split_product(bp, torch.from_numpy(_data(3, 4, 64)), 4, 2,
                               "HIGHEST", parts, 256)
    assert sweep_gf.launches == before


def test_split_bound():
    got, by, nbytes, ops = ec_kernel_sweep.kernel_bound_ms(
        "sweep_split_f32", 8, 4, 2097152, 8192)
    assert ops == 2 * 2 * 32 * 64 * 2097152
    assert nbytes == 12 * (8 << 20) + 8192
    assert by == "operations" and round(got, 4) == 0.2564
    # the same work as sweep_prec_f32's
    assert ec_kernel_sweep.kernel_bound_ms(
        "sweep_prec_f32", 8, 4, 2097152, 8192) == (got, by, nbytes, ops)


# -- the port's tool -------------------------------------------------------------


def _rows(out):
    return [line.split() for line in out.splitlines()
            if line.startswith("split")]


def test_split_tool_on_the_cpu(capsys):
    assert kernel_r4_split.main(["--device", "cpu", "--iters", "1"]) == 0
    out = capsys.readouterr().out
    assert "NOT the card" in out
    assert [r[:4] for r in _rows(out)] == [
        ["split2", "tile=8192", "HIGHEST", "bit-exact"],
        ["split4", "tile=16384", "HIGHEST", "bit-exact"],
        ["split8", "tile=16384", "HIGHEST", "bit-exact"],
        ["split1", "tile=16384", "DEFAULT", "MISMATCH"]]


def test_split_tool_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kernel_r4_split.main(["--iters", "1"])


def test_split_tool_exits_1_when_a_kernel_differs(monkeypatch, capsys):
    real = sweep_gf.split_product

    def wrong(bp, x, k, m, precision, parts, tile):
        out = real(bp, x, k, m, precision, parts, tile)
        return out ^ 1 if parts == 4 else out

    monkeypatch.setattr(sweep_gf, "split_product", wrong)
    assert kernel_r4_split.main(["--device", "cpu", "--iters", "1"]) == 1
    out = capsys.readouterr().out
    assert "split4 tile=16384 HIGHEST" in out
    assert "sweep_split_f32 differs from its plain version" in out
    assert [r[0] for r in _rows(out) if "bit-exact" in r] == ["split2",
                                                              "split8"]


def test_split_tool_exits_1_when_a_highest_row_mismatches(monkeypatch,
                                                          capsys):
    # kernel and plain version agree, but not with gf2_matrix_w8
    real_plain, real_product = sweep_gf.split_plain, sweep_gf.split_product
    monkeypatch.setattr(sweep_gf, "split_plain",
                        lambda *a: real_plain(*a) ^ 1)
    monkeypatch.setattr(
        sweep_gf, "split_product",
        lambda bp, x, k, m, prec, parts, tile: (
            real_plain(bp, x, k, m, parts) ^ 1 if prec == "HIGHEST"
            else real_product(bp, x, k, m, prec, parts, tile)))
    assert kernel_r4_split.main(["--device", "cpu", "--iters", "1"]) == 1
    rows = _rows(capsys.readouterr().out)
    assert [r[3] for r in rows] == ["MISMATCH"] * 4
