"""The port's static XOR network (``sweep_gf.make_xornet``,
``xornet_source``, ``xornet_plain``) against the JAX sweep's
``experiments/kernel_r4._make_xornet_kernel``.

The Pallas kernel runs in interpret mode on the CPU through
``kernel_r4._call_variant`` at lanes [k, 4096], tile 1024, as
``build_variants`` calls it; the port's wrapper runs its plain version on
CPU tensors.  All comparisons are exact.  Inputs are seeded numpy bytes,
uniform over 0..255.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ceph_tpu.matrices import bitmatrix as j_bitmatrix
from ceph_tpu.matrices import cauchy as j_cauchy
from ceph_tpu.matrices import reed_sol as j_reed_sol
from ceph_tpu.ops import pallas_gf
from ceph_tpu_torch.matrices import bitmatrix, cauchy, reed_sol
from ceph_tpu_torch.ops import cuda_gf, sweep_gf
from ceph_tpu_torch.tools import ec_kernel_sweep
from experiments import kernel_r4

N4, TILE = 4096, 1024

#: (name, port's coding matrix, the JAX package's coding matrix)
CODES = {
    "reed_sol_van": (reed_sol.vandermonde_coding_matrix,
                     j_reed_sol.vandermonde_coding_matrix),
    "cauchy_good": (cauchy.good_general_coding_matrix,
                    j_cauchy.good_general_coding_matrix),
}


def _bits(code, k, m):
    ours, theirs = CODES[code]
    bits = bitmatrix.matrix_to_bitmatrix(ours(k, m, 8), 8)
    ref = j_bitmatrix.matrix_to_bitmatrix(theirs(k, m, 8), 8)
    assert np.array_equal(bits, ref)
    return bits


def _data(seed, k, n4=N4):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, (k, n4 * 4), dtype=np.uint8).view(np.int32)


@pytest.mark.parametrize("code,k,m", [("reed_sol_van", 8, 4),
                                      ("reed_sol_van", 3, 2),
                                      ("cauchy_good", 8, 4)])
def test_xornet_matches_kernel_r4_and_production(code, k, m):
    bits, d32 = _bits(code, k, m), _data(k * 10 + m, k)
    with pltpu.force_tpu_interpret_mode():
        theirs = np.asarray(kernel_r4._call_variant(
            kernel_r4._make_xornet_kernel(bits, k, m), k, m,
            jnp.asarray(d32), TILE))
        production = np.asarray(pallas_gf._matrix_encode_call(
            jnp.asarray(pallas_gf.prep_matrix_w8(bits, k)),
            jnp.asarray(d32), k, m, TILE))
    x = torch.from_numpy(d32)
    ours = sweep_gf.make_xornet(bits, k, m)(x).numpy()
    assert np.array_equal(ours, theirs)
    assert np.array_equal(ours, production)
    assert np.array_equal(sweep_gf.xornet_plain(bits, x, k, m).numpy(), theirs)


@pytest.mark.parametrize("n4", [1, 1003])
def test_xornet_plain_at_ragged_widths(n4):
    bits, d32 = _bits("cauchy_good", 5, 3), _data(n4, 5, n4)
    tables = torch.from_numpy(cuda_gf.prep_matrix_w8(bits, 5))
    x = torch.from_numpy(d32)
    assert torch.equal(sweep_gf.make_xornet(bits, 5, 3)(x),
                       cuda_gf.matrix_encode_w8_plain(tables, x, 5, 3))


def test_xornet_source_is_deterministic_and_keyed_by_bitmatrix():
    rs_bits = _bits("reed_sol_van", 8, 4)
    cg_bits = _bits("cauchy_good", 8, 4)
    a = sweep_gf.xornet_source(rs_bits, 8, 4)
    assert a == sweep_gf.xornet_source(rs_bits.copy(), 8, 4)
    b = sweep_gf.xornet_source(cg_bits, 8, 4)
    assert a != b
    gen_a = (sweep_gf.XORNET_HEADER, a)
    gen_b = (sweep_gf.XORNET_HEADER, b)
    src = sweep_gf.XORNET_SOURCE
    assert cuda_gf.source_digest(src, gen_a) == cuda_gf.source_digest(
        src, gen_a)
    assert cuda_gf.source_digest(src, gen_a) != cuda_gf.source_digest(
        src, gen_b)
    assert cuda_gf.source_digest(src, gen_a) != cuda_gf.source_digest(src)
    assert "#define XORNET_K 8" in a and "#define XORNET_M 4" in a
    # one XOR for each 1 of the bitmatrix
    assert a.count("^= q;") == int(rs_bits.sum()) == 854


def test_xornet_source_extracts_no_unused_plane():
    bits = _bits("reed_sol_van", 3, 2).copy()
    bits[:, 1 * 8 + 5] = 0      # plane (j=1, s=5) used by no bit-row
    bits[:, 2 * 8:3 * 8] = 0    # input row 2 used by none
    bits[3] = 0                 # an all-zero bit-row
    src = sweep_gf.xornet_source(bits, 3, 2)
    planes = re.findall(r"q = \(x\[(\d+)\] >> (\d+)\)", src)
    used = {(c // 8, c % 8) for c in np.flatnonzero(bits.any(0))}
    assert {(int(j), int(s)) for j, s in planes} == used
    assert len(planes) == len(used)
    assert (1, 5) not in used and not any(j == 2 for j, _ in used)
    # input-major: all planes of row 0 before any of row 1
    assert [int(j) for j, _ in planes] == sorted(int(j) for j, _ in planes)
    d32 = _data(9, 3, 64)
    out = sweep_gf.make_xornet(bits, 3, 2)(torch.from_numpy(d32)).numpy()
    # bit-row 3 (bit 3 of output row 0) is all zero
    assert not (out[0] & 0x08080808).any()
    # _make_xornet_kernel cannot build an all-zero bit-row (it shifts
    # None); the production kernel is the oracle here
    with pltpu.force_tpu_interpret_mode():
        theirs = np.asarray(pallas_gf._matrix_encode_call(
            jnp.asarray(pallas_gf.prep_matrix_w8(bits, 3)),
            jnp.asarray(d32), 3, 2, 64))
    assert np.array_equal(out, theirs)


def test_make_xornet_refuses_what_it_does_not_build():
    with pytest.raises(ValueError, match="k <= 16 and m <= 8"):
        sweep_gf.make_xornet(np.zeros((8, 8 * 17), np.uint8), 17, 1)
    with pytest.raises(ValueError, match="k <= 16 and m <= 8"):
        sweep_gf.make_xornet(np.zeros((72, 8), np.uint8), 1, 9)
    with pytest.raises(ValueError, match="does not fit"):
        sweep_gf.make_xornet(np.zeros((32, 56), np.uint8), 8, 4)
    with pytest.raises(ValueError, match="0 or 1"):
        sweep_gf.make_xornet(np.full((16, 24), 2, np.uint8), 3, 2)
    fn = sweep_gf.make_xornet(_bits("reed_sol_van", 3, 2), 3, 2)
    with pytest.raises(ValueError, match="do not fit"):
        fn(torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(TypeError):
        fn(torch.zeros((3, 8), dtype=torch.int64))
    # the widest code it builds
    wide = sweep_gf.make_xornet(np.ones((64, 128), np.uint8), 16, 8)
    assert wide(torch.zeros((16, 8), dtype=torch.int32)).shape == (8, 8)


def test_cpu_xornet_counts_no_launches():
    before = dict(sweep_gf.launches)
    sweep_gf.make_xornet(_bits("reed_sol_van", 3, 2), 3, 2)(
        torch.from_numpy(_data(5, 3, 16)))
    assert sweep_gf.launches == before


def test_xornet_bound_is_bytes_only():
    got, by, nbytes, ops = ec_kernel_sweep.kernel_bound_ms(
        "sweep_xornet", 8, 4, 2097152)
    assert ops == 0 and nbytes == 12 * (8 << 20)
    assert by == "bytes" and round(got, 4) == 0.0300
