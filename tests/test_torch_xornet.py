"""The port's static XOR network (``sweep_gf.make_xornet``,
``xornet_source``, ``xornet_plain``) against the JAX sweep's
``experiments/kernel_r4._make_xornet_kernel``.

The Pallas kernel runs in interpret mode on the CPU through
``kernel_r4._call_variant`` at lanes [k, 4096], tile 1024, as
``build_variants`` calls it; the port's wrapper runs its plain version on
CPU tensors.  A numpy model of the kernel's frame (``csrc/xornet_kernel.cu``:
spans, the bit transposes and the generated network, read by a small
evaluator of the header's statements) is held against both.  All
comparisons are exact.  Inputs are seeded numpy bytes, uniform over 0..255.
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
from ceph_tpu_torch.tools import ec_kernel_sweep, xornet_probe
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
    # one XOR for each 1 of the bitmatrix, over whole planes: no shift and
    # no mask anywhere in the network
    assert a.count("^= p[") == int(rs_bits.sum()) == 854
    assert len(re.findall(r"z\[\d+\] \^= p\[[0-7]\];", a)) == 854
    assert ">>" not in a and "<<" not in a and "0x" not in a
    assert "854 ones, 822 XORs over 64 of 64 planes" in a


def _network(src):
    """(k, m, [(j, [(s, [bit-rows])])]) read from a generated header: one
    specialization ``xornet_row<j>`` per used input row, in the header's
    order, one line per used plane.  Raises on any statement outside the
    grammar (``z[r] ^= p[s];``)."""
    k = int(re.search(r"^#define XORNET_K (\d+)$", src, re.M).group(1))
    m = int(re.search(r"^#define XORNET_M (\d+)$", src, re.M).group(1))
    rows = []
    for j, body in re.findall(
            r"^template <>\n__device__ __forceinline__ void xornet_row<(\d+)>"
            r"\(const uint32_t \(&p\)\[8\], uint32_t \(&z\)\[8 \* "
            r"XORNET_M\]\) \{\n(.*?)\n\}$", src, re.M | re.S):
        planes = []
        for line in body.split("\n"):
            assert re.fullmatch(r"  z\[\d+\] \^= p\[[0-7]\];"
                                r"( z\[\d+\] \^= p\[[0-7]\];)*", line), line
            stmts = re.findall(r"z\[(\d+)\] \^= p\[(\d)\];", line)
            assert len({s for _, s in stmts}) == 1, line
            planes.append((int(stmts[0][1]), [int(r) for r, _ in stmts]))
        rows.append((int(j), planes))
    assert src.count("template <>") == len(rows)
    return k, m, rows


def test_xornet_source_extracts_no_unused_plane():
    bits = _bits("reed_sol_van", 3, 2).copy()
    bits[:, 1 * 8 + 5] = 0      # plane (j=1, s=5) used by no bit-row
    bits[:, 2 * 8:3 * 8] = 0    # input row 2 used by none
    bits[3] = 0                 # an all-zero bit-row
    src = sweep_gf.xornet_source(bits, 3, 2)
    _, _, rows = _network(src)
    planes = [(j, s) for j, row in rows for s, _ in row]
    used = {(c // 8, c % 8) for c in np.flatnonzero(bits.any(0))}
    assert set(planes) == used
    assert len(planes) == len(used)
    assert (1, 5) not in used and not any(j == 2 for j, _ in used)
    # no specialization for the unused input row, no statement for the
    # all-zero bit-row
    assert "xornet_row<2>" not in src and "z[3] ^=" not in src
    # input-major: all planes of row 0 before any of row 1
    assert [j for j, _ in planes] == sorted(j for j, _ in planes)
    # each statement is a 1 of the bitmatrix, and each 1 a statement
    got = np.zeros_like(bits)
    for j, row in rows:
        for s, targets in row:
            got[targets, j * 8 + s] = 1
    assert np.array_equal(got, bits)
    d32 = _data(9, 3, 64)
    out = sweep_gf.make_xornet(bits, 3, 2)(torch.from_numpy(d32)).numpy()
    # bit-row 3 (bit 3 of output row 0) is all zero
    assert not (out[0] & 0x08080808).any()
    assert np.array_equal(_frame_model(src, d32, False), out)
    # _make_xornet_kernel cannot build an all-zero bit-row (it shifts
    # None); the production kernel is the oracle here
    with pltpu.force_tpu_interpret_mode():
        theirs = np.asarray(pallas_gf._matrix_encode_call(
            jnp.asarray(pallas_gf.prep_matrix_w8(bits, 3)),
            jnp.asarray(d32), 3, 2, 64))
    assert np.array_equal(out, theirs)


# -- a numpy model of csrc/xornet_kernel.cu -----------------------------------

#: lanes a warp takes, and the lane of word e of thread t of a span in the
#: 16-byte form (4t..4t+3, 128+4t..128+4t+3) and the one-word form (t + 32e)
SPAN = 256
_T, _E = np.arange(32)[:, None], np.arange(8)[None, :]
SPAN_LANES = {True: 4 * _T + (_E & 3) + 128 * (_E >> 2), False: _T + 32 * _E}


def _transpose8(w):
    """The frame's ``transpose8`` on 8 uint32 arrays: bit (8b + t) of
    word s <- bit (8b + s) of word t, as three delta-swap stages."""
    w = list(w)
    for d, mask, pairs in ((4, 0x0F0F0F0F, (0, 1, 2, 3)),
                           (2, 0x33333333, (0, 1, 4, 5)),
                           (1, 0x55555555, (0, 2, 4, 6))):
        for t in pairs:
            a, b = w[t], w[t + d]
            x = ((a >> np.uint32(d)) ^ b) & np.uint32(mask)
            w[t], w[t + d] = a ^ (x << np.uint32(d)), b ^ x
    return w


def _frame_model(src, lanes, vec):
    """What the frame computes with the network of header ``src`` over
    lanes [k, n4]: each warp a span of 256 lanes, each thread 8 words of a
    row (``SPAN_LANES[vec]``), lanes past n4 read as 0; each row's words
    transposed into planes, the header's statements run on them, each
    output row's accumulators transposed back and stored where lanes are
    real."""
    k, m, rows = _network(src)
    n4 = lanes.shape[1]
    spans = -(-n4 // SPAN)
    x = np.zeros((k, spans * SPAN), np.uint32)
    x[:, :n4] = lanes.view(np.uint32)
    at = np.arange(spans)[:, None, None] * SPAN + SPAN_LANES[vec]
    words = np.moveaxis(x[:, at], -1, 0)        # [8, k, spans, 32]
    z = np.zeros((8 * m, spans, 32), np.uint32)
    for j, row in rows:
        p = _transpose8(words[:, j])
        for s, targets in row:
            for r in targets:
                z[r] ^= p[s]
    out = np.zeros((m, spans * SPAN), np.uint32)
    for i in range(m):
        for e, word in enumerate(_transpose8(z[8 * i:8 * i + 8])):
            out[i, at[..., e]] = word
    return out[:, :n4].view(np.int32)


def test_transpose8_is_a_bit_transpose_and_its_own_inverse():
    rs = np.random.RandomState(3)
    w = [rs.randint(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
         for _ in range(8)]
    p = _transpose8(w)
    for s in range(8):
        for t in range(8):
            for b in range(4):
                assert np.array_equal((p[s] >> np.uint32(8 * b + t)) & 1,
                                      (w[t] >> np.uint32(8 * b + s)) & 1)
    assert all(np.array_equal(a, b) for a, b in zip(_transpose8(p), w))


@pytest.mark.parametrize("code,k,m", [("reed_sol_van", 8, 4),
                                      ("reed_sol_van", 3, 2),
                                      ("cauchy_good", 8, 4),
                                      ("reed_sol_van", 16, 8)])
@pytest.mark.parametrize("n4,vec", [(1, False), (7, False), (9, False),
                                    (1003, False), (4096, True),
                                    (4096, False)])
def test_frame_model_matches_kernel_r4_and_plain(code, k, m, n4, vec):
    # the kernel takes its 16-byte form only where n4 is a multiple of 4
    # (and both pointers are on the 16-byte grid), else the one-word form
    bits, d32 = _bits(code, k, m), _data(k * 100 + n4, k, n4)
    ours = _frame_model(sweep_gf.xornet_source(bits, k, m), d32, vec)
    with pltpu.force_tpu_interpret_mode():
        theirs = np.asarray(kernel_r4._call_variant(
            kernel_r4._make_xornet_kernel(bits, k, m), k, m,
            jnp.asarray(d32), min(n4, TILE)))
    assert np.array_equal(ours, theirs)
    plain = sweep_gf.xornet_plain(bits, torch.from_numpy(d32), k, m)
    assert np.array_equal(ours, plain.numpy())


def test_xornet_probe_edits_find_their_statements():
    # every row of the probe tool is the shipped frame with statements
    # replaced (each found there once), over the generated network
    frame = (cuda_gf.CSRC / sweep_gf.XORNET_SOURCE).read_text()
    bits = _bits("reed_sol_van", 8, 4)
    builds = xornet_probe.xornet_builds(bits)
    assert set(builds) == {"loads and stores alone",
                           "loads, transposes and stores",
                           "plane per lane", "4 lanes a thread",
                           "persistent grid"}
    assert set(xornet_probe.CHECKED) < set(builds)
    header = sweep_gf.xornet_source(bits, 8, 4)
    for name, (text, net) in builds.items():
        assert text != frame, name
        assert net.startswith(header), name
    alone = builds["loads and stores alone"][0]
    assert "xornet_row<J>(w" not in alone and "transpose8(o);" not in alone
    transposes = builds["loads, transposes and stores"][0]
    assert "xornet_row<J>(w" not in transposes
    assert "transpose8(o);" in transposes
    lane, lane_net = builds["plane per lane"]
    assert "xornet_network(xe, zl);" in lane and "kQuads = 1;" in lane
    # the replaced form's network: one XOR per 1 of the bitmatrix, on
    # masked planes
    assert lane_net.count("^= q;") == 854
    assert "kQuads = 1;" in builds["4 lanes a thread"][0]
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor" in builds[
        "persistent grid"][0]


def test_greedy_xor_count_shares_pairs():
    # two equal rows of three ones: (0, 1) then (s, 2) computed once each,
    # where the network as generated takes 2 + 2 XORs
    bits = np.array([[1, 1, 1, 0], [1, 1, 1, 0], [0, 0, 0, 1]])
    assert xornet_probe.greedy_xor_count(bits) == 2
    # no pair occurs twice: nothing to share
    assert xornet_probe.greedy_xor_count(np.eye(4, dtype=int)) == 0
    rs_bits = _bits("reed_sol_van", 8, 4)
    assert xornet_probe.greedy_xor_count(rs_bits) < 822


def test_xornet_probe_reads_ptxas_report():
    log = ("ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_113xornet_kernelILb1EEEvPKjPjx' for 'sm_90a'\n"
           "ptxas info    : Function properties for "
           "_ZN12_GLOBAL__N_113xornet_kernelILb1EEEvPKjPjx\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 96 registers, used 0 barriers, 372 bytes "
           "cmem[0]\n")
    assert xornet_probe.ptxas_report(log) == [
        "xornet_kernel (16-byte form): 96 registers, 0 bytes spill stores, "
        "0 bytes spill loads"]


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
