"""The port's precision stage (``sweep_gf.prec_plain``, ``prec_product``)
against the JAX sweep's ``experiments/kernel_r4._kernel_prec``.

``_kernel_prec`` runs through ``pl.pallas_call`` in interpret mode as
``main_prec`` builds it, at lanes [8, 4096] with tile 1024.  On the CPU the
JAX product is exact at every precision (the CPU ignores ``precision``), so
the DEFAULT row is held against a model of one bf16 pass written here with
``jnp``: planes cast to bf16, float32 accumulation.  ``_wgmma_model`` is a
numpy model of the index maps of ``csrc/prec_tf32.cuh`` (the walk, the A
fragments built from words, B = Bp^T staged in wgmma's no-swizzle layout
and read through its descriptor, the accumulator layout and the epilogue's
reduce-scatter), held against ``prec_plain`` and ``_kernel_prec``.  All
comparisons are exact.  Inputs are seeded numpy bytes, uniform over 0..255.
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
from ceph_tpu_torch.ops import cuda_gf, sweep_gf
from ceph_tpu_torch.tools import ec_kernel_sweep, prec_probe
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
    # every precision's kernel stages Bp in shared memory and keeps its
    # accumulators in registers: k <= 16, m <= 8
    for prec, k, m in (("HIGH", 17, 1), ("DEFAULT", 4, 9), ("HIGHEST", 17, 1),
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


# -- a numpy model of csrc/prec_tf32.cuh's index maps --------------------------

def _rna(bits):
    """cvt.rna.tf32.f32 on float32 bits (uint32)."""
    return (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)


def _f32(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def _walk(n4, tile, groups, grid):
    """The kernel's walk: group -> [(first lane, stop)] of the 64-lane
    sub-tiles it takes, every block in turn (tiles b, b + grid, ...)."""
    ntiles = -(-n4 // tile)
    subs = {}
    for b in range(grid):
        for group in range(groups):
            for tile_i in range(b, ntiles, grid):
                stop = min((tile_i + 1) * tile, n4)
                sub = group
                while tile_i * tile + 64 * sub < stop:
                    subs.setdefault((b, group), []).append(
                        (tile_i * tile + 64 * sub, stop))
                    sub += groups
    return subs


def _stage_b(bp, k, m, nb):
    """``stage_b``: float (j, n, s) at j*8N + (n/8)*64 + (s/4)*32 + (n%8)*4
    + s%4, N = 32 nb, zero past 8m bit-rows."""
    N = 32 * nb
    sb = np.zeros(8 * k * N, np.float32)
    idx = np.arange(8 * k * N)
    j, rem = idx // (8 * N), idx % (8 * N)
    n, s = rem // 64 * 8 + rem // 4 % 8, rem // 32 % 2 * 4 + rem % 4
    live = n < 8 * m
    sb[live] = bp[n[live], s[live] * k + j[live]]
    return sb


def _b_tile(sb, desc_bytes):
    """B [32 bit-rows, 8 planes] as wgmma reads a no-swizzle K-major
    operand: 8-row groups SBO = 256 bytes apart, K halves LBO = 128."""
    n, kk = np.meshgrid(np.arange(32), np.arange(8), indexing="ij")
    off = desc_bytes + (n // 8) * 256 + (kk // 4) * 128 + (n % 8) * 16 \
        + (kk % 4) * 4
    return sb[off // 4]


def _wgmma_model(bp, x, k, m, precision, tile, grid=2):
    """What ``sweep_prec_tf32_kernel`` stores, thread by thread: A
    register r of thread (warp, g, t) is (lane 16 warp + g + 8 (r & 1),
    plane t + 4 (r >> 1)); accumulator 4i + 2h + c is (lane 16 warp + g +
    8h, bit-row 8i + 2t + c) of a 32-row half.  ``"HIGHEST"`` takes the
    plane values unrounded in one pass, ``"HIGH"`` big and small, and
    ``"DEFAULT"`` big alone."""
    bp = np.asarray(bp, np.float32)
    words = np.asarray(x).view(np.uint32)
    n4 = words.shape[1]
    nb = 1 if m <= 4 else 2
    groups = 3 if nb == 1 else 2
    sb = _stage_b(bp, k, m, nb)
    tid = np.arange(128)
    warp, g, t = tid // 32, tid % 32 // 4, tid % 4
    out = np.full((m, n4), -1, np.int64)
    covered = np.zeros(n4, np.int64)
    wide = 8 * k * 65537 >= 1 << 23
    for subs in _walk(n4, tile, groups, grid).values():
        for lane0, stop in subs:
            rows = lane0 + 16 * warp + g  # each thread's lanes g, g + 8
            acc = {half: np.zeros((nb, 128, 16)) for half in "LH"}
            for j in range(k):
                w = [np.where(r < stop, words[j, np.minimum(r, n4 - 1)], 0
                              ).astype(np.uint32) for r in (rows, rows + 8)]
                for half, base in (("L", 0), ("H", 8)):
                    a = np.zeros((4, 128), np.uint32)
                    for r in range(4):
                        v = w[r & 1] >> (t + 4 * (r >> 1)).astype(np.uint32)
                        a[r] = (((v >> base) & 0x10001) | 0x4B000000)
                    a = (_f32(a) - np.float32(8388608.0)).view(np.uint32)
                    if precision == "HIGHEST":
                        passes = [a]
                    else:
                        big = _rna(a)
                        small = (_f32(a) - _f32(big)).view(np.uint32)
                        passes = [big] if precision == "DEFAULT" \
                            else [big, small]
                    for p in passes:
                        A = np.zeros((64, 8))
                        for r in range(4):
                            A[16 * warp + g + 8 * (r & 1), t + 4 * (r >> 1)] \
                                = _f32(p[r])
                        for h in range(nb):
                            B = _b_tile(sb, 4 * (8 * 32 * nb * j + 256 * h))
                            D = A @ B.T.astype(np.float64)
                            for i in range(4):
                                for hr in range(2):
                                    for c in range(2):
                                        acc[half][h, :, 4 * i + 2 * hr + c] \
                                            += D[16 * warp + g + 8 * hr,
                                                 8 * i + 2 * t + c]
            # the epilogue: count bits, bit-rows 2t and 2t + 1, the quad's
            # reduce-scatter (xor 2, then xor 1), thread t stores row 4h + t
            for h in range(nb):
                for hr in range(2):
                    def bits(col):
                        cL, cH = (acc[s][h, :, col].astype(np.int64)
                                  for s in "LH")
                        assert (cL < 1 << 24).all() and (cH < 1 << 24).all()
                        if not wide:
                            assert (cL < 1 << 23).all()
                        return (cL & 0x10001) | (cH & 0x10001) << 8
                    v = [bits(4 * i + 2 * hr) << 2 * t
                         | bits(4 * i + 2 * hr + 1) << 2 * t + 1
                         for i in range(4)]
                    up, odd = (t & 2) > 0, (t & 1) > 0
                    k0 = np.where(up, v[2], v[0])
                    k1 = np.where(up, v[3], v[1])
                    k0 = k0 | np.where(up, v[0], v[2])[tid ^ 2]
                    k1 = k1 | np.where(up, v[1], v[3])[tid ^ 2]
                    word = np.where(odd, k1, k0)
                    word = word | np.where(odd, k0, k1)[tid ^ 1]
                    row, lane = 4 * h + t, rows + 8 * hr
                    mine = (row < m) & (lane < stop)
                    out[row[mine], lane[mine]] = word[mine]
                    if h == 0:
                        covered[lane[(lane < stop) & (t == 0)]] += 1
    assert (covered == 1).all(), "the walk takes each lane once"
    return out.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("k,m", [(1, 1), (8, 4), (8, 5), (16, 8), (16, 1),
                                 (1, 8)])
@pytest.mark.parametrize("prec", ["HIGHEST", "HIGH", "DEFAULT"])
def test_wgmma_model_matches_prec_plain_and_kernel_prec(k, m, prec):
    # a tile that is no multiple of the 64-lane sub-tile leaves a ragged
    # last one, and 250 lanes a ragged last tile
    n4, tile = 250, 96
    bits = np.random.RandomState(k * 10 + m).randint(0, 2, (8 * m, 8 * k))
    d32 = _data(k * m, k, n4)
    if k == 16:
        # counts past 2^23: all-ones rows of Bp over high halves of ones
        bits[::3] = 1
        d32[:, :100] = (d32[:, :100] & 0xFFFF) | -65536
    bp = sweep_gf.prep_shift_major_w8(bits, k)
    ours = _wgmma_model(bp, d32, k, m, prec, tile)
    plain = sweep_gf.prec_plain(torch.from_numpy(bp), torch.from_numpy(d32),
                                k, m, prec).numpy()
    assert np.array_equal(ours, plain)
    if prec == "DEFAULT":
        assert np.array_equal(ours, _one_bf16_pass(bp, d32, m))
    else:
        theirs = _kernel_prec(bp, d32, getattr(jax.lax.Precision, prec), k,
                              m, 128)
        assert np.array_equal(ours, theirs)


def test_wgmma_model_sees_a_swapped_descriptor():
    # the model is sharp: B read with LBO and SBO swapped is wrong
    bits, d32 = _bits(), _data(13, K, 128)
    bp = sweep_gf.prep_shift_major_w8(bits, K)
    good = _wgmma_model(bp, d32, K, M, "HIGH", 128)
    real = globals()["_b_tile"]

    def swapped(sb, desc_bytes):
        n, kk = np.meshgrid(np.arange(32), np.arange(8), indexing="ij")
        off = desc_bytes + (n // 8) * 128 + (kk // 4) * 256 + (n % 8) * 16 \
            + (kk % 4) * 4
        return sb[off // 4]
    try:
        globals()["_b_tile"] = swapped
        bad = _wgmma_model(bp, d32, K, M, "HIGH", 128)
    finally:
        globals()["_b_tile"] = real
    assert not np.array_equal(good, bad)


@pytest.mark.parametrize("prec", ["HIGHEST", "HIGH", "DEFAULT"])
def test_prec_product_takes_k_16_and_m_8_at_every_precision(prec):
    for k, m in ((16, 8), (16, 1), (1, 8), (9, 5)):
        bits = np.random.RandomState(k + m).randint(0, 2, (8 * m, 8 * k))
        bp = torch.from_numpy(sweep_gf.prep_shift_major_w8(bits, k))
        x = torch.from_numpy(_data(k, k, 97))
        got = sweep_gf.prec_product(bp, x, k, m, prec, 96)
        assert torch.equal(got, sweep_gf.prec_plain(bp, x, k, m, prec))
    for k, m in ((17, 1), (4, 9), (0, 4), (4, 0)):
        with pytest.raises(ValueError, match="the kernel takes"):
            sweep_gf.prec_product(torch.zeros((8 * m, 8 * k)),
                                  torch.zeros((k, 8), dtype=torch.int32), k,
                                  m, prec)


def test_split_parts_1_and_highest_name_one_kernel_source():
    # split_product(parts=1) is prec_product, whose HIGHEST kernel is the
    # split's: one header, which the entry point sweep_prec_f32 launches
    # at parts 1; HIGH and DEFAULT share the wgmma header
    src = sweep_gf.KERNEL_SOURCES
    assert src[sweep_gf.PREC_KERNELS["HIGHEST"]] == src["sweep_split_f32"] \
        == "split_f32.cuh"
    assert src["sweep_prec_tf32x3"] == src["sweep_prec_tf32"] \
        == "prec_tf32.cuh"
    text = (cuda_gf.CSRC / sweep_gf.SOURCE).read_text()
    entry = text[text.index("int sweep_prec_f32("):]
    entry = entry[:entry.index("\n}\n")]
    assert "run_split_f32(x, bp, out, k, m, n4, T, 1," in entry
    assert "sweep_prec_f32_kernel" not in text
    for name in set(src.values()) - {sweep_gf.XORNET_SOURCE}:
        assert name in cuda_gf._local_headers(text)
    bp = torch.from_numpy(sweep_gf.prep_shift_major_w8(_bits(4, 2), 4))
    x = torch.from_numpy(_data(5, 4, 256))
    assert torch.equal(
        sweep_gf.split_product(bp, x, 4, 2, "HIGHEST", 1, 256),
        sweep_gf.prec_product(bp, x, 4, 2, "HIGHEST", 256))


def test_prec_probe_edits_find_their_statements():
    # every row of the probe tool is the shipped header with statements
    # replaced (each found there once), in a frame that launches the HIGH
    # kernel at k <= 8, m <= 4
    shipped = (cuda_gf.CSRC / prec_probe.HEADER).read_text()
    builds = prec_probe.prec_builds()
    assert set(builds) == {"products alone",
                           "products alone, two steps in flight",
                           "extraction alone", "AND, OR fields",
                           "one pass", "2 warpgroups", "3 warpgroups"}
    for name, header in builds.items():
        assert header != shipped, name
    assert "plane_float" not in builds["products alone"].split(
        "void build_a")[1].split("}\n}")[0]
    assert "field_float(v & 0x00010001u)" in builds["AND, OR fields"]
    assert "if (0)\n  asm volatile" in builds["extraction alone"]
    assert "p < 1; ++p" in builds["one pass"]
    assert "wgmma_wait<1>" in builds["products alone, two steps in flight"]
    frame = prec_probe.frame()
    assert f'#include "{prec_probe.HEADER}"' in frame
    assert "launch_prec_tf32<1, PrecTf32x3, 4>" in frame
    assert f'extern "C" int {prec_probe.ENTRY}(' in frame
    # the shipped header is hashed into sweep_kernels.cu's digest
    assert prec_probe.HEADER in cuda_gf._local_headers(
        (cuda_gf.CSRC / sweep_gf.SOURCE).read_text())
