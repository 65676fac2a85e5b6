"""The single-bit-plane products' wgmma kernel (``csrc/dot_wgmma.cuh``:
``sweep_int8_4dot``, ``sweep_bf16_4dot``, ``sweep_f32_4dot`` and
``sweep_bf16_blockdiag``) as a numpy model of its index maps, against the
port's plain versions and the JAX sweep's ``experiments/kernel_r4.py``
kernels.

``dot_model`` follows the kernel thread by thread: the walk of 64-lane
sub-tiles, A built in registers from the words (the K order that puts a
thread's fragment in one input row, each register a shift, a mask and a
spread of P plane bits, decoded as TF32, bf16 or int8), B staged as raw
bits in wgmma's no-swizzle K-major layout and read through its
descriptor (LBO 128 bytes, SBO 256), the accumulator layout, and the
epilogue's parity bits and reduce-scatter over the quad.  The Pallas
kernels run in interpret mode on the CPU (``kernel_r4.build_variants`` at
its k=8 m=4; ``kernel_r4._call_variant`` with the same kernel functions at
other shapes where m <= k, and the production ``_matrix_kernel`` where m >
k, since kernel_r4's kernels start their output from the input's first m
rows).  All comparisons are exact.  Inputs are seeded numpy bytes,
uniform over 0..255.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ceph_tpu.ops import pallas_gf
from ceph_tpu_torch.matrices import bitmatrix, reed_sol
from ceph_tpu_torch.ops import cuda_gf, sweep_gf
from ceph_tpu_torch.tools import dot_probe
from experiments import kernel_r4

#: row -> (the JAX sweep's row, the model's operand type, whether its
#: table is the block-diagonal one)
ROWS = {"sweep_int8_4dot": ("int8_4dot", "int8", False),
        "sweep_bf16_4dot": ("bf16_4dot", "bf16", False),
        "sweep_f32_4dot": ("f32_4dot", "tf32", False),
        "sweep_bf16_blockdiag": ("bf16_blockdiag", "bf16", True)}
#: operand type -> (input rows a K-step, P; the dtype of its torch table)
TYPES = {"tf32": (1, torch.float32), "bf16": (2, torch.bfloat16),
         "int8": (4, torch.int8)}
SMEM_LIMIT = cuda_gf.SMEM_LIMIT


def _bits(k, m):
    return bitmatrix.matrix_to_bitmatrix(
        reed_sol.vandermonde_coding_matrix(k, m, 8), 8)


def _data(seed, k, n4):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, (k, n4 * 4), dtype=np.uint8).view(np.int32)


def _table(row, bits, k, m):
    """The row's table as its wrapper takes it, on the CPU."""
    _, kind, blk = ROWS[row]
    prep = (sweep_gf.prep_blockdiag_w8(bits, k, m) if blk
            else sweep_gf.prep_shift_major_w8(bits, k))
    return torch.from_numpy(prep).to(TYPES[kind][1])


def _raw(table):
    """A torch table's elements as raw bits (numpy unsigned)."""
    kind = {torch.float32: np.uint32, torch.bfloat16: np.uint16,
            torch.int8: np.uint8}[table.dtype]
    view = {np.uint32: torch.int32, np.uint16: torch.int16,
            np.uint8: torch.uint8}[kind]
    return table.view(view).numpy().view(kind)


# -- the model ----------------------------------------------------------------


def k_order(P):
    """K-index kk of a K-step -> (input row jj of its P rows, plane s):
    thread t of a quad holds, in its two registers of a lane, K-indices 4P
    (r >> 1) + P t + e, which are planes P (t % (4/P)) + e + 4 (r >> 1) of
    row floor(t P / 4)."""
    C = 4 * P
    out = []
    for kk in range(8 * P):
        t = kk % C // P
        out.append((t * P // 4, P * (t % (4 // P)) + kk % P + 4 * (kk // C)))
    return out


def frag(kind, v):
    """One A register from plane bits (bits 0.. of v): P elements, 0 or 1
    in the operand type (element e from bit e)."""
    v = v.astype(np.uint64)
    if kind == "tf32":
        r = (v & 1) * 0x3F800000
    elif kind == "bf16":
        r = ((v & 1) | ((v << 15) & 0x10000)) * 0x3F80
    else:
        r = ((v & 0xF) * 0x00204081) & 0x01010101
    return (r & 0xFFFFFFFF).astype(np.uint32)


def decode(kind, reg, e):
    """Element e of A registers ``reg`` (uint32) as a number."""
    if kind == "tf32":
        return (reg & np.uint32(0xFFFFE000)).view(np.float32).astype(float)
    if kind == "bf16":
        half = (reg >> np.uint32(16 * e)) & np.uint32(0xFFFF)
        return (half << np.uint32(16)).view(np.float32).astype(float)
    return ((reg >> np.uint32(8 * e)) & np.uint32(0xFF)).astype(
        np.uint8).view(np.int8).astype(float)


def decode_table(kind, raw):
    if kind == "tf32":
        return (raw & np.uint32(0xFFFFE000)).view(np.float32).astype(float)
    if kind == "bf16":
        return (raw.astype(np.uint32) << np.uint32(16)).view(
            np.float32).astype(float)
    return raw.view(np.int8).astype(float)


def stage_b(raw, k, m, P, N, blk, order=k_order):
    """``dot_stage_b``: the table's raw bits in wgmma's no-swizzle K-major
    layout, one K-step (N rows x 32 bytes) a row group q, and for the
    block-diagonal table a byte position b too (K-step 4q + b); bytes of
    element (n, kk) at (n/8)*256 + (kk/C)*128 + (n%8)*16 + (kk%C)*eb."""
    eb, K, C = 4 // P, 8 * P, 4 * P
    Q = -(-k // P)
    steps = 4 * Q if blk else Q
    rows, depth = (32 * m, 32 * k) if blk else (8 * m, 8 * k)
    sb = np.zeros(steps * N * K, raw.dtype)
    for st in range(steps):
        q, b = (st // 4, st % 4) if blk else (st, 0)
        for kk, (jj, s) in enumerate(order(P)):
            j = P * q + jj
            if j >= k:
                continue
            n = np.arange(min(N, rows))
            off = (n // 8) * 8 * K + kk // C * 8 * C + (n % 8) * C + kk % C
            sb[st * N * K + off] = raw[n, b * 8 * k + s * k + j]
    return sb


def b_tile(sb, start_bytes, N, K, eb, lbo=128, sbo=256):
    """B [N, K] raw bits as wgmma reads a no-swizzle K-major operand."""
    n, kk = np.meshgrid(np.arange(N), np.arange(K), indexing="ij")
    addr = start_bytes + (n // 8) * sbo + (kk * eb // 16) * lbo + \
        (n % 8) * 16 + (kk * eb) % 16
    return sb[addr // eb]


def groups_for(k, N, P, blk):
    """``dot_fit_groups``: 4 warpgroups while a thread's accumulators take
    at most 64 registers, else 2; fewer while the block's shared memory
    does not fit."""
    nacc = N // 2 if blk else 2 * N
    steps = (4 if blk else 1) * -(-k // P)
    for groups in range(4 if nacc <= 64 else 2, 0, -1):
        if steps * 32 * N + groups * sweep_gf.WGMMA_RING * k * 64 * 4 \
                <= SMEM_LIMIT:
            return groups
    return 0


def walk(n4, groups, grid):
    """The kernel's walk, T = 64 * groups lanes a tile: group -> [(first
    lane, stop)] of the 64-lane sub-tiles it takes, every block in turn
    (tiles b, b + grid, ...)."""
    T = 64 * groups
    ntiles = -(-n4 // T)
    subs = []
    for b in range(grid):
        for group in range(groups):
            for tile in range(b, ntiles, grid):
                stop = min((tile + 1) * T, n4)
                if tile * T + 64 * group < stop:
                    subs.append((tile * T + 64 * group, stop))
    return subs


def parity(kind, acc):
    """``dot_parity``: bit 0 of the int32 sum, or of the float sum's
    mantissa after adding 2^23."""
    if kind == "int8":
        return acc.astype(np.int64) & 1
    assert (acc < 1 << 23).all()
    f = acc.astype(np.float32) + np.float32(8388608.0)
    return (f.view(np.uint32) & 1).astype(np.int64)


def dot_model(row, table, x, k, m, grid=2, order=k_order, lbo=128, sbo=256):
    """What the kernel stores for ``row``, thread by thread: A register r
    of thread (warp, g, t) holds lane 16 warp + g + 8 (r & 1) and
    K-indices 4P (r >> 1) + P t + e; accumulator 4i + 2hr + c is lane 16
    warp + g + 8hr, column 8i + 2t + c."""
    _, kind, blk = ROWS[row]
    P = TYPES[kind][0]
    eb, K = 4 // P, 8 * P
    N = 32 * m if blk else (32 if m <= 4 else 64)
    MB = N // 32 if blk else N // 8
    raw = _raw(table)
    sb = stage_b(raw, k, m, P, N, blk, order)
    words = np.asarray(x).view(np.uint32)
    n4 = words.shape[1]
    Q = -(-k // P)
    tid = np.arange(128)
    warp, g, t = tid // 32, tid % 32 // 4, tid % 4
    jj, shift = t * P // 4, P * (t % (4 // P))
    out = np.full((m, n4), -1, np.int64)
    covered = np.zeros(n4, np.int64)
    groups = groups_for(k, N, P, blk)
    assert groups > 0
    for lane0, stop in walk(n4, groups, grid):
        lanes = lane0 + 16 * warp + g
        acc = np.zeros((128, 16 * MB))
        for q in range(Q):
            j = np.minimum(P * q + jj, k - 1)  # rows past k meet zero rows
            w = [np.where(ln < stop, words[j, np.minimum(ln, n4 - 1)], 0
                          ).astype(np.uint32) >> shift.astype(np.uint32)
                 for ln in (lanes, lanes + 8)]
            for b in range(4):
                A = np.zeros((64, K))
                for r in range(4):
                    shift_b = np.uint32(8 * b + 4 * (r >> 1))
                    reg = frag(kind, w[r & 1] >> shift_b)
                    for e in range(P):
                        A[16 * warp + g + 8 * (r & 1),
                          K // 2 * (r >> 1) + P * t + e] = decode(kind, reg, e)
                st = 4 * q + b if blk else q
                B = decode_table(kind, b_tile(sb, st * 32 * N, N, K, eb, lbo,
                                              sbo))
                D = A @ B.T
                base = 0 if blk else b * N // 2
                for i in range(N // 8):
                    for hr in range(2):
                        for c in range(2):
                            acc[:, base + 4 * i + 2 * hr + c] += D[
                                16 * warp + g + 8 * hr, 8 * i + 2 * t + c]
        # the epilogue: 8 bits a byte, bits 2t + c of each byte of row 4h
        # + i; the quad's reduce-scatter; thread t stores row 4h + t
        for h in range(-(-MB // 4)):
            for hr in range(2):
                v = []
                for i in range(4):
                    vi = np.zeros(128, np.int64)
                    if 4 * h + i < MB:
                        for b in range(4):
                            for c in range(2):
                                col = 4 * (b * MB + 4 * h + i) + 2 * hr + c
                                vi |= parity(kind, acc[:, col]) << 8 * b + c
                    v.append(vi << 2 * t)
                up, odd = (t & 2) > 0, (t & 1) > 0
                k0 = np.where(up, v[2], v[0]) | \
                    np.where(up, v[0], v[2])[tid ^ 2]
                k1 = np.where(up, v[3], v[1]) | \
                    np.where(up, v[1], v[3])[tid ^ 2]
                word = np.where(odd, k1, k0) | np.where(odd, k0, k1)[tid ^ 1]
                row_i, lane = 4 * h + t, lanes + 8 * hr
                mine = (row_i < m) & (lane < stop)
                out[row_i[mine], lane[mine]] = word[mine]
                if h == 0:
                    covered[lane[(lane < stop) & (t == 0)]] += 1
    assert (covered == 1).all(), "the walk takes each lane once"
    return out.astype(np.uint32).view(np.int32)


# -- the model against the plain versions and the Pallas kernels -------------


def _pallas(row, table, d32, k, m, tile):
    """The JAX sweep's kernel for ``row`` through ``_call_variant``, in
    interpret mode."""
    name, kind, blk = ROWS[row]
    fn = {"int8_4dot": functools.partial(kernel_r4._kernel_int8_4dot, k=k,
                                         m=m),
          "bf16_4dot": functools.partial(kernel_r4._kernel_bf16_4dot, k=k,
                                         m=m, dtype=jnp.bfloat16),
          "f32_4dot": functools.partial(kernel_r4._kernel_bf16_4dot, k=k,
                                        m=m, dtype=jnp.float32),
          "bf16_blockdiag": functools.partial(
              kernel_r4._kernel_bf16_blockdiag, k=k, m=m)}[name]
    extra = jnp.asarray(table.to(torch.float32).numpy())
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(kernel_r4._call_variant(fn, k, m, jnp.asarray(d32),
                                                  tile, extra=extra))


def _production(bits, d32, k, m, tile):
    """The JAX package's production w=8 kernel (``_matrix_kernel``)."""
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pallas_gf._matrix_encode_call(
            jnp.asarray(pallas_gf.prep_matrix_w8(bits, k)), jnp.asarray(d32),
            k, m, tile))


def _shapes():
    """(row, k, m, n4): the sweep's code, k = 1, k = 16 m = 8, m = 1, 3,
    5 and 7, n4 = 1 and 1003 (the block-diagonal row at m <= 4)."""
    cases = [(8, 4, 1003), (1, 4, 130), (16, 8, 97), (8, 1, 1), (5, 3, 1003),
             (7, 5, 131), (3, 7, 64), (16, 4, 65), (2, 2, 200)]
    return [(row, k, m, n4) for row in ROWS for k, m, n4 in cases
            if not (ROWS[row][2] and m > sweep_gf.BLOCKDIAG_MAX_M)]


@pytest.mark.parametrize("row,k,m,n4", _shapes())
def test_dot_model_matches_plain_and_kernel_r4(row, k, m, n4):
    rs = np.random.RandomState(k * 100 + m * 10 + n4)
    bits = rs.randint(0, 2, (8 * m, 8 * k)).astype(np.uint8)
    bits[::4] = 1  # all-ones rows: the largest sums, over all-ones words
    d32 = _data(k * n4 + m, k, n4)
    d32[:, :min(n4, 40)] = -1
    table = _table(row, bits, k, m)
    ours = dot_model(row, table, d32, k, m)
    x = torch.from_numpy(d32)
    wrapper = getattr(sweep_gf, ROWS[row][0])
    plain = getattr(sweep_gf, ROWS[row][0] + "_plain")
    assert np.array_equal(ours, plain(table, x, k, m).numpy())
    assert np.array_equal(ours, wrapper(table, x, k, m).numpy())
    tile = 128 if n4 >= 128 else n4
    # kernel_r4's kernels start their output from the input's first m
    # rows, so they take m <= k; past that the production kernel is the
    # oracle, as in the JAX sweep's gate
    theirs = (_pallas(row, table, d32, k, m, tile) if m <= k
              else _production(bits, d32, k, m, tile))
    assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("row", list(ROWS))
def test_dot_model_matches_build_variants(row):
    # kernel_r4's own k=8 m=4 sweep, as its main runs it
    bits, d32 = _bits(8, 4), _data(3, 8, 2048)
    with pltpu.force_tpu_interpret_mode():
        theirs = np.asarray(kernel_r4.build_variants(bits, 1024)[
            ROWS[row][0]](jnp.asarray(d32)))
    table = _table(row, bits, 8, 4)
    assert np.array_equal(dot_model(row, table, d32, 8, 4, grid=3), theirs)


def test_dot_model_sees_a_swapped_descriptor_or_k_order():
    # the model is sharp: B read with LBO and SBO swapped, or staged in
    # another K order than A's, gives another answer
    bits, d32 = _bits(8, 4), _data(5, 8, 128)
    for row in ROWS:
        table = _table(row, bits, 8, 4)
        good = dot_model(row, table, d32, 8, 4)
        swapped = dot_model(row, table, d32, 8, 4, lbo=256, sbo=128)

        def natural(P):  # K-index kk = 8 jj + s: the planes in row order
            return [(kk // 8, kk % 8) for kk in range(8 * P)]
        reordered = dot_model(row, table, d32, 8, 4, order=natural)
        assert not np.array_equal(good, swapped), row
        if ROWS[row][1] != "tf32":  # one row a K-step: both orders agree
            assert not np.array_equal(good, reordered), row


@pytest.mark.parametrize("P", [1, 2, 4])
def test_k_order_covers_each_plane_of_each_row_once(P):
    order = k_order(P)
    assert sorted(order) == [(jj, s) for jj in range(P) for s in range(8)]
    # thread t's 2P K-indices (two registers of P elements) lie in one row
    for t in range(4):
        idx = [4 * P * h + P * t + e for h in range(2) for e in range(P)]
        assert len({order[i][0] for i in idx}) == 1


# -- the wrappers' limits and the kernel's shared memory ----------------------


@pytest.mark.parametrize("row", ["sweep_int8_4dot", "sweep_bf16_4dot",
                                 "sweep_f32_4dot"])
def test_4dot_wrappers_take_k_16_m_8_and_refuse_k_17_and_m_9(row):
    wrapper = getattr(sweep_gf, ROWS[row][0])
    dtype, max_k, max_m = sweep_gf.DOT_KERNELS[row]
    assert (max_k, max_m) == (16, 8)
    bits = np.random.RandomState(1).randint(0, 2, (64, 128)).astype(np.uint8)
    table = _table(row, bits, 16, 8)
    x = torch.from_numpy(_data(2, 16, 70))
    assert torch.equal(wrapper(table, x, 16, 8),
                       sweep_gf.int8_4dot_plain(table, x, 16, 8))
    for k, m in ((17, 1), (4, 9), (0, 4), (4, 0)):
        with pytest.raises(ValueError, match="the kernel takes"):
            wrapper(torch.zeros((8 * m, 8 * k), dtype=dtype),
                    torch.zeros((k, 8), dtype=torch.int32), k, m)


def test_blockdiag_shared_memory_sets_its_widest_k():
    # 4 ceil(k/2) K-steps of 32m rows x 32 bytes, and a ring of 4 sub-tiles
    # of [k][64] words a warpgroup
    assert sweep_gf.blockdiag_smem_bytes(8, 4) == 65536 + 8192
    assert sweep_gf.blockdiag_smem_bytes(8, 4, 4) == 65536 + 4 * 8192
    widest = {m: max(k for k in range(1, 100)
                     if sweep_gf.blockdiag_smem_bytes(k, m) <= SMEM_LIMIT)
              for m in range(1, 5)}
    assert widest == {1: 75, 2: 44, 3: 32, 4: 24}
    # at the sweep's shape the kernel takes 4 warpgroups a block; at the
    # widest k one
    assert groups_for(8, 128, 2, True) == 4
    assert groups_for(24, 128, 2, True) == 1
    assert groups_for(16, 64, 1, False) == 2 and groups_for(8, 32, 4,
                                                            False) == 4


def test_four_rows_name_one_kernel_source():
    text = (cuda_gf.CSRC / sweep_gf.SOURCE).read_text()
    for row in ROWS:
        assert sweep_gf.KERNEL_SOURCES[row] == "dot_wgmma.cuh"
    assert "dot_wgmma.cuh" in cuda_gf._local_headers(text)
    assert "wgmma_walk.cuh" in cuda_gf._local_headers(text)
    for gone in ("sweep_4dot_kernel", "sweep_blockdiag_kernel", "ldmatrix",
                 "load_a_frags", "blockdiag_pitch"):
        assert gone not in text, gone


def test_dot_probe_edits_find_their_statements():
    # every row of the probe tool is the shipped header with statements
    # replaced (each found there once), in a frame with the four entry
    # points
    shipped = (cuda_gf.CSRC / dot_probe.HEADER).read_text()
    builds = dot_probe.dot_builds()
    assert set(builds) == {"products alone", "extraction alone",
                           "copies and epilogue alone", "2 warpgroups",
                           "3 warpgroups"}
    for name, header in builds.items():
        assert header != shipped, name
    assert "Op::frag(1u)" in builds["products alone"]
    assert "dot_mix(d, a)" in builds["extraction alone"]
    both = builds["copies and epilogue alone"]
    assert "Op::frag(1u)" in both and "dot_mix(d, a)" in both
    assert "return 2;" in builds["2 warpgroups"]
    frame = dot_probe.frame()
    assert f'#include "{dot_probe.HEADER}"' in frame
    for entry in ROWS:
        assert f'extern "C" int {entry}(' in frame
    assert dot_probe.HEADER in cuda_gf._local_headers(
        (cuda_gf.CSRC / sweep_gf.SOURCE).read_text())
