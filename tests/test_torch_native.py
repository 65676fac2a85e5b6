"""The port's native host engine against the JAX package's numpy engine.

``ceph_tpu_torch/native/gf_kernels.cpp`` (built by ``native/build.py`` with
the host ``g++``), its ctypes bindings (``native/gf_native.py``), the CPython
extension (``native/py_binding.py``) and ``ops/native_engine.py`` behind
``backend=native``.  Twin of ``tests/test_native.py`` and of the extension
half of ``tests/test_pyext_tools.py``: every region product, matrix and
packet encode and decode is compared with the JAX package's ``gf`` and
``cpu_engine`` on the same bytes, made with numpy from a seed; the tolerance
is zero.  The jerasure plugin's ``backend=native`` is held against the JAX
package's host encode and decode (isa and shec: ``backend=native`` cases of
``tests/test_torch_plugins_extra.py``).
"""

import errno
import itertools

import numpy as np
import pytest

from ceph_tpu.matrices import cauchy as j_cauchy
from ceph_tpu.matrices import liberation as j_liberation
from ceph_tpu.matrices import reed_sol as j_reed_sol
from ceph_tpu.matrices.bitmatrix import matrix_to_bitmatrix as j_to_bits
from ceph_tpu.ops import cpu_engine as j_cpu_engine
from ceph_tpu.ops.gf import gf as j_gf
from ceph_tpu.plugins import registry as j_registry
from ceph_tpu_torch.native import build, gf_native, py_binding
from ceph_tpu_torch.ops import native_engine
from ceph_tpu_torch.plugins import registry
from ceph_tpu_torch.plugins.interface import ErasureCodeError


def _bytes(rng, *shape):
    return rng.randint(0, 256, size=shape).astype(np.uint8)


# -- the region kernels -------------------------------------------------------


@pytest.mark.parametrize("n", [1, 31, 32, 1000, 4096 + 17])
def test_mul_region_matches_jax_gf(n):
    F = j_gf(8)
    rng = np.random.RandomState(n)
    region = _bytes(rng, n)
    acc = _bytes(rng, n)
    for c in (0, 1, 2, 0x1D, 0x8E, 255):
        want = F.mul_region(c, region)
        assert np.array_equal(gf_native.mul_region(c, region), want)
        got = gf_native.mul_region(c, region, acc.copy())
        assert np.array_equal(got, acc ^ want)


@pytest.mark.parametrize("k,n", [(1, 5), (2, 64), (5, 1000)])
def test_region_xor(k, n):
    rng = np.random.RandomState(k * n)
    srcs = [_bytes(rng, n) for _ in range(k)]
    assert np.array_equal(gf_native.region_xor(srcs),
                          np.bitwise_xor.reduce(srcs))


@pytest.mark.parametrize("k,m", [(2, 1), (4, 2), (8, 4), (12, 4)])
def test_matrix_encode_matches_jax(k, m):
    rng = np.random.RandomState(k + m)
    M = j_reed_sol.vandermonde_coding_matrix(k, m, 8)
    data = _bytes(rng, k, 4096 + 32 + 3)
    assert np.array_equal(gf_native.matrix_encode(M, data),
                          j_cpu_engine.matrix_encode(M, data, 8))
    zero = M.copy()
    zero[0] = 0  # a coding row of zeros
    assert np.array_equal(gf_native.matrix_encode(zero, data),
                          j_cpu_engine.matrix_encode(zero, data, 8))
    with pytest.raises(NotImplementedError):
        gf_native.matrix_encode(M, data, w=16)


@pytest.mark.parametrize("code", ["cauchy_good", "liberation"])
def test_bitmatrix_packet_encode_matches_xor_of_rows(code):
    if code == "cauchy_good":
        B = j_to_bits(j_cauchy.good_general_coding_matrix(4, 2, 8), 8)
    else:
        B = j_liberation.liberation_coding_bitmatrix(5, 7)
    rng = np.random.RandomState(2)
    rows = _bytes(rng, B.shape[1], 999)
    got = gf_native.bitmatrix_packet_encode(B, rows)
    want = np.zeros((B.shape[0], 999), np.uint8)
    for r in range(B.shape[0]):
        for c in np.nonzero(B[r])[0]:
            want[r] ^= rows[c]
    assert np.array_equal(got, want)


def test_crc32c_vectors():
    # crc32c("123456789") with init -1 and no final xor is ~0xE3069283
    assert gf_native.crc32c(b"123456789") == 0x1CF96D7C
    assert gf_native.crc32c(b"") == 0xFFFFFFFF
    a = gf_native.crc32c(b"hello ")
    assert gf_native.crc32c(b"world", crc=a) == \
        gf_native.crc32c(b"hello world")
    # the kernels library's own crc (the extension's) is the same function
    ext = py_binding.load()
    data = np.random.RandomState(9).bytes(10007)
    assert ext.crc32c(data) == gf_native.crc32c(data) == \
        gf_native.crc32c_plain(data)


def test_arch_probe_and_gate():
    feats = gf_native.cpu_features()
    assert set(feats["build"]) <= set(feats["cpu"])
    lib = gf_native.kernels()
    assert lib.ec_arch_built() & ~lib.ec_arch_probe() == 0
    # a library built for features the CPU lacks is refused, never run
    gf_native.arch_gate(0b0111, 0b1111)
    with pytest.raises(OSError, match="built for another CPU"):
        gf_native.arch_gate(0b1111, 0b0111)


def test_c_extension_parity():
    ext = py_binding.load()
    assert str(build.native_dir()) in ext.__file__
    rng = np.random.RandomState(3)
    data = _bytes(rng, 8192)
    for c in (0, 1, 2, 7, 143, 255):
        assert ext.gf8_mul_region(c, bytes(data)) == \
            bytes(gf_native.mul_region(c, data))
    a, b, cc = data[:1024], data[1024:2048], data[2048:3072]
    assert ext.region_xor([bytes(a), bytes(b), bytes(cc)]) == \
        bytes(a ^ b ^ cc)
    base = ext.gf8_mul_region(7, bytes(a))
    acc = ext.gf8_mul_region(3, bytes(b), base)
    assert acc == bytes(np.frombuffer(base, np.uint8) ^ np.frombuffer(
        ext.gf8_mul_region(3, bytes(b)), np.uint8))
    with pytest.raises(ValueError):
        ext.gf8_mul_region(1, b"abc", b"length-mismatch")
    with pytest.raises(ValueError):
        ext.region_xor([b"aa", b"bbb"])
    assert ext.arch_probe() == gf_native.kernels().ec_arch_probe()


# -- the build ----------------------------------------------------------------


def test_build_is_keyed_by_sources_flags_compiler_and_cpu(monkeypatch):
    out = build.native_dir()
    assert out.parent == build.BUILD_DIR and out.name.startswith("ec_native-")
    assert {p.name for p in out.glob("libec_*.so")} == {
        "libec_kernels.so", "libec_registry.so", "libec_xor_native.so",
        "libec_regen_native.so",
        *(f"libec_{name}.so" for name in build.FIXTURES)}
    cxx = build.compiler()
    key = build.digest(cxx)
    assert out.name == f"ec_native-{key}"
    assert build.digest("/other/g++") != key
    monkeypatch.setattr(build, "host_cpu", lambda: "x86_64 | other | sse2")
    assert build.digest(cxx) != key


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        build.compiler()
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        build.native_dir()
    assert not (tmp_path / "build").exists()


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "CXXFLAGS",
                        build.CXXFLAGS + ("-fno-such-flag",))
    with pytest.raises(RuntimeError, match="failed"):
        build.native_dir()
    assert list((tmp_path / "build").iterdir()) == []


# -- native_engine -----------------------------------------------------------


@pytest.mark.parametrize("w", [8, 16])
@pytest.mark.parametrize("k,m", [(4, 2), (6, 3)])
def test_native_engine_matrix_code_matches_jax(k, m, w):
    M = j_reed_sol.vandermonde_coding_matrix(k, m, w)
    rng = np.random.RandomState(k * m + w)
    size = 256 * w
    data = _bytes(rng, k, size)
    coding = native_engine.matrix_encode(M, data, w)
    assert np.array_equal(coding, j_cpu_engine.matrix_encode(M, data, w))
    chunks = dict(enumerate(np.concatenate([data, coding])))
    for erased in itertools.combinations(range(k + m), 2):
        have = {i: c for i, c in chunks.items() if i not in erased}
        got = native_engine.matrix_decode(M, have, k, m, w, size)
        want = j_cpu_engine.matrix_decode(M, have, k, m, w, size)
        for e in erased:
            assert np.array_equal(got[e], want[e]) and \
                np.array_equal(got[e], chunks[e]), (erased, e)


@pytest.mark.parametrize("k,m,packetsize", [(4, 2, 8), (5, 3, 64)])
def test_native_engine_packet_code_matches_jax(k, m, packetsize):
    w = 8
    B = j_to_bits(j_cauchy.good_general_coding_matrix(k, m, w), w)
    rng = np.random.RandomState(packetsize)
    size = w * packetsize * 3
    data = _bytes(rng, k, size)
    coding = native_engine.bitmatrix_encode(B, data, w, packetsize)
    assert np.array_equal(
        coding, j_cpu_engine.bitmatrix_encode(B, data, w, packetsize))
    chunks = dict(enumerate(np.concatenate([data, coding])))
    for erased in itertools.combinations(range(k + m), 2):
        have = {i: c for i, c in chunks.items() if i not in erased}
        got = native_engine.bitmatrix_decode(B, have, k, m, w, size,
                                             packetsize)
        for e in erased:
            assert np.array_equal(got[e], chunks[e]), (erased, e)
    with pytest.raises(ValueError):
        native_engine.bitmatrix_decode(
            B, {i: chunks[i] for i in range(k - 1)}, k, m, w, size,
            packetsize)


# -- the jerasure plugin's backend=native -------------------------------------

JERASURE = [
    {"technique": "reed_sol_van"},
    {"technique": "reed_sol_van", "w": "16"},
    {"technique": "reed_sol_r6_op"},
    {"technique": "cauchy_good", "packetsize": "8"},
    {"technique": "cauchy_orig", "packetsize": "16"},
    {"technique": "liberation", "w": "7", "packetsize": "8"},
]


@pytest.mark.parametrize("profile", JERASURE,
                         ids=lambda p: "-".join(p.values()))
def test_jerasure_native_backend_matches_jax(profile):
    prof = dict(profile, k="4", m="2")
    mine = registry.ErasureCodePluginRegistry().factory(
        "jerasure", dict(prof, backend="native"))
    theirs = j_registry.ErasureCodePluginRegistry().factory(
        "jerasure", dict(prof))
    assert mine._engine() is native_engine
    rng = np.random.RandomState(len(prof))
    payload = _bytes(rng, theirs.get_chunk_size(1) * 4 * 2 + 9).tobytes()
    km = theirs.get_chunk_count()
    chunks = mine.encode(set(range(km)), payload)
    want = theirs.encode(set(range(km)), payload)
    for i in range(km):
        assert np.array_equal(chunks[i], want[i]), i
    for erased in itertools.combinations(range(km), 2):
        have = {i: c for i, c in chunks.items() if i not in erased}
        got = mine.decode(set(erased), dict(have))
        ref = theirs.decode(set(erased), dict(have))
        for e in erased:
            assert np.array_equal(got[e], ref[e]), (erased, e)


# -- backend=tpu and the other keys -------------------------------------------


@pytest.mark.parametrize("name", ["jerasure", "isa", "shec"])
def test_backend_tpu_is_refused_naming_cuda(name):
    with pytest.raises(ErasureCodeError) as exc:
        registry.ErasureCodePluginRegistry().factory(name, {"backend": "tpu"})
    assert exc.value.errno == -errno.EINVAL
    assert "backend=cuda" in str(exc.value) and name in str(exc.value)


@pytest.mark.parametrize("name", ["jerasure", "isa", "shec"])
@pytest.mark.parametrize("backend", [None, "cpu", "something-else"])
def test_host_backends_run_the_numpy_engine(name, backend):
    from ceph_tpu_torch.ops import cpu_engine

    profile = {} if backend is None else {"backend": backend}
    ec = registry.ErasureCodePluginRegistry().factory(name, profile)
    assert ec._engine() in (None, cpu_engine)
