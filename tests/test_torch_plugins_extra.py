"""The port's isa, shec, lrc and example plugins (``plugins/{isa,shec,lrc,
example}.py``, ``matrices/isa.py``) and the registry's ``preload`` against
the JAX package's.

Every profile of ``tests/test_plugins_extra.py`` runs through both
packages with the same payload made with numpy from a seed; the tolerance
is zero.  Each port plugin runs on the host engine (``backend=cpu``), on
the host's AVX2 kernels (``backend=native``, isa and shec) and through the
PyTorch engine on profile ``backend=cuda device=cpu`` (the
``gf2_matrix_w8`` and ``gf2_matrix_w16`` kernels' plain versions); lrc's
layers also run the ``cuda`` plugin on ``device=cpu``.  Encoded chunks,
every decode pattern up to m erasures (up to c for shec), the
``minimum_to_decode`` plans and the guard rails' errnos are the JAX
package's.
"""

import errno
import itertools

import numpy as np
import pytest

from ceph_tpu.matrices import isa as j_isa_matrices
from ceph_tpu.plugins import registry as j_registry
from ceph_tpu.plugins.interface import ErasureCodeError as JErasureCodeError
from ceph_tpu_torch.matrices import isa as isa_matrices
from ceph_tpu_torch.plugins import registry
from ceph_tpu_torch.plugins.interface import ErasureCodeError
from ceph_tpu_torch.utils import unported

#: the port's engines: the host LUT engine, the host's AVX2 kernels
#: (``backend=native``) and the PyTorch engine
BACKENDS = {"host": {}, "native": {"backend": "native"},
            "torch": {"backend": "cuda", "device": "cpu"}}

ISA = [(t, k, m) for t in ("reed_sol_van", "cauchy")
       for k, m in ((2, 1), (4, 2), (8, 4), (12, 4))]
SHEC = [(t, k, m, c) for t in ("single", "multiple")
        for k, m, c in ((4, 3, 2), (6, 4, 2), (8, 4, 3))]
LRC_EXPLICIT = {
    "mapping": "__DD__DD",
    "layers": '[ [ "_cDD_cDD", "" ], [ "cDDD____", "" ], '
              '[ "____cDDD", "" ] ]',
}


def _pair(name, profile, extra=None):
    mine = registry.ErasureCodePluginRegistry().factory(
        name, dict(profile, **(extra or {})))
    theirs = j_registry.ErasureCodePluginRegistry().factory(
        name, dict(profile))
    return mine, theirs


def _payload(ec, seed, stripes=2, tail=13):
    rng = np.random.RandomState(seed)
    size = ec.get_chunk_size(1) * ec.get_data_chunk_count() * stripes + tail
    return rng.randint(0, 256, size, dtype=np.uint8).tobytes()


def _same_maps(a, b, what=""):
    assert set(a) == set(b), what
    for c in a:
        assert np.array_equal(np.asarray(a[c]), np.asarray(b[c])), (what, c)


def _roundtrip(mine, theirs, seed, max_erasures):
    km = theirs.get_chunk_count()
    payload = _payload(theirs, seed)
    chunks = mine.encode(set(range(km)), payload)
    _same_maps(chunks, theirs.encode(set(range(km)), payload), "encode")
    assert mine.decode_concat(chunks) == theirs.decode_concat(chunks)
    for r in range(1, max_erasures + 1):
        for erased in itertools.combinations(range(km), r):
            have = {i: c for i, c in chunks.items() if i not in erased}
            try:
                want = theirs.decode(set(erased), dict(have))
            except JErasureCodeError as e:
                with pytest.raises(ErasureCodeError) as mine_e:
                    mine.decode(set(erased), dict(have))
                assert mine_e.value.errno == e.errno
                continue
            _same_maps(mine.decode(set(erased), dict(have)), want, erased)
    return chunks


def _plans(ec, km):
    """Every single-chunk plan and every two-chunk plan with those two
    chunks lost."""
    out = {}
    for want in itertools.chain(((c,) for c in range(km)),
                                itertools.combinations(range(km), 2)):
        avail = [c for c in range(km) if c not in want]
        try:
            out[want] = ec.minimum_to_decode(list(want), avail)
        except (ErasureCodeError, JErasureCodeError) as e:
            out[want] = ("error", e.errno)
    return out


# -- matrices ---------------------------------------------------------------


@pytest.mark.parametrize("k,m", [(2, 1), (4, 2), (7, 3), (8, 4), (12, 4),
                                 (21, 4), (22, 4), (32, 2)])
def test_isa_generators_equal_the_jax_packages(k, m):
    for mine, theirs in ((isa_matrices.gen_rs_matrix,
                          j_isa_matrices.gen_rs_matrix),
                         (isa_matrices.gen_cauchy1_matrix,
                          j_isa_matrices.gen_cauchy1_matrix)):
        got, want = mine(k, m), theirs(k, m)
        assert got.dtype == want.dtype and np.array_equal(got, want)


# -- isa --------------------------------------------------------------------


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("technique,k,m", ISA)
def test_isa_matches_jax(technique, k, m, backend):
    mine, theirs = _pair("isa", {"k": str(k), "m": str(m),
                                 "technique": technique}, BACKENDS[backend])
    assert np.array_equal(mine.matrix, theirs.matrix)
    _roundtrip(mine, theirs, seed=k * 10 + m, max_erasures=min(m, 2))
    assert _plans(mine, k + m) == _plans(theirs, k + m)
    assert mine.get_chunk_size(4 << 20) == theirs.get_chunk_size(4 << 20)


def test_isa_every_erasure_pattern_up_to_m_matches_jax():
    mine, theirs = _pair("isa", {"k": "7", "m": "3"}, BACKENDS["torch"])
    _roundtrip(mine, theirs, seed=73, max_erasures=3)


@pytest.mark.parametrize("profile", [
    {"k": "33", "m": "2"}, {"k": "4", "m": "5"}, {"k": "22", "m": "4"},
    {"k": "1", "m": "2"}, {"k": "4", "m": "2", "technique": "liberation"},
])
def test_isa_guard_rails_match_jax(profile):
    with pytest.raises(ErasureCodeError) as e1:
        registry.ErasureCodePluginRegistry().factory("isa", dict(profile))
    with pytest.raises(JErasureCodeError) as e2:
        j_registry.ErasureCodePluginRegistry().factory("isa", dict(profile))
    assert e1.value.errno == e2.value.errno
    assert str(e1.value) == str(e2.value)


def test_isa_cauchy_lifts_the_vandermonde_limit_and_m1_is_xor():
    mine, theirs = _pair("isa", {"k": "22", "m": "4",
                                 "technique": "cauchy"})
    _roundtrip(mine, theirs, seed=224, max_erasures=1)
    mine, theirs = _pair("isa", {"k": "4", "m": "1"}, BACKENDS["torch"])
    chunks = _roundtrip(mine, theirs, seed=41, max_erasures=1)
    assert np.array_equal(
        chunks[4], np.bitwise_xor.reduce([chunks[i] for i in range(4)]))


# -- shec -------------------------------------------------------------------


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("technique,k,m,c", SHEC)
def test_shec_matches_jax(technique, k, m, c, backend):
    mine, theirs = _pair("shec", {"k": str(k), "m": str(m), "c": str(c),
                                  "technique": technique},
                         BACKENDS[backend])
    assert np.array_equal(mine.matrix, theirs.matrix)
    _roundtrip(mine, theirs, seed=k * 100 + m * 10 + c, max_erasures=c)
    assert _plans(mine, k + m) == _plans(theirs, k + m)


@pytest.mark.parametrize("w", ["16", "32"])
def test_shec_wide_words_match_jax(w):
    mine, theirs = _pair("shec", {"w": w}, BACKENDS["torch"])
    assert mine.get_profile()["w"] == theirs.get_profile()["w"] == w
    _roundtrip(mine, theirs, seed=int(w), max_erasures=2)


def test_shec_locality_and_defaults_match_jax():
    mine, theirs = _pair("shec", {"k": "8", "m": "4", "c": "3"})
    avail = set(range(12)) - {0}
    plan = mine.minimum_to_decode({0}, avail)
    assert plan == theirs.minimum_to_decode({0}, avail) and len(plan) < 8
    mine, theirs = _pair("shec", {})
    assert mine.get_profile() == theirs.get_profile()
    assert (mine.k, mine.m, mine.c, mine.w) == (4, 3, 2, 8)


@pytest.mark.parametrize("profile", [
    {"k": "13", "m": "3", "c": "2"}, {"k": "4", "m": "3", "c": "4"},
    {"k": "3", "m": "4", "c": "2"}, {"k": "4", "m": "3"},
    {"k": "x", "m": "3", "c": "2"}, {"k": "12", "m": "9", "c": "2"},
    {"technique": "triple"},
])
def test_shec_guard_rails_match_jax(profile):
    with pytest.raises(ErasureCodeError) as e1:
        registry.ErasureCodePluginRegistry().factory("shec", dict(profile))
    with pytest.raises(JErasureCodeError) as e2:
        j_registry.ErasureCodePluginRegistry().factory("shec", dict(profile))
    assert e1.value.errno == e2.value.errno
    assert str(e1.value) == str(e2.value)


@pytest.mark.parametrize("name,profile", [
    ("isa", {}), ("isa", {"technique": "cauchy"}), ("shec", {}),
    ("shec", {"w": "16"}),
])
def test_native_backend_runs_the_native_engine(name, profile):
    from ceph_tpu_torch.ops import native_engine

    assert "native" not in unported.MISSING
    mine, theirs = _pair(name, profile, BACKENDS["native"])
    assert mine._engine() is native_engine
    _roundtrip(mine, theirs, seed=len(profile) + 7, max_erasures=2)


# -- lrc --------------------------------------------------------------------


def _lrc_cuda_layers(profile):
    """The (k, m, l) profile's generated mapping and layers, each layer
    on the ``cuda`` plugin at ``device=cpu``."""
    gen = registry.ErasureCodePluginRegistry().factory("lrc", dict(profile))
    prof = gen.get_profile()
    layers = [[layer.chunks_map, "plugin=cuda device=cpu"]
              for layer in gen.layers]
    import json

    return {"mapping": prof["mapping"], "layers": json.dumps(layers)}


@pytest.mark.parametrize("inner", ["jerasure", "cuda"])
def test_lrc_kml_matches_jax(inner):
    profile = {"k": "4", "m": "2", "l": "3"}
    theirs = j_registry.ErasureCodePluginRegistry().factory(
        "lrc", dict(profile))
    if inner == "cuda":
        mine = registry.ErasureCodePluginRegistry().factory(
            "lrc", _lrc_cuda_layers(profile))
        assert all(type(layer.erasure_code).__module__ ==
                   "ceph_tpu_torch.plugins.cuda" for layer in mine.layers)
    else:
        mine = registry.ErasureCodePluginRegistry().factory(
            "lrc", dict(profile))
        assert mine.get_profile() == theirs.get_profile()
        assert mine.rule_steps == theirs.rule_steps
    assert mine.get_chunk_count() == theirs.get_chunk_count() == 8
    _roundtrip(mine, theirs, seed=423, max_erasures=2)
    assert _plans(mine, 8) == _plans(theirs, 8)
    # one lost chunk reads its local group only
    assert len(mine.minimum_to_decode({0}, set(range(1, 8)))) <= 3


def test_lrc_explicit_layers_and_locality_match_jax():
    mine, theirs = _pair("lrc", LRC_EXPLICIT)
    assert mine.get_data_chunk_count() == theirs.get_data_chunk_count() == 4
    _roundtrip(mine, theirs, seed=88, max_erasures=2)
    assert _plans(mine, 8) == _plans(theirs, 8)
    mine, theirs = _pair("lrc", {"k": "4", "m": "2", "l": "3",
                                 "crush-locality": "rack"})
    assert mine.rule_steps == theirs.rule_steps


@pytest.mark.parametrize("profile", [
    {"k": "4", "m": "2"}, {"k": "4", "m": "2", "l": "5"},
    {"mapping": "DD_"}, {"k": "4", "m": "2", "l": "3", "mapping": "DD"},
    {"k": "3", "m": "3", "l": "3"},
    {"mapping": "DD_", "layers": "not json"},
    {"mapping": "DD_", "layers": '[ [ "DDc_", "" ] ]'},
    {"mapping": "DD_", "layers": "[ ]"},
])
def test_lrc_guard_rails_match_jax(profile):
    with pytest.raises(ErasureCodeError) as e1:
        registry.ErasureCodePluginRegistry().factory("lrc", dict(profile))
    with pytest.raises(JErasureCodeError) as e2:
        j_registry.ErasureCodePluginRegistry().factory("lrc", dict(profile))
    assert e1.value.errno == e2.value.errno == -errno.EINVAL
    assert str(e1.value) == str(e2.value)


# -- example and the registry -----------------------------------------------


def test_example_matches_jax():
    mine, theirs = _pair("example", {})
    chunks = _roundtrip(mine, theirs, seed=2, max_erasures=1)
    assert np.array_equal(chunks[2], chunks[0] ^ chunks[1])
    costs = {0: 5, 1: 1, 2: 2}
    assert mine.minimum_to_decode_with_cost({0}, costs) == \
        theirs.minimum_to_decode_with_cost({0}, costs) == [1, 2]
    with pytest.raises(ErasureCodeError) as e1:
        mine.decode({0, 1}, {2: chunks[2]})
    assert e1.value.errno == -errno.EIO


def test_preload_loads_the_default_list():
    reg = registry.ErasureCodePluginRegistry()
    assert registry.DEFAULT_PLUGINS == "jerasure lrc isa cuda"
    assert j_registry.DEFAULT_PLUGINS.replace("tpu", "cuda") == \
        registry.DEFAULT_PLUGINS
    reg.preload()
    assert set(reg._plugins) == {"jerasure", "lrc", "isa", "cuda"}
    reg.preload("shec, regen example")
    assert set(reg._plugins) == {"jerasure", "lrc", "isa", "cuda", "shec",
                                 "regen", "example"}
    with pytest.raises(ErasureCodeError) as exc:
        reg.preload("nosuch")
    assert exc.value.errno == -errno.ENOENT
