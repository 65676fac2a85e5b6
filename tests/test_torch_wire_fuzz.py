"""The port's codec fuzzer (``ceph_tpu_torch/tools/wire_fuzz.py``) beside
the JAX package's (``tools/wire_fuzz.py``).

Every typed message kind the port's C decoder dispatches must have a
plain seed and a forced-fallback case in the fuzz corpus; the typed floor
is the JAX fuzzer's, kind for kind, and the port's seeds encode to the
bytes the JAX package's Python codec gives the JAX fuzzer's seeds from the
same seed.  A short seeded run (encode, decode, truncation and flip
mutants, the leak gate, ring mutants) agrees end to end, and the
minimizer shrinks a failing input.
"""

import importlib.util
import random
import re
from pathlib import Path

import pytest

from ceph_tpu.msg import wire as j_wire
from ceph_tpu_torch.msg import wire
from ceph_tpu_torch.native import wire_codec
from ceph_tpu_torch.tools import wire_fuzz

REPO = Path(__file__).resolve().parent.parent

_spec = importlib.util.spec_from_file_location(
    "j_wire_fuzz", REPO / "tools" / "wire_fuzz.py")
j_wire_fuzz = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(j_wire_fuzz)

NATIVE = wire_codec.native()
KINDS = sorted(wire_fuzz.typed_seeds(random.Random(0)))


def _c_decoder_kinds():
    """The ``case MSG_*:`` labels of the port's C decoder."""
    src = (REPO / "ceph_tpu_torch" / "native" / "wire_native.c").read_text()
    return set(re.findall(r"^\s*case (MSG_[A-Z_]+):", src, re.M))


def test_typed_kind_map_matches_the_c_decoder():
    assert set(KINDS) == _c_decoder_kinds()
    assert KINDS == sorted(j_wire_fuzz.typed_seeds(random.Random(0)))


@pytest.mark.parametrize("kind", KINDS)
def test_fuzz_corpus_seeds_every_typed_kind(kind):
    rng = random.Random(3)
    seed_type = type(wire_fuzz.typed_seeds(rng)[kind])
    fallback_type = type(wire_fuzz.typed_fallback_cases(rng)[kind])
    types_in_corpus = [type(m) for m in wire_fuzz.corpus(seed=9, n=40)]
    assert types_in_corpus.count(seed_type) >= 1
    assert types_in_corpus.count(fallback_type) >= 1


@pytest.mark.parametrize("kind", KINDS)
def test_typed_seeds_encode_like_the_jax_fuzzer(kind):
    """The same seed draws the same typed floor in both fuzzers: the
    port's C encoder gives the plain seed the bytes the JAX package's
    Python codec gives the JAX fuzzer's, and the forced-fallback case
    raises FallbackError and decodes equal through both decoders."""
    mine = wire_fuzz.typed_seeds(random.Random(7))[kind]
    theirs = j_wire_fuzz.typed_seeds(random.Random(7))[kind]
    assert NATIVE.encode_body(mine) == j_wire.encode_message(theirs)
    msg = wire_fuzz.typed_fallback_cases(random.Random(5))[kind]
    j_msg = j_wire_fuzz.typed_fallback_cases(random.Random(5))[kind]
    with pytest.raises(NATIVE.FallbackError):
        NATIVE.encode_body(msg)
    body = wire.encode_message(msg)
    assert body == j_wire.encode_message(j_msg)
    assert NATIVE.decode_body(body) == wire.decode_message(body)


def test_fuzz_run_smoke_and_minimizer():
    report = wire_fuzz.run_fuzz(cases=40, seed=13, mutations=3,
                                leak_passes=3, ring_cases=20)
    assert report["ok"], report["divergences"]
    assert report["cases"] == 40 and report["mutants"] > 0
    assert report["fallbacks"] >= len(KINDS)  # the typed fallback floor
    assert report["leak_gate"]["flat"], report["leak_gate"]
    assert report["ring"]["ok"] and report["ring"]["cases"] == 20

    data = bytes(range(64))
    small = wire_fuzz.minimize(data, lambda b: b"\x07" in b)
    assert b"\x07" in small and len(small) <= 2
    assert small == j_wire_fuzz.minimize(data, lambda b: b"\x07" in b)


def test_fuzz_cli_exits_zero(capsys):
    assert wire_fuzz.main(["--cases", "20", "--ring-cases", "5"]) == 0
    assert '"ok": true' in capsys.readouterr().out
