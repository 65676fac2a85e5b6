"""The port's EC tools (``ceph_tpu_torch/tools/{ec_non_regression,ec_info,
ec_bench_sweep,crushtool}.py``) against the JAX package's (``tools/``).

* ``ec_non_regression``: every directory of the committed corpus
  (``tests/data/ec_corpus``, made by the JAX package's tool) checks with
  both tools; a corpus freshly created by either tool checks with the
  other's; a corrupted chunk fails the check.  The card's profiles
  (``backend=cuda``, ``plugin=cuda``, ``regen``) run here on copies whose
  names end in `` device=cpu``, with ``--parameter device=cpu``; the JAX
  package's ``tpu`` plugin checks ``plugin=cuda`` directories on copies
  named ``plugin=tpu``.  Chunks are compared byte for byte.
* ``ec_info``: every built-in plugin exists; the codec description is the
  JAX tool's.
* ``ec_bench_sweep``: the same cells, in the same order, with the reference's
  keys (and ``h2d_ops`` on the cells that run on a device).
* ``crushtool``: ``--show-mappings``, ``--show-utilization`` and ``--dump``
  print what the JAX tool prints.
"""

import contextlib
import io
import json
import os
import shutil
from pathlib import Path

import pytest

from ceph_tpu_torch.ops import cuda_gf
from ceph_tpu_torch.plugins import registry
from ceph_tpu_torch.tools import (crushtool, ec_bench_sweep, ec_info,
                                  ec_non_regression)
from tools import crushtool as j_crushtool
from tools import ec_bench_sweep as j_ec_bench_sweep
from tools import ec_info as j_ec_info
from tools import ec_non_regression as j_ec_non_regression

CORPUS = Path(__file__).resolve().parent / "data" / "ec_corpus"
DIRS = sorted(p.name for p in CORPUS.iterdir() if p.is_dir())
CPU = " device=cpu"


def _card(name: str) -> bool:
    """The profiles that run on the card in the port."""
    return name.startswith(("plugin=cuda ", "plugin=regen ")) or \
        " backend=cuda" in name


def _jax_name(name: str) -> str:
    """The JAX package's name of a directory: ``tpu`` for ``cuda``, no
    device key."""
    if name.endswith(CPU):
        name = name[:-len(CPU)]
    if name.startswith("plugin=cuda "):
        name = "plugin=tpu " + name[len("plugin=cuda "):]
    return name


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _port_check(base: Path, name: str) -> int:
    """The port's ``--check`` of ``base/name``, on a ``device=cpu`` copy
    for the card's profiles."""
    if _card(name):
        shutil.copytree(base / name, base / (name + CPU))
        name += CPU
    return ec_non_regression.main(
        ["--check", "--base", str(base)]
        + ec_non_regression.directory_argv(name))


def _jax_check(base: Path, name: str) -> int:
    if _jax_name(name) != name:
        shutil.copytree(base / name, base / _jax_name(name))
        name = _jax_name(name)
    return j_ec_non_regression.main(
        ["--check", "--base", str(base)]
        + ec_non_regression.directory_argv(name))


def test_corpus_is_small_and_lane_aligned():
    assert len(DIRS) == 11 and (CORPUS / "README").exists()
    total = sum(p.stat().st_size for p in CORPUS.rglob("*") if p.is_file())
    assert total < 1 << 20
    for name in DIRS:
        files = {p.name for p in (CORPUS / name).iterdir()}
        n = len(files) - 1
        assert files == {"content", *map(str, range(n))}, name
        if _card(name):
            # whole 4-byte lanes, so on the card the products take the
            # kernels
            assert (CORPUS / name / "0").stat().st_size % \
                cuda_gf.LANE_BYTES == 0, name


@pytest.mark.parametrize("name", DIRS)
def test_committed_corpus_checks_with_the_ports_tool(name, tmp_path):
    shutil.copytree(CORPUS / name, tmp_path / name)
    assert _port_check(tmp_path, name) == 0


@pytest.mark.parametrize("name", DIRS)
def test_committed_corpus_checks_with_the_jax_tool(name, tmp_path):
    shutil.copytree(CORPUS / name, tmp_path / name)
    assert _jax_check(tmp_path, name) == 0


@pytest.mark.parametrize("name", DIRS)
def test_jax_created_corpus_checks_with_the_ports_tool(name, tmp_path):
    argv = ec_non_regression.directory_argv(_jax_name(name))
    assert j_ec_non_regression.main(
        ["--create", "--base", str(tmp_path)] + argv) == 0
    if _jax_name(name) != name:
        os.rename(tmp_path / _jax_name(name), tmp_path / name)
    assert _port_check(tmp_path, name) == 0


@pytest.mark.parametrize("name", DIRS)
def test_port_created_corpus_checks_with_the_jax_tool(name, tmp_path):
    created = name + CPU if _card(name) else name
    assert ec_non_regression.main(
        ["--create", "--base", str(tmp_path)]
        + ec_non_regression.directory_argv(created)) == 0
    assert _jax_check(tmp_path, created) == 0


def test_corrupted_chunk_fails_the_check(tmp_path):
    name = "plugin=lrc stripe-width=4096 k=4 m=2 l=3"
    shutil.copytree(CORPUS / name, tmp_path / name)
    assert _port_check(tmp_path, name) == 0
    chunk = tmp_path / name / "3"
    blob = bytearray(chunk.read_bytes())
    blob[7] ^= 0x40
    chunk.write_bytes(bytes(blob))
    assert _port_check(tmp_path, name) == 1
    assert j_ec_non_regression.main(
        ["--check", "--base", str(tmp_path)]
        + ec_non_regression.directory_argv(name)) == 1


def test_directory_argv_inverts_the_layout(tmp_path):
    argv = ["--plugin", "jerasure", "--stripe-width", "8192",
            "--parameter", "k=4", "--parameter", "m=2"]
    assert ec_non_regression.main(["--create", "--base", str(tmp_path)]
                                  + argv) == 0
    (name,) = os.listdir(tmp_path)
    assert name == "plugin=jerasure stripe-width=8192 k=4 m=2"
    assert ec_non_regression.directory_argv(name) == argv
    assert ec_non_regression.main(["--base", str(tmp_path)] + argv) == 1


# -- ec_info ------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(registry._BUILTIN))
def test_info_every_builtin_plugin_exists(name):
    assert ec_info.main(["--plugin_exists", name]) == 0


def test_info_unknown_plugin():
    assert ec_info.main(["--plugin_exists", "nonexistent_plugin"]) == 1
    assert j_ec_info.main(["--plugin_exists", "nonexistent_plugin"]) == 1
    assert _run(ec_info.main, [])[0] == 1


@pytest.mark.parametrize("plugin,params", [
    ("lrc", ["k=4", "m=2", "l=3"]),
    ("jerasure", ["k=6", "m=3", "technique=cauchy_good",
                  "packetsize=64"]),
    ("isa", ["k=8", "m=4"]),
    ("shec", ["k=4", "m=3", "c=2", "w=16"]),
    ("regen", ["k=4", "m=3"]),
])
def test_info_describes_the_codec_as_the_jax_tool(plugin, params):
    argv = ["--plugin", plugin] + [a for p in params
                                   for a in ("--parameter", p)]
    extra = ["--parameter", "device=cpu"] if plugin == "regen" else []
    rc, out = _run(ec_info.main, argv + extra)
    j_rc, j_out = _run(j_ec_info.main, argv)
    assert rc == j_rc == 0
    mine, theirs = json.loads(out), json.loads(j_out)
    if extra:
        assert mine["profile"].pop("device") == "cpu"
    assert mine == theirs


# -- ec_bench_sweep -----------------------------------------------------------

SWEEP = ["--size", "65536", "--total-size", "65536"]
KEYS = ["plugin", "technique", "k", "m", "workload", "gibps"]


def _lines(main, argv):
    rc, out = _run(main, argv)
    assert rc == 0
    return [json.loads(line) for line in out.splitlines()]


def _cells(rows):
    return [(r["plugin"], r["technique"], r["k"], r["m"]) for r in rows]


@pytest.mark.parametrize("backend", ["", "cpu", "native"])
def test_sweep_lines_match_the_reference_format(backend):
    argv = SWEEP + ["--plugins", "jerasure,isa", "--backend", backend]
    mine = _lines(ec_bench_sweep.main, argv)
    theirs = _lines(j_ec_bench_sweep.main, SWEEP + ["--plugins",
                                                    "jerasure,isa"])
    assert _cells(mine) == _cells(theirs) and len(mine) == 28
    for row in mine:
        assert list(row) == KEYS and row["gibps"] > 0, row


def test_sweep_device_cells_report_their_uploads():
    mine = _lines(ec_bench_sweep.main, SWEEP + [
        "--plugins", "cuda,jerasure", "--backend", "cuda",
        "--device", "cpu"])
    theirs = _lines(j_ec_bench_sweep.main, SWEEP + ["--plugins",
                                                    "tpu,jerasure"])
    assert [("tpu" if c[0] == "cuda" else c[0], *c[1:])
            for c in _cells(mine)] == _cells(theirs)
    for row in mine:
        assert list(row) == KEYS + ["h2d_ops"], row
        assert row["h2d_ops"] >= 0
    # the jerasure cells upload each encode's data; the cuda plugin's
    # one-shot encodes of the constant payload hit its upload cache
    assert all(r["h2d_ops"] >= 1 for r in mine if r["plugin"] == "jerasure")
    assert ec_bench_sweep.packetsize_heuristic(1 << 20, 3) == \
        j_ec_bench_sweep.packetsize_heuristic(1 << 20, 3) == 3100
    assert (ec_bench_sweep.KS, ec_bench_sweep.M_MAP) == \
        (j_ec_bench_sweep.KS, j_ec_bench_sweep.M_MAP)


def test_sweep_guard_rail_line():
    """A cell whose profile the plugin refuses prints an ``error`` line (at
    most 80 characters of the message) and the sweep goes on; here every
    cell, through ``backend=tpu``, which the port refuses."""
    rows = _lines(ec_bench_sweep.main, SWEEP + ["--plugins", "isa",
                                                "--backend", "tpu"])
    assert len(rows) == 14
    for row in rows:
        assert list(row) == ["plugin", "technique", "k", "m", "error"]
        assert row["error"].startswith("isa: backend=tpu names the TPU")
        assert len(row["error"]) == 80


# -- crushtool ----------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    "--build 8 --rule erasure --num-rep 4 --max-x 255 --show-utilization",
    "--build 16 --rule erasure --num-rep 12 --max-x 127 --show-utilization",
    "--build 4x3 --rule replicated --num-rep 3 --max-x 63 --show-mappings",
    "--build 4x3 --rule erasure --num-rep 4 --max-x 31 --show-mappings "
    "--show-utilization",
    "--build 6 --rule erasure --num-rep 4 --min-x 10 --max-x 41 "
    "--weight 2:0.5 --weight 5:0 --show-mappings",
    "--build 4x3 --dump",
], ids=lambda a: a.split(" --max-x")[0].replace(" ", ""))
def test_crushtool_prints_what_the_jax_tool_prints(argv):
    rc, out = _run(crushtool.main, argv.split())
    j_rc, j_out = _run(j_crushtool.main, argv.split())
    assert rc == j_rc == 0
    assert out == j_out and out
    if "--show-utilization" in argv:
        assert "bad mappings 0" in out
