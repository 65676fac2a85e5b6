"""The port stands alone: no module of ceph_tpu_torch, and not chip_smoke.py,
imports JAX, the JAX package or the JAX package's tools and experiments.
Checked twice: statically (an AST scan of every import) and at run time (a
fresh interpreter in which ``jax``, ``ceph_tpu``, ``tools`` and
``experiments`` cannot be imported imports every port module, encodes
and decodes one stripe, runs one small coalesced storage-path pass, and
runs the kernel sweep and its two probe tools on the CPU)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "ceph_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "ceph_tpu", "tools", "experiments")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    # whole module names: ceph_tpu_torch is not ceph_tpu
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_port_files_import_no_jax_and_no_reference_package():
    files = _port_files()
    assert len(files) > 15
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_port_cuda_sources_include_only_toolkit_and_generated_headers():
    # the kernels build from the checkout alone: CUDA runtime and C headers,
    # the XOR network's header that the port generates at build time, and
    # the headers of csrc/ itself (the w=8 lookup body both table kernels
    # share)
    headers = sorted((PORT / "csrc").glob("*.cuh"))
    allowed = {"cuda_runtime.h", "stdint.h", "xornet_net.h",
               *(h.name for h in headers)}
    sources = sorted((PORT / "csrc").glob("*.cu"))
    assert len(sources) >= 3
    for path in sources + headers:
        included = {line.split()[1].strip('<>"')
                    for line in path.read_text().splitlines()
                    if line.startswith("#include")}
        assert included <= allowed, (path.name, included - allowed)


def test_forbidden_prefix_compares_whole_module_names():
    assert _forbidden("ceph_tpu") and _forbidden("ceph_tpu.ops.gf")
    assert _forbidden("jax.numpy") and not _forbidden("jaxtyping")
    assert not _forbidden("ceph_tpu_torch.ops.gf")
    assert _forbidden("tools.ec_kernel_sweep") and _forbidden("experiments")
    assert not _forbidden("ceph_tpu_torch.tools.ec_kernel_sweep")
    assert not _forbidden("functools")


_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["ceph_tpu"] = None
sys.modules["tools"] = None
sys.modules["experiments"] = None
import numpy as np
import ceph_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ceph_tpu_torch.__path__,
                                                "ceph_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401  (imported, not run)
from ceph_tpu_torch.plugins import registry
reg = registry.instance()
profile = {"technique": "reed_sol_van", "k": "4", "m": "2"}
ec = reg.factory("cuda", dict(profile, device="cpu"))
ref = reg.factory("jerasure", dict(profile))
payload = np.random.RandomState(0).randint(0, 256, 4096, dtype=np.uint8)
enc = ec.encode(set(range(6)), payload)
want = ref.encode(set(range(6)), payload)
assert all(np.array_equal(enc[c], want[c]) for c in want)
dec = ec.decode(set(range(6)), {c: enc[c] for c in (0, 2, 3, 5)})
assert all(np.array_equal(dec[c], want[c]) for c in want)
import asyncio
from ceph_tpu_torch.osd import storage_bench
h = storage_bench.StoragePathHarness(ec)
payloads = storage_bench.make_payloads(6, 3000, seed=1)
loop = asyncio.new_event_loop()
store = loop.run_until_complete(h.write_pass(payloads, coalesce=True,
                                             writers=3))
got = loop.run_until_complete(h.read_pass(store, 6, [3000] * 6,
                                          coalesce=True, readers=3))
loop.close()
assert got == payloads and len(store) == 6 * 6
from ceph_tpu_torch.tools import ec_kernel_sweep, kernel_r4_probe, kernel_r4_split
for tool in (ec_kernel_sweep, kernel_r4_split, kernel_r4_probe):
    assert tool.main(["--device", "cpu", "--iters", "1"]) == 0
assert not any(m in ("jax", "tools", "experiments")
               or m.startswith(("jax.", "ceph_tpu.", "tools.", "experiments."))
               for m, mod in sys.modules.items() if mod is not None)
print("imported", len(names))
"""


def test_port_runs_where_jax_and_the_reference_cannot_import():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) > 15
