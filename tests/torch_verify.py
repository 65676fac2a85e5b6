"""The port's runtime verifiers on the port's tests.

``tests/conftest.py`` installs the JAX package's atomic-section verifier
as every event loop's task factory; under Python 3.12 its generator shim
cannot run a task.  The port's asyncio test files take
:func:`port_verifiers` (their ``_loop_policy`` fixture) instead, which
for the test's run

* routes every new event loop through the port's verifying policy
  (``ceph_tpu_torch.analysis.runtime``), whose verifier holds the port's
  declared atomic sections and, registered here by path, the JAX
  package's (``ceph_tpu/`` and ``tools/``): both halves of a comparison
  are checked, and the port imports nothing of the JAX package;
* installs ``ceph_tpu_torch.analysis.residency``'s verifier (raise mode,
  or what ``CEPH_TPU_TORCH_RESIDENCY_VERIFY`` says);

and fails the test that drove a new violation of either, as the
conftest's hook does for the JAX package.  The previous policy is
restored afterwards, so the JAX package's own test files keep the
conftest's.  ``CEPH_TPU_TORCH_ATOMIC_VERIFY=0`` leaves asyncio's default
policy in place of the verifying one."""

import asyncio
import contextlib
import os

import pytest

from ceph_tpu_torch.analysis import residency, runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ATOMIC = None


def atomic_verifier():
    """The process's port verifier (``runtime.install``), with the JAX
    package's sections registered beside the port's; None when switched
    off."""
    global _ATOMIC
    if _ATOMIC is None and runtime.enabled():
        saved = asyncio.get_event_loop_policy()
        _ATOMIC = runtime.install()
        asyncio.set_event_loop_policy(saved)  # scoped per test below
        for tree in ("ceph_tpu", "tools"):
            _ATOMIC.register_tree(os.path.join(REPO, tree))
    return _ATOMIC


def residency_verifier():
    """The port's residency verifier (installed once per process); None
    when ``CEPH_TPU_TORCH_RESIDENCY_VERIFY`` switches it off."""
    mode = residency.mode_from_env()
    return residency.install(mode) if mode is not None else None


def verifying_policy() -> asyncio.AbstractEventLoopPolicy:
    """A fresh event-loop policy whose loops carry the port's verifying
    task factory (asyncio's default when the verifier is off)."""
    atomic = atomic_verifier()
    return runtime.VerifyingPolicy(atomic) if atomic is not None \
        else asyncio.DefaultEventLoopPolicy()


@contextlib.contextmanager
def port_verifiers():
    """The test's run under the port's verifiers (see the module
    docstring); fails the test on a new violation."""
    atomic = atomic_verifier()
    resident = residency_verifier()
    saved = asyncio.get_event_loop_policy()
    asyncio.set_event_loop_policy(verifying_policy())
    before = len(atomic.violations) if atomic is not None else 0
    res_before = len(resident.violations) if resident is not None else 0
    try:
        yield
    finally:
        asyncio.set_event_loop_policy(saved)
    fresh_res = resident.violations[res_before:] if resident else []
    fresh = atomic.violations[before:] if atomic is not None else []
    if fresh_res:
        del resident.violations[res_before:]
    if fresh:
        del atomic.violations[before:]
    if fresh_res or fresh:
        lines = "\n".join(f"  {v!r}" for v in fresh_res + fresh)
        pytest.fail("the test drove a violation of a declared section "
                    f"(device-resident or atomic):\n{lines}",
                    pytrace=False)
