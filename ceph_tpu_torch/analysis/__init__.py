"""cephlint: AST-based static analysis for the ceph_tpu_torch tree, plus
the two runtime verifiers its section markers pair with.

Port of ``ceph_tpu/analysis/``.  Ceph ships invariant-enforcement
tooling beside its data path (lockdep, src/test static suites, CI clang
analyses); this package plays that role for the port.  Every module of
the JAX package's ``analysis/`` has its counterpart here: ``core``,
``suppress``, ``baseline``, ``cfg``, ``callgraph``, ``runner``, the rule
packs, ``residency_flow``, ``native_model``, ``runtime`` and
``residency``.  The rules read source only (nothing under analysis is
imported or executed), import neither ``torch`` nor the JAX package, and
every scope names the port: ``ceph_tpu_torch/...`` paths, the port's
options registry and its ``CEPH_TPU_TORCH_`` environment layer, the
port's ``msg/wire.py`` against its ``native/wire_native.c``.

Rule catalog (31 rules, ``ceph_tpu_torch/tools/cephlint.py
--list-rules``):

* **async** (``rules_async``, ``rules_interleave``; language-neutral, so
  on the same source they give the JAX package's findings):
  ``async-orphan-task``, ``async-unawaited-coroutine``,
  ``async-blocking-call``, ``async-sync-lock-await``,
  ``async-drain-per-item``, ``async-unbounded-retry``,
  ``async-unbounded-fanout``, ``async-background-unthrottled``,
  ``async-rmw-across-await``, ``async-lock-across-await``,
  ``async-atomic-section``.
* **ceph** (``rules_config``, ``rules_perf``, ``rules_profile``,
  ``rules_trace``, ``rules_osdmap``, ``rules_wire``):
  ``ceph-config-undeclared-key``, ``perf-counter-unexported``,
  ``profile-stage-unpaired``, ``trace-span-unfinished``,
  ``osdmap-apply-unguarded``, ``wire-schema-symmetry``,
  ``wire-trailing-compat``, ``wire-version-pairing``,
  ``wire-hot-path-alloc``.
* **native** (``rules_native`` over ``native_model``; ``.c``, ``.cpp``,
  ``.cc`` and ``.h`` sources): ``native-refcount-leak-on-error-path``,
  ``native-gil-released-pyapi``, ``native-missing-fallback``,
  ``native-schema-drift``.
* **torch** (``rules_torch``, ``rules_residency`` over
  ``residency_flow``): the JAX package's seven ``jax-*`` rules, each
  reading what the port does in that role:

  ======================================= ===================================
  JAX package                             port
  ======================================= ===================================
  ``jax-gf-dtype-drift``                  ``torch-gf-dtype-drift``
  ``jax-device-bytes-unaccounted``        ``torch-device-bytes-unaccounted``
  ``jax-d2h-in-resident-section``         ``torch-d2h-in-resident-section``
  ``jax-recompile-hazard``                ``torch-recompile-hazard``
  ``jax-donated-after-use``               ``torch-donated-after-use``
  ``jax-loop-invariant-transfer``         ``torch-loop-invariant-transfer``
  ``jax-percall-sharding-construction``   ``torch-percall-sharding-construction``
  ======================================= ===================================

  ``rules_torch``'s docstring says what each watches.  Two arms of
  ``jax-recompile-hazard`` (a raw shape fed to a ``static_argnums``
  parameter, a weak-typed scalar literal fed to a traced one) have no
  PyTorch idiom and no counterpart; ``torch-donated-after-use`` watches
  buffers owned by a ``non_blocking`` copy, PyTorch's form of handing a
  buffer away.

Markers (comments the rules and the runtime verifiers read):
``# cephlint: disable=<rule>[,<rule>]`` (this line),
``# cephlint: disable-next-line=<rule>``, ``# cephlint: atomic-section
<name>`` ... ``# cephlint: end-atomic-section`` (no task switch inside;
checked statically and by :mod:`runtime`), ``# cephlint:
device-resident-section <name>`` ... ``end-device-resident-section`` (no
D2H inside; checked statically and by :mod:`residency`'s
``resident_section``), ``# cephlint: wire-hot-section <name>`` ...
``end-wire-hot-section`` and ``# cephlint: wire-optional -- <why>``.

Baseline: ``ceph_tpu_torch/tools/cephlint_baseline.json`` (the JAX
package's ``format_version`` 1; ``--write-baseline`` regenerates it with
the inline-disable audit).  Entry points: :func:`run` / :func:`run_paths`
(programmatic), ``python ceph_tpu_torch/tools/cephlint.py`` (the gate)
and ``ceph_tpu_torch/tools/ci_lint.sh`` (the gate plus the smokes).
Rules self-register on import via the ``@rule`` decorator in
:mod:`ceph_tpu_torch.analysis.core`.
"""

from ceph_tpu_torch.analysis.core import Finding, Rule, all_rules, rule  # noqa: F401
from ceph_tpu_torch.analysis.runner import run, run_paths  # noqa: F401
