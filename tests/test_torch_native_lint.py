"""The port's ``native`` pack (``ceph_tpu_torch/analysis/native_model.py``
and ``rules_native.py``) on the port's ``native/wire_native.c`` beside
the JAX package's on its own (``tests/test_native_lint.py`` there).

Each sabotage takes the port's shipped source, re-introduces one fault
class (a field reorder, a dropped compat-tail guard, a deleted
error-path cleanup) and requires both packages' analyzers to give the
same single finding, so an analyzer that silently stops comparing shows
up here."""

import os
import re

import pytest

from ceph_tpu.analysis import native_model as j_native_model
from ceph_tpu.analysis import suppress as j_suppress
from ceph_tpu.analysis.runner import scan_file as j_scan_file
from ceph_tpu_torch.analysis import native_model
from ceph_tpu_torch.analysis import suppress as suppress_mod
from ceph_tpu_torch.analysis.runner import scan_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PSEUDO = "ceph_tpu_torch/native/wire_native.c"


def _source(package: str = "ceph_tpu_torch") -> str:
    with open(os.path.join(REPO, package, "native", "wire_native.c"),
              encoding="utf-8") as fh:
        return fh.read()


def _lint(source: str, jax: bool = False):
    """scan + inline suppressions, no baseline: (new, suppressed)."""
    scan, sup_mod = (j_scan_file, j_suppress) if jax else \
        (scan_file, suppress_mod)
    raw = scan(PSEUDO.replace("ceph_tpu_torch/", "ceph_tpu/") if jax
               else PSEUDO, source)
    sup = sup_mod.parse_suppressions(source)
    new = [f for f in raw if not sup_mod.is_suppressed(sup, f.rule, f.line)]
    return new, [f for f in raw if f not in new]


def test_shipped_native_source_gates_clean():
    """The port's extension scans to zero live findings; its three
    deliberate escapes (the typed-key TypeError of the Python encoder)
    carry the JAX package's inline disables, so they are audited."""
    new, suppressed = _lint(_source())
    assert new == [], [f.format() for f in new]
    assert {f.rule for f in suppressed} == {"native-missing-fallback"}
    assert len(suppressed) == 3
    audit = suppress_mod.audit(PSEUDO, _source())
    assert len(audit) == 3 and all(
        e["rules"] == ["native-missing-fallback"] for e in audit)


@pytest.mark.parametrize("package", ["ceph_tpu", "ceph_tpu_torch"])
def test_model_parses_every_function(package):
    """Both packages' models parse every function of both packages'
    sources, and agree on them."""
    src = _source(package)
    mine = native_model.NativeModel(PSEUDO, src)
    theirs = j_native_model.NativeModel(PSEUDO, src)
    assert not [f.name for f in mine.functions.values() if not f.parsed]
    assert len(mine.functions) > 40
    assert sorted(mine.functions) == sorted(theirs.functions)


def test_drift_rule_compares_every_wire_kind():
    model = native_model.NativeModel(PSEUDO, _source())
    enc = {k.lstrip("_") for k in native_model.encoder_branches(model)}
    dec = {k.lstrip("_") for k in native_model.decoder_branches(model)}
    typed = {"MSG_EC_SUB_WRITE", "MSG_EC_SUB_WRITE_REPLY",
             "MSG_EC_SUB_READ", "MSG_EC_SUB_READ_REPLY",
             "MSG_MGR_BEACON", "MSG_MGR_REPORT"}
    assert typed <= enc, typed - enc
    assert typed | {"MSG_VALUE"} <= dec, (typed | {"MSG_VALUE"}) - dec


def _both(broken: str):
    """The port's findings on ``broken``, after checking that the JAX
    package's analyzer (reading its own msg/wire.py) gives the same."""
    new, _sup = _lint(broken)
    j_new, _j_sup = _lint(broken, jax=True)

    def key(f):
        # each names its own msg/wire.py's line, which differ
        return f.rule, f.line, re.sub(r"line \d+", "line N", f.message)

    assert [key(f) for f in new] == [key(f) for f in j_new]
    return new


def test_sabotaged_field_reorder_fires_schema_drift():
    real = _source()
    broken = real.replace(
        "    if (emit_u8(e, MSG_MGR_BEACON) < 0 ||\n"
        "        emit_attr_string(e, msg, s_name) < 0 ||\n"
        "        emit_attr_varint(e, msg, s_seq) < 0 ||",
        "    if (emit_u8(e, MSG_MGR_BEACON) < 0 ||\n"
        "        emit_attr_varint(e, msg, s_seq) < 0 ||\n"
        "        emit_attr_string(e, msg, s_name) < 0 ||",
    )
    assert broken != real
    new = _both(broken)
    assert [f.rule for f in new] == ["native-schema-drift"]
    assert "MGR_BEACON" in new[0].message and "(encode)" in \
        new[0].message and "field #1" in new[0].message


def test_sabotaged_dropped_guard_fires_schema_drift():
    """Without the remaining-bytes check around the beacon's lag_ms, the
    C decoder reads a field that the port's msg/wire.py keeps optional
    (its restored ``cephlint: wire-optional`` tag)."""
    real = _source()
    guarded = (
        "      if (d->pos < d->end) {\n"
        "        if (kw_set(kw, s_lag_ms, dec_value(d)) < 0) goto fail;\n"
        "      }\n"
    )
    assert real.count(guarded) == 2
    broken = real.replace(
        guarded,
        "      if (kw_set(kw, s_lag_ms, dec_value(d)) < 0) goto fail;\n", 1)
    new = _both(broken)
    assert [f.rule for f in new] == ["native-schema-drift"]
    msg = new[0].message
    assert "MGR_BEACON" in msg and "(decode)" in msg
    assert "optional-guarded" in msg and "wire-optional" in msg


def test_sabotaged_deleted_cleanup_fires_refcount_leak():
    real = _source()
    broken = real.replace(
        "  if (FallbackError == NULL || Unknown == NULL || "
        "empty_tuple == NULL)\n    goto fail;",
        "  if (FallbackError == NULL || Unknown == NULL || "
        "empty_tuple == NULL)\n    return NULL;",
    )
    assert broken != real
    new = _both(broken)
    assert [f.rule for f in new] == ["native-refcount-leak-on-error-path"]
    assert "'mod'" in new[0].message
    assert broken.splitlines()[new[0].line - 1].strip() == "return NULL;"
