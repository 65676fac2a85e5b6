"""Builtin mgr modules (the src/pybind/mgr tree's role); port of
``ceph_tpu/mgr/mgr_modules/``."""
