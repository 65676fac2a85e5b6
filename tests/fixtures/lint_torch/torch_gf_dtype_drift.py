"""Fixture: torch-gf-dtype-drift (presented under ceph_tpu_torch/ops/ --
the rule is scoped to GF kernel code)."""
import numpy as np
import torch


def tables(k):
    v = np.arange(16)  # LINT: torch-gf-dtype-drift
    t = torch.zeros((k, 16))  # LINT: torch-gf-dtype-drift
    idx = torch.arange(8)  # LINT: torch-gf-dtype-drift
    w = np.zeros((k, 4)).astype(np.float64)  # LINT: torch-gf-dtype-drift,torch-gf-dtype-drift
    z = np.ones(k, dtype=np.float64)  # LINT: torch-gf-dtype-drift
    # explicit word dtypes: clean
    ok = np.zeros((k, 16), np.uint32)
    ok2 = torch.zeros((k, 16), dtype=torch.uint8)
    ok3 = torch.arange(8, dtype=torch.int32)
    ok4 = np.arange(16, dtype=np.uint8)
    # a torch float64 is the exact detour for 0/1 plane products: clean
    exact = ok2.to(torch.float64) @ ok2.to(torch.float64).T
    return v, t, idx, w, z, ok, ok3, ok4, exact
