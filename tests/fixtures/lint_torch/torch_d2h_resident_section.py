"""Fixture: torch-d2h-in-resident-section.

A declared device-resident region must not contain a D2H sink -- not
directly, and not through a helper call (the residency lattice follows
values interprocedurally).  The clean section shows the contract
holding: device-side slicing, kernel wrappers and the H2D upload edge
are legal; only pulls BACK to host are not.
"""
import numpy as np
import torch

from ceph_tpu_torch.analysis.residency import (device_get, device_put,
                                               resident_section)
from ceph_tpu_torch.ops import cuda_gf


def _helper_syncs_its_arg(block):
    # the residency lattice marks parameter `block` as synced-to-host:
    # callers handing a device value here D2H it transitively
    return np.asarray(block)


def _helper_returns_device(host_rows, dev):
    return torch.from_numpy(host_rows).to(dev)


class Pipeline:
    def violating_section(self, data, dev):
        d = device_put(data, dev)
        # cephlint: device-resident-section violating
        with resident_section("violating"):
            sliced = d[0:4]
            host = sliced.cpu()  # LINT: torch-d2h-in-resident-section
            rows = _helper_syncs_its_arg(d)  # LINT: torch-d2h-in-resident-section
            pulled = device_get(sliced)  # LINT: torch-d2h-in-resident-section
            first = int(d[0, 0].item())  # LINT: torch-d2h-in-resident-section,torch-d2h-in-resident-section
            back = d.to("cpu")  # LINT: torch-d2h-in-resident-section
        # cephlint: end-device-resident-section
        return host, rows, pulled, first, back

    def lattice_through_helper(self, host_rows, dev):
        # the device value is born inside a HELPER; the lattice carries
        # its residency through the call into the section's sink
        t = _helper_returns_device(host_rows, dev)
        # cephlint: device-resident-section through-helper
        with resident_section("through-helper"):
            scaled = t + 1
            flat = scaled.tolist()  # LINT: torch-d2h-in-resident-section
        # cephlint: end-device-resident-section
        return flat

    def clean_section(self, data, tables, dev):
        d = device_put(data, dev)
        # cephlint: device-resident-section clean
        with resident_section("clean"):
            up = torch.zeros(4, dtype=torch.int32, device=dev)  # legal
            out = cuda_gf.matrix_encode_w8(tables, d + up[0], 4, 2)
            rows = out.view(torch.uint8).contiguous()  # device-side ops
        # cephlint: end-device-resident-section
        return device_get(rows)  # the designed D2H, at the boundary


# a declared region with no runtime resident_section() guard is itself
# a finding: the static markers and the runtime seams must pair
def unguarded(data, dev):
    d = device_put(data, dev)
    # cephlint: device-resident-section unguarded  # LINT: torch-d2h-in-resident-section
    e = d + 1
    # cephlint: end-device-resident-section
    return e


# an end marker with no open section is malformed
# cephlint: end-device-resident-section  # LINT: torch-d2h-in-resident-section
