"""Fixture: torch-loop-invariant-transfer (under a ceph_tpu_torch/ops
path).

The same bytes must not cross the bus every loop pass (or every method
call): H2D of a loop-invariant value, iteration over a device tensor
(one D2H per element), and the per-call upload of instance-constant
state (``self.B.to(dev)``) are all flagged.  Variant operands and
construction-time uploads are clean.
"""
import numpy as np
import torch

from ceph_tpu_torch.analysis import residency
from ceph_tpu_torch.ops.pipeline import accounted_device_matrix


class MeshCodec:
    def __init__(self, matrix, dev):
        self.B = torch.from_numpy(matrix)
        self.dev = dev
        # upload at construction, through the accounted cache: clean
        self._Bd = accounted_device_matrix(matrix, dev)

    def encode(self, words):
        return self.B.to(self.dev) @ words  # LINT: torch-loop-invariant-transfer

    def encode_hoisted(self, words):
        return self._Bd @ words  # uses the construction-time upload


def invariant_in_loop(matrix, blocks, dev):
    outs = []
    for blk in blocks:
        B = residency.device_put(matrix, dev)  # LINT: torch-loop-invariant-transfer
        outs.append(B @ torch.as_tensor(blk, device=dev))
    return outs


def variant_in_loop(blocks, dev):
    outs = []
    for blk in blocks:
        d = blk.to(dev)  # the loop target varies: clean
        outs.append(d)
    return outs


def hoisted(matrix, blocks, dev):
    B = matrix.cuda()  # before the loop: clean
    return [B @ blk.to(dev) for blk in blocks]


def device_iteration(data, dev):
    t = torch.from_numpy(data).to(dev)
    total = 0
    for row in t:  # LINT: torch-loop-invariant-transfer
        total += int(row.sum())
    return total


def invariant_d2h_in_loop(data, n, dev):
    t = torch.from_numpy(data).to(dev)
    outs = []
    for i in range(n):
        host = t.cpu()  # LINT: torch-loop-invariant-transfer
        outs.append(np.asarray(host)[i])
    return outs
