"""Fixture: torch-device-bytes-unaccounted (presented under a
ceph_tpu_torch/ path): retaining a tensor placed on a card on an
attribute or container outside the tier/pipeline accounting seams."""
import numpy as np
import torch

from ceph_tpu_torch.analysis import residency


class Shard:
    def __init__(self, dev):
        self.dev = dev
        self.cache = {}

    def keep(self, data):
        self.table = torch.from_numpy(data).to(self.dev)  # LINT: torch-device-bytes-unaccounted
        d = residency.device_put(data, self.dev)
        self.cache["k"] = d  # LINT: torch-device-bytes-unaccounted
        self.ones = torch.ones(4, dtype=torch.uint8, device=self.dev)  # LINT: torch-device-bytes-unaccounted
        self.rows = torch.from_numpy(data).cuda()  # LINT: torch-device-bytes-unaccounted

    def transient(self, data):
        d = residency.device_put(data, self.dev)  # local bind: clean
        self.host = torch.zeros(4, dtype=torch.uint8, device="cpu")  # host
        self.cast = torch.from_numpy(data).to(torch.int32)  # a cast: clean
        self.shape = np.asarray(data).shape
        return d.sum()
