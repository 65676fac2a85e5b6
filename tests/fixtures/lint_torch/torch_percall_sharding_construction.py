"""Fixture: torch-percall-sharding-construction (under a ceph_tpu_torch/
path): placement objects -- the port's Mesh / make_mesh / Placement,
torch's DeviceMesh, CUDA streams, process groups -- are built once and
cached, never per loop pass or inside a compiled function."""
import numpy as np
import torch
import torch.distributed as dist
from torch.cuda import Stream as CudaStream

from ceph_tpu_torch.parallel.distributed import Mesh, make_mesh


class Plane:
    def __init__(self, devices):
        # construction: one stream per device, built with the plane
        self.streams = []
        for d in devices:
            self.streams.append(torch.cuda.Stream(device=d))
        self.mesh = make_mesh(1, len(devices))

    def dispatch(self, blocks):
        for blk in blocks:
            mesh = make_mesh(1, 2)  # LINT: torch-percall-sharding-construction
            s = CudaStream()  # LINT: torch-percall-sharding-construction
            blk.record_stream(s)
        return mesh

    def groups(self, ranks):
        out = []
        while ranks:
            out.append(dist.new_group(ranks[:2]))  # LINT: torch-percall-sharding-construction
            ranks = ranks[2:]
        return out

    def cached(self):
        return self.mesh  # built once at construction: clean


@torch.compile
def compiled_step(x, devices):
    m = Mesh(np.asarray(devices), ("data",))  # LINT: torch-percall-sharding-construction
    return x + len(m.axis_names)


def builder(devices):
    return Mesh(np.asarray(devices), ("data",))  # plain builder: clean
