"""Daemon entry points (reference: src/ceph_osd.cc etc. -- one process
per daemon, booted by vstart-style scripts).

Port of ``ceph_tpu/daemon/``: ``python -m ceph_tpu_torch.daemon.{osd,mon,
mgr}``.  An OSD whose pool is on the ``cuda`` plugin makes its own CUDA
context and runs the pool's chunk math on the card in its own process;
it loads the kernel library at boot and exits non-zero where it cannot.
"""
