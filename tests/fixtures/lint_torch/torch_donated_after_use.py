"""Fixture: torch-donated-after-use.

A buffer handed to an asynchronous copy belongs to the copy engine until
a synchronize: the destination of ``copy_(..., non_blocking=True)`` must
not be read, and the source of a non-blocking upload must not be
written, on any path before one.
"""
import numpy as np
import torch


def early_read(out):
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    peek = host.numpy()  # LINT: torch-donated-after-use
    done.synchronize()
    return peek


def synced_read(out):
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return host.numpy()  # after the synchronize: clean


def handed_off(out):
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done  # ownership moves with the event: clean


def staging_reuse(buf, dev, blocks):
    d = buf.to(dev, non_blocking=True)
    buf[0] = 7  # LINT: torch-donated-after-use
    torch.cuda.synchronize()
    buf.zero_()  # after the synchronize: clean
    return d


def branch_read(out, flag):
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    if flag:
        torch.cuda.current_stream().synchronize()
        return bytes(host.numpy())  # synchronized on this branch: clean
    return np.asarray(host)  # LINT: torch-donated-after-use


def blocking_copy(out):
    host = torch.empty(out.shape, dtype=out.dtype)
    host.copy_(out)  # a blocking copy: nothing is handed away
    return host.numpy()
