"""ISA-L-compatible matrix constructions (GF(2^8), poly 0x11D).

Mirrors the semantics of isa-l's gf_gen_rs_matrix / gf_gen_cauchy1_matrix as
used by the reference isa plugin (reference: src/erasure-code/isa/
ErasureCodeIsa.cc:383-386): full (k+m) x k systematic matrices with an
identity top block.  GF(2^8) with polynomial 0x11D is shared with jerasure's
w=8 field, so element values interoperate.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.ops.gf import gf


def gen_rs_matrix(k: int, m: int) -> np.ndarray:
    """(k+m) x k: identity on top; coding row r = [1, g, g^2, ...], g = 2^r.

    Matches isa-l gf_gen_rs_matrix(a, k+m, k).  Only guaranteed invertible for
    the parameter ranges the reference plugin enforces (k<=32, m<=4, and
    m==4 -> k<=21; reference: src/erasure-code/isa/ErasureCodeIsa.cc:322-363).
    """
    F = gf(8)
    A = np.zeros((k + m, k), dtype=np.uint32)
    for i in range(k):
        A[i, i] = 1
    gen = 1
    for r in range(m):
        p = 1
        for j in range(k):
            A[k + r, j] = p
            p = F.mul(p, gen)
        gen = F.mul(gen, 2)
    return A


def gen_cauchy1_matrix(k: int, m: int) -> np.ndarray:
    """(k+m) x k: identity on top; coding element [k+r, j] = inv((k+r) ^ j).

    Matches isa-l gf_gen_cauchy1_matrix.
    """
    F = gf(8)
    A = np.zeros((k + m, k), dtype=np.uint32)
    for i in range(k):
        A[i, i] = 1
    for r in range(m):
        for j in range(k):
            A[k + r, j] = F.inv((k + r) ^ j)
    return A
