"""Product-matrix MSR regenerating code construction (d = 2k-2).

Implements the minimum-storage-regenerating (MSR) point of the
product-matrix framework of Rashmi, Shah & Kumar ("Optimal
Exact-Regenerating Codes for Distributed Storage at the MSR and MBR
Points via a Product-Matrix Construction"; PAPERS "Fast Product-Matrix
Regenerating Codes" is the systems treatment this module follows):

* every node stores alpha = k-1 sub-chunks; the B = k*(k-1) message
  symbols fill two symmetric alpha x alpha matrices S1, S2 and node i
  stores ``psi_i^T @ [S1; S2]`` where ``psi_i = [phi_i | lam_i^alpha
  phi_i]`` and ``phi_i = (1, lam_i, ..., lam_i^(alpha-1))``;
* a lost node f is regenerated from ANY d = 2k-2 survivors, each
  contributing ONE sub-chunk worth (beta = chunk/alpha bytes): the dot
  of its alpha stored sub-chunks with ``phi_f`` -- so repair moves
  d*beta = 2*chunk bytes instead of k*chunk (ratio 2/k);
* because B = k*alpha exactly, the code LINEARIZES: stacking the k data
  nodes' sub-chunks gives an invertible kα x kα map from the free
  symbols, so the whole code collapses to ONE systematic GF(2^8)
  generator ``G`` over *virtual rows* (node i's sub-chunk j = virtual
  row i*alpha+j).  Encode/decode/repair are then all plain GF matmuls
  -- exactly the shape `ops/pipeline.py` batches on device.

Everything here is host-side construction (numpy over ``ops/gf.py``);
the device dispatch lives in ``plugins/regen.py``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ceph_tpu_torch.ops.gf import gf


def _select_points(field, n: int, alpha: int) -> List[int]:
    """n evaluation points whose alpha-th powers are pairwise distinct
    (the product-matrix MSR admissibility condition: Lambda's diagonal
    entries must differ; distinct lam^alpha implies distinct lam).  In
    GF(2^8)* the alpha-th powers form a subgroup of index gcd(255,
    alpha), so 255/gcd(255, alpha) nonzero points exist, plus zero."""
    points: List[int] = []
    seen_pow = set()
    for x in range(field.order):
        p = field_pow(field, x, alpha)
        if p in seen_pow:
            continue
        seen_pow.add(p)
        points.append(x)
        if len(points) == n:
            return points
    raise ValueError(
        f"only {len(points)} evaluation points with distinct "
        f"alpha-th powers exist in GF(2^{field.w}) for alpha={alpha}; "
        f"need n={n}"
    )


def field_pow(field, x: int, e: int) -> int:
    """x**e in the field (log/exp when available, square-multiply else)."""
    if e == 0:
        return 1
    if x == 0:
        return 0
    r = 1
    base = x
    while e:
        if e & 1:
            r = field.mul(r, base)
        base = field.mul(base, base)
        e >>= 1
    return r


class ProductMatrixMSR:
    """The construction for one (k, m) pool: n = k+m nodes, d = 2k-2.

    Exposes the three matrices the codec and the repair lane need:

    * :attr:`generator` -- (m*alpha, k*alpha) systematic generator over
      virtual rows (parity virtual rows from data virtual rows);
    * :meth:`repair_coeffs` -- phi_f, the alpha GF coefficients EVERY
      helper applies to its own sub-chunks (depends only on the lost
      node, so one wire-carried vector covers the whole helper set);
    * :meth:`repair_matrix` -- R_f, the (alpha, d) matrix regenerating
      the lost node's content from the d stacked helper symbols
      (depends on the helper set; cached by the caller per signature).
    """

    def __init__(self, k: int, m: int, w: int = 8):
        if w != 8:
            raise ValueError(f"product-matrix MSR supports w=8, not w={w}")
        if k < 2:
            raise ValueError(f"k={k} must be >= 2")
        if m < k - 1:
            raise ValueError(
                f"m={m} must be >= k-1={k - 1} so d=2k-2 helpers exist "
                f"among the n-1 survivors"
            )
        self.k, self.m, self.w = k, m, w
        self.n = k + m
        self.alpha = k - 1
        self.d = 2 * k - 2
        self.B = k * self.alpha
        self._field = gf(w)
        self._lam = _select_points(self._field, self.n, self.alpha)
        self._lam_alpha = [
            field_pow(self._field, x, self.alpha) for x in self._lam
        ]
        #: phi_i = (1, lam_i, ..., lam_i^(alpha-1)) per node, (n, alpha)
        self._phi = np.array(
            [[field_pow(self._field, x, j) for j in range(self.alpha)]
             for x in self._lam],
            dtype=np.uint32,
        )
        self.generator = self._build_generator()
        self._repair_cache: Dict[Tuple[int, Tuple[int, ...]], np.ndarray] = {}

    # -- construction ------------------------------------------------------

    def _free_symbol_index(self) -> Dict[Tuple[int, int, int], int]:
        """Map (matrix 0/1, row, col) of S1/S2 to its free-symbol slot
        (upper triangle incl. diagonal; symmetry folds the rest)."""
        idx: Dict[Tuple[int, int, int], int] = {}
        slot = 0
        for which in (0, 1):
            for i in range(self.alpha):
                for j in range(i, self.alpha):
                    idx[(which, i, j)] = slot
                    idx[(which, j, i)] = slot
                    slot += 1
        assert slot == self.B
        return idx

    def _node_rows(self, node: int, idx) -> np.ndarray:
        """A_i: node ``node``'s alpha stored sub-chunks as linear forms
        over the B free symbols -- sub-chunk j = sum_t phi[t]*S1[t,j] +
        lam^alpha * sum_t phi[t]*S2[t,j]."""
        field = self._field
        rows = np.zeros((self.alpha, self.B), dtype=np.uint32)
        la = self._lam_alpha[node]
        for j in range(self.alpha):
            for t in range(self.alpha):
                c = int(self._phi[node, t])
                rows[j, idx[(0, t, j)]] ^= c
                rows[j, idx[(1, t, j)]] ^= field.mul(la, c)
        return rows

    def _build_generator(self) -> np.ndarray:
        field = self._field
        idx = self._free_symbol_index()
        blocks = [self._node_rows(i, idx) for i in range(self.n)]
        a_data = np.vstack(blocks[: self.k])  # (k*alpha, B), B == k*alpha
        a_parity = np.vstack(blocks[self.k:])  # (m*alpha, B)
        try:
            inv = field.mat_invert(a_data)
        except np.linalg.LinAlgError as e:  # pragma: no cover
            raise ValueError(
                f"product-matrix data block singular for k={self.k} "
                f"m={self.m} (bad evaluation points)"
            ) from e
        return field.mat_mul(a_parity, inv).astype(np.uint32)

    # -- repair algebra ----------------------------------------------------

    def repair_coeffs(self, lost: int) -> List[int]:
        """phi_f: the coefficients every helper dots its own alpha
        sub-chunks with (identical across helpers -- only the LOST node
        determines them, which is what lets one wire field serve the
        whole corked read burst)."""
        if not 0 <= lost < self.n:
            raise ValueError(f"lost={lost} out of range for n={self.n}")
        return [int(c) for c in self._phi[lost]]

    def repair_matrix(self, lost: int,
                      helpers: Sequence[int]) -> np.ndarray:
        """R_f: (alpha, d) over GF(2^8); lost content = R_f @ stacked
        helper symbols (helpers in the given order).  Derivation: the d
        helpers stack to ``Psi_D @ (M phi_f)`` with Psi_D invertible
        (Vandermonde, distinct lam), and by S1/S2 symmetry the lost
        row is ``[I | lam_f^alpha I] @ (M phi_f)``."""
        helpers = tuple(int(h) for h in helpers)
        if len(helpers) != self.d:
            raise ValueError(
                f"regeneration needs exactly d={self.d} helpers, "
                f"got {len(helpers)}"
            )
        if lost in helpers:
            raise ValueError(f"lost node {lost} cannot be its own helper")
        if len(set(helpers)) != self.d:
            raise ValueError(f"duplicate helpers: {helpers}")
        for h in helpers:
            if not 0 <= h < self.n:
                raise ValueError(f"helper {h} out of range for n={self.n}")
        key = (int(lost), helpers)
        cached = self._repair_cache.get(key)
        if cached is not None:
            return cached
        field = self._field
        psi = np.zeros((self.d, self.d), dtype=np.uint32)
        for r, h in enumerate(helpers):
            psi[r, : self.alpha] = self._phi[h]
            la = self._lam_alpha[h]
            for j in range(self.alpha):
                psi[r, self.alpha + j] = field.mul(la, int(self._phi[h, j]))
        psi_inv = field.mat_invert(psi)
        sel = np.zeros((self.alpha, self.d), dtype=np.uint32)
        la_f = self._lam_alpha[lost]
        for j in range(self.alpha):
            sel[j, j] = 1
            sel[j, self.alpha + j] = la_f
        rf = field.mat_mul(sel, psi_inv).astype(np.uint32)
        self._repair_cache[key] = rf
        return rf
