"""SBAIJ — symmetric blocked sparse storage (upper triangle only).

Reference: src/mat/impls/sbaij/seq/sbaij.c (SeqSBAIJ: BSR storing only
the upper block triangle; MatMult applies U plus strict(U)ᵀ so storage
is halved for symmetric multi-DOF problems) and mpisbaij.c. Device layout:
block-ELL over block rows (like BAIJ, mat/bsr.py); the transpose
contribution is a scatter-add (segment-sum) over the stored slots.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SBAIJ:
    """Symmetric block-ELL: only block-upper-triangle slots stored.

    bcols : int32 [nb, K]       block-column per slot (own row = padding
                                convention uses the row itself with 0 vals)
    bvals : float [nb, K, bs, bs]
    shape : (n, n) static
    bs    : block size (static)
    nnzb  : true stored block count (static, for flops)
    """

    bcols: jax.Array
    bvals: jax.Array
    shape: tuple = field(metadata=dict(static=True))
    bs: int = field(metadata=dict(static=True), default=1)
    nnzb: int = field(metadata=dict(static=True), default=0)

    @property
    def dtype(self):
        return self.bvals.dtype

    @property
    def brows(self):
        return self.bvals.shape[0]

    def mult(self, x: jax.Array) -> jax.Array:
        bs = self.bs
        xb = x.reshape(-1, bs)                       # [nb, bs]
        gathered = xb[self.bcols]                    # [nb, K, bs]
        # upper-triangle part: y_b += Σ_k B[b,k] x[col]
        y = jnp.einsum("rkij,rkj->ri", self.bvals, gathered)
        # strict transpose part: y[col] += B[b,k]ᵀ x[b]  (col > b slots;
        # diagonal slots are masked out at construction via tvals=0)
        contrib = jnp.einsum("rkij,ri->rkj", self.bvals_strict, xb)
        y = y.at[self.bcols.reshape(-1)].add(
            contrib.reshape(-1, bs))
        return y.reshape(-1)

    @property
    def bvals_strict(self):
        """Off-diagonal stored blocks only (diagonal zeroed for the
        transpose pass)."""
        rows = jnp.arange(self.brows)[:, None]
        offdiag = (self.bcols != rows)[..., None, None]
        return jnp.where(offdiag, self.bvals, 0.0)

    multT = mult                                     # symmetric

    def diagonal(self) -> jax.Array:
        rows = jnp.arange(self.brows)[:, None]
        own = (self.bcols == rows)[..., None, None]
        D = jnp.sum(jnp.where(own, self.bvals, 0.0), axis=1)  # [nb,bs,bs]
        return jax.vmap(jnp.diag)(D).reshape(-1)

    def diag_blocks(self) -> jax.Array:
        rows = jnp.arange(self.brows)[:, None]
        own = (self.bcols == rows)[..., None, None]
        return jnp.sum(jnp.where(own, self.bvals, 0.0), axis=1)

    def flops_per_mult(self) -> float:
        # each stored off-diag block used twice, diag once
        return 2.0 * (2 * self.nnzb - self.brows) * self.bs * self.bs

    def rows_sum(self) -> jax.Array:
        """Row sums of the full (symmetrized) matrix."""
        s_up = jnp.sum(self.bvals, axis=(1, 3))          # [nb, bs]
        contrib = jnp.sum(self.bvals_strict, axis=2)     # [nb, K, bs] colsums
        s = s_up.at[self.bcols.reshape(-1)].add(
            contrib.reshape(-1, self.bs))
        return s.reshape(-1)


def sbaij_from_scipy(A, bs: int = 1, dtype=None, check_symmetry: bool = True
                     ) -> SBAIJ:
    """Build from a (symmetric) scipy matrix, keeping the upper block
    triangle (MatConvert to SBAIJ analog)."""
    A = sp.csr_matrix(A)
    n = A.shape[0]
    assert n % bs == 0 and A.shape[1] == n
    if check_symmetry:
        d = abs(A - A.T)
        if d.nnz and d.max() > 1e-12 * max(abs(A).max(), 1.0):
            raise ValueError("sbaij requires a symmetric matrix")
    Ab = sp.bsr_matrix(A, blocksize=(bs, bs))
    nb = n // bs
    indptr, indices, data = Ab.indptr, Ab.indices, Ab.data
    rows = [[] for _ in range(nb)]
    for r in range(nb):
        for k in range(indptr[r], indptr[r + 1]):
            c = indices[k]
            if c >= r:                      # upper triangle only
                rows[r].append((c, data[k]))
    K = max(1, max(len(r) for r in rows))
    bcols = np.zeros((nb, K), np.int32)
    bvals = np.zeros((nb, K, bs, bs), dtype or data.dtype)
    nnzb = 0
    for r in range(nb):
        for j, (c, blk) in enumerate(rows[r]):
            bcols[r, j] = c
            bvals[r, j] = blk
            nnzb += 1
        for j in range(len(rows[r]), K):
            bcols[r, j] = r                 # padding: own row, zero block
    return SBAIJ(jnp.asarray(bcols), jnp.asarray(bvals), (n, n), bs, nnzb)
