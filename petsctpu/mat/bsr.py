"""BAIJ — blocked sparse (BSR) for multi-DOF-per-node PDEs.

The reference's SeqBAIJ/MPIBAIJ (src/mat/impls/baij — unrolled kernels
per block size, e.g. MatMult_SeqBAIJ_4 baij2.c:387) exist because dense
bs×bs blocks amortize index overhead. Here block SpMV is a batched
small-matrix contraction (einsum) over gathered x blocks, and
point-block Jacobi needs exactly these dense blocks.

Layout: block-ELL. brows = m/bs block rows padded to width K:
  cols [brows, K]       block-column indices
  vals [brows, K, bs, bs] dense blocks (row-major within block)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BAIJ:
    cols: jax.Array   # int32 [brows, K]
    vals: jax.Array   # [brows, K, bs, bs]
    shape: tuple = field(metadata=dict(static=True))   # scalar (m, n)
    bs: int = field(metadata=dict(static=True), default=1)
    nnz: int = field(metadata=dict(static=True), default=0)  # scalar nnz

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def brows(self):
        return self.cols.shape[0]

    def mult(self, x: jax.Array) -> jax.Array:
        """y = A x. x is a flat scalar vector [n]."""
        bs = self.bs
        xb = x.reshape(-1, bs)                       # [bcols, bs]
        g = xb[self.cols]                            # [brows, K, bs]
        yb = jnp.einsum("rkij,rkj->ri", self.vals, g)
        return yb.reshape(-1)

    def mult_add(self, x, y):
        return y + self.mult(x)

    def multT(self, x: jax.Array) -> jax.Array:
        bs = self.bs
        xb = x.reshape(-1, bs)                       # [brows, bs]
        contrib = jnp.einsum("rkij,ri->rkj", self.vals, xb)  # [brows, K, bs]
        ncb = self.shape[1] // bs
        out = jnp.zeros((ncb, bs), self.vals.dtype)
        out = out.at[self.cols.reshape(-1)].add(contrib.reshape(-1, bs))
        return out.reshape(-1)

    def diagonal(self) -> jax.Array:
        rows = jnp.arange(self.brows, dtype=self.cols.dtype)[:, None]
        mask = (self.cols == rows)[..., None, None]
        dblk = jnp.sum(jnp.where(mask, self.vals, 0), axis=1)  # [brows, bs, bs]
        return jnp.einsum("rii->ri", dblk).reshape(-1)

    def diag_blocks(self) -> jax.Array:
        """Dense bs×bs diagonal blocks [brows, bs, bs] (for PBJacobi)."""
        rows = jnp.arange(self.brows, dtype=self.cols.dtype)[:, None]
        mask = (self.cols == rows)[..., None, None]
        return jnp.sum(jnp.where(mask, self.vals, 0), axis=1)

    def flops_per_mult(self) -> float:
        return 2.0 * self.nnz - self.shape[0]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SellBAIJ:
    """BAIJ whose forward SpMV runs the scalar SellMat on the
    block-expanded pattern (fmt="sell").

    The reference's per-bs unrolled kernels (MatMult_SeqBAIJ_4,
    src/mat/impls/baij/seq/baij2.c:387) exist to amortize index loads
    over dense blocks; blocked structure also makes SELL's window
    buckets dense (low slop). Blocked metadata (diag blocks for
    PBJacobi, multT, SetValuesBlocked layouts) stays on the BAIJ
    side."""

    base: BAIJ
    sell: Any

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def shape(self):
        return self.base.shape

    @property
    def bs(self):
        return self.base.bs

    @property
    def nnz(self):
        return self.base.nnz

    @property
    def brows(self):
        return self.base.brows

    @property
    def cols(self):
        return self.base.cols

    @property
    def vals(self):
        return self.base.vals

    def mult(self, x):
        return self.sell.mult(x)

    def mult_add(self, x, y):
        return y + self.mult(x)

    def multT(self, x):
        return self.base.multT(x)

    def diagonal(self):
        return self.base.diagonal()

    def diag_blocks(self):
        return self.base.diag_blocks()

    def flops_per_mult(self):
        return self.base.flops_per_mult()


def baij_from_scipy_bsr(A, bs: int = None, dtype=None,
                        fmt: str = "auto"):
    """Build from scipy (any format); converts to BSR with block size
    bs. fmt="sell" wraps the forward SpMV in the scalar SellMat
    (fp32, raises when not viable); "auto" and "ell" keep the batched
    block-gather einsum route."""
    import scipy.sparse as sp

    if not sp.issparse(A):
        A = sp.csr_matrix(np.asarray(A))
    if bs is None and hasattr(A, "blocksize"):
        bs = A.blocksize[0]
    B = sp.bsr_matrix(A, blocksize=(bs, bs))
    B.sum_duplicates()
    brows = B.shape[0] // bs
    row_nnz = np.diff(B.indptr)
    K = max(int(row_nnz.max()) if brows > 0 else 0, 1)
    cols = np.zeros((brows, K), dtype=np.int32)
    vals = np.zeros((brows, K, bs, bs), dtype=dtype or B.dtype)
    slot = np.arange(B.indptr[-1]) - np.repeat(B.indptr[:-1], row_nnz)
    rr = np.repeat(np.arange(brows), row_nnz)
    cols[rr, slot] = B.indices
    vals[rr, slot] = B.data.astype(vals.dtype)
    scal_nnz = int((B.data != 0).sum())
    base = BAIJ(jnp.asarray(cols), jnp.asarray(vals), B.shape, bs,
                scal_nnz)
    f32 = np.dtype(dtype or B.dtype) == np.float32
    if fmt == "sell" and not f32:
        raise ValueError("fmt='sell' needs float32 (SellMat's dtype)")
    if fmt == "sell":
        from petsctpu.mat.sell import sell_from_scipy, sell_viable
        C = sp.csr_matrix(B).astype(np.float32)
        C.sum_duplicates()
        if not sell_viable(C):
            raise ValueError("fmt='sell': operator not SELL-viable")
        return SellBAIJ(base, sell_from_scipy(C))
    return base
