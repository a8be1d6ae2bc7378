"""AIJ — the core sparse matrix format, ELL-packed.

The reference's foundational format is CSR ("SeqAIJ",
src/mat/impls/aij/seq/aij.c — MatMult_SeqAIJ :1173 is THE hot kernel).
A CSR row loop with variable row lengths maps poorly onto fixed-shape
XLA programs, so the device layout here is ELLPACK: every row padded to a
fixed width K (cols[n,K], vals[n,K]); SpMV is a dense gather + multiply
+ row-sum that XLA tiles cleanly. This is the same evolution the
reference itself started with its AIJPERM/AIJCRL constant-row-length
formats (src/mat/impls/aij/seq/{csrperm,crl}) — ELL is their natural
endpoint.

Padding convention: col = 0, val = 0 (padding contributes 0·x[0]).

Host-side (numpy/scipy) sparse work — symbolic factorization, orderings,
SpGEMM planning — operates on scipy CSR; converters below bridge the two.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class AIJ:
    """ELL-packed general sparse matrix (device-resident).

    cols : int32 [m, K]  column index per slot (0 for padding)
    vals : float [m, K]  value per slot (0 for padding)
    shape: (m, n) static
    nnz  : static true nonzero count (for flop accounting)
    """

    cols: jax.Array
    vals: jax.Array
    shape: tuple = field(metadata=dict(static=True))
    nnz: int = field(metadata=dict(static=True), default=0)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def ell_width(self) -> int:
        return self.cols.shape[1]

    # -- core ops (jit-safe) ----------------------------------------------
    def mult(self, x: jax.Array) -> jax.Array:
        """y = A x  (MatMult analog). Gather + fma + row reduce."""
        return jnp.sum(self.vals * x[self.cols], axis=1)

    def mult_add(self, x: jax.Array, y: jax.Array) -> jax.Array:
        """y + A x (MatMultAdd)."""
        return y + self.mult(x)

    def multT(self, x: jax.Array) -> jax.Array:
        """y = Aᵀ x (MatMultTranspose): scatter-add into columns."""
        contrib = (self.vals * x[:, None]).ravel()
        return jnp.zeros(self.shape[1], self.vals.dtype).at[self.cols.ravel()].add(contrib)

    def diagonal(self) -> jax.Array:
        """MatGetDiagonal. Padding (col 0, val 0) cannot corrupt row 0's sum."""
        m = self.shape[0]
        rows = jnp.arange(m, dtype=self.cols.dtype)[:, None]
        return jnp.sum(jnp.where(self.cols == rows, self.vals, 0), axis=1)

    def scale(self, a) -> "AIJ":
        return AIJ(self.cols, self.vals * a, self.shape, self.nnz)

    def diag_scale(self, left=None, right=None) -> "AIJ":
        """MatDiagonalScale: A ← diag(left) A diag(right)."""
        v = self.vals
        if right is not None:
            v = v * right[self.cols]
        if left is not None:
            v = v * left[:, None]
        return AIJ(self.cols, v, self.shape, self.nnz)

    def shift_diag(self, a) -> "AIJ":
        """A ← A + a·I, assuming the diagonal exists in the pattern
        (true for every format built with explicit diagonal; the
        reference's MatShift has the same fast path)."""
        m = self.shape[0]
        rows = jnp.arange(m, dtype=self.cols.dtype)[:, None]
        on_diag = self.cols == rows
        # only shift the FIRST diagonal slot of each row
        first = on_diag & (jnp.cumsum(on_diag, axis=1) == 1)
        return AIJ(self.cols, jnp.where(first, self.vals + a, self.vals),
                   self.shape, self.nnz)

    def rows_sum(self) -> jax.Array:
        return jnp.sum(self.vals, axis=1)

    # -- SpMM: sparse times dense ------------------------------------------
    def mult_dense(self, X: jax.Array) -> jax.Array:
        """Y = A X for dense X [n, k]: gathers X rows then contracts."""
        gathered = X[self.cols]            # [m, K, k]
        return jnp.einsum("mK,mKk->mk", self.vals, gathered)

    def flops_per_mult(self) -> float:
        """Reference flop convention 2*nnz - nrows (aij.c:1219)."""
        return 2.0 * self.nnz - self.shape[0]


# ---- host converters ---------------------------------------------------------
def aij_pack(A, dtype=None, min_width: int = 1):
    """Host-side ELL pack: (cols int32 [m,K], vals [m,K], shape, nnz).
    Lets callers pack the device transfers into few buffers
    (pc/mg.PackedMGPC) instead of paying per-array RPC latency."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    A.sum_duplicates()
    m, n = A.shape
    row_nnz = np.diff(A.indptr)
    K = max(int(row_nnz.max()) if m > 0 else 0, min_width)
    cols = np.zeros((m, K), dtype=np.int32)
    vals = np.zeros((m, K), dtype=dtype or A.dtype)
    for_rows = np.arange(m)
    # vectorized ELL pack: slot index within each row
    slot = np.arange(A.nnz) - np.repeat(A.indptr[:-1], row_nnz)
    rows_expanded = np.repeat(for_rows, row_nnz)
    cols[rows_expanded, slot] = A.indices
    vals[rows_expanded, slot] = A.data.astype(vals.dtype)
    return cols, vals, (m, n), int(A.nnz)


def aij_from_scipy(A, dtype=None, min_width: int = 1) -> AIJ:
    """Build a device AIJ from any scipy.sparse matrix."""
    cols, vals, shape, nnz = aij_pack(A, dtype=dtype, min_width=min_width)
    return AIJ(jnp.asarray(cols), jnp.asarray(vals), shape, nnz)


def aij_from_dense(M, tol: float = 0.0, dtype=None) -> AIJ:
    import scipy.sparse as sp

    M = np.asarray(M)
    M = np.where(np.abs(M) > tol, M, 0.0)
    return aij_from_scipy(sp.csr_matrix(M), dtype=dtype)


def aij_to_scipy(A: AIJ):
    """Back to scipy CSR (drops explicit padding zeros)."""
    import scipy.sparse as sp

    cols = np.asarray(A.cols)
    vals = np.asarray(A.vals)
    m, K = cols.shape
    rows = np.repeat(np.arange(m), K)
    mask = vals.ravel() != 0
    coo = sp.coo_matrix((vals.ravel()[mask], (rows[mask], cols.ravel()[mask])),
                        shape=A.shape)
    return coo.tocsr()
