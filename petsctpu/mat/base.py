"""Implicit-operator wrappers (matrix-free composition).

The reference has a family of wrapper Mat types — MATSHELL (user
callback), MATTRANSPOSE, MATNORMAL (AᵀA implicit), MATCOMPOSITE (ΣAᵢ or
product), MATLRC (A + U C Vᵀ) — see src/mat/impls/{shell,transpose,
normal,composite,lrc} and SURVEY.md §2.3. Here these are just pytree
dataclasses whose `mult` composes other operators' `mult`; XLA fuses
the arithmetic, so implicit operators are essentially free.

Any object with `.shape` and `.mult(x)` is an operator; `.multT(x)` is
optional. Solvers are generic over this protocol.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Shell:
    """User-callback operator (MATSHELL, src/mat/impls/shell).

    `mult_fn(ctx, x)` — ctx is an arbitrary pytree of arrays.
    """

    ctx: Any
    mult_fn: Callable = field(metadata=dict(static=True))
    shape: tuple = field(metadata=dict(static=True))
    multT_fn: Optional[Callable] = field(metadata=dict(static=True), default=None)
    diag_fn: Optional[Callable] = field(metadata=dict(static=True), default=None)

    def mult(self, x):
        return self.mult_fn(self.ctx, x)

    def multT(self, x):
        if self.multT_fn is None:
            raise NotImplementedError("Shell operator has no multT_fn")
        return self.multT_fn(self.ctx, x)

    def diagonal(self):
        if self.diag_fn is None:
            raise NotImplementedError("Shell operator has no diag_fn")
        return self.diag_fn(self.ctx)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Transpose:
    """Implicit Aᵀ (MATTRANSPOSE)."""

    A: Any

    @property
    def shape(self):
        return (self.A.shape[1], self.A.shape[0])

    def mult(self, x):
        return self.A.multT(x)

    def multT(self, x):
        return self.A.mult(x)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Normal:
    """Implicit AᵀA (MATNORMAL, src/mat/impls/normal)."""

    A: Any

    @property
    def shape(self):
        n = self.A.shape[1]
        return (n, n)

    def mult(self, x):
        return self.A.multT(self.A.mult(x))

    multT = mult


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class NormalHermitian:
    """Implicit AAᵀ."""

    A: Any

    @property
    def shape(self):
        m = self.A.shape[0]
        return (m, m)

    def mult(self, x):
        return self.A.mult(self.A.multT(x))

    multT = mult


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ShiftScale:
    """alpha·A + beta·I, implicit (covers MatShift/MatScale composition)."""

    A: Any
    alpha: jax.Array
    beta: jax.Array

    @property
    def shape(self):
        return self.A.shape

    def mult(self, x):
        return self.alpha * self.A.mult(x) + self.beta * x

    def multT(self, x):
        return self.alpha * self.A.multT(x) + self.beta * x

    def diagonal(self):
        return self.alpha * self.A.diagonal() + self.beta


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Composite:
    """Sum or product of operators (MATCOMPOSITE, src/mat/impls/composite)."""

    ops: Tuple
    mode: str = field(metadata=dict(static=True), default="additive")

    @property
    def shape(self):
        if self.mode == "additive":
            return self.ops[0].shape
        return (self.ops[0].shape[0], self.ops[-1].shape[1])

    def mult(self, x):
        if self.mode == "additive":
            y = self.ops[0].mult(x)
            for op in self.ops[1:]:
                y = y + op.mult(x)
            return y
        # multiplicative: A1·A2·…·Ak x applied right-to-left
        y = x
        for op in reversed(self.ops):
            y = op.mult(y)
        return y


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class LRC:
    """Low-rank correction A + U C Vᵀ, implicit (MATLRC, src/mat/impls/lrc)."""

    A: Any
    U: jax.Array  # [m, k]
    C: jax.Array  # [k, k]
    V: jax.Array  # [n, k]

    @property
    def shape(self):
        return self.A.shape

    def mult(self, x):
        return self.A.mult(x) + self.U @ (self.C @ (self.V.T @ x))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Diagonal:
    """diag(d) as an operator."""

    d: jax.Array

    @property
    def shape(self):
        n = self.d.shape[0]
        return (n, n)

    def mult(self, x):
        return self.d * x

    multT = mult

    def diagonal(self):
        return self.d


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Identity:
    """I (useful as a trivial PC / operator)."""

    shape: tuple = field(metadata=dict(static=True))

    def mult(self, x):
        return x

    multT = mult

    def apply(self, x):  # usable directly as PCNone
        return x


def csr_submatrix_keep_zeros(A, rows, cols):
    """A[rows][:, cols] PRESERVING explicitly-stored zeros.

    scipy's fancy-indexed extraction is selection-matrix matmul, which
    prunes stored zeros — but the reference's MatGetSubMatrix keeps
    them, and pattern-sensitive consumers (ILU(0)/ICC of fieldsplit/
    ASM blocks) factor on the FULL stored pattern: snes ex19's
    fieldsplit_0 ILU runs on the 576-entry DMDA-preallocated pattern,
    not the 136 true nonzeros, and the monitor digits differ by ~3%
    between the two."""
    import numpy as np
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    colmap = np.full(A.shape[1], -1, dtype=np.int64)
    colmap[cols] = np.arange(cols.size)
    out_indptr = np.zeros(rows.size + 1, dtype=np.int64)
    out_ind = []
    out_val = []
    for k, r in enumerate(rows):
        s, e = A.indptr[r], A.indptr[r + 1]
        cj = colmap[A.indices[s:e]]
        keep = cj >= 0
        cjk = cj[keep]
        vk = A.data[s:e][keep]
        order = np.argsort(cjk, kind="stable")
        out_ind.append(cjk[order])
        out_val.append(vk[order])
        out_indptr[k + 1] = out_indptr[k] + cjk.size
    ind = (np.concatenate(out_ind) if out_ind
           else np.zeros(0, np.int64))
    val = (np.concatenate(out_val) if out_val
           else np.zeros(0, A.dtype))
    return sp.csr_matrix((val, ind, out_indptr),
                         shape=(rows.size, cols.size))


def mat_zero_rows(A, rows, diag=1.0):
    """MatZeroRows_SeqAIJ (aij.c:1642) default semantics: each listed
    row is COMPRESSED to just its diagonal entry (value `diag`) —
    without MAT_KEEP_NONZERO_PATTERN the off-diagonal slots are
    removed from the pattern, which changes downstream ILU(0)/ICC
    fill. Returns a new scipy CSR."""
    import numpy as np
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    rows = np.unique(np.asarray(rows, dtype=np.int64))
    mask = np.zeros(A.shape[0], bool)
    mask[rows] = True
    row_of = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    keep = ~mask[row_of]
    lil_rows = []
    new_indptr = np.zeros(A.shape[0] + 1, np.int64)
    counts = np.bincount(row_of[keep], minlength=A.shape[0])
    counts[rows] = 1
    new_indptr[1:] = np.cumsum(counts)
    nnz = int(new_indptr[-1])
    ind = np.empty(nnz, A.indices.dtype)
    val = np.empty(nnz, A.dtype)
    # fill kept rows wholesale, BC rows with the single diagonal
    src = 0
    for r in range(A.shape[0]):
        s, e = new_indptr[r], new_indptr[r + 1]
        if mask[r]:
            ind[s] = r
            val[s] = diag
        else:
            a, b = A.indptr[r], A.indptr[r + 1]
            ind[s:e] = A.indices[a:b]
            val[s:e] = A.data[a:b]
    return sp.csr_matrix((val, ind, new_indptr), shape=A.shape)


def mat_axpy(Y, a, X, structure: str = "different"):
    """MatAXPY (src/mat/utils/axpy.c): Y ← Y + a·X as host scipy CSR.

    structure:
      "same"      — X's pattern must be a subset of Y's; values land in
                    Y's existing slots (pattern unchanged).
      "subset"    — alias of "same" (SUBSET_NONZERO_PATTERN).
      "different" — union pattern (DIFFERENT_NONZERO_PATTERN); slots
                    present in either operand are stored even when the
                    sum cancels to zero (factorization patterns see
                    the union, as in the reference).
    """
    import numpy as np
    import scipy.sparse as sp

    Y = sp.csr_matrix(Y, copy=True)
    X = sp.csr_matrix(X)
    if structure in ("same", "subset"):
        Yl = Y.tolil()
        Xc = X.tocoo()
        for r, c, v in zip(Xc.row, Xc.col, Xc.data):
            Yl[r, c] = Yl[r, c] + a * v
        out = Yl.tocsr()
        out.sort_indices()
        return out
    # union pattern with explicit zeros kept: carry indicator matrices
    ones_Y = sp.csr_matrix((np.ones_like(Y.data), Y.indices, Y.indptr),
                           shape=Y.shape)
    ones_X = sp.csr_matrix((np.ones_like(X.data), X.indices, X.indptr),
                           shape=X.shape)
    pat = (ones_Y + ones_X).tocsr()
    pat.sort_indices()
    S = Y + a * X
    S = sp.csr_matrix(S)
    S.sort_indices()
    # spread S's values onto pat's (superset) slots
    out_data = np.zeros(pat.nnz, dtype=S.dtype)
    for i in range(pat.shape[0]):
        ps, pe = pat.indptr[i], pat.indptr[i + 1]
        ss, se = S.indptr[i], S.indptr[i + 1]
        pos = np.searchsorted(pat.indices[ps:pe], S.indices[ss:se])
        out_data[ps + pos] = S.data[ss:se]
    return sp.csr_matrix((out_data, pat.indices, pat.indptr),
                         shape=Y.shape)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ScatterMat:
    """MATSCATTER (src/mat/impls/scatter): the matrix whose action IS
    a VecScatter — y[i] = x[idx[i]] for the stored index map (a 0/1
    selection matrix applied as a gather; MatMult_Scatter forwards to
    VecScatterBegin/End). multT is the scatter-reverse (ADD) — a
    scatter-add into the source layout."""

    idx: jax.Array          # int32 [m] source index of each output row
    shape: tuple = field(metadata=dict(static=True))

    def mult(self, x):
        return x[self.idx]

    def multT(self, y):
        n = self.shape[1]
        return jnp.zeros((n,), y.dtype).at[self.idx].add(y)

    def diagonal(self):
        m = min(self.shape)
        rows = jnp.arange(m)
        return jnp.where(self.idx[:m] == rows, 1.0, 0.0)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BlockMat:
    """MATBLOCKMAT (src/mat/impls/blockmat): a sparse block matrix
    whose nonzero blocks are themselves operators (usually sparse) —
    a sparse generalization of MATNEST. Stored as a static COO of
    (block-row, block-col, op); row/col offsets carry the (possibly
    ragged) block layout."""

    ops: tuple              # per stored block: any operator pytree
    bi: tuple = field(metadata=dict(static=True))   # block-row ids
    bj: tuple = field(metadata=dict(static=True))   # block-col ids
    row_offsets: tuple = field(metadata=dict(static=True))
    col_offsets: tuple = field(metadata=dict(static=True))

    @property
    def shape(self):
        return (self.row_offsets[-1], self.col_offsets[-1])

    def mult(self, x):
        y = jnp.zeros((self.shape[0],), x.dtype)
        for op, i, j in zip(self.ops, self.bi, self.bj):
            xs = x[self.col_offsets[j]:self.col_offsets[j + 1]]
            y = y.at[self.row_offsets[i]:self.row_offsets[i + 1]].add(
                op.mult(xs))
        return y

    def multT(self, x):
        y = jnp.zeros((self.shape[1],), x.dtype)
        for op, i, j in zip(self.ops, self.bi, self.bj):
            xs = x[self.row_offsets[i]:self.row_offsets[i + 1]]
            y = y.at[self.col_offsets[j]:self.col_offsets[j + 1]].add(
                op.multT(xs))
        return y

    def diagonal(self):
        d = jnp.zeros((self.shape[0],))
        for op, i, j in zip(self.ops, self.bi, self.bj):
            if i == j:
                d = d.at[self.row_offsets[i]:self.row_offsets[i + 1]] \
                    .set(op.diagonal())
        return d


def block_mat(blocks, row_sizes, col_sizes) -> BlockMat:
    """Build a BlockMat from {(i, j): op} + block layout sizes."""
    ro = (0,) + tuple(np.cumsum(row_sizes).tolist())
    co = (0,) + tuple(np.cumsum(col_sizes).tolist())
    items = sorted(blocks.items())
    return BlockMat(tuple(op for _, op in items),
                    tuple(i for (i, _), _ in items),
                    tuple(j for (_, j), _ in items), ro, co)


class LocalRef:
    """MATLOCALREF (src/mat/impls/localref): an assembly ALIAS into a
    parent matrix — values added through the local index maps land in
    the parent's global COO stream (MatSetValuesLocal forwarding; the
    reference wraps the parent's ops table, we wrap its builder)."""

    def __init__(self, parent_builder, rmap, cmap=None):
        self.parent = parent_builder        # has .add(rows, cols, vals)
        self.rmap = np.asarray(rmap, np.int64)
        self.cmap = (self.rmap if cmap is None
                     else np.asarray(cmap, np.int64))
        self.shape = (len(self.rmap), len(self.cmap))

    def add_values(self, rows, cols, vals) -> None:
        """MatSetValues on the reference frame → parent global adds."""
        self.parent.add(self.rmap[np.asarray(rows, np.int64)],
                        self.cmap[np.asarray(cols, np.int64)],
                        np.asarray(vals))
