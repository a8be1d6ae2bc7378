"""RectBandMat — slant-band storage for rectangular operators whose
columns advance at a (near-)constant integer rate per row.

The MG restriction R = Pᵀ is the motivating case (reference: MatRestrict
→ MatMultTranspose on the stored MPIAIJ prolongator, mg.c): after
GAMG's locality-preserving aggregate numbering (pc/gamg.py), coarse row
j's nonzero columns sit in a window [s·j + e_j, s·j + e_j + w) of the
fine vector with s ≈ n_fine/n_coarse and a small spread of e_j.  Folding
e_j into the coefficient layout at plan time gives a dense band
B[j, d] = R[j, s·j + off + d], and

    (R r)[j] = Σ_d B[j, d] · r[s·j + off + d]

where the operand window r[s·j + off + d] is assembled from
ceil(W/s)+1 STATIC strided reshapes of r — no gather instructions at
all, in place of the scalar gathers of an ELL restriction.  (The
square-operator analog is mat/band.py; this
generalizes it to rectangular slope-s operators.)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class RectBandMat:
    """B[j, d] = A[j, s*j + off + d]; zero where out of range."""

    B: jax.Array                                        # [m, W]
    s: int = field(metadata=dict(static=True))          # column slope
    off: int = field(metadata=dict(static=True))        # window offset
    shape: tuple = field(metadata=dict(static=True))
    nnz: int = field(metadata=dict(static=True), default=0)

    @property
    def dtype(self):
        return self.B.dtype

    def _window(self, x):
        m, W = self.B.shape
        s = self.s
        nseg = -(-W // s) + 1
        pad0 = max(0, -self.off)
        need = pad0 + self.off + nseg * s + s * m
        xp = jnp.concatenate([
            jnp.zeros((pad0,), x.dtype), x,
            jnp.zeros((max(0, need - pad0 - x.shape[0]),), x.dtype)])
        segs = [jax.lax.slice(xp, (pad0 + self.off + k * s,),
                              (pad0 + self.off + k * s + s * m,))
                .reshape(m, s) for k in range(nseg)]
        return jnp.concatenate(segs, axis=1)[:, :W]

    def mult(self, x: jax.Array) -> jax.Array:
        return jnp.sum(self.B * self._window(x.astype(self.dtype)),
                       axis=1)

    def mult_add(self, x, y):
        return y + self.mult(x)

    def flops_per_mult(self) -> float:
        return 2.0 * self.nnz - self.shape[0]


def rectband_plan(A: sp.csr_matrix):
    """(s, off, W) minimizing the band width, or None if degenerate."""
    A = sp.csr_matrix(A)
    m, n = A.shape
    rows_nnz = np.diff(A.indptr)
    if m == 0 or A.nnz == 0 or rows_nnz.min() == 0:
        return None
    j = np.arange(m)
    lo = A.indices[A.indptr[:-1]].astype(np.int64)
    hi = A.indices[A.indptr[1:] - 1].astype(np.int64)
    best = None
    for s in {max(1, n // m), max(1, -(-n // m))}:
        off = int((lo - s * j).min())
        W = int((hi - s * j).max()) - off + 1
        if best is None or W < best[2]:
            best = (s, off, W)
    return best


def rectband_from_scipy(A, dtype=None, max_fill: float = 8.0):
    """Build a RectBandMat, or return None when the slant-band fill
    (m*W/nnz) exceeds max_fill (caller falls back to another format)."""
    A = sp.csr_matrix(A)
    A.sum_duplicates()
    A.sort_indices()
    plan = rectband_plan(A)
    if plan is None:
        return None
    s, off, W = plan
    m = A.shape[0]
    if m * W > max_fill * max(A.nnz, 1):
        return None
    dt = np.dtype(dtype or A.dtype).type
    B = np.zeros((m, W), dt)
    coo = A.tocoo()
    d = coo.col.astype(np.int64) - s * coo.row.astype(np.int64) - off
    B[coo.row, d] = coo.data.astype(dt)
    return RectBandMat(jnp.asarray(B), s, off,
                       (m, A.shape[1]), int(A.nnz))
