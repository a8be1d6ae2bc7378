"""DiaMat — general diagonal-offset (DIA) storage for banded matrices.

Rationale: a diagonal layout has NO index arrays — every diagonal is a
contiguous stream multiplied against a shifted read of x — so it
trades the gather of nnz values for streaming D·n values, where RCM
banding fills the band with D ≈ 2·bandwidth diagonals. Whether that
trade wins depends on the device's gather cost; a benchmark cell
decides. This is the reference's AIJPERM/CRL "regularize the layout"
idea (src/mat/impls/aij/seq/{csrperm,crl}) pushed to its endpoint,
generalizing StencilMat (mat/stencil.py)
from grid stencils to arbitrary banded matrices.

Recipe for an irregular matrix A:
    perm = get_ordering(A, "rcm")
    D, fill = dia_fill(A, perm)           # check band compressibility
    Ad = dia_from_scipy(A, perm=perm)     # solve in permuted space
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DiaMat:
    """coeffs[d, i] = A[i, i + offsets[d]] (zero where out of range)."""

    coeffs: jax.Array                                    # [D, n]
    offsets: tuple = field(metadata=dict(static=True))   # D ints
    shape: tuple = field(metadata=dict(static=True))
    nnz: int = field(metadata=dict(static=True), default=0)

    @property
    def dtype(self):
        return self.coeffs.dtype

    def _shift(self, x, off):
        n = x.shape[0]
        if off == 0:
            return x
        if off > 0:
            return jnp.pad(x, (0, off))[off:off + n]
        return jnp.pad(x, (-off, 0))[:n]

    def mult(self, x: jax.Array) -> jax.Array:
        y = jnp.zeros_like(x)
        for d, off in enumerate(self.offsets):
            y = y + self.coeffs[d] * self._shift(x, int(off))
        return y

    def mult_add(self, x, y):
        return y + self.mult(x)

    def multT(self, x: jax.Array) -> jax.Array:
        y = jnp.zeros_like(x)
        for d, off in enumerate(self.offsets):
            y = y + self._shift(self.coeffs[d] * x, -int(off))
        return y

    def diagonal(self) -> jax.Array:
        for d, off in enumerate(self.offsets):
            if off == 0:
                return self.coeffs[d]
        return jnp.zeros(self.shape[0], self.dtype)

    def rows_sum(self) -> jax.Array:
        return jnp.sum(self.coeffs, axis=0)

    def flops_per_mult(self) -> float:
        return 2.0 * self.nnz - self.shape[0]

    def traffic_per_mult(self) -> float:
        """Bytes streamed per apply (the roofline denominator)."""
        D, n = self.coeffs.shape
        return (D + 2.0) * n * self.coeffs.dtype.itemsize


def dia_fill(A, perm=None) -> tuple:
    """(ndiags, fill_ratio) the DIA conversion would produce."""
    A = sp.csr_matrix(A)
    if perm is not None:
        A = A[perm][:, perm]
    d = sp.dia_matrix(A)
    D = len(d.offsets)
    return D, D * A.shape[0] / max(A.nnz, 1)


def dia_from_scipy(A, dtype=None, perm=None, max_fill: float = 64.0
                   ) -> DiaMat:
    """Convert (optionally permuted) A to DIA. Raises when the band
    fill exceeds max_fill — the caller should stay on ELL then."""
    A = sp.csr_matrix(A)
    if perm is not None:
        perm = np.asarray(perm)
        A = A[perm][:, perm]
    n = A.shape[0]
    d = sp.dia_matrix(A)
    D = len(d.offsets)
    if D * n > max_fill * max(A.nnz, 1):
        raise ValueError(f"DIA fill {D * n / max(A.nnz, 1):.1f}x exceeds "
                         f"max_fill={max_fill}; keep ELL for this matrix")
    # scipy dia stores data[d, j] = A[j - off, j]; we want row-indexed
    coeffs = np.zeros((D, n), dtype or d.data.dtype)
    Ac = A.tocoo()
    offmap = {int(o): k for k, o in enumerate(d.offsets)}
    offs_of = Ac.col - Ac.row
    for r, c, v in zip(Ac.row, Ac.col, Ac.data):
        coeffs[offmap[int(c - r)], r] = v
    return DiaMat(jnp.asarray(coeffs), tuple(int(o) for o in d.offsets),
                  (n, n), int(A.nnz))
