"""Dense matrix operator (SeqDense analog, src/mat/impls/dense).

A dense mult is a single matmul; factorizations use
jax.scipy/lax.linalg (LU/Cholesky), replacing the reference's
LAPACK dependency.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Dense:
    M: jax.Array

    @property
    def shape(self):
        return self.M.shape

    @property
    def dtype(self):
        return self.M.dtype

    # precision="highest": solver math (residuals, smoothers, Galerkin
    # products) needs full fp32, never reduced-precision products
    def mult(self, x):
        return jnp.dot(self.M, x, precision="highest")

    def mult_add(self, x, y):
        return y + self.mult(x)

    def multT(self, x):
        return jnp.dot(self.M.T, x, precision="highest")

    def diagonal(self):
        return jnp.diagonal(self.M)

    def mult_dense(self, X):
        return jnp.dot(self.M, X, precision="highest")
