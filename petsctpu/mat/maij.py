"""MAIJ — multi-DOF wrapper A ⊗ I_dof over a scalar AIJ.

Reference: src/mat/impls/maij (MATMAIJ: applies a scalar matrix to each
of `dof` interleaved components — used by DMDA interpolation with
dof > 1 so only the scalar interpolation stencil is stored). Device
mapping: the interleaved multi-DOF multiply IS the scalar matrix's
SpMM over a [n, dof] right-hand side — a strictly better-shaped kernel
(row-sum over dense [K, dof] tiles) than dof separate SpMVs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class MAIJ:
    """y = (A ⊗ I_dof) x on interleaved storage x[node*dof + c]."""

    A: object                       # scalar operator with mult_dense/multT
    dof: int = field(metadata=dict(static=True), default=1)

    @property
    def shape(self):
        m, n = self.A.shape
        return (m * self.dof, n * self.dof)

    @property
    def dtype(self):
        return self.A.dtype

    def mult(self, x: jax.Array) -> jax.Array:
        X = x.reshape(-1, self.dof)
        return self.A.mult_dense(X).reshape(-1)

    def multT(self, x: jax.Array) -> jax.Array:
        X = x.reshape(-1, self.dof)
        cols = jax.vmap(self.A.multT, in_axes=1, out_axes=1)(X)
        return cols.reshape(-1)

    def flops_per_mult(self) -> float:
        f = getattr(self.A, "flops_per_mult", lambda: 0.0)()
        return f * self.dof
