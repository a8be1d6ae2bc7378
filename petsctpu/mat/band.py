"""BandMat — dense-tiled banded matrices (general irregular SpMV path).

The medium-size irregular matrices of the reference's own headline
benchmark (BAIJ bs=3 oil-reservoir system, src/benchmarks/results/
performance_medium) become BANDED after RCM: bandwidth B ~ sqrt(n).
A diagonal-by-diagonal DIA sum generates O(B) tiny kernels. This
format instead tiles the band into dense [T, T+2B] row blocks and
applies them as ONE batched einsum — XLA fuses everything, and x's
sliding windows are built from reshaped chunks (no gather anywhere).

    y[tT:(t+1)T] = tiles[t] @ x_padded[tT : tT + T + 2B]

Storage/traffic = n·(T+2B) values ≈ (1.5-2)× the band area — the
classic LAPACK gbmv layout, tiled for batched matmuls. Use for
banded/RCM-ordered systems with B up to a few thousand; keep ELL for
genuinely unbandable sparsity.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BandMat:
    tiles: jax.Array                                    # [nt, T, T+2B]
    bandwidth: int = field(metadata=dict(static=True), default=0)
    tile: int = field(metadata=dict(static=True), default=128)
    shape: tuple = field(metadata=dict(static=True), default=(0, 0))
    nnz: int = field(metadata=dict(static=True), default=0)

    @property
    def dtype(self):
        return self.tiles.dtype

    def _windows(self, x):
        """Sliding windows xw[t] = xp[tT : tT + W], W = T + 2B, built
        from reshaped chunks (pure reshapes/concats — no gather)."""
        T, B = self.tile, self.bandwidth
        nt = self.tiles.shape[0]
        W = T + 2 * B
        nchunks = -(-W // T) + 1
        xp = jnp.zeros(((nt + nchunks) * T,), x.dtype)
        xp = xp.at[B:B + x.shape[0]].set(x)
        Xe = xp.reshape(nt + nchunks, T)
        xw = jnp.concatenate([Xe[k:k + nt] for k in range(nchunks)], axis=1)
        return xw[:, :W]

    def mult(self, x: jax.Array) -> jax.Array:
        n = self.shape[0]
        xw = self._windows(x.reshape(-1))
        y = jnp.einsum("tij,tj->ti", self.tiles, xw)
        return y.reshape(-1)[:n].reshape(x.shape)

    def multT(self, x: jax.Array) -> jax.Array:
        """Scatter the transposed tile products back into windows —
        the adjoint of _windows is an overlap-add (segment sum)."""
        T, B = self.tile, self.bandwidth
        nt = self.tiles.shape[0]
        W = T + 2 * B
        n = self.shape[0]
        xf = jnp.zeros((nt * T,), x.dtype).at[:n].set(x.reshape(-1))
        Xt = xf.reshape(nt, T)
        contrib = jnp.einsum("tij,ti->tj", self.tiles, Xt)   # [nt, W]
        nchunks = -(-W // T) + 1
        pad_w = nchunks * T - W
        contrib = jnp.pad(contrib, ((0, 0), (0, pad_w)))
        acc = jnp.zeros(((nt + nchunks) * T,), x.dtype)
        for k in range(nchunks):
            acc = acc.at[k * T:(k + nt) * T].add(
                contrib[:, k * T:(k + 1) * T].reshape(-1))
        return acc[B:B + n].reshape(x.shape)

    def diagonal(self) -> jax.Array:
        T, B = self.tile, self.bandwidth
        n = self.shape[0]
        d = jax.vmap(lambda t: jnp.diagonal(t, offset=B))(self.tiles)
        return d.reshape(-1)[:n]

    def flops_per_mult(self) -> float:
        return 2.0 * self.nnz - self.shape[0]

    def traffic_per_mult(self) -> float:
        return float(self.tiles.size + 2 * self.shape[0]) \
            * self.tiles.dtype.itemsize


def band_tile(bandwidth: int) -> int:
    """Default tile: the smallest 128-multiple >= max(128, B/2)."""
    return max(128, -(-max(bandwidth, 1) // 256) * 128)


def band_slots(n: int, bandwidth: int) -> int:
    """Values stored by the tiles band_from_scipy builds: n·(T+2B)."""
    T = band_tile(bandwidth)
    return -(-n // T) * T * (T + 2 * bandwidth)


def band_from_scipy(A, dtype=None, perm=None, tile: int = None) -> BandMat:
    """Build from (optionally RCM-permuted) A. tile defaults to the
    smallest 128-multiple ≥ max(128, B/2) (bounds window overhead)."""
    A = sp.csr_matrix(A)
    if perm is not None:
        perm = np.asarray(perm)
        A = A[perm][:, perm]
    n = A.shape[0]
    coo = A.tocoo()
    B = int(np.abs(coo.col - coo.row).max()) if A.nnz else 0
    T = tile or band_tile(B)
    nt = -(-n // T)
    W = T + 2 * B
    tiles = np.zeros((nt, T, W), dtype or A.dtype)
    t_of = coo.row // T
    i_of = coo.row % T
    j_of = coo.col - (coo.row // T) * T + B
    tiles[t_of, i_of, j_of] = coo.data
    return BandMat(jnp.asarray(tiles), B, T, (n, n), int(A.nnz))
