"""Sharded stencil matrices: structured-grid SPMD with ppermute halos.

This is the device analog of the reference's DMDA ghost exchange
(src/dm/impls/da/da2.c:664 — ghost scatters sized by stencil width):
the grid's slowest axis is sharded over the mesh; each apply exchanges
`w` boundary rows with the two neighbor shards via `lax.ppermute`
(neighbor traffic only, no all-to-all), then applies the stencil
with pad+slice shifts exactly like the serial StencilMat. Unmatched
ppermute partners (grid boundary) receive zeros — which is precisely
the out-of-grid value.

Supports any offsets with |offset₀| ≤ halo width (star or box; box
corner values ride along with full-row halos).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from petsctpu.mat.stencil import StencilMat, _shift


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ShardedStencil:
    """Leading axis = shard: coeffs [P, D, mloc, *rest]."""

    coeffs: jax.Array
    offsets: tuple = field(metadata=dict(static=True))
    grid: tuple = field(metadata=dict(static=True))       # global (padded)
    nshards: int = field(metadata=dict(static=True), default=1)
    axis: str = field(metadata=dict(static=True), default="rows")
    halo: int = field(metadata=dict(static=True), default=1)

    @property
    def shape(self):
        n = int(np.prod(self.grid))
        return (n, n)

    @property
    def dtype(self):
        return self.coeffs.dtype

    @property
    def mloc(self):
        return self.grid[0] // self.nshards

    def local(self) -> "ShardedStencil":
        return jax.tree.map(lambda a: a[0], self)

    # -- halo exchange ----------------------------------------------------
    def _exchange(self, xg):
        """Returns xg extended with halo rows: [mloc+2w, *rest]."""
        w = self.halo
        P = self.nshards
        fwd = [(i, i + 1) for i in range(P - 1)]    # my last rows → next
        bwd = [(i + 1, i) for i in range(P - 1)]    # my first rows → prev
        from_above = lax.ppermute(xg[-w:], self.axis, fwd)
        from_below = lax.ppermute(xg[:w], self.axis, bwd)
        return jnp.concatenate([from_above, xg, from_below], axis=0)

    # -- ops ---------------------------------------------------------------
    def mult(self, x_local: jax.Array) -> jax.Array:
        w = self.halo
        rest = self.grid[1:]
        xg = x_local.reshape((self.mloc,) + rest)
        if self.nshards > 1:
            xs = self._exchange(xg)
        else:
            pads = [(w, w)] + [(0, 0)] * len(rest)
            xs = jnp.pad(xg, pads)
        C = self.coeffs
        y = jnp.zeros_like(xg)
        for d, off in enumerate(self.offsets):
            # row offset handled on the extended slab; others via _shift
            o0 = int(off[0])
            sl = xs[w + o0: w + o0 + self.mloc]
            if any(o != 0 for o in off[1:]):
                sl = _shift(sl, (0,) + tuple(off[1:]))
            y = y + C[d] * sl
        return y.reshape(-1)

    def diagonal(self) -> jax.Array:
        for d, off in enumerate(self.offsets):
            if all(o == 0 for o in off):
                return self.coeffs[d].reshape(-1)
        return jnp.zeros(self.mloc * int(np.prod(self.grid[1:])), self.dtype)

    def flops_per_mult(self) -> float:
        n = int(np.prod(self.grid))
        return 2.0 * n * len(self.offsets) - n


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ShardedQ1Interp:
    """Q1 prolongation/restriction between two leading-axis-sharded
    grid levels (the sharded twin of dm.da.Q1Interp).

    Reference analog: DMDA interpolation applied on distributed grids
    (dainterp.c operators act on MPI vectors whose ghost exchange the
    DMDA scatters provide). Here the leading grid axis of BOTH levels
    is sharded with aligned boundaries (mloc_fine = 2*mloc_coarse, so
    fine row 2i lives on the same shard as coarse row i) and each
    transfer needs exactly ONE halo row from one neighbor
    (`lax.ppermute`); the non-leading axes are full per shard and use
    the serial stencil formulas.

    Padding semantics: the leading axes are padded to P*mloc with
    identity rows; level vectors keep pad entries ZERO (operators have
    identity pad rows and no true<->pad coupling), and `fmask` zeroes
    the fine pad rows that prolongation would otherwise write.

    mult  = P  (coarse -> fine), multT = P^T (restriction).
    Leaves are stacked [P, ...] like ShardedStencil; `.local()` view
    runs inside shard_map.
    """

    fmask: jax.Array             # [mloc_f] (local) true-fine-row mask
    fine: tuple = field(metadata=dict(static=True))    # (Mf_pad,)+rest
    coarse: tuple = field(metadata=dict(static=True))  # (Mc_pad,)+rest
    nshards: int = field(metadata=dict(static=True), default=1)
    axis: str = field(metadata=dict(static=True), default="rows")

    @property
    def shape(self):
        return (int(np.prod(self.fine)), int(np.prod(self.coarse)))

    def local(self) -> "ShardedQ1Interp":
        return jax.tree.map(lambda a: a[0], self)

    def _mloc(self, grid):
        return grid[0] // self.nshards

    def mult(self, xc: jax.Array) -> jax.Array:
        """Prolongate local coarse vector -> local fine vector."""
        from petsctpu.dm.da import _interp_axis
        rest_c = self.coarse[1:]
        rest_f = self.fine[1:]
        mc = self._mloc(self.coarse)
        Xc = xc.reshape((mc,) + rest_c)
        P = self.nshards
        if P > 1:
            # next shard's first coarse row (boundary odd fine row);
            # the last shard's unmatched recv is zero == pad value
            nxt = lax.ppermute(Xc[:1], self.axis,
                               [(i + 1, i) for i in range(P - 1)])
        else:
            nxt = jnp.zeros_like(Xc[:1])
        Xe = jnp.concatenate([Xc, nxt], axis=0)          # [mc+1, rest]
        even = Xc                                        # fine 2i
        odd = 0.5 * (Xe[:-1] + Xe[1:])                   # fine 2i+1
        Xf = jnp.stack([even, odd], axis=1).reshape((2 * mc,) + rest_c)
        for ax in range(1, len(self.fine)):
            Xf = _interp_axis(Xf, ax, rest_f[ax - 1])
        Xf = Xf * self.fmask.reshape((-1,) + (1,) * len(rest_f))
        return Xf.reshape(-1)

    def multT(self, xf: jax.Array) -> jax.Array:
        """Restrict local fine vector -> local coarse vector (P^T)."""
        from petsctpu.dm.da import _restrict_axis
        rest_f = self.fine[1:]
        rest_c = self.coarse[1:]
        mf = self._mloc(self.fine)
        Xf = xf.reshape((mf,) + rest_f)
        Xf = Xf * self.fmask.reshape((-1,) + (1,) * len(rest_f))
        even = Xf[0::2]                                  # fine 2i
        odd = Xf[1::2]                                   # fine 2i+1
        P = self.nshards
        if P > 1:
            # previous shard's last odd row contributes to my coarse 0
            prev = lax.ppermute(odd[-1:], self.axis,
                                [(i, i + 1) for i in range(P - 1)])
        else:
            prev = jnp.zeros_like(odd[:1])
        odd_ext = jnp.concatenate([prev, odd], axis=0)   # [mc+1, rest]
        Xc = even + 0.5 * (odd_ext[:-1] + odd_ext[1:])
        for ax in range(1, len(self.coarse)):
            Xc = _restrict_axis(Xc, ax, rest_c[ax - 1])
        return Xc.reshape(-1)


def sharded_q1_interp(fine_true: tuple, coarse_true: tuple, nshards: int,
                      mloc_f: int, axis: str = "rows",
                      dtype=np.float64) -> ShardedQ1Interp:
    """Build the stacked transfer between padded sharded levels.

    fine_true/coarse_true: TRUE grids (leading 2x-1 relation);
    mloc_f: fine per-shard leading size (must be even; coarse level
    uses mloc_f//2)."""
    assert mloc_f % 2 == 0 and fine_true[0] == 2 * coarse_true[0] - 1
    assert tuple(fine_true[1:]) == tuple(2 * c - 1 for c in coarse_true[1:])
    assert nshards * mloc_f >= fine_true[0]
    rows = np.arange(nshards * mloc_f).reshape(nshards, mloc_f)
    fmask = (rows < fine_true[0]).astype(dtype)
    fine = (nshards * mloc_f,) + tuple(fine_true[1:])
    coarse = (nshards * (mloc_f // 2),) + tuple(coarse_true[1:])
    return ShardedQ1Interp(jnp.asarray(fmask), fine, coarse, nshards, axis)


def sharded_stencil_from(S: StencilMat, nshards: int,
                         axis: str = "rows",
                         mloc: int = None) -> ShardedStencil:
    """Partition a StencilMat over the leading grid axis. The axis is
    padded to a multiple of nshards with identity rows (diag 1).

    mloc: explicit per-shard leading size (>= ceil(m/nshards)) —
    multigrid hierarchies use this to keep shard boundaries aligned
    2:1 between levels (mloc_fine = 2*mloc_coarse)."""
    m = S.grid[0]
    rest = tuple(S.grid[1:])
    if mloc is None:
        mloc = -(-m // nshards)
    assert mloc * nshards >= m, (mloc, nshards, m)
    m_pad = mloc * nshards
    C = np.asarray(S.coeffs)
    D = C.shape[0]
    halo = max(abs(int(o[0])) for o in S.offsets) or 1
    if m_pad != m:
        Cp = np.zeros((D, m_pad) + rest, C.dtype)
        Cp[:, :m] = C
        diag_d = next(d for d, off in enumerate(S.offsets)
                      if all(o == 0 for o in off))
        Cp[diag_d, m:] = 1.0
        C = Cp
    # stack per shard: [P, D, mloc, *rest]
    C = C.reshape((D, nshards, mloc) + rest).swapaxes(0, 1)
    return ShardedStencil(jnp.asarray(np.ascontiguousarray(C)), S.offsets,
                          (m_pad,) + rest, nshards, axis, halo)
