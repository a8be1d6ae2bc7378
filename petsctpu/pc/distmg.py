"""Distributed geometric multigrid: multi-level sharded hierarchy with
coarse-level agglomeration.

Reference pattern: GAMG's coarse-grid agglomeration onto fewer ranks
(src/ksp/pc/impls/gamg/gamg.c:131-198 createLevel with
-pc_gamg_repartition / proc reduction; cf. -pc_gamg_process_eq_limit)
— tiny levels must not be latency-dominated. Device mapping (SURVEY
§5.7): every level with more than `pc_mg_repl_size` true unknowns
stays SHARDED over the mesh axis — Chebyshev smoothing uses only
ppermute halo exchange (zero global collectives per sweep), and
inter-level transfers are ShardedQ1Interp (one boundary-row ppermute
each). Below the threshold, ONE `all_gather` brings the residual to
every shard and the remaining hierarchy runs REPLICATED (identical
redundant compute, the PCREDUNDANT idea) — no further communication
below that point.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from jax import lax

from petsctpu.core.options import Options
from petsctpu.dm.da import DA, Q1Interp, q1_interp_scipy
from petsctpu.pc.mg import MGPC, ChebySmoother, _power_lambda_max, \
    make_geometric_mg
from petsctpu.parallel.pstencil import ShardedQ1Interp, ShardedStencil, \
    sharded_q1_interp, sharded_stencil_from


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DistMGLevel:
    A: ShardedStencil            # level operator (stacked shard axis)
    smoother: ChebySmoother      # dinv stacked [P, nloc]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DistMGPC:
    """One MG cycle, sharded down to the agglomeration level.

    levels[l] lives on grid grids[l] (true shape; leading axis padded
    to nshards * mloc_l with identity rows). transfers[l] connects
    levels l and l+1 (both sharded). P_t + coarse handle everything
    below the coarsest sharded level, replicated on every shard.
    """

    levels: Tuple                # DistMGLevel, fine → coarsest sharded
    transfers: Tuple             # ShardedQ1Interp, len(levels)-1
    P_t: Q1Interp                # coarsest-sharded ↔ next-stage transfer
    coarse: Any                  # replicated MGPC below (None if inner)
    grids: tuple = field(metadata=dict(static=True))    # true grids/level
    axis: Any = field(metadata=dict(static=True), default="rows")
    nshards: int = field(metadata=dict(static=True), default=1)
    cycles: int = field(metadata=dict(static=True), default=1)  # 1=V 2=W
    # re-sharded continuation on a sub-axis (GAMG rank reduction,
    # gamg.c:174-198): another DistMGPC over fewer shards (e.g. the
    # "ici" axis of a ("dcn","ici") mesh, redundant across "dcn")
    inner: Any = None

    @property
    def A(self) -> ShardedStencil:
        """Fine-level operator (what the outer KSP should apply)."""
        return self.levels[0].A

    def shard_specs(self, axis):
        """Mixed layout: sharded levels/transfers stacked per shard;
        the replicated coarse hierarchy identical on every shard."""
        from jax.sharding import PartitionSpec as PS
        sh, rep = PS(axis), PS()
        return DistMGPC(
            levels=jax.tree.map(lambda _: sh, self.levels),
            transfers=jax.tree.map(lambda _: sh, self.transfers),
            P_t=jax.tree.map(lambda _: rep, self.P_t),
            coarse=jax.tree.map(lambda _: rep, self.coarse),
            grids=self.grids, axis=self.axis, nshards=self.nshards,
            cycles=self.cycles,
            inner=None if self.inner is None
            else self.inner.shard_specs(self.inner.axis))

    def local(self) -> "DistMGPC":
        # strip ONLY the stacked leaves; coarse hierarchy + P_t are
        # replicated (unstacked)
        lv = jax.tree.map(lambda a: a[0], self.levels)
        tr = jax.tree.map(lambda a: a[0], self.transfers)
        return DistMGPC(lv, tr, self.P_t, self.coarse, self.grids,
                        self.axis, self.nshards, self.cycles,
                        None if self.inner is None else self.inner.local())

    # -- apply (inside shard_map) ------------------------------------------
    def apply(self, b):
        return self._cycle(0, b)

    def _cycle(self, l, b):
        lev = self.levels[l]
        x = lev.smoother.smooth(lev.A, b, jnp.zeros_like(b))
        for _ in range(self.cycles):
            r = b - lev.A.mult(x)
            if l + 1 < len(self.levels):
                rc = self.transfers[l].multT(r)
                xc = self._cycle(l + 1, rc)
                x = x + self.transfers[l].mult(xc)
            else:
                x = x + self._agglomerated(r)
        return lev.smoother.smooth(lev.A, b, x)

    def _agglomerated(self, r):
        """Gather the coarsest-sharded residual once, solve the next
        coarser grid — replicated (self.coarse) or re-sharded onto the
        sub-axis (self.inner) — and slice my shard of the correction
        back out. The gather over self.axis is the agglomeration
        boundary: for the hierarchical mesh it is the ONE cross-host
        collective per cycle, issued at a small level."""
        rfull = lax.all_gather(r, self.axis, tiled=True)   # padded global
        ntrue = int(np.prod(self.grids[-1]))
        rc = self.P_t.multT(rfull[:ntrue])                 # true coarse
        if self.inner is None:
            xc = self.coarse.apply(rc)                     # replicated
        else:
            xc = self._inner_apply(rc)
        xf = self.P_t.mult(xc)
        xf = jnp.concatenate(
            [xf, jnp.zeros(rfull.shape[0] - ntrue, xf.dtype)])
        nloc = r.shape[0]
        me = lax.axis_index(self.axis)
        return lax.dynamic_slice(xf, (me * nloc,), (nloc,))

    def _inner_apply(self, rc):
        """Run the re-sharded continuation: slice my sub-axis shard of
        the (replicated) coarse residual, V-cycle over the sub-axis,
        gather the correction back (sub-axis collective only — for
        ("dcn","ici") meshes this stays intra-host; every host computes
        the identical correction redundantly, the PCREDUNDANT idea)."""
        inner = self.inner
        n_in = inner.levels[0].A.shape[0]                  # inner padding
        rin = jnp.concatenate(
            [rc, jnp.zeros(n_in - rc.shape[0], rc.dtype)])
        nloc = n_in // inner.nshards
        ci = lax.axis_index(inner.axis)
        x_in = inner.apply(lax.dynamic_slice(rin, (ci * nloc,), (nloc,)))
        x_full = lax.all_gather(x_in, inner.axis, tiled=True)
        return x_full[: rc.shape[0]]


def _stacked_cheby(Ah: sp.csr_matrix, npad: int, dtype, its: int,
                   nshards: int) -> ChebySmoother:
    """Chebyshev+Jacobi smoother with per-shard-stacked dinv; identity
    pad rows get dinv = 1 (residual there stays zero)."""
    d = np.ones(npad, dtype)
    d[: Ah.shape[0]] = Ah.diagonal()
    d = np.where(d != 0, d, 1.0)
    lam = _power_lambda_max(Ah, 1.0 / d[: Ah.shape[0]])
    return ChebySmoother(
        jnp.asarray((1.0 / d).reshape(nshards, -1)),
        jnp.broadcast_to(jnp.asarray(dtype(0.1 * lam)), (nshards,)),
        jnp.broadcast_to(jnp.asarray(dtype(1.1 * lam)), (nshards,)), its)


def _sharded_stage(Ah, da, nshards, axis, repl_n, max_levels, sm_its,
                   dtype):
    """Build the sharded part of a hierarchy: Galerkin chain (host,
    scipy) while the NEXT level still has more than repl_n true
    unknowns, per-level shard sizes chosen bottom-up so boundaries stay
    2:1 aligned (mloc_f = 2*mloc_c). Returns (levels, transfers, das,
    Ahs) — das[-1]/Ahs[-1] is the coarsest SHARDED level."""
    from petsctpu.mat.stencil import stencil_from_scipy

    das = [da]
    Ahs = [Ah]
    while das[-1].can_coarsen():
        nxt = das[-1].coarsen()
        if int(np.prod(nxt.grid)) <= repl_n or not nxt.can_coarsen():
            break
        if max_levels and len(das) >= max_levels - 1:
            break
        Ps = q1_interp_scipy(das[-1].grid, nxt.grid)
        Ahs.append((Ps.T @ Ahs[-1] @ Ps).tocsr())
        das.append(nxt)
    if not das[-1].can_coarsen():
        raise ValueError(f"grid {da.grid} has no 2x-1 coarsening")
    L = len(das)

    mlocs = [0] * L
    mlocs[L - 1] = -(-das[L - 1].grid[0] // nshards)
    for l in range(L - 2, -1, -1):
        mlocs[l] = 2 * mlocs[l + 1]

    levels, transfers = [], []
    for l in range(L):
        S = stencil_from_scipy(Ahs[l], das[l].grid, dtype=dtype)
        Sh = sharded_stencil_from(S, nshards, axis=axis, mloc=mlocs[l])
        levels.append(DistMGLevel(
            Sh, _stacked_cheby(Ahs[l], Sh.shape[0], dtype, sm_its,
                               nshards)))
        if l + 1 < L:
            transfers.append(sharded_q1_interp(
                das[l].grid, das[l + 1].grid, nshards, mlocs[l],
                axis=axis, dtype=dtype))
    return levels, transfers, das, Ahs


def make_dist_mg(A_host, grid, nshards: int, dtype=None,
                 options: Options = None, axis="rows") -> DistMGPC:
    """Build the sharded Galerkin hierarchy (PCSetUp_MG + GAMG
    agglomeration analog): levels with more than `pc_mg_repl_size`
    (default 512 — the -pc_gamg_process_eq_limit idea) true unknowns
    stay sharded; everything below runs replicated."""
    opts = options or Options()
    dtype = np.dtype(dtype or A_host.dtype).type
    repl_n = opts.get_int("pc_mg_repl_size", 512)
    max_levels = opts.get_int("pc_mg_levels", 0)
    sm_its = opts.get_int("mg_levels_ksp_max_it", 2)
    cycles = 2 if opts.get_str("pc_mg_cycle_type", "v") == "w" else 1

    levels, transfers, das, Ahs = _sharded_stage(
        sp.csr_matrix(A_host).astype(dtype), DA(tuple(grid)), nshards,
        axis, repl_n, max_levels, sm_its, dtype)

    coarse_da = das[-1].coarsen()
    Pt = das[-1].interpolation(coarse_da)
    Ps = q1_interp_scipy(das[-1].grid, coarse_da.grid)
    Ac = (Ps.T @ Ahs[-1] @ Ps).tocsr()
    coarse = make_geometric_mg(Ac, coarse_da, dtype=dtype, options=opts)
    return DistMGPC(tuple(levels), tuple(transfers), Pt, coarse,
                    tuple(da.grid for da in das), axis, nshards, cycles)


def make_dist_gamg(A_host, nshards: int, dtype=None,
                   options: Options = None, axis="rows",
                   theta: float = 0.0, coarsen: str = "mis") -> DistMGPC:
    """DISTRIBUTED algebraic multigrid: the GAMG hierarchy (smoothed
    aggregation, pc/gamg.py) built on host at setup, then applied
    SHARDED — levels with more than `pc_mg_repl_size` unknowns are
    ShardedAIJ operators with Chebyshev+Jacobi smoothing (halo
    all_to_all only), inter-level transfers are ShardedRectAIJ
    prolongators (the reference stores P as an ordinary MPIAIJ;
    MatMultTranspose's scatter-reverse is the restriction), and the
    small tail of the hierarchy runs replicated after one all_gather
    (gamg.c:174-198 proc reduction). Reuses the DistMGPC cycle."""
    from petsctpu.mat.ell import aij_from_scipy
    from petsctpu.parallel.pmat import (sharded_aij_from_scipy,
                                        sharded_rect_from_scipy)
    from petsctpu.pc.gamg import gamg_hierarchy
    from petsctpu.pc.mg import make_algebraic_mg_from_hierarchy, make_lu

    opts = options or Options()
    dtype = np.dtype(dtype or A_host.dtype).type
    repl_n = opts.get_int("pc_mg_repl_size", 512)
    sm_its = opts.get_int("mg_levels_ksp_max_it", 2)
    cycles = 2 if opts.get_str("pc_mg_cycle_type", "v") == "w" else 1
    coarse_n = opts.get_int("pc_gamg_coarse_eq_limit", 64)
    # fmt like pc/mg.py: "sell" routes each sharded level's LOCAL diag
    # SpMV through SellMat (ShardedAIJ.diag_sell); otherwise ELL
    fmt = opts.get_str("pc_gamg_mat_type", "auto")

    As, Ps = gamg_hierarchy(sp.csr_matrix(A_host).astype(dtype),
                            theta=theta, coarse_n=coarse_n,
                            coarsen=coarsen)
    # how many levels stay sharded (the NEXT one must still be big)
    L = 1
    while (L < len(As) - 1 and As[L].shape[0] > repl_n):
        L += 1
    if L >= len(As):              # hierarchy too shallow: keep 1 sharded
        L = max(1, len(As) - 1)

    levels, transfers = [], []
    for l in range(L):
        Sh, _ = sharded_aij_from_scipy(As[l], nshards, dtype=dtype,
                                       axis=axis, fmt=fmt)
        levels.append(DistMGLevel(
            Sh, _stacked_cheby(sp.csr_matrix(As[l]), Sh.shape[0], dtype,
                               sm_its, nshards)))
        if l + 1 < L:
            transfers.append(sharded_rect_from_scipy(
                Ps[l], nshards, dtype=dtype, axis=axis))

    # replicated tail: P_t bridges the coarsest sharded level to it
    Pt = aij_from_scipy(Ps[L - 1], dtype=dtype)
    if L < len(As) - 1:
        coarse = make_algebraic_mg_from_hierarchy(
            As[L:], Ps[L:], dtype=dtype, sm_its=sm_its, cycles=cycles)
    else:
        coarse = make_lu(sp.csr_matrix(As[-1]), dtype=dtype)
    return DistMGPC(tuple(levels), tuple(transfers), Pt, coarse,
                    tuple((A.shape[0],) for A in As[:L]), axis,
                    nshards, cycles)


def make_dist_mg_hier(A_host, grid, H: int, C: int, dtype=None,
                      options: Options = None,
                      axes=("dcn", "ici")) -> DistMGPC:
    """Two-level-mesh hierarchy for (H hosts × C chips) ("dcn","ici")
    meshes — the full GAMG createLevel rank-reduction ladder
    (gamg.c:174-198) mapped to a two-level fabric (SURVEY §5.7):

      * levels > `pc_mg_dcn_repl_size` unknowns: sharded over ALL H·C
        shards (flattened tuple axis; halo ppermutes stay within a host except
        one boundary row per host pair);
      * then ONE cross-host all_gather per cycle re-shards onto the C
        chips of each host ("ici" axis, redundant across hosts);
      * levels ≤ `pc_mg_repl_size`: fully replicated.
    """
    opts = options or Options()
    dtype = np.dtype(dtype or A_host.dtype).type
    dcn_repl_n = opts.get_int("pc_mg_dcn_repl_size", 2048)
    repl_n = opts.get_int("pc_mg_repl_size", 512)
    sm_its = opts.get_int("mg_levels_ksp_max_it", 2)
    cycles = 2 if opts.get_str("pc_mg_cycle_type", "v") == "w" else 1

    # ---- stage 1: sharded over the flattened (H·C) mesh ----
    levels, transfers, das, Ahs = _sharded_stage(
        sp.csr_matrix(A_host).astype(dtype), DA(tuple(grid)), H * C,
        axes, max(dcn_repl_n, repl_n), 0, sm_its, dtype)

    coarse_da = das[-1].coarsen()
    Pt = das[-1].interpolation(coarse_da)
    Ps = q1_interp_scipy(das[-1].grid, coarse_da.grid)
    Ac = (Ps.T @ Ahs[-1] @ Ps).tocsr()

    # ---- stage 2: re-sharded onto the intra-host axis ----
    if int(np.prod(coarse_da.grid)) > repl_n and coarse_da.can_coarsen():
        inner = make_dist_mg(Ac, coarse_da.grid, C, dtype=dtype,
                             options=opts, axis=axes[1])
        coarse = None
    else:
        inner = None
        coarse = make_geometric_mg(Ac, coarse_da, dtype=dtype,
                                   options=opts)
    return DistMGPC(tuple(levels), tuple(transfers), Pt, coarse,
                    tuple(da.grid for da in das), axes, H * C, cycles,
                    inner)
