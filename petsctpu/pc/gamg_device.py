"""Device-side GAMG re-setup: algebraic hierarchy refresh inside jit.

Reference flow: every Newton/TS operator refresh re-runs PCSetUp_GAMG
(src/ksp/pc/impls/gamg/gamg.c:533) — graph, aggregation, prolongator
smoothing (agg.c:1110) and Galerkin MatPtAP (gamg.c:156) — all host
work, and a host round trip per refresh. This module freezes the
SYMBOLIC side once (aggregates, tentative P0, all product patterns —
the reference's own symbolic/numeric split, matmatmult.c:29) and
re-builds the NUMERIC hierarchy on device as one jitted program:

    per level:  dinv, λmax(D⁻¹A) by power iteration,
                P = P0 − ω D⁻¹A P0        (frozen union pattern)
                A_{l+1} = Pᵀ A_l P        (chained SpGEMM plans)
    coarsest:   dense LU (jax.scipy lu_factor)

`GAMGDevicePlan.refresh(a_data)` returns a ready MGPC; inside a
`lax.while_loop` Newton iteration it costs one fused XLA computation —
no host sparse algebra at all. Patterns are value-independent
supersets (products of boolean patterns), so any coefficients on the
same sparsity refresh exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from petsctpu.mat.ell import AIJ, aij_from_scipy
from petsctpu.mat.spgemm import (SpGEMMPlan, _csr_entry_index,
                                 _ell_positions, _fill_template)
from petsctpu.pc.gamg import aggregate, strength_graph, \
    tentative_prolongator
from petsctpu.pc.mg import ChebySmoother, MGLevel, MGPC


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DenseLUPC:
    """Coarse exact solve, device-rebuildable (lu_factor under jit)."""

    lu: jax.Array
    piv: jax.Array

    def apply(self, b):
        from jax.scipy.linalg import lu_solve
        return lu_solve((self.lu, self.piv), b)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class GAMGLevelPlan:
    """Frozen symbolic plan for one level transition (A_l -> A_{l+1})."""

    p0_data: jax.Array      # tentative prolongator values (CSR-sorted)
    p0_slot: jax.Array      # P0 entry -> slot in the union pattern Pu
    prod_plan: SpGEMMPlan   # (D⁻¹A) @ P0  (A-pattern x P0-pattern)
    prod_slot: jax.Array    # product entry -> slot in Pu
    ap_plan: SpGEMMPlan     # A @ Pu
    ptap_plan: SpGEMMPlan   # Puᵀ @ (A Pu)
    c_sel: jax.Array        # ptap output slot -> next level's operator
    #                         pattern (re-bases each level on the
    #                         NUMERIC coarse pattern; chaining the
    #                         structural supersets compounds density
    #                         level-over-level and explodes plan memory)
    pt_perm: jax.Array      # Pu CSR data -> Puᵀ CSR data permutation
    a_rows: jax.Array       # row of each A data slot (D⁻¹ scaling)
    a_tmpl: AIJ             # ELL template for A_l (smoother operator)
    a_ell_pos: jax.Array
    p_tmpl: AIJ             # ELL template for Pu
    p_ell_pos: jax.Array
    v0: jax.Array           # fixed power-iteration start vector
    pu_nnz: int = field(metadata=dict(static=True), default=0)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class GAMGDevicePlan:
    """refresh(a_data) -> MGPC, pure device code (jit-safe)."""

    levels: Tuple               # GAMGLevelPlan per transition
    coarse_rows: jax.Array      # coarsest CSR entry -> (i, j) scatter
    coarse_cols: jax.Array
    csr_from_ell: jax.Array     # fine ELL flat slot of each CSR entry
    nc: int = field(metadata=dict(static=True), default=0)
    sm_its: int = field(metadata=dict(static=True), default=2)
    power_its: int = field(metadata=dict(static=True), default=12)
    cycles: int = field(metadata=dict(static=True), default=1)

    def refresh(self, a_data: jax.Array) -> MGPC:
        levels = []
        for lp in self.levels:
            A = _fill_template(lp.a_tmpl, lp.a_ell_pos, a_data)
            d = A.diagonal()
            dinv = jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1.0), 1.0)
            lam = _power_lambda_device(A, dinv, lp.v0, self.power_its)
            omega = 4.0 / (3.0 * jnp.maximum(lam, 1e-12))
            da = dinv[lp.a_rows] * a_data
            prod = lp.prod_plan.numeric_data(da, lp.p0_data)
            pu = jnp.zeros((lp.pu_nnz,), a_data.dtype)
            pu = pu.at[lp.p0_slot].add(lp.p0_data)
            pu = pu.at[lp.prod_slot].add(-omega * prod)
            P = _fill_template(lp.p_tmpl, lp.p_ell_pos, pu)
            ap = lp.ap_plan.numeric_data(a_data, pu)
            a_data = lp.ptap_plan.numeric_data(pu[lp.pt_perm],
                                               ap)[lp.c_sel]
            levels.append(MGLevel(A, P, ChebySmoother(
                dinv, 0.1 * lam, 1.1 * lam, self.sm_its)))
        dense = jnp.zeros((self.nc, self.nc), a_data.dtype)
        dense = dense.at[self.coarse_rows, self.coarse_cols].add(a_data)
        from jax.scipy.linalg import lu_factor
        lu, piv = lu_factor(dense)
        coarse = DenseLUPC(lu, piv)
        return MGPC(tuple(levels), coarse, None, self.cycles)

    def refresh_from_ell(self, A: AIJ) -> MGPC:
        """Refresh from a device AIJ whose pattern matches the plan's
        fine template (e.g. a colored-FD Jacobian on the same
        sparsity)."""
        return self.refresh(A.vals.reshape(-1)[self.csr_from_ell])


def _power_lambda_device(A: AIJ, dinv, v0, iters: int):
    v = v0
    lam = jnp.asarray(1.0, dinv.dtype)
    for _ in range(iters):
        w = dinv * A.mult(v)
        lam = jnp.linalg.norm(w)
        v = w / jnp.maximum(lam, 1e-30)
    return lam


def _pattern(M) -> sp.csr_matrix:
    """Boolean (value-independent) sparsity of M."""
    M = sp.csr_matrix(M).copy()
    M.data = np.ones_like(M.data)
    return M


def _slot_in(U: sp.csr_matrix, M: sp.csr_matrix) -> np.ndarray:
    """CSR data slot in U of every entry of M (pattern(M) ⊆ pattern(U))."""
    U = _csr_entry_index(U)
    M = _csr_entry_index(M)
    ncols = U.shape[1]
    u_rows = np.repeat(np.arange(U.shape[0], dtype=np.int64),
                       np.diff(U.indptr))
    ukeys = u_rows * ncols + U.indices
    m_rows = np.repeat(np.arange(M.shape[0], dtype=np.int64),
                       np.diff(M.indptr))
    return np.searchsorted(ukeys, m_rows * ncols + M.indices)


def _transpose_perm(P: sp.csr_matrix) -> np.ndarray:
    """perm with Pt.data == P.data[perm] for sorted-CSR P and Pt=P.T."""
    P = _csr_entry_index(P)
    rows = np.repeat(np.arange(P.shape[0], dtype=np.int64),
                     np.diff(P.indptr))
    cols = P.indices.astype(np.int64)
    # Pt sorted order = lexsort by (col, row)
    return np.lexsort((rows, cols))


def gamg_device_plan(A_host, theta: float = 0.0, coarse_n: int = 64,
                     max_levels: int = 10, sm_its: int = 2,
                     cycles: int = 1, dtype=np.float32,
                     p0s=None) -> GAMGDevicePlan:
    """Build the frozen symbolic plan from the initial operator.

    Aggregation runs once on the INITIAL values (like the reference
    re-using the graph under -pc_gamg_reuse_interpolation); all later
    refreshes reuse the aggregates and patterns.

    p0s: optional precomputed tentative prolongators per level (host
    CSR) — the blocked/rigid-body-mode route (pc/asa.asa_tentatives
    for ex56-style elasticity); aggregation is skipped."""
    A = _csr_entry_index(sp.csr_matrix(A_host).astype(dtype))
    dt = np.dtype(dtype).type
    rng = np.random.default_rng(11)

    # fine template + CSR<->ELL maps
    tmplA = aij_from_scipy(A, dtype=dt)
    posA = _ell_positions(A, tmplA)

    levels = []
    Al = A            # pattern-superset operator (plan structure)
    Al_num = A        # numeric operator (drives aggregation quality)
    tmpl_l, pos_l = tmplA, posA
    while Al.shape[0] > coarse_n and len(levels) < max_levels - 1:
        if p0s is not None:
            if len(levels) >= len(p0s):
                break
            P0 = _csr_entry_index(sp.csr_matrix(p0s[len(levels)])
                                  .astype(dt))
            if P0.shape[1] >= P0.shape[0]:   # degenerate level guard
                break
        else:
            S = strength_graph(Al_num, theta)
            agg = aggregate(S)
            na = int(agg.max()) + 1
            if na >= Al.shape[0]:
                break
            P0 = _csr_entry_index(tentative_prolongator(agg).astype(dt))
        Apat = _pattern(Al)
        prod_pat = _csr_entry_index((Apat @ _pattern(P0)).tocsr())
        Pu_pat = _csr_entry_index(
            ((_pattern(P0) + prod_pat) > 0).astype(dt).tocsr())
        # plan on PATTERNS only — planning with P0's VALUES lets scipy
        # prune exact cancellations (orthonormalized aggregate columns
        # produce them) and desyncs the slot maps
        prod_plan = SpGEMMPlan.plan(Apat, _pattern(P0), dtype=dt)
        ap_plan = SpGEMMPlan.plan(Apat, Pu_pat, dtype=dt)
        APu_pat = _csr_entry_index((Apat @ Pu_pat).tocsr())
        PuT_pat = _csr_entry_index(Pu_pat.T.tocsr())
        ptap_plan = SpGEMMPlan.plan(PuT_pat, APu_pat, dtype=dt)
        C_sup = _csr_entry_index((PuT_pat @ APu_pat).tocsr())
        # numeric hierarchy (host, once): next aggregation round AND
        # the next level's pattern — chaining C_sup itself compounds
        # density and explodes plan memory
        from petsctpu.pc.gamg import smooth_prolongator
        P_num = smooth_prolongator(Al_num, P0)
        Al_num = _csr_entry_index((P_num.T @ Al_num @ P_num).tocsr())
        Anext = _csr_entry_index(_pattern(Al_num))
        c_sel = _slot_in(C_sup, Anext)
        a_rows = np.repeat(np.arange(Al.shape[0], dtype=np.int64),
                           np.diff(Al.indptr))
        v0 = rng.standard_normal(Al.shape[0]).astype(dt)
        v0 /= np.linalg.norm(v0)
        levels.append(GAMGLevelPlan(
            jnp.asarray(P0.data.astype(dt)),
            jnp.asarray(_slot_in(Pu_pat, P0), jnp.int32),
            prod_plan,
            jnp.asarray(_slot_in(Pu_pat, prod_pat), jnp.int32),
            ap_plan, ptap_plan,
            jnp.asarray(c_sel, jnp.int32),
            jnp.asarray(_transpose_perm(Pu_pat), jnp.int32),
            jnp.asarray(a_rows, jnp.int32),
            tmpl_l, jnp.asarray(pos_l, jnp.int32),
            aij_from_scipy(Pu_pat, dtype=dt),
            jnp.asarray(_ell_positions(Pu_pat,
                                       aij_from_scipy(Pu_pat, dtype=dt)),
                        jnp.int32),
            jnp.asarray(v0),
            int(Pu_pat.nnz)))
        Al = Anext
        tmpl_l = aij_from_scipy(Al, dtype=dt)
        pos_l = _ell_positions(Al, tmpl_l)

    c_rows = np.repeat(np.arange(Al.shape[0], dtype=np.int64),
                       np.diff(Al.indptr))
    # CSR entry k of the fine operator sits at ELL flat slot posA[k]
    return GAMGDevicePlan(
        tuple(levels),
        jnp.asarray(c_rows, jnp.int32),
        jnp.asarray(Al.indices, jnp.int32),
        jnp.asarray(posA, jnp.int32),
        int(Al.shape[0]), sm_its, 12, cycles)


def csr_data_of_matching(A_host, dtype=np.float32) -> np.ndarray:
    A = _csr_entry_index(sp.csr_matrix(A_host).astype(dtype))
    return A.data


# ---------------------------------------------------------------------------
# comb-probe Galerkin refresh (colored-SpMV probing; VERDICT r3 item 1)
# ---------------------------------------------------------------------------
@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PPair:
    """Prolongation with an explicit transpose operator (restriction
    runs Pt.mult instead of P.multT's scatter-add)."""

    P: Any
    Pt: Any

    def mult(self, x):
        return self.P.mult(x)

    def multT(self, x):
        return self.Pt.mult(x)

    @property
    def vals(self):
        return self.P.vals


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class FillTemplate:
    """Frozen-pattern ELL operator whose numerics refill inside jit.
    Probing multiplies it against a block of vectors via `mult_block`
    (one chunked row-gather SpMM)."""

    ell_tmpl: AIJ
    ell_pos: jax.Array

    @classmethod
    def plan(cls, M: sp.csr_matrix, dtype=np.float32) -> "FillTemplate":
        M = _csr_entry_index(sp.csr_matrix(M).astype(dtype))
        tmpl = aij_from_scipy(M, dtype=dtype)
        pos = jnp.asarray(_ell_positions(M, tmpl), jnp.int32)
        return cls(tmpl, pos)

    def fill(self, data: jax.Array) -> AIJ:
        return _fill_template(self.ell_tmpl, self.ell_pos, data)


def mult_block(op: AIJ, X: jax.Array) -> jax.Array:
    """Y[v] = op.mult(X[v]) for a block of vectors X [NV, m]: one
    NV-wide row pick per stored ELL entry."""
    cols, vals = op.cols, op.vals               # [n, K]
    NV = X.shape[0]
    n, K = cols.shape
    Xt = X.T                                     # [m, NV]
    chunk = max(1, int(256e6 // max(n * NV * 4, 1)))
    out = jnp.zeros((n, NV), X.dtype)
    for k0 in range(0, K, chunk):
        c = cols[:, k0:k0 + chunk]
        v = vals[:, k0:k0 + chunk]
        out = out + jnp.einsum("rk,rkc->rc", v.astype(X.dtype), Xt[c])
    return out.T


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class GAMGProbeLevelPlan:
    """One level transition of the comb-probe refresh."""

    a: FillTemplate             # A_l
    p: FillTemplate             # Pu (smoothed prolongator pattern)
    pt: FillTemplate            # Puᵀ
    p0_data: jax.Array          # frozen tentative prolongator values
    p0_slot: jax.Array          # -> slot in Pu (CSR order)
    prod_slot: jax.Array        # (D⁻¹A)P0 entries -> slot in Pu
    prod_pick: jax.Array        # flat (color·n + row) picks into W
    p0v: jax.Array              # [ncp, n] = (P0 · color-indicators)ᵀ
    vc: jax.Array               # [ncc, nc] coarse probe indicators
    c_pick: jax.Array           # flat (color·nc + row) picks into Y
    pt_perm: jax.Array
    v0: jax.Array
    pu_nnz: int = field(metadata=dict(static=True), default=0)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class GAMGProbePlan:
    """Device GAMG refresh via comb-probe Galerkin: the three SpGEMM
    numerics of GAMGDevicePlan (gather-bound)
    become ~ncp + 3·ncc colored SpMVs per level through the fast
    kernels + small extraction gathers. Reference being replaced:
    PCSetUp_GAMG's MatPtAP/MatMatMult host chain
    (src/ksp/pc/impls/gamg/agg.c:1110, gamg.c:156)."""

    levels: Tuple
    coarse_rows: jax.Array
    coarse_cols: jax.Array
    csr_from_ell: jax.Array
    nc: int = field(metadata=dict(static=True), default=0)
    sm_its: int = field(metadata=dict(static=True), default=2)
    power_its: int = field(metadata=dict(static=True), default=12)
    cycles: int = field(metadata=dict(static=True), default=1)

    def refresh(self, a_data: jax.Array) -> MGPC:
        levels = []
        for lp in self.levels:
            A = lp.a.fill(a_data)
            d = A.diagonal()
            dinv = jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1.0), 1.0)
            lam = _power_lambda_device(A, dinv, lp.v0, self.power_its)
            omega = 4.0 / (3.0 * jnp.maximum(lam, 1e-12))
            n = A.shape[0]
            nc = lp.vc.shape[1]
            # probe (D⁻¹A)·P0 by prod-pattern column colors
            W = mult_block(A, lp.p0v) * dinv[None, :]     # [ncp, n]
            prod = W.reshape(-1)[lp.prod_pick]
            pu = jnp.zeros((lp.pu_nnz,), a_data.dtype)
            pu = pu.at[lp.p0_slot].add(lp.p0_data)
            pu = pu.at[lp.prod_slot].add(-omega * prod)
            P = lp.p.fill(pu)
            Pt = lp.pt.fill(pu[lp.pt_perm])
            # probe Pᵀ A P by coarse-pattern column colors
            X1 = mult_block(P, lp.vc)                     # [ncc, n]
            X2 = mult_block(A, X1)
            Y = mult_block(Pt, X2)                        # [ncc, nc]
            a_data = Y.reshape(-1)[lp.c_pick]
            levels.append(MGLevel(A, PPair(P, Pt), ChebySmoother(
                dinv, 0.1 * lam, 1.1 * lam, self.sm_its)))
        dense = jnp.zeros((self.nc, self.nc), a_data.dtype)
        dense = dense.at[self.coarse_rows, self.coarse_cols].add(a_data)
        from jax.scipy.linalg import lu_factor
        lu, piv = lu_factor(dense)
        return MGPC(tuple(levels), DenseLUPC(lu, piv), None, self.cycles)

    def refresh_from_ell(self, A: AIJ) -> MGPC:
        return self.refresh(A.vals.reshape(-1)[self.csr_from_ell])


def gamg_probe_plan(A_host, theta: float = 0.0, coarse_n: int = 64,
                    max_levels: int = 10, sm_its: int = 2,
                    cycles: int = 1, dtype=np.float32,
                    p0s=None) -> GAMGProbePlan:
    """Comb-probe refresh plan: same symbolic hierarchy as
    gamg_device_plan (aggregates + patterns frozen from the initial
    values), with distance-2 column colorings of the product patterns
    (mat/coloring.greedy_color — the MatFDColoring machinery) instead
    of SpGEMM contribution tables."""
    from petsctpu.mat.coloring import greedy_color
    from petsctpu.pc.gamg import smooth_prolongator

    A = _csr_entry_index(sp.csr_matrix(A_host).astype(dtype))
    dt = np.dtype(dtype).type
    rng = np.random.default_rng(11)
    tmplA = aij_from_scipy(A, dtype=dt)
    posA = _ell_positions(A, tmplA)

    levels = []
    Al = A
    Al_num = A
    while Al.shape[0] > coarse_n and len(levels) < max_levels - 1:
        n = Al.shape[0]
        if p0s is not None:
            if len(levels) >= len(p0s):
                break
            P0 = _csr_entry_index(sp.csr_matrix(p0s[len(levels)])
                                  .astype(dt))
            if P0.shape[1] >= P0.shape[0]:
                break
        else:
            S = strength_graph(Al_num, theta)
            agg = aggregate(S)
            na = int(agg.max()) + 1
            if na >= n:
                break
            P0 = _csr_entry_index(tentative_prolongator(agg).astype(dt))
        nc = P0.shape[1]
        Apat = _pattern(Al)
        prod_pat = _csr_entry_index((Apat @ _pattern(P0)).tocsr())
        Pu_pat = _csr_entry_index(
            ((_pattern(P0) + prod_pat) > 0).astype(dt).tocsr())
        C_sup = _csr_entry_index((Pu_pat.T @ (Apat @ Pu_pat)).tocsr())
        # numeric hierarchy (host, once) for aggregation + next pattern
        P_num = smooth_prolongator(Al_num, P0)
        Al_num = _csr_entry_index((P_num.T @ Al_num @ P_num).tocsr())
        Anext = _csr_entry_index(_pattern(Al_num))

        # prod probe: color prod_pat columns; W = (D⁻¹A)·(P0·1_color)
        col_p = greedy_color(prod_pat)
        ncp = int(col_p.max()) + 1
        Vp = np.zeros((nc, ncp), dt)
        Vp[np.arange(nc), col_p] = 1.0
        p0v = np.asarray((P0 @ Vp)).T                    # [ncp, n]
        pr_rows = np.repeat(np.arange(n, dtype=np.int64),
                            np.diff(prod_pat.indptr))
        prod_pick = col_p[prod_pat.indices].astype(np.int64) * n + pr_rows

        # coarse probe: color C_sup columns; extract Anext entries
        col_c = greedy_color(C_sup)
        ncc = int(col_c.max()) + 1
        Vc = np.zeros((nc, ncc), dt)
        Vc[np.arange(nc), col_c] = 1.0
        cn_rows = np.repeat(np.arange(nc, dtype=np.int64),
                            np.diff(Anext.indptr))
        c_pick = col_c[Anext.indices].astype(np.int64) * nc + cn_rows

        v0 = rng.standard_normal(n).astype(dt)
        v0 /= np.linalg.norm(v0)
        levels.append(GAMGProbeLevelPlan(
            FillTemplate.plan(Al, dt),
            FillTemplate.plan(Pu_pat, dt),
            FillTemplate.plan(Pu_pat.T.tocsr(), dt),
            jnp.asarray(P0.data.astype(dt)),
            jnp.asarray(_slot_in(Pu_pat, P0), jnp.int32),
            jnp.asarray(_slot_in(Pu_pat, prod_pat), jnp.int32),
            jnp.asarray(prod_pick, jnp.int32),
            jnp.asarray(p0v),
            jnp.asarray(Vc.T),
            jnp.asarray(c_pick, jnp.int32),
            jnp.asarray(_transpose_perm(Pu_pat), jnp.int32),
            jnp.asarray(v0),
            int(Pu_pat.nnz)))
        Al = Anext

    c_rows = np.repeat(np.arange(Al.shape[0], dtype=np.int64),
                       np.diff(Al.indptr))
    return GAMGProbePlan(
        tuple(levels),
        jnp.asarray(c_rows, jnp.int32),
        jnp.asarray(Al.indices, jnp.int32),
        jnp.asarray(posA, jnp.int32),
        int(Al.shape[0]), sm_its, 12, cycles)
