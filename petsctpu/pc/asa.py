"""PCASA — adaptive smoothed aggregation AMG.

Reference: src/ksp/pc/impls/asa (Brezina-Falgout-MacLachlan-Manteuffel-
McCormick-Ruge "Adaptive smoothed aggregation"). The method discovers
the near-null candidate vectors it needs instead of assuming them:

  1. relax on A x = 0 from a random start → first candidate
  2. build an SA hierarchy whose tentative prolongator interpolates
     the candidate(s) exactly (per-aggregate QR → block prolongator)
  3. self-test: apply the V-cycle error propagator to a random vector;
     if the convergence factor is poor, the surviving slow error IS
     the missing candidate — append it and rebuild.

Setup (host, numpy/scipy): aggregation + QR + Galerkin products and a
host Jacobi V-cycle for the self-test. The returned PC applies on
device via the same MGPC machinery as GAMG.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from petsctpu.core.options import Options
from petsctpu.pc.gamg import strength_graph, aggregate, smooth_prolongator


def tentative_prolongator_multi(agg: np.ndarray, B: np.ndarray):
    """Block tentative prolongator from k candidate vectors: for each
    aggregate a with rows r, QR-factor B[r] → P0[r, a·k:(a+1)·k] = Q
    and coarse candidates Bc[a·k:(a+1)·k] = R (agg.c:1110's tentative
    step generalized to k candidates)."""
    n, k = B.shape
    na = int(agg.max()) + 1
    order = np.argsort(agg, kind="stable")
    bounds = np.searchsorted(agg[order], np.arange(na + 1))
    sizes = np.diff(bounds)
    rows, cols, vals = [], [], []
    Bc = np.zeros((na * k, k))
    # batch the QRs by aggregate size (LAPACK geqrf on a [cnt, m, k]
    # stack gives the same factors as the per-aggregate loop, ~20×
    # fewer Python iterations; aggregate sizes take only a handful of
    # distinct values)
    for m in np.unique(sizes):
        if m == 0:
            continue
        aggs_m = np.flatnonzero(sizes == m)
        ridx = order[bounds[aggs_m][:, None] + np.arange(m)]  # [cnt, m]
        Qs, Rs = np.linalg.qr(B[ridx])       # [cnt,m,q], [cnt,q,k]
        cnt, q = Qs.shape[0], Qs.shape[2]
        rows.append(np.broadcast_to(ridx[:, :, None],
                                    (cnt, m, q)).ravel())
        cols.append(np.broadcast_to(
            (aggs_m * k)[:, None, None] + np.arange(q)[None, None, :],
            (cnt, m, q)).ravel())
        vals.append(Qs.ravel())
        Bc[((aggs_m * k)[:, None] + np.arange(q)).ravel()] = \
            Rs.reshape(-1, k)
    P0 = sp.coo_matrix((np.concatenate(vals),
                        (np.concatenate(rows), np.concatenate(cols))),
                       shape=(n, na * k)).tocsr()
    # rank safety: aggregates smaller than k (or rank-deficient B[r])
    # leave ZERO coarse columns, which would make PᵀAP exactly
    # singular — prune them and renumber (the reference sizes the
    # coarse block by the actual aggregate rank)
    colnnz = np.asarray((P0 != 0).sum(axis=0)).ravel()
    keep = np.flatnonzero(colnnz > 0)
    if keep.size < P0.shape[1]:
        P0 = P0[:, keep].tocsr()
        Bc = Bc[keep]
    return P0, Bc


def _collapse_by_block(M, bs: int):
    """Node graph of a bs-dof-interleaved operator: sum of |entries|
    over each bs×bs block (the reference's bs>1 graph construction,
    PCGAMGgraph_AGG on the blocked matrix)."""
    coo = sp.coo_matrix(abs(M))
    nb = M.shape[0] // bs
    return sp.coo_matrix((coo.data, (coo.row // bs, coo.col // bs)),
                         shape=(nb, nb)).tocsr()


def asa_hierarchy(A, B, theta: float = 0.0, coarse_n: int = 64,
                  max_levels: int = 10, smooth: bool = True,
                  bs: int = 1):
    """SA hierarchy interpolating the candidate block B exactly.

    bs > 1: dof-interleaved block operators (elasticity) — aggregation
    runs on the bs-collapsed NODE graph and aggregates expand to all
    dofs of their nodes; coarser levels use bs = k (one dof per
    candidate), like the reference's cr_bs = ncand."""
    As, Ps = [sp.csr_matrix(A)], []
    Bl = np.asarray(B, np.float64)
    k = Bl.shape[1]
    cur_bs = bs
    while As[-1].shape[0] > coarse_n and len(As) < max_levels:
        Ac = As[-1]
        G = _collapse_by_block(Ac, cur_bs) if cur_bs > 1 else Ac
        S = strength_graph(G, theta)
        agg_node = aggregate(S)
        agg = (np.repeat(agg_node, cur_bs) if cur_bs > 1 else agg_node)
        if int(agg_node.max()) + 1 >= G.shape[0]:
            break
        P0, Bc = tentative_prolongator_multi(agg, Bl)
        if P0.shape[1] >= P0.shape[0]:     # no real coarsening left:
            break                          # k candidates x na nodes
            # can equal the fine size once cur_bs collapses to 1 —
            # the 24000-dof ex56 run previously stacked SIX identical
            # 1206-row levels here (asa_tentatives had this guard)
        P = smooth_prolongator(Ac, P0) if smooth else P0
        As.append((P.T @ Ac @ P).tocsr())
        Ps.append(P)
        na = int(agg_node.max()) + 1
        # coarse block structure only survives when NO rank pruning
        # disturbed the k-dof-per-aggregate alignment
        cur_bs = k if Bc.shape[0] == na * k else 1
        Bl = Bc
    return As, Ps


def asa_tentatives(A, B, theta: float = 0.0, coarse_n: int = 64,
                   max_levels: int = 10, bs: int = 1):
    """The TENTATIVE prolongators of the SA hierarchy (un-smoothed
    P0 per level, smoothing applied for the numeric recursion only) —
    the frozen-P0 input of pc/gamg_device's device refresh plan
    (-pc_gamg_reuse_interpolation semantics for blocked/RBM
    hierarchies)."""
    As, P0s = [sp.csr_matrix(A)], []
    Bl = np.asarray(B, np.float64)
    k = Bl.shape[1]
    cur_bs = bs
    while As[-1].shape[0] > coarse_n and len(As) < max_levels:
        Ac = As[-1]
        G = _collapse_by_block(Ac, cur_bs) if cur_bs > 1 else Ac
        S = strength_graph(G, theta)
        agg_node = aggregate(S)
        agg = (np.repeat(agg_node, cur_bs) if cur_bs > 1 else agg_node)
        if int(agg_node.max()) + 1 >= G.shape[0]:
            break
        P0, Bc = tentative_prolongator_multi(agg, Bl)
        if P0.shape[1] >= P0.shape[0]:     # no real coarsening left
            break
        P = smooth_prolongator(Ac, P0)
        As.append((P.T @ Ac @ P).tocsr())
        P0s.append(sp.csr_matrix(P0))
        na = int(agg_node.max()) + 1
        cur_bs = k if Bc.shape[0] == na * k else 1
        Bl = Bc
    return P0s


def _host_vcycle(As, Ps, b, x, omega=0.7, level=0):
    """Jacobi V(1,1) cycle on host (setup-time self-test only)."""
    A = As[level]
    if level == len(As) - 1:
        return spla.spsolve(A.tocsc(), b) if A.shape[0] > 1 else b / A[0, 0]
    dinv = 1.0 / A.diagonal()
    x = x + omega * dinv * (b - A @ x)
    r = b - A @ x
    P = Ps[level]
    x = x + P @ _host_vcycle(As, Ps, P.T @ r,
                             np.zeros(P.shape[1]), omega, level + 1)
    x = x + omega * dinv * (b - A @ x)
    return x


def _relax_candidate(A, x, sweeps=10, omega=0.7):
    dinv = 1.0 / A.diagonal()
    for _ in range(sweeps):
        x = x - omega * dinv * (A @ x)
    return x


def asa_candidates(A, max_candidates: int = 3, target_factor: float = 0.25,
                   test_its: int = 6, relax_sweeps: int = 10,
                   theta: float = 0.0, coarse_n: int = 64, seed: int = 0):
    """The adaptive loop: grow the candidate block until the V-cycle
    converges at `target_factor` per iteration (or the cap is hit)."""
    A = sp.csr_matrix(A).astype(np.float64)
    rng = np.random.default_rng(seed)
    c = _relax_candidate(A, rng.standard_normal(A.shape[0]), relax_sweeps)
    B = (c / np.linalg.norm(c))[:, None]
    while B.shape[1] < max_candidates:
        As, Ps = asa_hierarchy(A, B, theta=theta, coarse_n=coarse_n)
        # self-test on A e = 0: surviving error is the next candidate
        e = rng.standard_normal(A.shape[0])
        e /= np.linalg.norm(e)
        factors = []
        for _ in range(test_its):
            e = e - _host_vcycle(As, Ps, A @ e, np.zeros_like(e))
            nrm = np.linalg.norm(e)
            factors.append(nrm)
            if nrm == 0:
                break
            e /= nrm
        factor = factors[-1]
        if factor <= target_factor or nrm == 0:
            break
        # orthonormalize the slow mode against B and append
        e = e - B @ (B.T @ e)
        nrm = np.linalg.norm(e)
        if nrm < 1e-12:
            break
        B = np.hstack([B, (e / nrm)[:, None]])
    return B


def make_asa(A_host, dtype=None, options: Options = None):
    """PCASA factory: adaptive candidates → SA hierarchy → device MG."""
    from petsctpu.pc.mg import make_algebraic_mg_from_hierarchy

    opts = options or Options()
    theta = opts.get_real("pc_asa_threshold", 0.0)
    coarse_n = opts.get_int("pc_asa_coarse_eq_limit", 64)
    maxc = opts.get_int("pc_asa_max_candidates", 3)
    target = opts.get_real("pc_asa_target_factor", 0.25)
    B = asa_candidates(A_host, max_candidates=maxc, target_factor=target,
                       theta=theta, coarse_n=coarse_n)
    As, Ps = asa_hierarchy(A_host, B, theta=theta, coarse_n=coarse_n)
    return make_algebraic_mg_from_hierarchy(
        As, Ps, dtype=dtype, sm_its=opts.get_int("mg_levels_ksp_max_it", 2))
