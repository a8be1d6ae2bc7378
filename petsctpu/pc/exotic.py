"""PCExotic (wirebasket/face) and PCTFS (XXT inverse factor).

Reference:
  * src/ksp/pc/impls/wb/wb.c — PCExotic: a 2-level multigrid whose
    coarse space comes from subdomain-boundary pieces of a 3-D DMDA
    decomposition. DMDAGetWireBasketInterpolation (wb.c:21) builds, per
    subdomain box, 26 surface basis columns (8 vertices + 12 edges + 6
    faces of the box boundary, the Xsurf indicators at wb.c:79-90) and
    harmonically extends them into the interior by solving
    A_ii·Xint = −A_is·Xsurf (wb.c:155-185); DMDAGetFaceInterpolation
    builds the 6-column face variant. The columns assemble a global P
    handed to a 2-level PCMG.
  * src/ksp/pc/impls/tfs — PCTFS: the Tufo-Fischer parallel direct
    solver; xxt.c computes a factor X with A⁻¹ = X·Xᵀ (inverse
    Cholesky) so a solve is two matrix products — no triangular
    recurrences. That apply shape suits an accelerator: both products
    are dense matmuls. The reference uses tfs for small coarse problems
    (xxt.c header); same intended use here (e.g. the agglomerated
    coarse level of distmg).

Design: all index analysis and local solves happen at plan time
(host, scipy); the assembled P feeds the existing MGPC machinery, so
PCExotic application is the standard smoother + Galerkin-coarse cycle.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from petsctpu.core.options import Options


def _box_splits(n: int, parts: int):
    """Split range(n) into `parts` contiguous chunks (sizes as equal
    as possible — the DMDA ownership-range rule)."""
    sizes = [n // parts + (1 if i < n % parts else 0) for i in range(parts)]
    starts = np.cumsum([0] + sizes)
    return [(starts[i], starts[i + 1]) for i in range(parts)]


def exotic_interpolation(A_host, grid: Tuple[int, int, int],
                         sub: Tuple[int, int, int],
                         etype: str = "wirebasket",
                         direct_solve: bool = True) -> sp.csr_matrix:
    """Build the exotic coarse-space interpolation P (host, scipy).

    grid: global dims (C-order flattening, matching dm.da.DA).
    sub:  number of subdomain boxes per axis (the reference uses the
          processor decomposition; serial callers choose it).
    etype "wirebasket": one coarse dof per box-boundary piece (vertex/
          edge/face — up to 26 per box, wb.c:80-90's 3x3x3
          classification); "face" (the reference DEFAULT, wb.c:576):
          6 columns per box indicating face INTERIORS only — wire
          nodes (vertices/edges) get ZERO rows
          (DMDAGetFaceInterpolation wb.c:357-364).
    Surface rows of each column are indicators; interior rows are the
    extension −A_ii⁻¹A_is·Xsurf (wb.c:155-185). direct_solve=False
    mimics the reference default (-pc_exotic_direct_solver false):
    each column's interior solve runs GMRES+ILU(0) to rtol 1e-5 — the
    interpolation then only approximately reproduces constants (the
    wb.c:92 comment).
    """
    A = sp.csr_matrix(A_host)
    grid = tuple(grid)
    if len(grid) != 3:
        raise ValueError("PCExotic is a 3-D DMDA method (wb.c:47)")
    n = int(np.prod(grid))
    if A.shape[0] != n:
        raise ValueError(f"operator size {A.shape[0]} != grid {grid}")
    splits = [_box_splits(grid[ax], sub[ax]) for ax in range(3)]

    rows, cols, vals = [], [], []
    piece_ids = {}

    def piece_col(key):
        if key not in piece_ids:
            piece_ids[key] = len(piece_ids)
        return piece_ids[key]

    for b0 in range(sub[0]):
        for b1 in range(sub[1]):
            for b2 in range(sub[2]):
                lo = (splits[0][b0][0], splits[1][b1][0], splits[2][b2][0])
                hi = (splits[0][b0][1], splits[1][b1][1], splits[2][b2][1])
                sz = tuple(h - l for l, h in zip(lo, hi))
                if min(sz) < 3:
                    raise ValueError(
                        "each box needs >=3 grid points per axis (wb.c:75)")
                ii = np.arange(lo[0], hi[0])
                jj = np.arange(lo[1], hi[1])
                kk = np.arange(lo[2], hi[2])
                I3, J3, K3 = np.meshgrid(ii, jj, kk, indexing="ij")
                gidx = np.ravel_multi_index((I3, J3, K3), grid).ravel()
                # extremes signature per node: -1/+1 on a box face plane
                ext = np.stack([
                    np.where(I3 == lo[0], -1, np.where(I3 == hi[0] - 1, 1, 0)),
                    np.where(J3 == lo[1], -1, np.where(J3 == hi[1] - 1, 1, 0)),
                    np.where(K3 == lo[2], -1, np.where(K3 == hi[2] - 1, 1, 0)),
                ], axis=-1).reshape(-1, 3)
                surf = np.any(ext != 0, axis=1)
                S, I = gidx[surf], gidx[~surf]
                box = (b0, b1, b2)
                # piece key per surface node. NOTE on "face": the
                # reference's DMDAGetFaceInterpolation writes its
                # 6-column indicator stream into Xsurf rows by a
                # RUNNING COUNTER that only covers the face-interior
                # count, while Xsurf rows are the full surface in lex
                # order (wb.c:357-364 vs the Isurf fill at :389-404).
                # The 1s therefore land on the FIRST 150 lex-ordered
                # surface rows — corners and edges included, the last
                # 68 surface rows zero. The ex45_1 golden bakes this
                # in, so it is replicated verbatim here.
                keys = []
                srows = []
                if etype == "wirebasket":
                    for sk, e in enumerate(ext[surf]):
                        keys.append(piece_col((box, tuple(e))))
                        srows.append(sk)
                else:
                    # surface ranks follow ascending global index
                    # (axis 0 slowest == the reference's k); the
                    # reference's (m, n, p) = our (axis2, axis1, axis0)
                    dz, dy, dx = (hi[0] - lo[0], hi[1] - lo[1],
                                  hi[2] - lo[2])
                    stream = [0] * ((dy - 2) * (dx - 2))
                    for _k in range(dz - 2):
                        stream += [1] * (dx - 2)
                        for _j in range(dy - 2):
                            stream += [2, 3]
                        stream += [4] * (dx - 2)
                    stream += [5] * ((dy - 2) * (dx - 2))
                    for sk, cidx in enumerate(stream):
                        keys.append(piece_col((box, cidx)))
                        srows.append(sk)
                keys = np.asarray(keys, np.int64)
                srows = np.asarray(srows, np.int64)
                ncol_here = (keys.max() + 1) if len(keys) else 0
                Xsurf = sp.csr_matrix(
                    (np.ones(len(keys)), (srows, keys)),
                    shape=(len(S), max(ncol_here, 1)))
                rows.append(S[srows])
                cols.append(keys)
                vals.append(np.ones(len(keys)))
                if len(I):
                    Aii = A[I][:, I].tocsc()
                    Ais = A[I][:, S]
                    rhsm = -(Ais @ Xsurf).toarray()
                    if direct_solve:
                        Xint = spla.splu(Aii).solve(rhsm)
                    else:
                        Xint = _inexact_interior_solve(Aii.tocsr(), rhsm)
                    ri, ci = np.nonzero(np.abs(Xint) > 1e-14)
                    rows.append(I[ri])
                    cols.append(ci)
                    vals.append(Xint[ri, ci])
    P = sp.csr_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, len(piece_ids)))
    return P


def _inexact_interior_solve(Aii: sp.csr_matrix, rhsm: np.ndarray):
    """The reference's default interior extension (exotic->directSolve
    false, wb.c:168-185): per column, GMRES(30)+ILU(0) to the KSP
    default rtol 1e-5, zero initial guess — via our own solver (whose
    gmres stream is digit-matched to the reference elsewhere)."""
    import jax.numpy as jnp

    from petsctpu.ksp import ksp_solve
    from petsctpu.mat.ell import aij_from_scipy
    from petsctpu.pc.factor import make_ilu

    Ad = aij_from_scipy(Aii, dtype=np.float64)
    pc = make_ilu(Aii, dtype=np.float64)
    out = np.empty_like(rhsm)
    for c in range(rhsm.shape[1]):
        r = ksp_solve(Ad, jnp.asarray(rhsm[:, c]), pc=pc,
                      ksp_type="gmres", rtol=1e-5, maxits=10000)
        out[:, c] = np.asarray(r.x)
    return out


def make_exotic(A_host, grid, sub=(2, 2, 2), etype: str = "wirebasket",
                dtype=None, sm_its: int = 2,
                mg_type: str = "multiplicative",
                direct_solve: bool = True):
    """PCExotic: 2-level MG with the wirebasket/face coarse space
    (PCSetUp_Exotic wb.c:~380: build P, then PCMG with Galerkin
    coarse operator)."""
    from petsctpu.pc.mg import make_algebraic_mg_from_hierarchy

    A = sp.csr_matrix(A_host)
    P = exotic_interpolation(A, grid, sub, etype,
                             direct_solve=direct_solve)
    Ac = (P.T @ A @ P).tocsr()
    return make_algebraic_mg_from_hierarchy(
        [A, Ac], [P], dtype=dtype, sm_its=sm_its, mg_type=mg_type)


# ---------------------------------------------------------------------------
# PCTFS — XXT inverse factor
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class TFSPC:
    """x = X·(Xᵀ·b) — the XXT solve (xxt.c do_xxt_solve): A⁻¹ = X Xᵀ.

    Both products are dense matmuls; there is no triangular
    recurrence anywhere in the apply path."""

    X: jax.Array                     # n×n (or n×r) inverse factor

    def apply(self, b):
        return self.X @ (self.X.T @ b)


def make_tfs(A_host, dtype=None, drop_tol: float = 0.0):
    """Build the XXT factor: X = L⁻ᵀ from the (dense) Cholesky
    A = LLᵀ, so X·Xᵀ = A⁻¹ exactly (xxt.c computes the same factor
    column-by-column with A-orthogonalization; the closed form is the
    inverse transposed Cholesky). drop_tol > 0 sparsifies X into an
    approximate direct solve.

    Intended for SMALL systems — the reference uses PCTFS for coarse
    problems (tfs.c header: "preconditioner for the coarse grid").
    """
    A = np.asarray(sp.csr_matrix(A_host).toarray(), dtype=np.float64)
    n = A.shape[0]
    L = np.linalg.cholesky(A)
    X = np.linalg.solve(L.T, np.eye(n))       # L⁻ᵀ (upper triangular)
    if drop_tol > 0.0:
        X = np.where(np.abs(X) >= drop_tol * np.abs(X).max(), X, 0.0)
    dt = np.dtype(dtype or A_host.dtype).type
    return TFSPC(jnp.asarray(X.astype(dt)))


def make_exotic_from_options(A, A_host, opts: Options):
    """-pc_type exotic|wb entry (PCSetFromOptions_Exotic analog):
    -pc_exotic_type wirebasket|face, -pc_exotic_grid, -pc_exotic_sub."""
    grid = opts.get("pc_exotic_grid", None)
    if grid is None:
        raise ValueError("pc_exotic_grid (3-D dims tuple) required")
    sub = opts.get("pc_exotic_sub", (2, 2, 2))
    # reference default TYPE is face (wb.c:576); direct_solve mirrors
    # -pc_exotic_direct_solver (default FALSE — inexact gmres+ILU
    # interior extension; see the ex45_1 oracle parity test)
    return make_exotic(
        A_host, tuple(grid), tuple(sub),
        etype=opts.get_str("pc_exotic_type", "face"),
        direct_solve=opts.get_bool("pc_exotic_direct_solver", False),
        dtype=getattr(A, "dtype", None))
