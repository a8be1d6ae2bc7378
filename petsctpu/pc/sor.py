"""SOR/SSOR preconditioner.

Reference: PCSOR (src/ksp/pc/impls/sor) delegating to MatSOR
(src/mat/impls/aij/seq/aij.c:1463). A Gauss-Seidel sweep is a
triangular solve in disguise:
    x ← (D/ω + L)⁻¹ (b − U x + ((1−ω)/ω) D x)
so on the device each sweep is one level-scheduled SpTRSV (mat/factor.py)
plus an ELL SpMV — the sequential row loop becomes a wavefront loop.
Supports forward / backward / symmetric sweeps and ω ≠ 1.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from petsctpu.mat.ell import AIJ, aij_from_scipy
from petsctpu.mat.factor import SpTRSVPlan, make_sptrsv_plan


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SORPC:
    fwd_plan: SpTRSVPlan          # (D/ω + L)⁻¹
    bwd_plan: SpTRSVPlan          # (D/ω + U)⁻¹
    U_ell: AIJ                    # strict upper
    L_ell: AIJ                    # strict lower
    diag: jax.Array
    omega: float = field(metadata=dict(static=True), default=1.0)
    sweeps: int = field(metadata=dict(static=True), default=1)
    symmetric: bool = field(metadata=dict(static=True), default=True)
    forward_only: bool = field(metadata=dict(static=True), default=False)

    def apply(self, b):
        w = self.omega
        x = jnp.zeros_like(b)
        gd = ((1.0 - w) / w) * self.diag
        for _ in range(self.sweeps):
            # forward sweep
            rhs = b - self.U_ell.mult(x) + gd * x
            x = self.fwd_plan.solve(rhs)
            if self.symmetric:
                rhs = b - self.L_ell.mult(x) + gd * x
                x = self.bwd_plan.solve(rhs)
        return x


def make_sor(A_host, omega: float = 1.0, sweeps: int = 1,
             symmetric: bool = True, dtype=None) -> SORPC:
    A = sp.csr_matrix(A_host)
    L = sp.tril(A, k=-1, format="csr")
    U = sp.triu(A, k=1, format="csr")
    d = A.diagonal()
    Dw = sp.diags(d / omega)
    fwd = make_sptrsv_plan((Dw + L).tocsr(), lower=True, unit_diag=False,
                           dtype=dtype)
    bwd = make_sptrsv_plan((Dw + U).tocsr(), lower=False, unit_diag=False,
                           dtype=dtype)
    return SORPC(fwd, bwd, aij_from_scipy(U, dtype=dtype),
                 aij_from_scipy(L, dtype=dtype),
                 jnp.asarray(d.astype(dtype or d.dtype)), float(omega),
                 int(sweeps), bool(symmetric))


# ---------------------------------------------------------------------------
# Inode-blocked SOR — MatSOR_SeqAIJ_Inode (inode.c:2757)
# ---------------------------------------------------------------------------
@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class InodeSORPC:
    """Node-blocked Gauss-Seidel: the reference silently upgrades
    MatSOR on AIJ matrices whose consecutive rows share identical
    column patterns (Mat_CheckInode) to a BLOCK sweep — each inode's
    <=5x5 diagonal block is inverted once and applied directly
    (inode.c:2757 MatSOR_SeqAIJ_Inode; only omega == 1 is supported
    there, matching this plan). Mathematically block-SSOR:
    M = (Db + Lb) Db^-1 (Db + Ub) with Db the inode diagonal blocks.

    Device layout: inode levels (wavefronts of the block-lower DAG),
    member-row gathers over strict block-lower/upper ELL slices, and a
    batched [m, s, s] inverse-block einsum per level — the sequential
    inode loop becomes a level loop exactly like SpTRSVPlan's.
    """

    fwd_levels: jax.Array     # int32 [nlf, imax] inode ids (pad m)
    bwd_levels: jax.Array     # int32 [nlb, imax]
    members: jax.Array        # int32 [m+1, smax] rows (pad n; last=pad node)
    invB: jax.Array           # [m+1, smax, smax] inverse diag blocks
    Lcols: jax.Array          # int32 [n+1, Kl] strict block-lower ELL
    Lvals: jax.Array
    Ucols: jax.Array          # int32 [n+1, Ku] strict block-upper ELL
    Uvals: jax.Array
    n: int = field(metadata=dict(static=True))
    sweeps: int = field(metadata=dict(static=True), default=1)
    symmetric: bool = field(metadata=dict(static=True), default=True)
    forward_only: bool = field(metadata=dict(static=True), default=False)

    def _sweep(self, levels, cols, vals, rhs_of, x):
        """One block sweep; returns (x, t) with t the pre-inverse
        block sums (the reference's ssor_work vector, used as the
        backward sweep's rhs in zero-guess SSOR)."""
        t = jnp.zeros(self.n + 1, x.dtype)

        def level(l, carry):
            x, t = carry
            ids = levels[l]                       # [imax]
            rows = self.members[ids]              # [imax, smax]
            acc = jnp.sum(vals[rows] * x[cols[rows]], axis=2)
            rhs = rhs_of(rows) - acc              # [imax, smax]
            xI = jnp.einsum("ijk,ik->ij", self.invB[ids], rhs)
            x = x.at[rows].set(xI, mode="drop")
            t = t.at[rows].set(rhs, mode="drop")
            return (x, t)

        x, t = jax.lax.fori_loop(0, levels.shape[0], level, (x, t))
        return x, t

    def apply(self, b):
        bp = jnp.concatenate([b, jnp.zeros(1, b.dtype)])
        x = jnp.zeros(self.n + 1, b.dtype)
        t = bp
        for s in range(self.sweeps):
            if s == 0:
                x, t = self._sweep(self.fwd_levels, self.Lcols,
                                   self.Lvals, lambda r: bp[r], x)
            else:
                # nonzero-guess forward: rhs = b - Ub x_old (upper
                # cols keep their pre-sweep values during a forward
                # sweep, so the frozen capture is exact GS)
                xs = x

                def rhs_fwd(r, xs=xs):
                    return bp[r] - jnp.sum(
                        self.Uvals[r] * xs[self.Ucols[r]], axis=2)
                x, t = self._sweep(self.fwd_levels, self.Lcols,
                                   self.Lvals, rhs_fwd, x)
            if self.symmetric and not self.forward_only:
                if s == 0:
                    # zero-guess SSOR backward rides the stored block
                    # sums: t = b - Lb x_half (ssor_work in the
                    # reference), so rhs = t - Ub x
                    tt = t
                    x, _ = self._sweep(self.bwd_levels, self.Ucols,
                                       self.Uvals, lambda r: tt[r], x)
                else:
                    # nonzero guess: t contains a stale Ub term -> use
                    # the explicit lower residual (lower cols keep
                    # their forward values during a backward sweep)
                    xs2 = x

                    def rhs_bwd(r, xs2=xs2):
                        return bp[r] - jnp.sum(
                            self.Lvals[r] * xs2[self.Lcols[r]], axis=2)
                    x, _ = self._sweep(self.bwd_levels, self.Ucols,
                                       self.Uvals, rhs_bwd, x)
        return x[: self.n]


def _block_levels(C: sp.csr_matrix, lower: bool) -> np.ndarray:
    """Wavefront levels of a block dependency DAG given the inode
    adjacency C (strictly lower used when lower else strictly upper);
    returns int32 [nlev, imax] padded with m."""
    m = C.shape[0]
    T = sp.tril(C, k=-1, format="csr") if lower \
        else sp.triu(C, k=1, format="csr")
    lev = np.zeros(m, np.int64)
    order = range(m) if lower else range(m - 1, -1, -1)
    for i in order:
        cs = T.indices[T.indptr[i]:T.indptr[i + 1]]
        if len(cs):
            lev[i] = lev[cs].max() + 1
    nlev = int(lev.max()) + 1 if m else 1
    groups = [np.flatnonzero(lev == l) for l in range(nlev)]
    imax = max((len(g) for g in groups), default=1)
    out = np.full((nlev, imax), m, np.int32)
    for l, g in enumerate(groups):
        out[l, : len(g)] = g
    return out


def make_inode_sor(A_host, omega: float = 1.0, sweeps: int = 1,
                   symmetric: bool = True, forward_only: bool = False,
                   dtype=None, limit: int = 5):
    """MatSOR_SeqAIJ_Inode analog; returns None when the matrix has no
    inodes (caller falls back to scalar make_sor) or omega != 1 (the
    reference errors there and tells you to use -mat_no_inode)."""
    from petsctpu.mat.coloring import inode_groups

    if omega != 1.0:
        return None
    A = sp.csr_matrix(A_host)
    A.sort_indices()
    ns = inode_groups(A, limit)
    if ns is None:
        return None
    n = A.shape[0]
    m = len(ns)
    starts = np.concatenate([[0], np.cumsum(ns)])
    row2node = np.repeat(np.arange(m), ns)
    smax = int(ns.max())
    dt = np.dtype(dtype or A.dtype)

    members = np.full((m + 1, smax), n, np.int32)
    for i in range(m):
        members[i, : ns[i]] = np.arange(starts[i], starts[i + 1])

    # split entries: block-lower (col < inode start), block diag,
    # block-upper (col >= inode end)
    coo = A.tocoo()
    rn = row2node[coo.row]
    lo = coo.col < starts[rn]
    hi = coo.col >= starts[rn + 1]
    mid = ~(lo | hi)
    Lb = sp.coo_matrix((coo.data[lo], (coo.row[lo], coo.col[lo])),
                       shape=A.shape).tocsr()
    Ub = sp.coo_matrix((coo.data[hi], (coo.row[hi], coo.col[hi])),
                       shape=A.shape).tocsr()

    # diagonal blocks + inverses (identity padding keeps them regular)
    B = np.tile(np.eye(smax, dtype=np.float64), (m + 1, 1, 1))
    br, bc, bv = coo.row[mid], coo.col[mid], coo.data[mid]
    B[row2node[br], br - starts[row2node[br]],
      bc - starts[row2node[br]]] = bv
    if np.abs(np.linalg.det(B[:m])).min() < 1e-300:
        return None                        # singular block: fall back
    invB = np.linalg.inv(B).astype(dt)

    def ell(T):
        T = T.tocsr()
        K = max(int(np.diff(T.indptr).max()) if T.nnz else 0, 1)
        ci = np.full((n + 1, K), n, np.int32)
        vi = np.zeros((n + 1, K), dt)
        for r in range(n):
            c = T.indices[T.indptr[r]:T.indptr[r + 1]]
            v = T.data[T.indptr[r]:T.indptr[r + 1]]
            ci[r, : len(c)] = c
            vi[r, : len(v)] = v
        return ci, vi

    Lc, Lv = ell(Lb)
    Uc, Uv = ell(Ub)

    from petsctpu.mat.coloring import _inode_compress_pattern
    C = _inode_compress_pattern(A, ns)
    fwd = _block_levels(C, lower=True)
    bwd = _block_levels(C, lower=False)
    return InodeSORPC(jnp.asarray(fwd), jnp.asarray(bwd),
                      jnp.asarray(members), jnp.asarray(invB),
                      jnp.asarray(Lc), jnp.asarray(Lv),
                      jnp.asarray(Uc), jnp.asarray(Uv),
                      n, int(sweeps), bool(symmetric),
                      bool(forward_only))
