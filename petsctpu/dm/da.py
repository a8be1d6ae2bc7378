"""DA — structured-grid manager (DMDA analog).

Reference: src/dm/impls/da (DMDACreate2d da2.c:870, DMDACreate3d
da3.c:1480; ghost scatters da2.c:443,664; Q1 interpolation
dainterp.c:53; stencil-based matrix preallocation fdda.c). The device
re-design:

  * vectors are grid-shaped arrays; "ghost updates" for stencil ops
    are pad+slice reads (serial) or halo collectives (sharded), not
    scatter plans;
  * DMCreateMatrix returns a StencilMat coefficient builder — assembly
    writes coefficient arrays, never (row, col) triples;
  * refinement follows the reference's vertex-centered rule
    m_fine = 2·m_coarse − 1, and interpolation is matrix-free Q1
    (tensor-product linear), with a scipy twin for Galerkin setup.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


@dataclass(frozen=True)
class DA:
    """Host-side descriptor of a structured grid (1/2/3-D, dof=1)."""

    grid: Tuple[int, ...]           # global dims, natural ordering
    stencil_width: int = 1
    stencil_type: str = "star"      # star | box
    # per-axis DMDABoundaryType (petscdmda.h:51):
    # "none" | "ghosted" | "mirror" | "periodic"; a bare string
    # applies to every axis. GHOSTED = ghost slots exist and carry a
    # USER value (the `fill` argument of local_with_ghosts); MIRROR
    # reflects about the boundary node.
    boundary: Tuple[str, ...] = ()

    def boundary_types(self) -> Tuple[str, ...]:
        b = self.boundary
        if not b:
            return ("none",) * self.ndim
        if isinstance(b, str):
            return (b,) * self.ndim
        return tuple(b)

    @property
    def ndim(self):
        return len(self.grid)

    @property
    def n(self):
        return int(np.prod(self.grid))

    # ---- vectors ------------------------------------------------------
    def create_global_vector(self, dtype=jnp.float64):
        return jnp.zeros(self.n, dtype)

    def to_grid(self, x):
        return x.reshape(self.grid)

    def from_grid(self, xg):
        return xg.reshape(-1)

    def local_with_ghosts(self, x, fill=0.0):
        """Ghosted view: grid array padded by stencil_width (the
        DMGlobalToLocal analog for one process). Periodic axes wrap,
        mirror axes reflect about the boundary node, "none"/"ghosted"
        axes take `fill` (the user-set ghost value)."""
        xg = self.to_grid(x)
        w = self.stencil_width
        bts = self.boundary_types()
        if all(b in ("none", "ghosted") for b in bts):
            return jnp.pad(xg, w, constant_values=fill)
        for ax, b in enumerate(bts):
            pad = [(0, 0)] * xg.ndim
            pad[ax] = (w, w)
            if b == "periodic":
                xg = jnp.pad(xg, pad, mode="wrap")
            elif b == "mirror":
                xg = jnp.pad(xg, pad, mode="reflect")
            else:
                xg = jnp.pad(xg, pad, constant_values=fill)
        return xg

    # ---- stencil offsets ----------------------------------------------
    def stencil_offsets(self):
        w = self.stencil_width
        nd = self.ndim
        offs = []
        rng = range(-w, w + 1)
        import itertools
        for off in itertools.product(rng, repeat=nd):
            if self.stencil_type == "star" and \
                    sum(1 for o in off if o != 0) > 1:
                continue
            offs.append(off)
        # diagonal first (conventional)
        offs.sort(key=lambda o: (sum(abs(v) for v in o), o))
        return tuple(offs)

    def create_matrix(self, dtype=jnp.float64):
        """Empty StencilMat with this grid's stencil pattern (and this
        grid's boundary types: periodic axes wrap in the operator)."""
        from petsctpu.mat.stencil import StencilMat
        offs = self.stencil_offsets()
        coeffs = jnp.zeros((len(offs),) + self.grid, dtype)
        bts = self.boundary_types()
        return StencilMat(coeffs, offs, self.grid,
                          () if all(b == "none" for b in bts) else bts)

    # ---- hierarchy -----------------------------------------------------
    def coarsen(self) -> "DA":
        """Vertex-centered axes: m_c = (m_f + 1)/2 (inverse of the
        reference's 2x−1 refine); periodic axes: m_c = m_f/2 (ratio-2
        wrap rule, dainterp.c:67-69 / da DMRefine)."""
        cg = tuple(g // 2 if b == "periodic" else (g + 1) // 2
                   for g, b in zip(self.grid, self.boundary_types()))
        if any(c < 2 for c in cg):
            raise ValueError(f"cannot coarsen grid {self.grid}")
        return DA(cg, self.stencil_width, self.stencil_type,
                  self.boundary)

    def refine(self) -> "DA":
        return DA(tuple(2 * g if b == "periodic" else 2 * g - 1
                        for g, b in zip(self.grid,
                                        self.boundary_types())),
                  self.stencil_width, self.stencil_type, self.boundary)

    def can_coarsen(self) -> bool:
        def ok(g, b):
            if b == "periodic":
                return g % 2 == 0 and g // 2 >= 2
            return (g + 1) // 2 >= 2 and (g % 2 == 1)
        return all(ok(g, b)
                   for g, b in zip(self.grid, self.boundary_types()))

    def interpolation_scipy(self, coarse: "DA") -> sp.csr_matrix:
        return q1_interp_scipy(self.grid, coarse.grid,
                               self.boundary_types())

    def interpolation(self, coarse: "DA") -> "Q1Interp":
        assert coarse.grid == tuple((g + 1) // 2 for g in self.grid), \
            f"{coarse.grid} is not the coarsening of {self.grid}"
        return Q1Interp(self.grid, coarse.grid)

    def coordinates(self, lo=0.0, hi=1.0):
        """Uniform vertex coordinates per axis."""
        return [np.linspace(lo, hi, g) for g in self.grid]


# ---------------------------------------------------------------------------
# Q1 (multilinear) interpolation, matrix-free
# ---------------------------------------------------------------------------
def _interp_axis(X, axis, nf):
    """1-D linear interpolation along `axis`: nc → nf = 2·nc − 1."""
    X = jnp.moveaxis(X, axis, 0)
    out = jnp.zeros((nf,) + X.shape[1:], X.dtype)
    out = out.at[::2].set(X)
    out = out.at[1::2].set(0.5 * (X[:-1] + X[1:]))
    return jnp.moveaxis(out, 0, axis)


def _restrict_axis(X, axis, nc):
    """Adjoint of _interp_axis (Pᵀ, unscaled — full weighting × 2)."""
    X = jnp.moveaxis(X, axis, 0)
    even = X[::2]
    odd = X[1::2]
    z = jnp.zeros_like(even)
    left = jnp.concatenate([z[:1], 0.5 * odd], axis=0)
    right = jnp.concatenate([0.5 * odd, z[:1]], axis=0)
    out = even + left + right
    return jnp.moveaxis(out, 0, axis)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Q1Interp:
    """Matrix-free prolongation P: coarse → fine (dainterp.c analog).

    mult  = P  (coarse→fine Q1 interpolation)
    multT = Pᵀ (restriction; PCMG applies MatRestrict = Pᵀ)
    """

    fine: tuple = field(metadata=dict(static=True))
    coarse: tuple = field(metadata=dict(static=True))

    @property
    def shape(self):
        return (int(np.prod(self.fine)), int(np.prod(self.coarse)))

    def mult(self, xc):
        X = xc.reshape(self.coarse)
        for ax in range(len(self.fine)):
            X = _interp_axis(X, ax, self.fine[ax])
        return X.reshape(-1)

    def multT(self, xf):
        X = xf.reshape(self.fine)
        for ax in range(len(self.fine)):
            X = _restrict_axis(X, ax, self.coarse[ax])
        return X.reshape(-1)


def q0_interp_scipy(fine: tuple, coarse: tuple) -> sp.csr_matrix:
    """Piecewise-constant (cell-centered) interpolation — the DMDA_Q0
    path (DMCreateInterpolation_DA_3D_Q0, dainterp.c:588): fine cell
    (i,j,k) takes coarse cell (i//r, j//r, k//r)'s value, ratio
    r = mf/mc per axis ∈ {1,2}. Restriction (Pᵀ) sums the children."""
    assert len(fine) == len(coarse)
    nf = int(np.prod(fine))
    idx = np.arange(nf)
    coords = np.unravel_index(idx, fine)      # C-order, last axis fastest
    ccoords = []
    for ax in range(len(fine)):
        r = fine[ax] // coarse[ax]
        assert r * coarse[ax] == fine[ax] and r in (1, 2), (fine, coarse)
        ccoords.append(coords[ax] // r)
    col = np.ravel_multi_index(tuple(ccoords), coarse)
    return sp.csr_matrix((np.ones(nf), (idx, col)),
                         shape=(nf, int(np.prod(coarse))))


def q1_interp_scipy(fine: tuple, coarse: tuple,
                    boundary: tuple = ()) -> sp.csr_matrix:
    """scipy twin of Q1Interp (for Galerkin PᵀAP setup and tests).

    boundary: per-axis "none"|"periodic" (DMCreateInterpolation_DA_*_Q1
    dainterp.c:67-73 — periodic axes use ratio mx/Mx with wrapping
    right neighbor; non-periodic use the vertex-centered 2x−1 rule)."""
    def p1d(nc, nf):
        rows, cols, vals = [], [], []
        for i in range(nc):
            rows.append(2 * i)
            cols.append(i)
            vals.append(1.0)
        for i in range(nc - 1):
            rows += [2 * i + 1, 2 * i + 1]
            cols += [i, i + 1]
            vals += [0.5, 0.5]
        return sp.coo_matrix((vals, (rows, cols)), shape=(nf, nc)).tocsr()

    def p1d_periodic(nc, nf):
        # dainterp.c:93-118 with bx periodic: i_c = i//ratio, weights
        # (1−x, x) at (i_c, i_c+1 mod Mx), x = (i − i_c·ratio)/ratio
        ratio = nf // nc
        assert ratio * nc == nf, (nf, nc)
        rows, cols, vals = [], [], []
        for i in range(nf):
            ic = i // ratio
            x = (i - ic * ratio) / ratio
            rows.append(i)
            cols.append(ic)
            vals.append(1.0 - x)
            if ic * ratio != i:
                rows.append(i)
                cols.append((ic + 1) % nc)
                vals.append(x)
        return sp.coo_matrix((vals, (rows, cols)), shape=(nf, nc)).tocsr()

    bts = (boundary if boundary else ("none",) * len(fine))
    if isinstance(bts, str):
        bts = (bts,) * len(fine)

    def axis(k):
        return (p1d_periodic(coarse[k], fine[k]) if bts[k] == "periodic"
                else p1d(coarse[k], fine[k]))

    P = axis(0)
    for k in range(1, len(fine)):
        P = sp.kron(P, axis(k), format="csr")
    return P


def interp_dof_scipy(P: sp.csr_matrix, dof: int) -> sp.csr_matrix:
    """MAIJ expansion P ⊗ I_dof for interleaved multi-component grids —
    the reference wraps DMDA interpolation in MATMAIJ when dof>1
    (DMCreateInterpolation_DA, dainterp.c; src/mat/impls/maij)."""
    if dof == 1:
        return P
    return sp.kron(P, sp.identity(dof, format="csr"), format="csr")
