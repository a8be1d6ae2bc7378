"""StencilMat — grid-structured (DIA-style) matrices, the structured path.

The reference's structured-grid operators (DMDA-built matrices, the
lap2d/ex45 benchmark family) are stored as general CSR there; here the
same operator is expressed as a stencil — per-offset coefficient
arrays with pad+slice shifted reads, so an SpMV streams coefficients
and reads x without any gather. This format is the moral equivalent of
the reference's AIJPERM/CRL "regularized" layouts
(src/mat/impls/aij/seq/{csrperm,crl}) taken to their endpoint: no
index arrays at all.

Layout: coeffs[d, *grid] for offsets[d] (grid-coordinate tuples).
Row (i,j,..) of A has entry coeff_d[i,j,..] at column (i,j,..)+off_d.
Out-of-grid neighbors simply carry coefficient 0 (exactly how
boundary rows look in the assembled matrix).

  mult :  y = Σ_d coeff_d ⊙ shift(x, +off_d)     (pad+slice reads)
  multT:  y = Σ_d shift(coeff_d ⊙ x, −off_d)     (still scatter-free)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np


def _shift(xg: jax.Array, off: tuple, boundary: tuple = ()) -> jax.Array:
    """Return array s with s[idx] = xg[idx + off]; outside the grid the
    value is zero ("none"/"ghosted" — ghost values are user state, not
    operator structure), wraps (DMDA_BOUNDARY_PERIODIC), or reflects
    about the boundary node (DMDA_BOUNDARY_MIRROR, petscdmda.h:51:
    ghost −1 reads interior 1)."""
    if boundary:
        rolls = [(-int(o), ax) for ax, (o, b) in enumerate(zip(off, boundary))
                 if b == "periodic" and int(o) != 0]
        if rolls:
            xg = jnp.roll(xg, [r for r, _ in rolls], [a for _, a in rolls])
            off = tuple(0 if b == "periodic" else o
                        for o, b in zip(off, boundary))
    pads_zero = []
    pads_ref = []
    slices = []
    for ax, (o, dim) in enumerate(zip(off, xg.shape)):
        o = int(o)
        b = boundary[ax] if boundary else "none"
        p = (0, o) if o >= 0 else (-o, 0)
        slices.append(slice(o, o + dim) if o >= 0 else slice(0, dim))
        if b == "mirror":
            pads_ref.append(p)
            pads_zero.append((0, 0))
        else:
            pads_zero.append(p)
            pads_ref.append((0, 0))
    if any(p != (0, 0) for p in pads_ref):
        xg = jnp.pad(xg, pads_ref, mode="reflect")
    if any(p != (0, 0) for p in pads_zero):
        xg = jnp.pad(xg, pads_zero)
    if all(s == slice(0, d) for s, d in zip(slices, xg.shape)):
        return xg
    return xg[tuple(slices)]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class StencilMat:
    coeffs: jax.Array                                   # [D, *grid]
    offsets: tuple = field(metadata=dict(static=True))  # D grid-offset tuples
    grid: tuple = field(metadata=dict(static=True))
    # per-axis boundary: "none" | "periodic" (DMDABoundaryType analog);
    # () means all-none
    boundary: tuple = field(metadata=dict(static=True), default=())

    @property
    def shape(self):
        n = int(np.prod(self.grid))
        return (n, n)

    @property
    def dtype(self):
        return self.coeffs.dtype

    @property
    def nnz(self):
        # true nonzeros ≈ stored coefficients that are nonzero; for flop
        # accounting use the dense-stencil count (static)
        return int(np.prod(self.grid)) * len(self.offsets)

    def mult(self, x: jax.Array) -> jax.Array:
        """Shape-preserving: a grid-shaped x returns a grid-shaped y.

        This can matter for performance, not only convenience: where
        XLA lays a flat [m·n] carry and a [m, n] grid operand out with
        different memory tilings, a solver iterating on flat vectors
        pays a relayout copy at every mult. Driving the solve with
        grid-shaped vectors keeps the whole Krylov iteration in the
        grid layout."""
        xg = x.reshape(self.grid)
        y = jnp.zeros_like(xg)
        for d, off in enumerate(self.offsets):
            y = y + self.coeffs[d] * _shift(xg, off, self.boundary)
        return y.reshape(x.shape)

    def mult_add(self, x, y):
        return y + self.mult(x)

    def multT(self, x: jax.Array) -> jax.Array:
        if any(b == "mirror" for b in self.boundary):
            # the adjoint of a reflect-read is a fold-back scatter;
            # use the assembled form for transpose solves
            raise NotImplementedError("StencilMat.multT: mirror "
                                      "boundary (assemble to AIJ)")
        xg = x.reshape(self.grid)
        y = jnp.zeros_like(xg)
        for d, off in enumerate(self.offsets):
            y = y + _shift(self.coeffs[d] * xg, tuple(-o for o in off),
                           self.boundary)
        return y.reshape(x.shape)

    def diagonal(self) -> jax.Array:
        for d, off in enumerate(self.offsets):
            if all(o == 0 for o in off):
                return self.coeffs[d].reshape(-1)
        return jnp.zeros(self.shape[0], self.dtype)

    def rows_sum(self) -> jax.Array:
        return jnp.sum(self.coeffs, axis=0).reshape(-1)

    def scale(self, a) -> "StencilMat":
        return StencilMat(self.coeffs * a, self.offsets, self.grid,
                          self.boundary)

    def shift_diag(self, a) -> "StencilMat":
        for d, off in enumerate(self.offsets):
            if all(o == 0 for o in off):
                return StencilMat(self.coeffs.at[d].add(a), self.offsets,
                                  self.grid, self.boundary)
        raise ValueError("stencil has no diagonal offset")

    def flops_per_mult(self) -> float:
        return 2.0 * self.nnz - self.shape[0]


# ---- host converters --------------------------------------------------------
def stencil_from_scipy(A, grid: tuple, offsets=None, dtype=None) -> StencilMat:
    """Extract a StencilMat from a scipy matrix known to be grid-banded.

    offsets: iterable of grid-coordinate offsets; if None, inferred from
    the set of flat band offsets present (must map to in-grid offsets
    with |o_k| < grid[k])."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    n = int(np.prod(grid))
    assert A.shape == (n, n), f"matrix {A.shape} vs grid {grid}"
    strides = np.array([int(np.prod(grid[k + 1:])) for k in range(len(grid))],
                       dtype=np.int64)

    coo = A.tocoo()
    flat_offs = np.unique(coo.col - coo.row)
    if offsets is None:
        offsets = [_unflatten_offset(f, grid, strides) for f in flat_offs]
    offsets = [tuple(int(o) for o in off) for off in offsets]

    dtype = dtype or A.dtype
    D = len(offsets)
    coeffs = np.zeros((D,) + tuple(grid), dtype=dtype)
    rows_idx = np.arange(n)
    multi = np.stack(np.unravel_index(rows_idx, grid), axis=1)  # [n, nd]
    Acsr = A
    for d, off in enumerate(offsets):
        tgt = multi + np.array(off)
        ok = np.all((tgt >= 0) & (tgt < np.array(grid)), axis=1)
        cols = (tgt @ strides)
        vals = np.zeros(n, dtype=dtype)
        rr = rows_idx[ok]
        cc = cols[ok]
        vals[ok] = np.asarray(Acsr[rr, cc]).ravel()
        coeffs[d] = vals.reshape(grid)
    return StencilMat(jnp.asarray(coeffs), tuple(offsets), tuple(grid))


def _unflatten_offset(f: int, grid, strides):
    """Flat column offset → grid offset (choose minimal per-axis moves)."""
    off = []
    rem = int(f)
    for k, s in enumerate(strides):
        lim = grid[k]
        o = int(np.round(rem / s)) if s > 0 else 0
        # clamp to sane stencil range
        o = max(min(o, lim - 1), -(lim - 1))
        off.append(o)
        rem -= o * s
    if rem != 0:
        raise ValueError(f"flat offset {f} not representable on grid {grid}")
    return tuple(off)


def stencil_to_scipy(S: StencilMat):
    import scipy.sparse as sp

    n = S.shape[0]
    grid = S.grid
    strides = np.array([int(np.prod(grid[k + 1:])) for k in range(len(grid))])
    rows_idx = np.arange(n)
    multi = np.stack(np.unravel_index(rows_idx, grid), axis=1)
    rows, cols, vals = [], [], []
    C = np.asarray(S.coeffs)
    bnd = S.boundary or ("none",) * len(grid)
    periodic = np.array([b == "periodic" for b in bnd])
    for d, off in enumerate(S.offsets):
        tgt = multi + np.array(off)
        for k in np.where(periodic)[0]:
            tgt[:, k] %= grid[k]
        ok = np.all((tgt >= 0) & (tgt < np.array(grid)), axis=1)
        v = C[d].reshape(-1)
        keep = ok & (v != 0)
        rows.append(rows_idx[keep])
        cols.append((tgt @ strides)[keep])
        vals.append(v[keep])
    return sp.coo_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(n, n)).tocsr()


# ---- device Galerkin coarsening (stencil probing) ---------------------------
def coarse_reach(A: StencilMat) -> tuple:
    """Per-axis stencil reach of Pᵀ A P for Q1 (vertex 2:1) transfers.

    R[q,i] couples |i − 2q| ≤ 1, A couples |j − i| ≤ r, P[j,p] couples
    |j − 2p| ≤ 1, so |q − p| ≤ (r + 2) / 2 per axis."""
    nd = len(A.grid)
    return tuple((max(abs(int(off[ax])) for off in A.offsets) + 2) // 2
                 for ax in range(nd))


def galerkin_coarsen(A: StencilMat, P, coarse_grid: tuple) -> StencilMat:
    """Exact Galerkin coarse operator Ac = Pᵀ A P, computed ON DEVICE.

    The reference builds coarse MG operators with host SpGEMM
    (MatPtAP, src/mat/impls/aij/seq/matptap.c) because its data lives
    in host CSR. Here both A (stencil coefficient planes) and P
    (matrix-free Q1) live on the device, so the device formulation is
    comb probing: the coarse operator is again a stencil with per-axis
    reach rc (see coarse_reach), hence probing with combs of coarse
    unit vectors spaced s = 2·rc+1 apart resolves EVERY coarse matrix
    entry exactly — within any s-wide window there is exactly one comb
    point per class, so y = Pᵀ(A(P·comb_class))[q] IS the single
    coefficient A_c[q, p(q,class)]. Π s_ax probes (9 for 2-D 5/9-point,
    27 for 3-D) of one RAP apply each; no host transfer, no SpGEMM.

    Returns the full ±rc box stencil (planes that are identically zero
    are kept — they are the DMDA structural zeros the reference's
    fdda.c preallocation also keeps).
    """
    import functools
    import itertools

    nd = len(A.grid)
    bnd = A.boundary or ("none",) * nd
    if any(b == "periodic" for b in bnd):
        # comb classes would alias across the wrap unless s | grid;
        # periodic hierarchies keep the host PtAP path
        raise NotImplementedError("galerkin_coarsen: periodic boundary")
    rc = coarse_reach(A)
    s = tuple(2 * r + 1 for r in rc)
    classes = list(itertools.product(*[range(si) for si in s]))
    offs_c = list(itertools.product(*[range(-ri, ri + 1) for ri in rc]))

    iotas = [jax.lax.broadcasted_iota(jnp.int32, tuple(coarse_grid), ax)
             for ax in range(nd)]

    def _rap(xc_grid):
        y = P.multT(A.mult(P.mult(xc_grid.reshape(-1))))
        return y.reshape(tuple(coarse_grid))

    ys = []
    for cls in classes:
        mask = functools.reduce(
            jnp.logical_and,
            [(iotas[ax] % s[ax]) == cls[ax] for ax in range(nd)])
        ys.append(_rap(mask.astype(A.dtype)))
    ys = jnp.stack(ys)                        # [Πs, *coarse_grid]

    planes = []
    for off in offs_c:
        cls_idx = jnp.zeros(tuple(coarse_grid), jnp.int32)
        for ax in range(nd):
            cls_idx = cls_idx * s[ax] + (iotas[ax] + off[ax]) % s[ax]
        planes.append(jnp.take_along_axis(ys, cls_idx[None], axis=0)[0])
    return StencilMat(jnp.stack(planes), tuple(offs_c),
                      tuple(coarse_grid), A.boundary)
