"""Jacobian construction strategies for SNES.

Reference: SNESComputeJacobian (src/snes/interface/snes.c:2101)
dispatches between a user callback, FD-coloring
(SNESDefaultComputeJacobianColor snesj2.c:36 → MatFDColoringApply
src/mat/matfd/fdmatrix.c) and matrix-free MFFD (src/snes/mf,
src/mat/impls/mffd). Additions the reference cannot have:

  * `jvp_operator` — EXACT matrix-free Jacobian-vector products via
    jax.jvp (forward-mode AD): no ε, no extra F evaluations;
  * `ColoredJacobian` — the FD-coloring assembly runs as ONE batched
    (vmapped) residual evaluation over all colors, and the entries
    land directly in the ELL/stencil value arrays by pure gathers (no
    scatter): vals[i,k] = (F_batch[color[cols[i,k]], i] − F0[i]) / h.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from petsctpu.mat.base import Shell
from petsctpu.mat.coloring import greedy_color, stencil_coloring
from petsctpu.mat.ell import AIJ
from petsctpu.mat.stencil import StencilMat


def jvp_operator(F: Callable, x: jax.Array, Fx: jax.Array) -> Shell:
    """Exact J(x)·v via forward-mode AD."""
    n = x.shape[0]

    def mv(ctx, v):
        xx, = ctx
        return jax.jvp(F, (xx,), (v,))[1]

    def mtv(ctx, v):
        xx, = ctx
        return jax.vjp(F, xx)[1](v)[0]

    return Shell(ctx=(x,), mult_fn=mv, multT_fn=mtv, shape=(n, n))


def mffd_operator(F: Callable, x: jax.Array, Fx: jax.Array,
                  umin: float = 1e-6) -> Shell:
    """MFFD: J·v ≈ (F(x + h v) − F(x))/h, h from the reference's 'wp'
    differencing parameter heuristic (src/mat/impls/mffd/wp.c)."""
    n = x.shape[0]
    eps = jnp.sqrt(jnp.finfo(x.dtype).eps)

    def mv(ctx, v):
        xx, Fxx = ctx
        nv = jnp.linalg.norm(v)
        nx = jnp.linalg.norm(xx)
        # wp.c:73-81 verbatim: h = error_rel·sqrt(1+‖u‖)/‖a‖
        h = eps * jnp.where(nv > 0,
                            jnp.sqrt(1.0 + nx) / jnp.maximum(nv, 1e-30),
                            1.0)
        return (F(xx + h * v) - Fxx) / h

    return Shell(ctx=(x, Fx), mult_fn=mv, shape=(n, n))


@dataclass(frozen=True)
class ColoredJacobian:
    """Plan for FD-coloring Jacobian assembly into a frozen layout.

    Built once from the sparsity (host); `assemble(F, x, Fx)` is pure
    jit-safe device code producing an AIJ or StencilMat."""

    template: object               # AIJ or StencilMat (structure donor)
    color: np.ndarray              # int32 [n] column colors
    ncolors: int
    # differencing parameter rule: "const" (one h = sqrt(eps) for all
    # columns — the round-1 scheme) or "ds" (the reference's
    # MatFDColoringApply default, fdmatrix.c:583-593: per-column
    # dx_j = eps*x_j clamped to +-eps*umin, entries scaled by 1/dx_j)
    htype: str = "const"
    umin: float = 0.0              # 0 -> 100*sqrt(machine eps)

    @classmethod
    def from_sparsity(cls, A_host, template,
                      htype: str = "const") -> "ColoredJacobian":
        color = greedy_color(A_host)
        return cls(template, color, int(color.max()) + 1, htype)

    @classmethod
    def from_stencil(cls, template: StencilMat,
                     htype: str = "const") -> "ColoredJacobian":
        color = stencil_coloring(template.grid, template.offsets)
        return cls(template, color, int(color.max()) + 1, htype)

    def assemble(self, F: Callable, x: jax.Array, Fx: jax.Array,
                 h: float = None):
        dtype = x.dtype
        n = x.shape[0]
        eps_m = float(np.finfo(np.dtype(dtype)).eps)
        hval = jnp.asarray(h if h is not None else np.sqrt(eps_m), dtype)
        colors = jnp.asarray(self.color)
        # perturbation directions: D[c] = 1 where color == c
        D = (colors[None, :] == jnp.arange(self.ncolors)[:, None]).astype(dtype)
        if self.htype == "ds":
            umin = jnp.asarray(self.umin or 100.0 * np.sqrt(eps_m), dtype)
            eps = jnp.asarray(np.sqrt(eps_m), dtype)
            dx = x
            dx = jnp.where(dx == 0, jnp.ones((), dtype), dx)
            dx = jnp.where((jnp.abs(dx) < umin) & (dx.real >= 0),
                           umin, dx)
            dx = jnp.where((dx.real < 0) & (jnp.abs(dx) < umin),
                           -umin, dx)
            dx = dx * eps                        # per-column parameter
            vscale = 1.0 / dx
            Fb = jax.vmap(lambda d: F(x + dx * d))(D)      # [C, n]
            return self._fill(Fb, Fx, colors, vscale, n)
        Fb = jax.vmap(lambda d: F(x + hval * d))(D)        # [C, n]
        return self._fill(Fb, Fx, colors,
                          jnp.full((n,), 1.0 / hval, dtype), n)

    def _fill(self, Fb, Fx, colors, vscale, n):
        t = self.template
        if isinstance(t, StencilMat):
            grid = t.grid
            rows = jnp.arange(n)
            cg = colors.reshape(grid)
            coeffs = []
            multi = np.stack(np.unravel_index(np.arange(n), grid), axis=1)
            for d, off in enumerate(t.offsets):
                tgt = multi + np.array(off)
                ok = np.all((tgt >= 0) & (tgt < np.array(grid)), axis=1)
                strides = np.array([int(np.prod(grid[k + 1:]))
                                    for k in range(len(grid))])
                col = np.where(ok, tgt @ strides, 0)
                colj = colors[jnp.asarray(col)]
                v = (Fb[colj, rows] - Fx) * vscale[jnp.asarray(col)]
                v = jnp.where(jnp.asarray(ok), v, 0.0)
                coeffs.append(v.reshape(grid))
            return StencilMat(jnp.stack(coeffs), t.offsets, t.grid)
        # AIJ/ELL: vals[i,k] = (Fb[color[cols[i,k]], i] − Fx[i]) / h
        rows = jnp.arange(t.shape[0])[:, None]
        vj = (Fb[colors[t.cols], jnp.broadcast_to(rows, t.cols.shape)]
              - Fx[:, None]) * vscale[t.cols]
        # keep only true pattern entries (padding has vals==0 in template)
        pattern = t.vals != 0
        return AIJ(t.cols, jnp.where(pattern, vj, 0.0), t.shape, t.nnz)
