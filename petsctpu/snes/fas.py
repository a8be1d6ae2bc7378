"""FAS nonlinear multigrid, colored nonlinear Gauss-Seidel, and
nonlinear CG.

Reference: SNESFAS (src/snes/impls/fas/fas.c — full approximation
scheme V-cycles with nonlinear smoothers and a Newton coarse solve),
SNESGS (src/snes/impls/gs — pointwise nonlinear Gauss-Seidel; the
reference sweeps points, we sweep stencil COLORS so each color's
pointwise Newton updates run data-parallel), SNESNCG
(src/snes/impls/ncg — Fletcher-Reeves/PRP nonlinear CG with a
critical-point secant line search).

Device mapping: a colored NGS sweep is 2 residual evaluations per color
(probe + update), fully vectorized; the FAS V-cycle is a static
Python recursion over levels (XLA sees straight-line code), with the
outer iteration a `lax.while_loop`.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from petsctpu.core.errors import SNESConvergedReason
from petsctpu.ksp.common import KSPConfig
from petsctpu.mat.coloring import stencil_coloring
from petsctpu.snes.api import SNESConfig, SNESResult, _check, _monitor, snes_solve
from petsctpu.vec import ops


# ---------------------------------------------------------------------------
# Colored nonlinear Gauss-Seidel
# ---------------------------------------------------------------------------

def ngs_sweep(F: Callable, x: jax.Array, b, colors: jax.Array, ncolors: int,
              omega: float = 1.0, h: float = None):
    """One nonlinear Gauss-Seidel sweep over stencil colors.

    For each color c: one residual eval + one probe along the color's
    indicator vector yields the Jacobian diagonal on that color (same-
    colored points don't interact at distance-2 coloring), then all
    points of the color take a damped pointwise Newton step at once."""
    dtype = x.dtype
    hval = jnp.asarray(h if h is not None
                       else np.sqrt(np.finfo(np.dtype(dtype)).eps), dtype)
    for c in range(ncolors):
        Fx = F(x)
        r = Fx - b if b is not None else Fx
        d = (colors == c).astype(dtype)
        diag = (F(x + hval * d) - Fx) / hval
        safe = jnp.where(jnp.abs(diag) > 1e-30, diag,
                         jnp.ones_like(diag))
        x = x - jnp.where(colors == c, omega * r / safe, 0.0)
    return x


def snes_ngs(F: Callable, x0: jax.Array, colors: np.ndarray,
             ncolors: int = None, omega: float = 1.0,
             cfg: SNESConfig = None, axis: Optional[str] = None,
             **kw) -> SNESResult:
    """Standalone nonlinear Gauss-Seidel solver (SNESGS analog)."""
    cfg = replace(cfg or SNESConfig(), **kw) if kw else (cfg or SNESConfig())
    colors_j = jnp.asarray(colors)
    nc = ncolors if ncolors is not None else int(np.max(colors)) + 1

    Fx = F(x0)
    fnorm = ops.norm(Fx, axis)
    fnorm0 = fnorm
    history = jnp.full((cfg.maxits + 1,), jnp.nan, x0.dtype).at[0].set(fnorm)
    _monitor(cfg, 0, fnorm)
    reason = _check(fnorm, fnorm0, jnp.zeros((), x0.dtype),
                    ops.norm(x0, axis), jnp.int32(0), cfg)

    def cond(c):
        return c["reason"] == SNESConvergedReason.ITERATING

    def body(c):
        x = ngs_sweep(F, c["x"], None, colors_j, nc, omega)
        fn = ops.norm(F(x), axis)
        its = c["its"] + 1
        history = c["history"].at[its].set(fn)
        _monitor(cfg, its, fn)
        reason = _check(fn, fnorm0, ops.norm(x - c["x"], axis),
                        ops.norm(x, axis), its, cfg)
        return dict(x=x, its=its, history=history, reason=reason)

    out = lax.while_loop(cond, body, dict(x=x0, its=jnp.int32(0),
                                          history=history, reason=reason))
    return SNESResult(out["x"], out["its"], out["reason"],
                      ops.norm(F(out["x"]), axis), out["history"])


# ---------------------------------------------------------------------------
# FAS — full approximation scheme
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FASLevel:
    """One level of the FAS hierarchy (fine→coarse list order).

    F       residual function on this level
    colors  distance-2 coloring (NGS smoother plan)
    ncolors number of colors
    interp  Q1Interp fine←coarse (None on the coarsest level)
    inject  int index array restricting fine states to the coarse grid
            (None on the coarsest level)
    """

    F: Callable
    colors: np.ndarray
    ncolors: int
    interp: object = None
    inject: np.ndarray = None
    # interior mask (1 on PDE rows, 0 on Dirichlet-identity boundary
    # rows): Pᵀ would otherwise leak interior residuals into coarse
    # boundary rows and corrupt the FAS right-hand side
    interior: np.ndarray = None


def fas_levels_from_da(da, make_residual: Callable, nlevels: int,
                       mask_boundary: bool = False) -> Sequence[FASLevel]:
    """Build a FAS hierarchy from a DA and a residual factory
    `make_residual(da) -> F` (e.g. models.bratu_residual)."""
    levels = []
    cur = da

    def interior_mask(grid):
        m = np.zeros(grid, bool)
        m[tuple(slice(1, -1) for _ in grid)] = True
        return m.reshape(-1)

    for l in range(nlevels):
        offs = cur.stencil_offsets()
        colors = stencil_coloring(cur.grid, offs)
        nc = int(colors.max()) + 1
        interp = inject = None
        if l < nlevels - 1:
            coarse = cur.coarsen()
            interp = cur.interpolation(coarse)
            idx = np.arange(int(np.prod(cur.grid))).reshape(cur.grid)
            inject = idx[tuple(slice(None, None, 2) for _ in cur.grid)
                         ].reshape(-1).copy()
            levels.append(FASLevel(make_residual(cur), colors, nc, interp,
                                   inject,
                                   interior_mask(coarse.grid)
                                   if mask_boundary else None))
            cur = coarse
        else:
            levels.append(FASLevel(make_residual(cur), colors, nc))
    return levels


def snes_fas(levels: Sequence[FASLevel], x0: jax.Array,
             cfg: SNESConfig = None, npre: int = 2, npost: int = 2,
             omega: float = 0.9, coarse_cfg: SNESConfig = None,
             coarse_ksp: KSPConfig = None, axis: Optional[str] = None,
             smoother: str = "ngs", user_smoothers=None,
             fas_type: str = "multiplicative",
             **kw) -> SNESResult:
    """FAS V-cycle iteration (SNESFAS, fas.c).

    Each outer iteration runs one V-cycle: presmooth, restrict state
    (injection) and residual (Pᵀ), form the coarse FAS right-hand side
    b_c = F_c(R x) + R(b − F(x)), recurse, prolong the coarse
    CORRECTION, postsmooth. The coarsest level is solved by
    Newton-Krylov (reference default: SNESNEWTONLS on level 0).

    smoother: "ngs" (colored nonlinear Gauss-Seidel — the
    data-parallel choice), "nrichardson" (the reference's DEFAULT
    level smoother, fasfunc.c:396: one L2-line-search Richardson step
    per sweep — use with npre=npost=1 for fas.c default behavior), or
    "user" with user_smoothers = per-level callables f(x, b) — the
    SNESSetGS hook (one call = one smoother iteration; npre/npost are
    the level SNES max_its, fasfunc.c:269)."""
    cfg = replace(cfg or SNESConfig(), **kw) if kw else (cfg or SNESConfig())
    coarse_cfg = coarse_cfg or SNESConfig(maxits=12, rtol=1e-10,
                                          linesearch="bt")
    coarse_ksp = coarse_ksp or KSPConfig(ksp_type="gmres", rtol=1e-8,
                                         maxits=200)
    nlev = len(levels)
    colors_j = [jnp.asarray(L.colors) for L in levels]
    inject_j = [jnp.asarray(L.inject) if L.inject is not None else None
                for L in levels]

    def smooth(l, x, b, sweeps):
        if smoother == "user":
            for _ in range(sweeps):
                x = user_smoothers[l](x, b)
            return x
        if smoother == "nrichardson":
            from petsctpu.snes.api import _linesearch_l2

            def R(v):
                return levels[l].F(v) - b
            for _ in range(sweeps):
                Rx = R(x)
                x, _, _, _, _ = _linesearch_l2(R, x, Rx,
                                               ops.norm(Rx, axis), axis)
            return x
        for _ in range(sweeps):
            x = ngs_sweep(levels[l].F, x, b, colors_j[l], levels[l].ncolors,
                          omega)
        return x

    def vcycle(l, x, b):
        L = levels[l]
        if l == nlev - 1:
            res = snes_solve(lambda y: L.F(y) - b, x, jac="jvp",
                             ksp_cfg=coarse_ksp, cfg=coarse_cfg, axis=axis)
            return res.x
        x = smooth(l, x, b, npre)
        r = b - L.F(x)
        xc0 = x[inject_j[l]]
        Rr = L.interp.multT(r)
        if L.interior is not None:
            Rr = jnp.where(jnp.asarray(L.interior), Rr, 0.0)
        bc = levels[l + 1].F(xc0) + Rr
        xc = vcycle(l + 1, xc0, bc)
        x = x + L.interp.mult(xc - xc0)
        x = smooth(l, x, b, npost)
        return x

    def acycle(l, x, b):
        """SNESFASCycle_Additive (fas.c:625): recurse FIRST from the
        unsmoothed iterate, smooth this level from the SAME iterate,
        then add the interpolated coarse direction through the FAS
        L2 line search (fas.c:343 sets SNESLINESEARCHL2 for the
        additive coarse correction)."""
        from petsctpu.snes.api import _linesearch_l2

        L = levels[l]
        if l == nlev - 1:
            res = snes_solve(lambda y: L.F(y) - b, x, jac="jvp",
                             ksp_cfg=coarse_ksp, cfg=coarse_cfg, axis=axis)
            return res.x

        def G(y):
            return L.F(y) - b

        Fx = G(x)
        xc0 = x[inject_j[l]]
        Rr = L.interp.multT(Fx)
        if L.interior is not None:
            Rr = jnp.where(jnp.asarray(L.interior), Rr, 0.0)
        bc = levels[l + 1].F(xc0) - Rr
        xc = acycle(l + 1, xc0, bc)
        xs = smooth(l, x, b, npre)
        d = L.interp.mult(xc0 - xc)      # minus convention: xn = x − λd
        Fs = G(xs)
        xn, _, _, _, _ = _linesearch_l2(G, xs, d, ops.norm(Fs, axis), axis)
        return xn

    cycle = acycle if fas_type == "additive" else vcycle

    F0 = levels[0].F
    Fx = F0(x0)
    fnorm = ops.norm(Fx, axis)
    fnorm0 = fnorm
    history = jnp.full((cfg.maxits + 1,), jnp.nan, x0.dtype).at[0].set(fnorm)
    _monitor(cfg, 0, fnorm)
    reason = _check(fnorm, fnorm0, jnp.zeros((), x0.dtype),
                    ops.norm(x0, axis), jnp.int32(0), cfg)
    zero_b = jnp.zeros_like(x0)

    def cond(c):
        return c["reason"] == SNESConvergedReason.ITERATING

    def body(c):
        x = cycle(0, c["x"], zero_b)
        fn = ops.norm(F0(x), axis)
        its = c["its"] + 1
        history = c["history"].at[its].set(fn)
        _monitor(cfg, its, fn)
        # fas.c:824 passes xnorm=snorm=0 to the convergence test —
        # the step tolerance NEVER fires for FAS cycles (matching the
        # oracle's 23-cycle ex5_5_fas trajectory; with a live stol the
        # run stops 10 cycles early)
        reason = _check(fn, fnorm0, jnp.zeros((), fn.dtype),
                        jnp.zeros((), fn.dtype), its, cfg)
        return dict(x=x, its=its, history=history, reason=reason)

    out = lax.while_loop(cond, body, dict(x=x0, its=jnp.int32(0),
                                          history=history, reason=reason))
    return SNESResult(out["x"], out["its"], out["reason"],
                      ops.norm(F0(out["x"]), axis), out["history"])


# ---------------------------------------------------------------------------
# Nonlinear CG
# ---------------------------------------------------------------------------

def snes_ncg(F: Callable, x0: jax.Array, beta_type: str = "prp",
             ls_its: int = 1, cfg: SNESConfig = None,
             axis: Optional[str] = None, **kw) -> SNESResult:
    """Nonlinear conjugate gradients (SNESNCG, src/snes/impls/ncg).

    Directions p = F + β p with β from Fletcher-Reeves ("fr") or
    Polak-Ribière-Polyak ("prp", reference default, with max(β,0)
    restart). Step length from the reference's default "cp" line
    search: secant iteration on g(λ) = F(x−λp)·p = 0."""
    cfg = replace(cfg or SNESConfig(), **kw) if kw else (cfg or SNESConfig())
    dtype = x0.dtype

    Fx = F(x0)
    fnorm = ops.norm(Fx, axis)
    fnorm0 = fnorm
    history = jnp.full((cfg.maxits + 1,), jnp.nan, dtype).at[0].set(fnorm)
    _monitor(cfg, 0, fnorm)
    reason = _check(fnorm, fnorm0, jnp.zeros((), dtype),
                    ops.norm(x0, axis), jnp.int32(0), cfg)

    def cp_linesearch(x, p, Fx):
        """The reference's CP line search, linear order, ONE iteration
        (linesearchcp.c:61, defaults linesearch.c:63): secant on
        g(λ) = ⟨F(x−λp), p⟩ with the sign/steptol rules verbatim."""
        steptol = jnp.asarray(1e-12, dtype)
        lam = jnp.asarray(1.0, dtype)
        lam_old = jnp.asarray(0.0, dtype)
        fty_old = ops.dot(Fx, p, axis)
        for _ in range(ls_its):
            fty = ops.dot(F(x - lam * p), p, axis)
            s = (fty - fty_old) / (lam - lam_old)
            s = jnp.where(s > 0, -s, s)
            upd = lam - fty / s
            upd = jnp.where(upd < steptol, lam + fty / s, upd)
            lam_old, lam, fty_old = lam, upd, fty
        return lam

    def body(c):
        x, Fx, p, its = c["x"], c["F"], c["p"], c["its"]
        lam = cp_linesearch(x, p, Fx)
        xn = x - lam * p
        Fn = F(xn)
        fn = ops.norm(Fn, axis)
        if beta_type == "fr":
            beta = (fn * fn) / jnp.maximum(c["fnorm"] ** 2, 1e-300)
        else:                                   # PRP+ (reference default)
            num_l = jnp.vdot(Fn, Fn - Fx)
            num = ops.psum(num_l, axis)
            beta = jnp.maximum(num / jnp.maximum(c["fnorm"] ** 2, 1e-300),
                               0.0)
        pn = Fn + beta * p
        its = its + 1
        history = c["history"].at[its].set(fn)
        _monitor(cfg, its, fn)
        reason = _check(fn, fnorm0, ops.norm(xn - x, axis),
                        ops.norm(xn, axis), its, cfg)
        return dict(x=xn, F=Fn, p=pn, fnorm=fn, its=its, history=history,
                    reason=reason)

    def cond(c):
        return c["reason"] == SNESConvergedReason.ITERATING

    out = lax.while_loop(cond, body, dict(x=x0, F=Fx, p=Fx, fnorm=fnorm,
                                          its=jnp.int32(0), history=history,
                                          reason=reason))
    return SNESResult(out["x"], out["its"], out["reason"], out["fnorm"],
                      out["history"])
