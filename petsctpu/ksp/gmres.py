"""GMRES(m) and flexible FGMRES as nested `lax.while_loop` programs.

Reference: KSPGMRESCycle (src/ksp/ksp/impls/gmres/gmres.c:118) —
restarted Arnoldi with Givens-rotation Hessenberg updates; pluggable
orthogonalization (classical Gram-Schmidt w/ optional iterative
refinement, borthog2.c; modified GS, borthog.c); FGMRES
(src/ksp/ksp/impls/gmres/fgmres) stores the preconditioned directions
so the preconditioner may change per iteration.

Device mapping: the Krylov basis V is a [m+1, n] matrix; classical GS
is ONE V@w matvec + one psum — the reference's VecMDot hot spot
(dvec2.c:36) becomes a single fused reduction. Modified GS is provided
for parity but costs m sequential dots. All shapes static; the active
column count j is masked.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from petsctpu.core.errors import ConvergedReason
from petsctpu.ksp.common import (
    KSPConfig, SolveResult, NORM_NONE, NORM_PRECONDITIONED,
    NORM_UNPRECONDITIONED, apply_pc, check_convergence, init_history,
    monitor_cb, monitor_cb_if, monitor_true_cb, monitor_true_cb_if,
    record, rnorm0_reference,
)
from petsctpu.vec import ops


def _orthogonalize(V, w, j, m, cfg, axis):
    """Orthogonalize w against V[0..j] (masked). Returns (w, h[m+1])."""
    mask = (jnp.arange(m + 1) <= j)

    if cfg.orth == "mgs":
        # modified Gram-Schmidt: sequential masked dots (borthog.c)
        def body(i, carry):
            w, h = carry
            active = i <= j
            hi = jnp.where(active, ops.dot(V[i], w, axis), 0.0)
            w = w - hi * V[i]
            return (w, h.at[i].set(hi))

        w, h = lax.fori_loop(0, m + 1, body, (w, jnp.zeros(m + 1, w.dtype)))
        return w, h

    # classical GS: one mdot + correction (borthog2.c)
    h = jnp.where(mask, ops.mdot(w, V, axis), 0.0)
    w = w - h @ V
    if cfg.cgs_refine in ("always", "ifneeded"):
        # 'ifneeded' is treated as 'always': the data-dependent skip
        # would force a device round-trip; a second CGS pass is one
        # extra matvec+psum and is unconditionally stable.
        h2 = jnp.where(mask, ops.mdot(w, V, axis), 0.0)
        w = w - h2 @ V
        h = h + h2
    return w, h


def _apply_givens(h, hj1, cs, sn, g, j, m):
    """Apply stored rotations 0..j-1 to column h, then form rotation j.

    Returns (h_col updated incl. new diag, cs, sn, g, rnorm)."""

    def rot(i, h):
        # KSPGMRESUpdateHessenberg (gmres.c): complex-correct plane
        # rotations — h_i ← conj(c)h_i + s·h_{i+1}; h_{i+1} ← c·h_{i+1}
        # − s·h_i (conj is a no-op for real dtypes)
        active = i < j
        hi = jnp.conj(cs[i]) * h[i] + sn[i] * h[i + 1]
        hip = cs[i] * h[i + 1] - sn[i] * h[i]
        h = h.at[i].set(jnp.where(active, hi, h[i]))
        h = h.at[i + 1].set(jnp.where(active, hip, h[i + 1]))
        return h

    h = lax.fori_loop(0, m, rot, h)
    hj = h[j]
    # tt = sqrt(conj(h)h + conj(h1)h1); c = h/tt; s = h1/tt (hj1 is the
    # real orthogonalization norm, so tt is real-positive)
    denom = jnp.sqrt((jnp.conj(hj) * hj + hj1 * hj1).real).astype(h.dtype)
    safe = jnp.abs(denom) > 0
    c = jnp.where(safe, hj / jnp.where(safe, denom, 1.0), 1.0)
    s = jnp.where(safe, hj1 / jnp.where(safe, denom, 1.0), 0.0)
    cs = cs.at[j].set(c)
    sn = sn.at[j].set(s)
    h = h.at[j].set(jnp.conj(c) * hj + s * hj1)
    gj = g[j]
    g = g.at[j].set(jnp.conj(c) * gj)
    g = g.at[j + 1].set(-s * gj)
    rnorm = jnp.abs(g[j + 1])
    return h, cs, sn, g, rnorm


def _solve_update(H, g, basis, j_end, m):
    """x-correction = basisᵀ y with R y = g solved on the leading j_end.

    basis is [m, n]. Unused columns of H (j >= j_end) are still zero,
    so adding 1 to their diagonal with a zero rhs makes y vanish there."""
    k = jnp.arange(m)
    R = H[:m, :m] + jnp.diag(jnp.where(k >= j_end, 1.0, 0.0).astype(H.dtype))
    gs = jnp.where(k < j_end, g[:m], 0.0)
    y = jax.scipy.linalg.solve_triangular(R, gs, lower=False)
    return y @ basis


def _gmres_generic(A, b, x0, pc, cfg: KSPConfig, axis, flexible: bool):
    dtype = b.dtype
    m = cfg.restart
    n = b.shape[0]
    nt = cfg.norm_type or (NORM_UNPRECONDITIONED if flexible
                           else NORM_PRECONDITIONED)

    def precond_res(x):
        r = b - A.mult(x)
        if flexible or nt == NORM_UNPRECONDITIONED:
            return r          # right-preconditioned: residual is true residual
        return apply_pc(pc, r)

    history0 = init_history(cfg, dtype)

    def outer_cond(c):
        return c["reason"] == ConvergedReason.ITERATING

    def outer_body(c):
        x = c["x"]
        r = precond_res(x)
        beta = ops.norm(r, axis)
        first = c["its"] == 0
        rnorm0 = jnp.where(first,
                           rnorm0_reference(cfg, b, pc, nt, axis, beta),
                           c["rnorm0"])
        history = jnp.where(first, record(c["history"], 0, beta), c["history"])
        monitor_cb_if(cfg, first, jnp.int32(0), beta)
        if cfg.monitor_true:
            monitor_true_cb_if(cfg, first, jnp.int32(0), beta,
                               ops.norm(b - A.mult(x), axis),
                               ops.norm(b, axis))
        reason = jnp.where(first,
                           check_convergence(beta, rnorm0, jnp.int32(0), cfg),
                           c["reason"])

        V = jnp.zeros((m + 1, n), dtype).at[0].set(
            r / jnp.where(beta > 0, beta, 1.0))
        Z = jnp.zeros((m, n), dtype) if flexible else jnp.zeros((0, n), dtype)
        H = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)

        def inner_cond(ic):
            return (ic["j"] < m) & (ic["reason"] == ConvergedReason.ITERATING)

        def inner_body(ic):
            j = ic["j"]
            v = ic["V"][j]
            if flexible:
                z = apply_pc(pc, v)
                Z = ic["Z"].at[j].set(z)
                w = A.mult(z)
            else:
                Z = ic["Z"]
                w = apply_pc(pc, A.mult(v))
            w, h = _orthogonalize(ic["V"], w, j, m, cfg, axis)
            hj1 = ops.norm(w, axis)
            V = ic["V"].at[j + 1].set(w / jnp.where(hj1 > 0, hj1, 1.0))
            h, cs, sn, g, rnorm = _apply_givens(h, hj1, ic["cs"], ic["sn"],
                                                ic["g"], j, m)
            H = ic["H"].at[:, j].set(h)
            its = ic["its"] + 1
            history = record(ic["history"], its, rnorm)
            monitor_cb(cfg, its, rnorm)
            if cfg.monitor_true:
                # KSPBuildResidual: form the current iterate and its
                # actual residual (only compiled in when requested)
                basis = Z if flexible else V[:m]
                xcur = x + _solve_update(H, g, basis, ic["j"] + 1, m)
                rtrue = ops.norm(b - A.mult(xcur), axis)
                monitor_true_cb(cfg, its, rnorm, rtrue,
                                ops.norm(b, axis))
            reason = check_convergence(rnorm, ic["rnorm0"], its, cfg)
            # lucky/happy breakdown: residual exactly 0
            reason = jnp.where((reason == 0) & (hj1 == 0),
                               jnp.int32(ConvergedReason.CONVERGED_HAPPY_BREAKDOWN),
                               reason)
            return dict(V=V, Z=Z, H=H, cs=cs, sn=sn, g=g, j=j + 1, its=its,
                        history=history, reason=reason, rnorm0=ic["rnorm0"])

        init_inner = dict(V=V, Z=Z, H=H, cs=cs, sn=sn, g=g, j=jnp.int32(0),
                          its=c["its"], history=history, reason=reason,
                          rnorm0=rnorm0)
        ic = lax.while_loop(inner_cond, inner_body, init_inner)

        basis = ic["Z"] if flexible else ic["V"][:m]
        dx = _solve_update(ic["H"], ic["g"], basis, ic["j"], m)
        x = x + dx
        return dict(x=x, its=ic["its"], reason=ic["reason"],
                    rnorm0=ic["rnorm0"], history=ic["history"])

    x0 = x0 if cfg.guess_nonzero else jnp.zeros_like(b)
    init = dict(x=x0, its=jnp.int32(0),
                reason=jnp.int32(ConvergedReason.ITERATING),
                rnorm0=jnp.zeros((), dtype), history=history0)
    out = lax.while_loop(outer_cond, outer_body, init)
    return SolveResult(out["x"], out["its"], out["reason"],
                       out["history"][out["its"]], out["history"])


def solve_gmres(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """Left-preconditioned restarted GMRES (gmres.c default)."""
    return _gmres_generic(A, b, x0, pc, cfg, axis, flexible=False)


def solve_fgmres(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """Flexible (right-preconditioned) GMRES storing Z directions."""
    return _gmres_generic(A, b, x0, pc, cfg, axis, flexible=True)
