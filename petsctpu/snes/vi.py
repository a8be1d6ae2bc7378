"""SNES VI — box-constrained variational inequalities.

Reference: src/snes/impls/vi (reduced-space rsaug/rs and semismooth ss
variants). Solves
    F(x) ⟂ (lb ≤ x ≤ ub):   x in box, F_i(x) = 0 where lb<x<ub,
    F_i ≥ 0 where x=lb, F_i ≤ 0 where x=ub.

RSLS (src/snes/impls/vi — SNESVINEWTONRSLS): each iteration classifies
the active set from (x, F), solves the Newton system restricted to
inactive variables (the operator masks active rows/cols to identity —
same static shapes every iteration), steps active variables to their
bound, projects, and measures the NATURAL residual ‖x − Π(x − F)‖.

SSLS (src/snes/impls/vi/ss): reformulates the VI as the nonsmooth
system Φ(x) = 0 via the Fischer-Burmeister NCP function
    φ(a, b) = sqrt(a² + b²) − a − b
(lower bound: a = x − lb, b = F; upper bound composed through
−φ(ub − x, −·)), then runs Newton on a B-subdifferential element with
an Armijo line search on the merit ½‖Φ‖². Everything is elementwise +
one jvp — the data-parallel variant (no active-set reshuffling at all).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from petsctpu.core.errors import SNESConvergedReason
from petsctpu.ksp.api import KSP_REGISTRY
from petsctpu.ksp.common import KSPConfig
from petsctpu.mat.base import Shell
from petsctpu.snes.api import SNESConfig, SNESResult, _check, _monitor
from petsctpu.vec import ops


def snes_vinewtonrsls(F: Callable, x0: jax.Array, lb, ub,
                      cfg: SNESConfig = None, ksp_cfg: KSPConfig = None,
                      axis: Optional[str] = None, active_tol: float = 1e-10,
                      **kw) -> SNESResult:
    cfg = replace(cfg or SNESConfig(), **kw) if kw else (cfg or SNESConfig())
    ksp_cfg = ksp_cfg or KSPConfig(ksp_type="gmres", rtol=1e-6, maxits=300)
    solver = KSP_REGISTRY[ksp_cfg.ksp_type]
    lb = jnp.broadcast_to(jnp.asarray(lb, x0.dtype), x0.shape)
    ub = jnp.broadcast_to(jnp.asarray(ub, x0.dtype), x0.shape)

    def proj(x):
        return jnp.clip(x, lb, ub)

    def natural_residual(x, Fx):
        return x - proj(x - Fx)

    x = proj(x0)
    Fx = F(x)
    rn = ops.norm(natural_residual(x, Fx), axis)
    rn0 = rn
    history = jnp.full((cfg.maxits + 1,), jnp.nan, x.dtype).at[0].set(rn)
    _monitor(cfg, 0, rn)
    reason = _check(rn, rn0, jnp.zeros((), x.dtype), ops.norm(x, axis),
                    jnp.int32(0), cfg)

    def cond(c):
        return c["reason"] == SNESConvergedReason.ITERATING

    def body(c):
        x, its = c["x"], c["its"]
        Fx = F(x)
        at_lb = (x <= lb + active_tol) & (Fx > 0)
        at_ub = (x >= ub - active_tol) & (Fx < 0)
        active = at_lb | at_ub
        inact = ~active

        def red_mult(ctx, v):
            xx, act = ctx
            vi = jnp.where(act, 0.0, v)
            Jv = jax.jvp(F, (xx,), (vi,))[1]
            return jnp.where(act, v, Jv)

        J = Shell(ctx=(x, active), mult_fn=red_mult,
                  shape=(x.shape[0], x.shape[0]))
        rhs = jnp.where(at_lb, x - lb, jnp.where(at_ub, x - ub, Fx))
        dx = solver(J, rhs, jnp.zeros_like(x), None, ksp_cfg, axis).x
        # damped projected line search on the natural residual
        def ls_body(k, carry):
            lam, best_x, best_rn, done = carry
            xn = proj(x - lam * dx)
            rnn = ops.norm(natural_residual(xn, F(xn)), axis)
            good = rnn < c["rn"]
            best_x = jnp.where(good & ~done, xn, best_x)
            best_rn = jnp.where(good & ~done, rnn, best_rn)
            return (lam * 0.5, best_x, best_rn, done | good)

        lam0 = jnp.asarray(1.0, x.dtype)
        _, xn, rnn, ok = lax.fori_loop(0, 12, ls_body,
                                       (lam0, x, c["rn"],
                                        jnp.asarray(False)))
        its = its + 1
        history = c["history"].at[its].set(rnn)
        _monitor(cfg, its, rnn)
        reason = _check(rnn, rn0, ops.norm(xn - x, axis),
                        ops.norm(xn, axis), its, cfg)
        reason = jnp.where((reason == 0) & ~ok,
                           jnp.int32(SNESConvergedReason.DIVERGED_LINE_SEARCH),
                           reason)
        return dict(x=xn, rn=rnn, its=its, history=history, reason=reason)

    out = lax.while_loop(cond, body, dict(x=x, rn=rn, its=jnp.int32(0),
                                          history=history, reason=reason))
    return SNESResult(out["x"], out["its"], out["reason"], out["rn"],
                      out["history"])


# ---------------------------------------------------------------------------
# Semismooth (Fischer-Burmeister) Newton — SNESVINEWTONSSLS
# ---------------------------------------------------------------------------

def _phi_fb(a, b):
    """viss.c Phi: a + b − sqrt(a² + b²) (zero ⟺ a,b ≥ 0, ab = 0)."""
    return a + b - jnp.sqrt(a * a + b * b)


def _dphi_fb(a, b):
    """viss.c DPhi: ∂Phi/∂a = 1 − a/sqrt(a²+b²); 0.5 near the kink."""
    r = jnp.sqrt(a * a + b * b)
    safe = (jnp.abs(a) >= 1e-6) | (jnp.abs(b) >= 1e-6)
    return jnp.where(safe, 1.0 - a / jnp.maximum(r, 1e-300), 0.5)


def snes_vinewtonssls(F: Callable, x0: jax.Array, lb, ub,
                      cfg: SNESConfig = None, ksp_cfg: KSPConfig = None,
                      axis: Optional[str] = None, **kw) -> SNESResult:
    """Semismooth VI Newton (src/snes/impls/vi/ss): Newton on the
    Fischer-Burmeister reformulation with Armijo on ½‖Φ‖²."""
    cfg = replace(cfg or SNESConfig(), **kw) if kw else (cfg or SNESConfig())
    ksp_cfg = ksp_cfg or KSPConfig(ksp_type="gmres", rtol=1e-6, maxits=300)
    solver = KSP_REGISTRY[ksp_cfg.ksp_type]
    lb = jnp.broadcast_to(jnp.asarray(lb, x0.dtype), x0.shape)
    ub = jnp.broadcast_to(jnp.asarray(ub, x0.dtype), x0.shape)
    # the reference's SNES_VI_INF convention: |bound| >= 1e20 means
    # unbounded (vi.c uses 1.0e20 sentinels, not IEEE inf)
    has_lb = lb > -1.0e20
    has_ub = ub < 1.0e20

    fixed = has_lb & has_ub & (lb == ub)

    def Phi(x):
        """SNESVIComputeFunction (viss.c:61), all four bound cases."""
        Fx = F(x)
        both = _phi_fb(x - lb, -_phi_fb(ub - x, -Fx))
        out = jnp.where(has_lb & has_ub, both,
                        jnp.where(has_lb, _phi_fb(x - lb, Fx),
                                  jnp.where(has_ub,
                                            -_phi_fb(ub - x, -Fx), Fx)))
        return jnp.where(fixed, lb - x, out)

    def make_jss(x):
        """B-subdifferential element Da + Db·J at x as a matrix-free
        Shell (SNESVIComputeBsubdifferentialVectors, viss.c)."""
        Fx = F(x)
        da1 = _dphi_fb(x - lb, -_phi_fb(ub - x, -Fx))
        db1 = _dphi_fb(-_phi_fb(ub - x, -Fx), x - lb)
        da2 = _dphi_fb(ub - x, -Fx)
        db2 = _dphi_fb(-Fx, ub - x)
        Da = jnp.where(
            has_lb & has_ub, da1 + db1 * da2,
            jnp.where(has_lb, _dphi_fb(x - lb, Fx),
                      jnp.where(has_ub, da2, 0.0)))
        Db = jnp.where(
            has_lb & has_ub, db1 * db2,
            jnp.where(has_lb, _dphi_fb(Fx, x - lb),
                      jnp.where(has_ub, db2, 1.0)))
        Da = jnp.where(fixed, 1.0, Da)
        Db = jnp.where(fixed, 0.0, Db)

        def mult(ctx, v):
            xx, Da, Db = ctx
            Jv = jax.jvp(F, (xx,), (v,))[1]
            return Da * v + Db * Jv

        return Shell(ctx=(x, Da, Db), mult_fn=mult,
                     shape=(x.shape[0], x.shape[0]))

    x = jnp.clip(x0, lb, ub)
    ph = Phi(x)
    rn = ops.norm(ph, axis)
    rn0 = rn
    history = jnp.full((cfg.maxits + 1,), jnp.nan, x.dtype).at[0].set(rn)
    _monitor(cfg, 0, rn)
    reason = _check(rn, rn0, jnp.zeros((), x.dtype), ops.norm(x, axis),
                    jnp.int32(0), cfg)

    def cond(c):
        return c["reason"] == SNESConvergedReason.ITERATING

    def body(c):
        x, its = c["x"], c["its"]
        ph = Phi(x)
        J = make_jss(x)
        dx = solver(J, ph, jnp.zeros_like(x), None, ksp_cfg, axis).x

        merit0 = 0.5 * c["rn"] ** 2

        def ls_body(k, carry):
            lam, best_x, best_rn, done = carry
            xn = x - lam * dx
            rnn = ops.norm(Phi(xn), axis)
            # Armijo on the merit with sigma = 1e-4 (viss.c line search)
            good = 0.5 * rnn ** 2 <= merit0 * (1.0 - 1e-4 * lam)
            best_x = jnp.where(good & ~done, xn, best_x)
            best_rn = jnp.where(good & ~done, rnn, best_rn)
            return (lam * 0.5, best_x, best_rn, done | good)

        lam0 = jnp.asarray(1.0, x.dtype)
        _, xn, rnn, ok = lax.fori_loop(0, 16, ls_body,
                                       (lam0, x, c["rn"],
                                        jnp.asarray(False)))
        its = its + 1
        history = c["history"].at[its].set(rnn)
        _monitor(cfg, its, rnn)
        reason = _check(rnn, rn0, ops.norm(xn - x, axis),
                        ops.norm(xn, axis), its, cfg)
        reason = jnp.where((reason == 0) & ~ok,
                           jnp.int32(SNESConvergedReason.DIVERGED_LINE_SEARCH),
                           reason)
        return dict(x=xn, rn=rnn, its=its, history=history, reason=reason)

    out = lax.while_loop(cond, body, dict(x=x, rn=rn, its=jnp.int32(0),
                                          history=history, reason=reason))
    return SNESResult(out["x"], out["its"], out["reason"], out["rn"],
                      out["history"])
