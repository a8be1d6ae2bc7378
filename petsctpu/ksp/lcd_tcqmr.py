"""LCD (left conjugate directions) and TCQMR (Tony Chan's
transpose-free QMR).

Reference: src/ksp/ksp/impls/lcd/lcd.c (Yuan/Golub left conjugate
direction method with restarts; GCR-shaped storage of P and Q = BAP
with oblique P-orthogonalization) and src/ksp/ksp/impls/tcqmr/tcqmr.c
(squared-Lanczos TFQMR variant; iteration structure transcribed from
tcqmr.c:30-135). Both left-preconditioned.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from petsctpu.core.errors import ConvergedReason
from petsctpu.ksp.common import (
    KSPConfig, SolveResult, apply_pc, check_convergence, init_history,
    monitor_cb, record,
)
from petsctpu.vec import ops


def solve_lcd(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """KSPLCD (lcd.c): per step α = (Pᵢ·r)/(Pᵢ·Qᵢ), x += αPᵢ, r −= αQᵢ;
    the next direction is r obliquely orthogonalized against stored
    directions: βⱼ = −(Pⱼ·Q_new)/(Pⱼ·Qⱼ), applied to both P and Q.
    Restart copies the last direction to slot 0 (lcd.c:116).

    Device shape: the j-loop of lcd.c:106-112 collapses into ONE masked
    [m,n]@[n] matvec per new direction (fused reduction)."""
    dtype = b.dtype
    m = cfg.restart + 1
    n = b.shape[0]

    def BA(v):
        return apply_pc(pc, A.mult(v))

    x = x0 if cfg.guess_nonzero else jnp.zeros_like(b)
    r = apply_pc(pc, b - A.mult(x)) if cfg.guess_nonzero else apply_pc(pc, b)
    dp = ops.norm(r, axis)
    history = record(init_history(cfg, dtype), 0, dp)
    monitor_cb(cfg, 0, dp)
    reason = check_convergence(dp, dp, jnp.int32(0), cfg)
    rnorm0 = dp

    P = jnp.zeros((m, n), dtype).at[0].set(r)
    Q = jnp.zeros((m, n), dtype)
    dens = jnp.ones((m,), dtype)

    def cond(c):
        return c["reason"] == ConvergedReason.ITERATING

    def body(c):
        it = jnp.mod(c["its"], cfg.restart)
        # restart: move last direction to slot 0 (already done at wrap
        # because we write it+1 below and reset masks via `it`)
        fresh = (it == 0)
        P = jnp.where(fresh & (c["its"] > 0),
                      jnp.zeros_like(c["P"]).at[0].set(c["P"][c["last"]]),
                      c["P"])
        Qs = jnp.where(fresh & (c["its"] > 0), jnp.zeros_like(c["Q"]), c["Q"])
        # Q_it is computed lazily: on a fresh cycle (or first iteration)
        q_needed = fresh | (c["its"] == 0)
        q_it = jnp.where(q_needed, BA(P[it]), Qs[it])
        Qs = Qs.at[it].set(q_it)
        num_l = jnp.vdot(P[it], c["r"])
        den_l = jnp.vdot(P[it], q_it)
        num, den = ops.reduce_all((num_l, den_l), axis)
        dens = c["dens"].at[it].set(den)
        sden = jnp.where(den != 0, den, 1.0)
        alfa = num / sden
        x = c["x"] + alfa * P[it]
        r = c["r"] - alfa * q_it
        dp = ops.norm(r, axis)
        its = c["its"] + 1
        history = record(c["history"], its, dp)
        monitor_cb(cfg, its, dp)
        reason = check_convergence(dp, rnorm0, its, cfg)
        reason = jnp.where((reason == 0) & (den == 0),
                           jnp.int32(ConvergedReason.DIVERGED_BREAKDOWN),
                           reason)
        # build next direction: p = r, q = BA r, obliquely
        # orthogonalized SEQUENTIALLY like the reference's j-loop
        # (lcd.c:106-112 updates Q[it+1] before the next j's dot —
        # modified Gram-Schmidt; the one-shot classical variant loses
        # orthogonality near convergence and stalls at ~1e-4)
        dsafe = jnp.where(dens != 0, dens, 1.0)

        def orth(j, pq):
            pn, qn = pq
            num = ops.dot(P[j], qn, axis)
            beta = -num / dsafe[j]
            return (pn + beta * P[j], qn + beta * Qs[j])

        pn, qn = lax.fori_loop(0, it + 1, orth, (r, BA(r)))
        P = P.at[it + 1].set(pn)
        Qs = Qs.at[it + 1].set(qn)
        return dict(x=x, r=r, P=P, Q=Qs, dens=dens, its=its, last=it + 1,
                    history=history, reason=reason)

    init = dict(x=x, r=r, P=P, Q=Q, dens=dens, its=jnp.int32(0),
                last=jnp.int32(0), history=history, reason=reason)
    out = lax.while_loop(cond, body, init)
    return SolveResult(out["x"], out["its"], out["reason"],
                       out["history"][out["its"]], out["history"])


def solve_tcqmr(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """KSPTCQMR (tcqmr.c): squared-Lanczos vectors + Givens rotations;
    monitors the QMR upper bound rnorm0·√(its+2)·Π|s| (tcqmr.c:130)."""
    dtype = b.dtype

    def BA(v):
        return apply_pc(pc, A.mult(v))

    x = x0 if cfg.guess_nonzero else jnp.zeros_like(b)
    r = apply_pc(pc, b - A.mult(x)) if cfg.guess_nonzero else apply_pc(pc, b)
    rnorm0 = ops.norm(r, axis)
    history = record(init_history(cfg, dtype), 0, rnorm0)
    monitor_cb(cfg, 0, rnorm0)
    reason = check_convergence(rnorm0, rnorm0, jnp.int32(0), cfg)
    zero = jnp.zeros_like(b)
    sr = jnp.where(rnorm0 > 0, rnorm0, 1.0)
    u0 = r / sr

    z0 = jnp.zeros((), dtype)
    rt = jnp.zeros((), dtype).real.dtype   # norms/products: REAL even
    init = dict(x=x, u=u0, um1=zero, v=u0, vm1=zero, v0=u0, p=zero,
                pvec1=zero, pvec2=zero,    # for complex scalars
                theta=z0, ep=z0, cl1=z0, sl1=z0, cl=z0, sl=z0,
                sprod=jnp.ones((), rt), tau_n1=rnorm0.astype(dtype),
                f=jnp.ones((), rt), Gamma=jnp.ones((), rt),
                rhom1=jnp.ones((), dtype), its=jnp.int32(0),
                history=history, reason=reason)

    def cond(c):
        return c["reason"] == ConvergedReason.ITERATING

    def body(c):
        its = c["its"] + 1
        u, v0 = c["u"], c["v0"]
        y = BA(u)
        dp11_l = jnp.vdot(y, v0)
        dp2_l = jnp.vdot(u, v0)
        dp11, dp2 = ops.reduce_all((dp11_l, dp2_l), axis)
        sdp2 = jnp.where(dp2 != 0, dp2, 1.0)
        alpha = dp11 / sdp2
        deltmp = alpha
        z = y - alpha * u
        rho = dp2                               # VecDot(u, v0) again
        beta = rho / (c["f"] * c["rhom1"])
        rhom1 = rho
        utmp = z - 2.0 * beta * c["p"]
        up1 = BA(utmp) - alpha * utmp + (c["f"] * beta * beta) * c["um1"]
        dp1 = ops.norm(up1, axis)
        sdp1 = jnp.where(dp1 > 0, dp1, 1.0)
        f = 1.0 / sdp1
        up1 = up1 * f
        p = f * (z - beta * c["p"])
        um1, u = u, up1
        beta_g = beta / jnp.where(c["Gamma"] != 0, c["Gamma"], 1.0)
        eptmp = beta_g
        vp1 = BA(c["v"]) - alpha * c["v"] - beta_g * c["vm1"]
        Gamma = ops.norm(vp1, axis)
        sG = jnp.where(Gamma > 0, Gamma, 1.0)
        vp1 = vp1 / sG
        vm1, v = c["v"], vp1

        # apply last two Givens rotations (tcqmr.c:99-106)
        theta = jnp.where(its > 2, c["sl1"] * beta_g, c["theta"])
        eptmp = jnp.where(its > 2, -c["cl1"] * beta_g, eptmp)
        ep = jnp.where(its > 1, -c["cl"] * eptmp + c["sl"] * alpha, c["ep"])
        deltmp = jnp.where(its > 1, -c["sl"] * eptmp - c["cl"] * alpha,
                           deltmp)
        big = jnp.abs(Gamma) > jnp.abs(deltmp)
        ta1 = -deltmp / sG
        s1 = 1.0 / jnp.sqrt(1.0 + ta1 * ta1)
        sdel = jnp.where(deltmp != 0, deltmp, 1.0)
        ta2 = -Gamma / sdel
        c2 = 1.0 / jnp.sqrt(1.0 + ta2 * ta2)
        s_ = jnp.where(big, s1, c2 * ta2)
        c_ = jnp.where(big, s1 * ta1, c2)
        delta = -c_ * deltmp + s_ * Gamma
        tau_n = -c_ * c["tau_n1"]
        tau_n1 = -s_ * c["tau_n1"]
        sdelta = jnp.where(delta != 0, delta, 1.0)
        pvec = (vm1 - theta * c["pvec2"] - ep * c["pvec1"]) / sdelta
        x = c["x"] + tau_n * pvec
        sprod = c["sprod"] * jnp.abs(s_)
        rnorm = rnorm0 * jnp.sqrt(its.astype(rnorm0.dtype) + 2.0) * sprod
        history = record(c["history"], its, rnorm)
        monitor_cb(cfg, its, rnorm)
        reason = check_convergence(rnorm, rnorm0, its, cfg)
        reason = jnp.where((reason == 0) & ((dp2 == 0) | (dp1 == 0)),
                           jnp.int32(ConvergedReason.DIVERGED_BREAKDOWN),
                           reason)
        return dict(x=x, u=u, um1=um1, v=v, vm1=vm1, v0=v0, p=p,
                    pvec1=pvec, pvec2=c["pvec1"],
                    theta=theta, ep=ep, cl1=c["cl"], sl1=c["sl"],
                    cl=c_, sl=s_, sprod=sprod, tau_n1=tau_n1, f=f,
                    Gamma=Gamma, rhom1=rhom1, its=its, history=history,
                    reason=reason)

    out = lax.while_loop(cond, body, init)
    return SolveResult(out["x"], out["its"], out["reason"],
                       out["history"][out["its"]], out["history"])
