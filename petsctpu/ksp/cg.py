"""Conjugate gradients: standard PCG, pipelined PIPECG, and Gropp CG.

Reference: KSPSolve_CG (src/ksp/ksp/impls/cg/cg.c:92) with its NaN/Inf
guard (cg.c:152) and indefinite-PC/matrix detection (cg.c:188);
pipelined variant KSPSolve_PIPECG (src/ksp/ksp/impls/cg/pipecg/
pipecg.c:45) which overlaps the allreduce with the SpMV; GROPPCG
likewise. Here the "overlap" is expressed by fusing the two inner
products of an iteration into ONE psum (reduce_all) and, for pipecg,
restructuring so each iteration has a single fused reduction whose
result is consumed after the next SpMV — which XLA can schedule
asynchronously.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from petsctpu.core.errors import ConvergedReason
from petsctpu.ksp.common import (
    KSPConfig, SolveResult, NORM_NATURAL, NORM_NONE, NORM_PRECONDITIONED,
    NORM_UNPRECONDITIONED, apply_pc, check_convergence, init_history,
    monitor_cb, monitor_true_cb, record, rnorm0_reference,
)
from petsctpu.vec import ops


def _cg_norm(r, z, rz, cfg, axis):
    nt = cfg.norm_type or NORM_PRECONDITIONED
    if nt == NORM_PRECONDITIONED:
        return ops.norm(z, axis)
    if nt == NORM_UNPRECONDITIONED:
        return ops.norm(r, axis)
    if nt == NORM_NATURAL:
        return jnp.sqrt(jnp.abs(rz))
    return jnp.zeros((), r.dtype)


def solve_cg(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    if cfg.cg_single_reduction:
        return solve_cg_single(A, b, x0, pc, cfg, axis)
    dtype = b.dtype
    x = x0
    r = b - A.mult(x) if cfg.guess_nonzero else b
    z = apply_pc(pc, r)
    rz = ops.dot(z, r, axis)
    dp = _cg_norm(r, z, rz, cfg, axis)
    history = record(init_history(cfg, dtype), 0, dp)
    monitor_cb(cfg, 0, dp)
    bnorm = ops.norm(b, axis)
    monitor_true_cb(cfg, 0, dp, ops.norm(r, axis), bnorm)
    rnorm0 = rnorm0_reference(cfg, b, pc,
                              cfg.norm_type or NORM_PRECONDITIONED, axis, dp)
    reason = check_convergence(dp, rnorm0, jnp.int32(0), cfg)

    def cond(c):
        return c[-1] == ConvergedReason.ITERATING

    def body(c):
        x, r, z, p, rz, its, history, reason = c
        w = A.mult(p)
        pw = ops.dot(p, w, axis)
        indefinite_mat = pw <= 0
        alpha = rz / pw
        x = x + alpha * p
        r = r - alpha * w
        z = apply_pc(pc, r)
        # fuse the two reductions of the iteration into one psum
        rz_new_l = jnp.vdot(z, r)
        zz_l = jnp.vdot(z, z).real
        rr_l = jnp.vdot(r, r).real
        rz_new, zz, rr = ops.reduce_all((rz_new_l, zz_l, rr_l), axis)
        nt = cfg.norm_type or NORM_PRECONDITIONED
        if nt == NORM_PRECONDITIONED:
            dp = jnp.sqrt(zz)
        elif nt == NORM_UNPRECONDITIONED:
            dp = jnp.sqrt(rr)
        elif nt == NORM_NATURAL:
            dp = jnp.sqrt(jnp.abs(rz_new))
        else:
            dp = jnp.zeros((), dtype)
        its = its + 1
        history = record(history, its, dp)
        monitor_cb(cfg, its, dp)
        monitor_true_cb(cfg, its, dp, jnp.sqrt(rr), bnorm)
        reason = check_convergence(dp, rnorm0, its, cfg)
        beta = rz_new / rz
        indefinite_pc = beta < 0
        reason = jnp.where(
            (reason == 0) & indefinite_mat,
            jnp.int32(ConvergedReason.DIVERGED_INDEFINITE_MAT), reason)
        reason = jnp.where(
            (reason == 0) & indefinite_pc,
            jnp.int32(ConvergedReason.DIVERGED_INDEFINITE_PC), reason)
        p = z + beta * p
        return (x, r, z, p, rz_new, its, history, reason)

    init = (x, r, z, z, rz, jnp.int32(0), history, reason)
    x, r, z, p, rz, its, history, reason = lax.while_loop(cond, body, init)
    return SolveResult(x, its, reason, history[its], history)


def solve_cg_single(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """CG with KSPCGUseSingleReduction (cg.c:116-266, option
    -ksp_cg_single_reduction): keeps s = Az each iteration, rebuilds
    w = Ap from w <- s + (beta/betaold)·w and p'Ap from the recurrence
    dpi = delta - beta²·dpiold/betaold² (delta = z'Az), so the
    iteration's inner products merge into ONE fused reduction — at the
    cost of the extra matmult s = Az. On the device mesh this is 1
    collective per iteration (vs 2 for plain CG); with an HBM-bound
    operator the extra SpMV usually costs more than the saved psum,
    which is why the reference gates it behind an option too."""
    dtype = b.dtype
    x = x0
    r = b - A.mult(x) if cfg.guess_nonzero else b
    z = apply_pc(pc, r)
    s = A.mult(z)
    delta_l = jnp.vdot(z, s)
    rz_l = jnp.vdot(z, r)
    zz_l = jnp.vdot(z, z).real
    rr_l = jnp.vdot(r, r).real
    delta, rz, zz, rr = ops.reduce_all((delta_l, rz_l, zz_l, rr_l), axis)
    nt = cfg.norm_type or NORM_PRECONDITIONED
    if nt == NORM_PRECONDITIONED:
        dp = jnp.sqrt(zz)
    elif nt == NORM_UNPRECONDITIONED:
        dp = jnp.sqrt(rr)
    elif nt == NORM_NATURAL:
        dp = jnp.sqrt(jnp.abs(rz))
    else:
        dp = jnp.zeros((), dtype)
    history = record(init_history(cfg, dtype), 0, dp)
    monitor_cb(cfg, 0, dp)
    bnorm = ops.norm(b, axis)
    monitor_true_cb(cfg, 0, dp, ops.norm(r, axis), bnorm)
    rnorm0 = rnorm0_reference(cfg, b, pc, nt, axis, dp)
    reason = check_convergence(dp, rnorm0, jnp.int32(0), cfg)

    def cond(c):
        return c[-1] == ConvergedReason.ITERATING

    def body(c):
        (x, r, z, s, p, w, rz, rzold, delta, dpiold, its, history,
         reason) = c
        first = its == 0
        one = jnp.ones((), rz.dtype)
        bcoef = jnp.where(first, jnp.zeros((), rz.dtype),
                          rz / jnp.where(rzold == 0, one, rzold))
        p = z + bcoef * p
        w = s + bcoef * w                   # w = Ap by recurrence
        dpi = jnp.where(
            first, delta,
            delta - rz * rz * dpiold
            / jnp.where(rzold == 0, one, rzold * rzold))
        indefinite_mat = (dpi == 0) | (~first & ((dpi * dpiold).real <= 0))
        alpha = rz / jnp.where(dpi == 0, one, dpi)
        x = x + alpha * p
        r = r - alpha * w
        z = apply_pc(pc, r)
        s = A.mult(z)
        delta_n_l = jnp.vdot(z, s)
        rz_n_l = jnp.vdot(z, r)
        zz_l = jnp.vdot(z, z).real
        rr_l = jnp.vdot(r, r).real
        delta_n, rz_n, zz, rr = ops.reduce_all(
            (delta_n_l, rz_n_l, zz_l, rr_l), axis)
        if nt == NORM_PRECONDITIONED:
            dp = jnp.sqrt(zz)
        elif nt == NORM_UNPRECONDITIONED:
            dp = jnp.sqrt(rr)
        elif nt == NORM_NATURAL:
            dp = jnp.sqrt(jnp.abs(rz_n))
        else:
            dp = jnp.zeros((), dtype)
        its = its + 1
        history = record(history, its, dp)
        monitor_cb(cfg, its, dp)
        monitor_true_cb(cfg, its, dp, jnp.sqrt(rr), bnorm)
        reason = check_convergence(dp, rnorm0, its, cfg)
        indefinite_pc = (rz_n * rz).real < 0
        reason = jnp.where(
            (reason == 0) & indefinite_mat,
            jnp.int32(ConvergedReason.DIVERGED_INDEFINITE_MAT), reason)
        reason = jnp.where(
            (reason == 0) & indefinite_pc,
            jnp.int32(ConvergedReason.DIVERGED_INDEFINITE_PC), reason)
        return (x, r, z, s, p, w, rz_n, rz, delta_n, dpi, its, history,
                reason)

    init = (x, r, z, s, z, s, rz, jnp.ones_like(rz), delta,
            jnp.zeros_like(delta), jnp.int32(0), history, reason)
    out = lax.while_loop(cond, body, init)
    x, its, history, reason = out[0], out[10], out[11], out[12]
    return SolveResult(x, its, reason, history[its], history)


def solve_pipecg(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """Pipelined CG (pipecg.c:45): one fused reduction per iteration,
    started BEFORE the preconditioner+SpMV it overlaps with.

    State follows Ghysels & Vanroose: r, u=M⁻¹r, w=Au, and the shifted
    vectors z=Aq, q=M⁻¹p, p. Each iteration does one SpMV, one PC apply
    and ONE psum of (r·u, w·u, ||r||², ||u||²)."""
    dtype = b.dtype
    x = x0
    r = b - A.mult(x) if cfg.guess_nonzero else b
    u = apply_pc(pc, r)
    w = A.mult(u)
    gamma_l = jnp.vdot(r, u)
    delta_l = jnp.vdot(w, u)
    rr_l = jnp.vdot(r, r).real
    uu_l = jnp.vdot(u, u).real
    gamma, delta, rr, uu = ops.reduce_all((gamma_l, delta_l, rr_l, uu_l), axis)
    nt = cfg.norm_type or NORM_PRECONDITIONED
    if nt == NORM_PRECONDITIONED:
        dp0 = jnp.sqrt(uu)
    elif nt == NORM_UNPRECONDITIONED:
        dp0 = jnp.sqrt(rr)
    elif nt == NORM_NATURAL:
        dp0 = jnp.sqrt(jnp.abs(gamma))
    else:
        dp0 = jnp.zeros((), dtype)
    history = record(init_history(cfg, dtype), 0, dp0)
    monitor_cb(cfg, 0, dp0)
    rnorm0 = rnorm0_reference(cfg, b, pc, nt, axis, dp0)
    reason = check_convergence(dp0, rnorm0, jnp.int32(0), cfg)

    zero = jnp.zeros_like(b)

    def cond(c):
        return c["reason"] == ConvergedReason.ITERATING

    def body(c):
        its = c["its"]
        m = apply_pc(pc, c["w"])          # m = M⁻¹ w
        n = A.mult(m)                      # n = A m   (the overlapped SpMV)
        first = its == 0
        beta = jnp.where(first, 0.0, c["gamma"] / c["gamma_old"])
        # alpha = gamma / (delta - (beta/alpha_old)·gamma); first: gamma/delta
        alpha_den = jnp.where(first, c["delta"],
                              c["delta"] - (beta / c["alpha_old"]) * c["gamma"])
        alpha = c["gamma"] / alpha_den
        z = n + beta * c["z"]
        q = m + beta * c["q"]
        p = c["u"] + beta * c["p"]
        s = c["w"] + beta * c["s"]
        x = c["x"] + alpha * p
        u = c["u"] - alpha * q
        w = c["w"] - alpha * z
        r = c["r"] - alpha * s
        gamma_l = jnp.vdot(r, u)
        delta_l = jnp.vdot(w, u)
        rr_l = jnp.vdot(r, r).real
        uu_l = jnp.vdot(u, u).real
        gamma, delta, rr, uu = ops.reduce_all(
            (gamma_l, delta_l, rr_l, uu_l), axis)
        if nt == NORM_PRECONDITIONED:
            dp = jnp.sqrt(uu)
        elif nt == NORM_UNPRECONDITIONED:
            dp = jnp.sqrt(rr)
        elif nt == NORM_NATURAL:
            dp = jnp.sqrt(jnp.abs(gamma))
        else:
            dp = jnp.zeros((), dtype)
        its = its + 1
        history = record(c["history"], its, dp)
        monitor_cb(cfg, its, dp)
        reason = check_convergence(dp, rnorm0, its, cfg)
        return dict(x=x, r=r, u=u, w=w, z=z, q=q, p=p, s=s,
                    gamma=gamma, gamma_old=c["gamma"], delta=delta,
                    alpha_old=alpha, its=its, history=history,
                    reason=reason)

    init = dict(x=x, r=r, u=u, w=w, z=zero, q=zero, p=zero, s=zero,
                gamma=gamma, gamma_old=jnp.ones((), gamma.dtype),
                delta=delta, alpha_old=jnp.ones((), delta.dtype),
                its=jnp.int32(0), history=history, reason=reason)
    out = lax.while_loop(cond, body, init)
    return SolveResult(out["x"], out["its"], out["reason"],
                       out["history"][out["its"]], out["history"])
