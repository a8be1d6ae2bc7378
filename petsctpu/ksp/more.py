"""More Krylov methods: SYMMLQ, GCR, BiCGStab(l), trust-region CG, LGMRES.

Reference impls: src/ksp/ksp/impls/{symmlq,gcr,bcgsl,cg/stcg,cg/nash,
cg/gltr,gmres/lgmres}. Same design as the rest of the KSP layer: each
solve is a `lax.while_loop` with static shapes; multi-term reductions
are fused into one psum (`ops.reduce_all`) so every iteration costs a
bounded number of collectives regardless of solver complexity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from petsctpu.core.errors import ConvergedReason
from petsctpu.ksp.common import (
    KSPConfig, SolveResult, apply_pc, check_convergence, init_history,
    monitor_cb, monitor_cb_if, record,
)
from petsctpu.ksp.gmres import _apply_givens, _orthogonalize, _solve_update
from petsctpu.vec import ops


# ---------------------------------------------------------------------------
# SYMMLQ — symmetric (possibly indefinite) systems, SPD preconditioner
# ---------------------------------------------------------------------------

def solve_symmlq(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """SYMMLQ, transcribed to the reference's exact state machine
    (src/ksp/ksp/impls/symmlq/symmlq.c): Lanczos on the B-inner
    product with the deferred w/w_bar rotation (the its>1 update
    block), ceta three-term recurrence, residual MONITOR
    np0 = ||z||_2 then np = beta1·Π|s|/|c| (the CGNORM estimate,
    symmlq.c:91,163-167), and the exit move to the CG point
    x += (ceta/c)·w_bar. Requires symmetric A and SPD M."""
    dtype = b.dtype
    rt = jnp.zeros((), dtype).real.dtype
    x_base = x0 if cfg.guess_nonzero else jnp.zeros_like(b)
    r = b - A.mult(x_base) if cfg.guess_nonzero else b
    z = apply_pc(pc, r)
    dp0 = jnp.real(ops.dot(r, z, axis))
    indef_pc = dp0 < 0
    beta1 = jnp.sqrt(jnp.maximum(dp0, 0.0)).astype(rt)
    sb1 = jnp.where(beta1 > 0, beta1, 1.0)
    v = r / sb1
    u = z / sb1
    wbar = u
    np0 = ops.norm(z, axis)
    history = record(init_history(cfg, dtype), 0, np0)
    monitor_cb(cfg, 0, np0)
    reason = check_convergence(np0, np0, jnp.int32(0), cfg)
    reason = jnp.where((reason == 0) & indef_pc,
                       jnp.int32(ConvergedReason.DIVERGED_INDEFINITE_PC),
                       reason)
    zero = jnp.zeros_like(b)
    one = jnp.ones((), rt)
    zs = jnp.zeros((), rt)

    def cond(c):
        return c["reason"] == ConvergedReason.ITERATING

    def body(c):
        its = c["its"] + 1
        upd = its > 1
        sbeta = jnp.where(c["beta"] > 0, c["beta"], 1.0)
        vold = jnp.where(upd, c["v"], c["vold"])
        uold = jnp.where(upd, c["u"], c["uold"])
        v = jnp.where(upd, c["r"] / sbeta, c["v"])
        u = jnp.where(upd, c["z"] / sbeta, c["u"])
        w = c["c"] * c["wbar"] + c["s"] * u
        wbar = jnp.where(upd, -c["s"] * c["wbar"] + c["c"] * u,
                         c["wbar"])
        x = jnp.where(upd, c["x"] + c["ceta"] * w, c["x"])
        ceta_oold = jnp.where(upd, c["ceta_old"], c["ceta_oold"])
        ceta_old = jnp.where(upd, c["ceta"], c["ceta_old"])

        # Lanczos
        r = A.mult(u)
        alpha = jnp.real(ops.dot(u, r, axis))
        z = apply_pc(pc, r)
        r = r - alpha * v - c["beta"] * vold
        z = z - alpha * u - c["beta"] * uold
        betaold = c["beta"]
        dp = jnp.real(ops.dot(r, z, axis))
        indef = dp < 0
        beta = jnp.sqrt(jnp.maximum(dp, 0.0)).astype(rt)

        # QR factorization of the tridiagonal
        coold, cold = c["cold"], c["c"]
        soold, sold = c["sold"], c["s"]
        rho0 = cold * alpha - coold * sold * betaold
        rho1 = jnp.sqrt(rho0 * rho0 + beta * beta)
        rho2 = sold * alpha + coold * cold * betaold
        rho3 = soold * betaold
        srho1 = jnp.where(rho1 > 0, rho1, 1.0)
        cs = rho0 / srho1
        sn = beta / srho1
        ceta = jnp.where(its == 1, beta1 / srho1,
                         -(rho2 * ceta_old + rho3 * ceta_oold) / srho1)
        s_prod = c["s_prod"] * jnp.abs(sn)
        np_ = jnp.where(cs == 0, s_prod * 1e16, s_prod
                        / jnp.where(cs == 0, 1.0, jnp.abs(cs)))
        history = record(c["history"], its, np_)
        monitor_cb(cfg, its, np_)
        reason = check_convergence(np_, np0, its, cfg)
        reason = jnp.where((reason == 0) & indef,
                           jnp.int32(ConvergedReason.DIVERGED_INDEFINITE_PC),
                           reason)
        return dict(x=x, r=r, z=z, u=u, v=v, uold=uold, vold=vold,
                    wbar=wbar, beta=beta, c=cs, cold=cold, s=sn,
                    sold=sold, ceta=ceta, ceta_old=ceta_old,
                    ceta_oold=ceta_oold, s_prod=s_prod, its=its,
                    history=history, reason=reason)

    init = dict(x=jnp.zeros_like(b), r=r, z=z, u=u, v=v, uold=zero,
                vold=zero, wbar=wbar, beta=beta1, c=one, cold=one,
                s=zs, sold=zs, ceta=zs, ceta_old=zs, ceta_oold=zs,
                s_prod=jnp.abs(beta1), its=jnp.int32(0),
                history=history, reason=reason)
    out = lax.while_loop(cond, body, init)
    # move to the CG point: x <- x + (ceta/c) w_bar (symmlq.c:180-186)
    ceta_bar = jnp.where(out["c"] == 0, out["ceta"] * 1e15,
                         out["ceta"]
                         / jnp.where(out["c"] == 0, 1.0, out["c"]))
    x = x_base + out["x"] + ceta_bar * out["wbar"]
    return SolveResult(x, out["its"], out["reason"],
                       out["history"][out["its"]], out["history"])


# ---------------------------------------------------------------------------
# GCR(m) — flexible, right-preconditioned generalized conjugate residuals
# ---------------------------------------------------------------------------

def solve_gcr(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """GCR(m) (reference gcr.c). Right-preconditioned and flexible; the
    orthogonalization of the new direction against the stored A-images
    is ONE fused [m,n]@[n] matvec + psum (the VecMDots of gcr.c:40
    collapse into one product)."""
    dtype = b.dtype
    m = cfg.restart
    n = b.shape[0]
    x = x0 if cfg.guess_nonzero else jnp.zeros_like(b)
    r = b - A.mult(x) if cfg.guess_nonzero else b
    dp = ops.norm(r, axis)
    history = record(init_history(cfg, dtype), 0, dp)
    monitor_cb(cfg, 0, dp)
    reason = check_convergence(dp, dp, jnp.int32(0), cfg)

    init = dict(x=x, r=r, VV=jnp.zeros((m, n), dtype),
                SS=jnp.zeros((m, n), dtype), its=jnp.int32(0),
                history=history, reason=reason)

    def cond(c):
        return c["reason"] == ConvergedReason.ITERATING

    def body(c):
        k = jnp.mod(c["its"], m)
        # restart: drop stored directions when the window wraps
        fresh = (k == 0) & (c["its"] > 0)
        VV = jnp.where(fresh, jnp.zeros_like(c["VV"]), c["VV"])
        SS = jnp.where(fresh, jnp.zeros_like(c["SS"]), c["SS"])
        s = apply_pc(pc, c["r"])
        v = A.mult(s)
        mask = jnp.arange(m) < k
        betas = jnp.where(mask, ops.mdot(v, VV, axis), 0.0)
        v = v - betas @ VV
        s = s - betas @ SS
        nv_l = jnp.vdot(v, v).real
        # projection coefficient <v, r> = conj(v)·r (complex-correct;
        # conj is a no-op in real builds)
        rv_l = jnp.vdot(v, c["r"])
        nv_sq, rv = ops.reduce_all((nv_l, rv_l), axis)
        nv = jnp.sqrt(nv_sq)
        snv = jnp.where(nv > 0, nv, 1.0)
        v = v / snv
        s = s / snv
        gamma = rv / snv
        x = c["x"] + gamma * s
        r = c["r"] - gamma * v
        VV = VV.at[k].set(v)
        SS = SS.at[k].set(s)
        dp = ops.norm(r, axis)
        its = c["its"] + 1
        history = record(c["history"], its, dp)
        monitor_cb(cfg, its, dp)
        reason = check_convergence(dp, history[0], its, cfg)
        reason = jnp.where((reason == 0) & (nv == 0),
                           jnp.int32(ConvergedReason.DIVERGED_BREAKDOWN),
                           reason)
        return dict(x=x, r=r, VV=VV, SS=SS, its=its, history=history,
                    reason=reason)

    out = lax.while_loop(cond, body, init)
    return SolveResult(out["x"], out["its"], out["reason"],
                       out["history"][out["its"]], out["history"])


# ---------------------------------------------------------------------------
# BiCGStab(l) — Sleijpen–Fokkema polynomial BiCGStab
# ---------------------------------------------------------------------------

def solve_bcgsl(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """BiCGStab(l) (reference bcgsl.c), left-preconditioned. The BiCG
    half-sweep is unrolled over the static polynomial degree l; the MR
    polynomial is found from the Gram matrix of the residual stack —
    ONE [l+1,n]@[n,l+1] matmul + psum, then an l×l solve on device."""
    ell = max(1, int(cfg.bcgsl_ell))
    dtype = b.dtype
    x = x0 if cfg.guess_nonzero else jnp.zeros_like(b)
    r0 = apply_pc(pc, b - A.mult(x)) if cfg.guess_nonzero else apply_pc(pc, b)

    def B(v):
        return apply_pc(pc, A.mult(v))

    dp = ops.norm(r0, axis)
    history = record(init_history(cfg, dtype), 0, dp)
    monitor_cb(cfg, 0, dp)
    reason = check_convergence(dp, dp, jnp.int32(0), cfg)
    rnorm0 = dp
    n = b.shape[0]

    init = dict(x=x, R=jnp.zeros((ell + 1, n), dtype).at[0].set(r0),
                U=jnp.zeros((ell + 1, n), dtype), rt=r0,
                rho0=jnp.ones((), dtype), alpha=jnp.zeros((), dtype),
                omega=jnp.ones((), dtype), its=jnp.int32(0),
                history=history, reason=reason)

    def cond(c):
        return c["reason"] == ConvergedReason.ITERATING

    def body(c):
        R, U, rt = c["R"], c["U"], c["rt"]
        x = c["x"]
        rho0 = -c["omega"] * c["rho0"]
        alpha = c["alpha"]
        breakdown = jnp.zeros((), bool)
        # ---- BiCG part (unrolled: ell is static) ----
        for j in range(ell):
            rho1 = ops.dot(R[j], rt, axis)
            safe = rho0 != 0
            beta = alpha * rho1 / jnp.where(safe, rho0, 1.0)
            breakdown = breakdown | ~safe
            rho0 = rho1
            for i in range(j + 1):
                U = U.at[i].set(R[i] - beta * U[i])
            U = U.at[j + 1].set(B(U[j]))
            gamma_d = ops.dot(U[j + 1], rt, axis)
            safe_g = gamma_d != 0
            alpha = rho0 / jnp.where(safe_g, gamma_d, 1.0)
            breakdown = breakdown | ~safe_g
            for i in range(j + 1):
                R = R.at[i].set(R[i] - alpha * U[i + 1])
            R = R.at[j + 1].set(B(R[j]))
            x = x + alpha * U[0]
        # ---- MR part: minimize ||R[0] - sum_j g_j R[j]|| ----
        G_l = R @ R.T                                # (ell+1)^2 local dots
        G = ops.psum(G_l, axis)
        # SVD-based pseudo-inverse: the residual stack goes numerically
        # dependent near convergence (reference bcgsl.c uses LAPACK
        # gelss with a drop tolerance for the same reason)
        g = jnp.linalg.pinv(G[1:, 1:], rtol=64 * jnp.finfo(dtype).eps) @ G[1:, 0]
        x = x + g @ R[:ell]
        R = R.at[0].set(R[0] - g @ R[1:])
        U = U.at[0].set(U[0] - g @ U[1:])
        omega = g[ell - 1]
        dp = ops.norm(R[0], axis)
        its = c["its"] + 1
        history = record(c["history"], its, dp)
        monitor_cb(cfg, its, dp)
        reason = check_convergence(dp, rnorm0, its, cfg)
        reason = jnp.where((reason == 0) & (breakdown | (omega == 0)),
                           jnp.int32(ConvergedReason.DIVERGED_BREAKDOWN),
                           reason)
        return dict(x=x, R=R, U=U, rt=rt, rho0=rho0, alpha=alpha,
                    omega=omega, its=its, history=history, reason=reason)

    out = lax.while_loop(cond, body, init)
    return SolveResult(out["x"], out["its"], out["reason"],
                       out["history"][out["its"]], out["history"])


# ---------------------------------------------------------------------------
# Trust-region CG (STCG / NASH / GLTR) — for SNES Newton trust region
# ---------------------------------------------------------------------------

def solve_stcg(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """Steihaug–Toint trust-region CG (reference stcg.c; nash.c and
    gltr.c share the interface — they refine the boundary handling,
    which this implementation resolves by stepping exactly to the
    sphere). cfg.radius <= 0 means unconstrained (plain PCG).

    On negative curvature or when the iterate would leave the ball
    ||x|| <= radius, x moves to the boundary along p and the solve
    stops with CONVERGED_CG_NEG_CURVE / CONVERGED_CG_CONSTRAINED —
    exactly the semantics SNES NEWTONTR consumes."""
    dtype = b.dtype
    radius = cfg.radius if cfg.radius > 0 else float("inf")
    x = jnp.zeros_like(b)           # TR solves always start at the origin
    r = b
    z = apply_pc(pc, r)
    rz = ops.dot(r, z, axis)
    dp = ops.norm(r, axis)
    history = record(init_history(cfg, dtype), 0, dp)
    monitor_cb(cfg, 0, dp)
    reason = check_convergence(dp, dp, jnp.int32(0), cfg)
    rnorm0 = dp

    init = dict(x=x, r=r, z=z, p=z, rz=rz, its=jnp.int32(0),
                history=history, reason=reason)

    def cond(c):
        return c["reason"] == ConvergedReason.ITERATING

    def body(c):
        p = c["p"]
        Ap = A.mult(p)
        kappa_l = jnp.vdot(p, Ap).real
        xx_l = jnp.vdot(c["x"], c["x"]).real
        xp_l = jnp.vdot(c["x"], p).real
        pp_l = jnp.vdot(p, p).real
        kappa, xx, xp, pp = ops.reduce_all((kappa_l, xx_l, xp_l, pp_l), axis)
        neg_curve = kappa <= 0
        alpha_cg = c["rz"] / jnp.where(kappa != 0, kappa, 1.0)
        # boundary intersection: ||x + tau p|| = radius, tau >= 0
        disc = jnp.maximum(xp * xp + pp * (radius ** 2 - xx), 0.0)
        tau = (-xp + jnp.sqrt(disc)) / jnp.where(pp > 0, pp, 1.0)
        crosses = jnp.isfinite(jnp.asarray(radius, dtype)) & (
            neg_curve | (jnp.sqrt(jnp.maximum(
                xx + 2 * alpha_cg * xp + alpha_cg ** 2 * pp, 0.0)) >= radius))
        alpha = jnp.where(crosses, tau, alpha_cg)
        x = c["x"] + alpha * p
        r = c["r"] - alpha * Ap
        z = apply_pc(pc, r)
        rz_l = jnp.vdot(r, z)
        rr_l = jnp.vdot(r, r).real
        rz_new, rr = ops.reduce_all((rz_l, rr_l), axis)
        dp = jnp.sqrt(rr)
        its = c["its"] + 1
        history = record(c["history"], its, dp)
        monitor_cb(cfg, its, dp)
        reason = check_convergence(dp, rnorm0, its, cfg)
        reason = jnp.where(
            crosses,
            jnp.where(neg_curve,
                      jnp.int32(ConvergedReason.CONVERGED_CG_NEG_CURVE),
                      jnp.int32(ConvergedReason.CONVERGED_CG_CONSTRAINED)),
            reason)
        beta = rz_new / jnp.where(c["rz"] != 0, c["rz"], 1.0)
        p = z + beta * p
        return dict(x=x, r=r, z=z, p=p, rz=rz_new, its=its,
                    history=history, reason=reason)

    out = lax.while_loop(cond, body, init)
    return SolveResult(out["x"], out["its"], out["reason"],
                       out["history"][out["its"]], out["history"])


# ---------------------------------------------------------------------------
# LGMRES(m, k) — GMRES augmented with previous-cycle error approximations
# ---------------------------------------------------------------------------

def solve_lgmres(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """LGMRES (Baker–Jessup–Manteuffel; reference lgmres.c). Each
    restart cycle spends cfg.restart total directions, of which the
    trailing min(cycle, aug_dim) are the error approximations dx from
    previous cycles — recovering much of the convergence lost to
    restarting for ~no extra reductions per iteration."""
    dtype = b.dtype
    m = cfg.restart
    k_aug = min(cfg.aug_dim, m - 1)
    n = b.shape[0]

    history0 = init_history(cfg, dtype)

    def outer_cond(c):
        return c["reason"] == ConvergedReason.ITERATING

    def outer_body(c):
        x = c["x"]
        r = apply_pc(pc, b - A.mult(x))
        beta = ops.norm(r, axis)
        first = c["its"] == 0
        rnorm0 = jnp.where(first, beta, c["rnorm0"])
        history = jnp.where(first, record(c["history"], 0, beta),
                            c["history"])
        monitor_cb_if(cfg, first, jnp.int32(0), beta)
        reason = jnp.where(first,
                           check_convergence(beta, rnorm0, jnp.int32(0), cfg),
                           c["reason"])

        k_act = jnp.minimum(c["n_aug"], k_aug)      # active augmentations
        # lgmres.c:448 (approx_constant default false): every cycle
        # runs max_k - aug_dim Arnoldi steps, so the FIRST cycle uses
        # only (restart - aug_dim) directions even though no error
        # approximations exist yet; later cycles total restart - aug_dim
        # + aug_ct directions.
        s_split = m - k_aug                          # Krylov directions
        j_tot = s_split + k_act                      # directions this cycle
        V = jnp.zeros((m + 1, n), dtype).at[0].set(
            r / jnp.where(beta > 0, beta, 1.0))
        Z = jnp.zeros((m, n), dtype)                # update basis (sources)
        H = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)

        def inner_cond(ic):
            return (ic["j"] < j_tot) \
                & (ic["reason"] == ConvergedReason.ITERATING)

        def inner_body(ic):
            j = ic["j"]
            aug_idx = jnp.clip(j - s_split, 0, max(k_aug - 1, 0))
            src = jnp.where(j < s_split, ic["V"][j], c["AUG"][aug_idx])
            Z = ic["Z"].at[j].set(src)
            w = apply_pc(pc, A.mult(src))
            w, h = _orthogonalize(ic["V"], w, j, m, cfg, axis)
            hj1 = ops.norm(w, axis)
            V = ic["V"].at[j + 1].set(w / jnp.where(hj1 > 0, hj1, 1.0))
            h, cs, sn, g, rnorm = _apply_givens(h, hj1, ic["cs"], ic["sn"],
                                                ic["g"], j, m)
            H = ic["H"].at[:, j].set(h)
            its = ic["its"] + 1
            history = record(ic["history"], its, rnorm)
            monitor_cb(cfg, its, rnorm)
            reason = check_convergence(rnorm, ic["rnorm0"], its, cfg)
            reason = jnp.where(
                (reason == 0) & (hj1 == 0),
                jnp.int32(ConvergedReason.CONVERGED_HAPPY_BREAKDOWN), reason)
            return dict(V=V, Z=Z, H=H, cs=cs, sn=sn, g=g, j=j + 1, its=its,
                        history=history, reason=reason, rnorm0=ic["rnorm0"])

        init_inner = dict(V=V, Z=Z, H=H, cs=cs, sn=sn, g=g, j=jnp.int32(0),
                          its=c["its"], history=history, reason=reason,
                          rnorm0=rnorm0)
        ic = lax.while_loop(inner_cond, inner_body, init_inner)

        dx = _solve_update(ic["H"], ic["g"], ic["Z"], ic["j"], m)
        x = x + dx
        # store the normalized error approximation for the next cycle
        dxn = ops.norm(dx, axis)
        zvec = dx / jnp.where(dxn > 0, dxn, 1.0)
        AUG = c["AUG"]
        if k_aug > 0:
            AUG = jnp.roll(AUG, 1, axis=0).at[0].set(zvec)
        return dict(x=x, its=ic["its"], reason=ic["reason"],
                    rnorm0=ic["rnorm0"], history=ic["history"],
                    AUG=AUG, n_aug=c["n_aug"] + 1)

    x0 = x0 if cfg.guess_nonzero else jnp.zeros_like(b)
    init = dict(x=x0, its=jnp.int32(0),
                reason=jnp.int32(ConvergedReason.ITERATING),
                rnorm0=jnp.zeros((), dtype), history=history0,
                AUG=jnp.zeros((max(k_aug, 1), n), dtype),
                n_aug=jnp.int32(0))
    out = lax.while_loop(outer_cond, outer_body, init)
    return SolveResult(out["x"], out["its"], out["reason"],
                       out["history"][out["its"]], out["history"])
