"""IBCGS — improved BiCGStab with ONE fused reduction per iteration.

Reference: src/ksp/ksp/impls/ibcgs/ibcgs.c (Yang & Brent's reordered
BiCGStab: all six inner products of an iteration are arranged to be
computable from the same two vectors sn/tn, merged with the LAGGED
residual norm into a single 7-term MPI_Allreduce, ibcgs.c:185-217).

Device mapping: the 7 local contractions fuse into one `ops.reduce_all`
psum. Like the reference, the DEFAULT convergence norm is the current
iteration's ‖rn‖ (a second reduction, ibcgs.c:238-243); with
cfg.lag_norm (-ksp_lag_norm) the lagged norm rides the single fused
reduction — one collective per iteration total.

Requires a symmetric preconditioner (or none): f0 = Aᵀ Bᵀ r0 is formed
with B applied as itself (the reference calls PCApplyTranspose; every
PC offered here that makes sense for IBCGS — none/jacobi/pbjacobi/
symmetric SOR — is symmetric).
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


def solve_ibcgs(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    dtype = b.dtype

    def BA(v):
        return apply_pc(pc, A.mult(v))

    x = x0 if cfg.guess_nonzero else jnp.zeros_like(b)
    r = apply_pc(pc, b - A.mult(x)) if cfg.guess_nonzero else apply_pc(pc, b)
    rnorm0 = ops.norm(r, axis)
    history = record(init_history(cfg, dtype), 0, rnorm0)
    monitor_cb(cfg, 0, rnorm0)
    reason = check_convergence(rnorm0, rnorm0, jnp.int32(0), cfg)

    r0 = r
    u = BA(r)                                   # un_1 = B A rn_1
    f0 = A.multT(apply_pc(pc, r0))              # f0 = A' B' r0 (B symmetric)
    zero = jnp.zeros_like(b)
    one = jnp.ones((), dtype)
    z0 = jnp.zeros((), dtype)
    phin_1_l = jnp.vdot(r0, r0)
    sig1_l = jnp.vdot(r0, u)
    phin_1, sigman_1 = ops.reduce_all((phin_1_l, sig1_l), axis)

    init = dict(x=x, r=r, u=u, v=zero, q=zero, z=zero,
                sigman_2=z0, sigman_1=sigman_1, pin_1=z0, phin_1=phin_1,
                taun_1=z0, alphan_1=one, omegan_1=one,
                rnormin=phin_1,                  # lagged ‖r‖² (local sum is
                its=jnp.int32(0),                # already global at setup)
                history=history, reason=reason)

    def cond(c):
        return c["reason"] == ConvergedReason.ITERATING

    def body(c):
        its = c["its"] + 1
        rhon = (c["phin_1"] - c["omegan_1"] * c["sigman_2"]
                + c["omegan_1"] * c["alphan_1"] * c["pin_1"])
        deltan = jnp.where(its == 1, rhon,
                           rhon / jnp.where(c["taun_1"] != 0,
                                            c["taun_1"], 1.0))
        betan = deltan / jnp.where(c["omegan_1"] != 0, c["omegan_1"], 1.0)
        taun = c["sigman_1"] + betan * c["taun_1"] - deltan * c["pin_1"]
        bad_tau = taun == 0
        alphan = rhon / jnp.where(bad_tau, 1.0, taun)

        # fused vector updates (ibcgs.c:149-155, incl. the alphan/alphan_1
        # correction the paper omits)
        zn = (alphan * c["r"]
              + (alphan / c["alphan_1"]) * betan * c["z"]
              - alphan * deltan * c["v"])
        vn = c["u"] + betan * c["v"] - deltan * c["q"]
        sn = c["r"] - alphan * vn
        qn = BA(vn)
        tn = c["u"] - alphan * qn

        # THE single fused reduction: 6 recurrence dots + lagged ‖r‖²
        phin_l = jnp.vdot(r0, sn)
        pin_l = jnp.vdot(r0, qn)
        gamman_l = jnp.vdot(f0, sn)
        etan_l = jnp.vdot(f0, tn)
        thetan_l = jnp.vdot(sn, tn)
        kappan_l = jnp.vdot(tn, tn)
        # c["rnormin"] at its==1 is already global; afterwards local
        rl = jnp.where(its == 1, jnp.zeros((), dtype), c["rnormin"])
        phin, pin, gamman, etan, thetan, kappan, rsum = ops.reduce_all(
            (phin_l, pin_l, gamman_l, etan_l, thetan_l, kappan_l, rl), axis)
        rnorm_sq = jnp.where(its == 1, c["rnormin"], rsum)
        rnorm = jnp.sqrt(jnp.maximum(rnorm_sq.real, 0.0))

        bad_kt = (kappan == 0) | (thetan == 0)
        omegan = thetan / jnp.where(kappan != 0, kappan, 1.0)
        sigman = gamman - omegan * etan
        rn = sn - omegan * tn
        rnormin_l = jnp.vdot(rn, rn)            # reduced NEXT iteration
        xn = c["x"] + zn + omegan * sn

        if not cfg.lag_norm:
            # reference DEFAULT (!ksp->lagnorm, ibcgs.c:238-243): the
            # convergence norm is ‖rn‖ of THIS iteration, paid as a
            # second reduction; -ksp_lag_norm restores the fused
            # single-reduction variant above
            rnorm = jnp.sqrt(jnp.maximum(
                ops.reduce_all((rnormin_l,), axis)[0].real, 0.0))

        history = record(c["history"], its, rnorm)
        monitor_cb(cfg, its, rnorm)
        reason = check_convergence(rnorm, rnorm0, its, cfg)
        reason = jnp.where((reason == 0) & (bad_tau | bad_kt),
                           jnp.int32(ConvergedReason.DIVERGED_BREAKDOWN),
                           reason)
        un = BA(rn)
        return dict(x=xn, r=rn, u=un, v=vn, q=qn, z=zn,
                    sigman_2=c["sigman_1"], sigman_1=sigman, pin_1=pin,
                    phin_1=phin, taun_1=taun, alphan_1=alphan,
                    omegan_1=omegan, rnormin=rnormin_l, its=its,
                    history=history, reason=reason)

    out = lax.while_loop(cond, body, init)
    # the loop's norm is lagged; report the true final residual norm
    rfinal = ops.norm(out["r"], axis)
    return SolveResult(out["x"], out["its"], out["reason"], rfinal,
                       out["history"])
