"""DGMRES — deflated GMRES (adaptive spectral deflation at restarts).

Reference: src/ksp/ksp/impls/gmres/dgmres (Erhel, Burrage & Pohl;
KSPDGMRES: after each unconverged restart cycle, extract the smallest
Ritz vectors of the Arnoldi Hessenberg, accumulate them into a
deflation space U, and precondition subsequent cycles with
M_D⁻¹ = I + U(σ·T⁻¹ − I)Uᵀ, T = Uᵀ(A M⁻¹)U — removing the small
eigenvalues that make restarted GMRES stall).

Structure note: the reference calls LAPACK between cycles; XLA has
no in-graph nonsymmetric eigensolver, so this solver is HOST-DRIVEN —
each Arnoldi cycle is one jitted device program, and the m×m Ritz
extraction runs in numpy between cycles (exactly the reference's
division of labor). Consequently dgmres is serial/replicated only
(axis=None); inside shard_map use lgmres, which plays the same
restart-acceleration role collectively.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from petsctpu.core.errors import ConvergedReason
from petsctpu.ksp.common import (
    KSPConfig, SolveResult, apply_pc, check_convergence, init_history,
)
from petsctpu.ksp.gmres import _apply_givens, _orthogonalize, _solve_update


def _cycle_fn(A, pc, cfg: KSPConfig, n, dtype):
    """One right-preconditioned Arnoldi(m) cycle as a jitted program.

    Operator per column: w = A·pc(Md(v)), Md(v) = v + U C (Uᵀ v).
    Returns (V, H, g, j, rnorm) for host-side Ritz extraction."""
    m = cfg.restart

    def cycle(x, b, U, C, r):
        beta = jnp.linalg.norm(r)
        V = jnp.zeros((m + 1, n), dtype).at[0].set(
            r / jnp.where(beta > 0, beta, 1.0))
        H = jnp.zeros((m + 1, m), dtype)
        Hraw = jnp.zeros((m + 1, m), dtype)      # unrotated (for Ritz)
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)

        def Md(v):
            return v + U.T @ (C @ (U @ v))

        def cond(ic):
            return (ic["j"] < m) & (ic["rnorm"] > jnp.maximum(
                cfg.rtol * ic["rnorm0"], cfg.atol))

        def body(ic):
            j = ic["j"]
            v = ic["V"][j]
            z = apply_pc(pc, Md(v))
            w = A.mult(z)
            w, h = _orthogonalize(ic["V"], w, j, m, cfg, None)
            hj1 = jnp.linalg.norm(w)
            V = ic["V"].at[j + 1].set(w / jnp.where(hj1 > 0, hj1, 1.0))
            Hraw = ic["Hraw"].at[:, j].set(h.at[j + 1].set(hj1))
            h, cs, sn, g, rnorm = _apply_givens(h, hj1, ic["cs"], ic["sn"],
                                                ic["g"], j, m)
            H = ic["H"].at[:, j].set(h)
            return dict(V=V, H=H, Hraw=Hraw, cs=cs, sn=sn, g=g, j=j + 1,
                        rnorm=rnorm, rnorm0=ic["rnorm0"])

        ic = lax.while_loop(cond, body, dict(V=V, H=H, Hraw=Hraw, cs=cs,
                                             sn=sn, g=g, j=jnp.int32(0),
                                             rnorm=beta, rnorm0=beta))
        # x update: dx = pc(Md(Vᵀ y))
        ytV = _solve_update(ic["H"], ic["g"], ic["V"][:m], ic["j"], m)
        x = x + apply_pc(pc, Md(ytV))
        r = b - A.mult(x)
        return x, r, ic["V"], ic["Hraw"], ic["j"], ic["rnorm"]

    return jax.jit(cycle)


def solve_dgmres(A, b, x0, pc, cfg: KSPConfig, axis=None,
                 max_neig: int = 8, extract_k: int = 2) -> SolveResult:
    if axis is not None:
        raise ValueError("dgmres is host-driven (between-cycle LAPACK, as "
                         "in the reference); use lgmres under shard_map")
    dtype = b.dtype
    n = b.shape[0]
    m = cfg.restart
    x = x0 if cfg.guess_nonzero else jnp.zeros_like(b)
    r = b - A.mult(x) if cfg.guess_nonzero else b
    rnorm0 = float(jnp.linalg.norm(r))
    history = np.full(cfg.maxits + 1, np.nan)
    history[0] = rnorm0
    reason = int(check_convergence(jnp.asarray(rnorm0), jnp.asarray(rnorm0),
                                   jnp.int32(0), cfg))
    its = 0
    cycle = _cycle_fn(A, pc, cfg, n, dtype)

    U = jnp.zeros((1, n), dtype)                 # row-stacked deflation basis
    C = jnp.zeros((1, 1), dtype)                 # σT⁻¹ − I  (zero ⇒ Md = I)
    U_np = np.zeros((0, n))
    sigma = 1.0

    while reason == 0:
        x, r, V, H, j, _ = cycle(x, b, U, C, r)
        j = int(j)
        rn = float(jnp.linalg.norm(r))           # true residual
        for k in range(1, j + 1):                # per-iteration history
            if its + k <= cfg.maxits:
                history[its + k] = np.nan        # filled at cycle ends only
        its += j
        history[min(its, cfg.maxits)] = rn
        reason = int(check_convergence(jnp.asarray(rn), jnp.asarray(rnorm0),
                                       jnp.int32(its), cfg))
        if reason != 0 or j < 1:
            break
        # ---- host: Ritz extraction from the m×m Hessenberg ----
        Hm = np.asarray(H)[:j, :j]
        try:
            lam, W = np.linalg.eig(Hm)
        except np.linalg.LinAlgError:
            continue
        sigma = max(sigma, float(np.abs(lam).max()))
        order = np.argsort(np.abs(lam))
        take = []
        for idx in order:
            if len(take) >= extract_k:
                break
            take.append(idx)
            # keep conjugate pairs together for a real basis
            if abs(lam[idx].imag) > 0 and len(take) < extract_k + 1:
                conj = np.argmin(np.abs(lam - np.conj(lam[idx])))
                if conj not in take:
                    take.append(conj)
        Wr = np.real(W[:, take])
        Wi = np.imag(W[:, take])
        Wreal = np.unique(np.concatenate([Wr, Wi], axis=1).round(14), axis=1)
        Vn = np.asarray(V)[:j]                   # [j, n]
        cand = Wreal.T @ Vn                      # new deflation vectors [r, n]
        U_np = np.concatenate([U_np, cand], axis=0)
        # re-orthonormalize and cap the basis size
        Q, _ = np.linalg.qr(U_np.T)
        U_np = Q.T[:max_neig]
        # T = Uᵀ (A M⁻¹) U on device (r matvecs)
        Ud = jnp.asarray(U_np, dtype)
        AU = jax.vmap(lambda u: A.mult(apply_pc(pc, u)))(Ud)
        T = np.asarray(Ud @ AU.T)
        try:
            Cn = sigma * np.linalg.inv(T) - np.eye(T.shape[0])
        except np.linalg.LinAlgError:
            Cn = np.zeros_like(T)
        U, C = Ud, jnp.asarray(Cn, dtype)

    hist = jnp.asarray(history, dtype)
    return SolveResult(x, jnp.int32(min(its, cfg.maxits)), jnp.int32(reason),
                       jnp.asarray(float(jnp.linalg.norm(r)), dtype), hist)
