"""KSPSPECEST — estimate the spectrum on the first application, then
run a cheap dot-product-free smoother on every subsequent one.

Reference: src/ksp/ksp/impls/specest/specest.c — KSPSolve_SpecEst: the
first solve runs `kspest` (default GMRES, maxits 5) with singular-value
computation on, takes (σmin, σmax) from the Krylov process
(KSPComputeExtremeSingularValues) and the spectral radius of 1−B from
the Ritz values (KSPComputeEigenvalues, rad = max √((Reλ−1)²+Imλ²)),
then configures `kspcheap` (default Chebyshev with bounds
[0.9·σmin, 1.1·σmax], maxits 5, norm NONE / KSPSkipConverged; or
Richardson with scale richfactor/rad) for every later solve.

Device mapping: SpecEst is inherently STATEFUL across applications, which
cannot live inside one jitted while_loop — so it is a host-stateful PC
(`SpecEstPC`, the "stateful host-side wrapper" design), and the outer
flexible solver that drives it is the host-driven FGMRES below
(`solve_fgmres_host`, registered as "fgmres_host"; ksp_solve
auto-routes fgmres to it whenever the PC declares `host_stateful`).
Each inner est/cheap solve and every matvec still runs jitted on
device; only the between-application control flow is host Python —
exactly the reference's LAPACK-on-host / kernels-on-device split.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from petsctpu.core.errors import ConvergedReason
from petsctpu.ksp.common import (KSPConfig, SolveResult, _monitor_print,
                                 apply_pc)
from petsctpu.ksp.cheby import (_arnoldi_hessenberg,
                                estimate_extreme_singular_arnoldi)


def _arnoldi_ritz(A, pc, b, iters):
    """Complex Ritz values of the square Hessenberg — the
    KSPComputeEigenvalues_GMRES geev path (gmreig.c)."""
    H = _arnoldi_hessenberg(A, pc, b, iters)
    k = H.shape[1]
    if k == 0:
        return np.zeros(0, complex)
    return np.linalg.eigvals(H[:k, :k])


def _cg_lanczos(A, pc, b, iters):
    """Host CG (left-preconditioned, zero guess) collecting the Lanczos
    tridiagonal exactly as KSPSolve_CG does (cg.c:198-222: e[i] =
    √|β/βold|/a_prev, d[i] = √|β/βold|·e[i] + 1/a). Returns its sorted
    eigenvalues (the KSPComputeEigenvalues_CG / ExtremeSingularValues_CG
    tql1 convention, cgeig.c:65-67)."""
    x = np.zeros_like(np.asarray(b, np.float64))
    r = np.asarray(b, np.float64).copy()
    d = np.zeros(iters)
    e = np.zeros(iters)
    a = 1.0
    betaold = 1.0
    p = None
    nits = 0
    for i in range(iters):
        z = np.asarray(apply_pc(pc, jnp.asarray(r)), np.float64)
        beta = float(r @ z)
        if beta == 0.0:
            break
        if i == 0:
            p = z.copy()
            bb = 0.0
        else:
            bb = beta / betaold
            e[i] = np.sqrt(abs(bb)) / a
            p = z + bb * p
        w = np.asarray(A.mult(jnp.asarray(p)), np.float64)
        dpi = float(p @ w)
        if dpi == 0.0:
            break
        betaold = beta
        a = beta / dpi
        d[i] = np.sqrt(abs(bb)) * e[i] + 1.0 / a
        x += a * p
        r -= a * w
        nits = i + 1
    if nits == 0:
        return np.array([1.0]), x
    T = np.diag(d[:nits])
    for i in range(1, nits):
        T[i, i - 1] = T[i - 1, i] = e[i]
    return np.sort(np.linalg.eigvalsh(T)), x


class SpecEstPC:
    """Host-stateful two-phase PC (specest.c semantics).

    apply #1 = the estimation solve (its result IS the returned
    correction, like KSPSolve_SpecEst's first pass); applies #2.. run
    the configured cheap smoother with the baked-in bounds. Call
    `reset()` to re-estimate (the reference re-estimates whenever the
    operator changes, KSPSetUp_SpecEst spec->current=FALSE)."""

    host_stateful = True

    def __init__(self, A, pc=None, est_type="gmres",
                 cheap_type="chebyshev", est_maxits=5, cheap_maxits=5,
                 minfactor=0.9, maxfactor=1.1, richfactor=1.0,
                 est_rtol=1e-5):
        self.A = A
        self.pc = pc
        self.est_type = est_type
        self.cheap_type = cheap_type
        self.est_maxits = est_maxits
        self.cheap_maxits = cheap_maxits
        self.minfactor = minfactor
        self.maxfactor = maxfactor
        self.richfactor = richfactor
        self.est_rtol = est_rtol
        self.reset()

    def reset(self):
        self.current = False
        self.emin = self.emax = self.radius = 0.0

    def _estimate(self, x):
        from petsctpu.ksp.api import KSP_REGISTRY

        cfg = KSPConfig(ksp_type=self.est_type, rtol=self.est_rtol,
                        atol=1e-50, maxits=self.est_maxits)
        if self.est_type == "cg":
            eigs, sol = _cg_lanczos(self.A, self.pc, x, self.est_maxits)
            smin, smax = float(eigs[0]), float(eigs[-1])
            rad = float(np.max(np.abs(eigs - 1.0))) if eigs.size else 0.0
            out = jnp.asarray(sol, jnp.asarray(x).dtype)
        else:
            res = KSP_REGISTRY[self.est_type](
                self.A, x, jnp.zeros_like(x), self.pc, cfg, None)
            its = max(int(res.its), 1)
            smin, smax = estimate_extreme_singular_arnoldi(
                self.A, self.pc, x, its)
            ritz = _arnoldi_ritz(self.A, self.pc, x, its)
            rad = float(np.max(np.sqrt((ritz.real - 1.0) ** 2
                                       + ritz.imag ** 2))) \
                if ritz.size else 0.0
            out = res.x
        self.emin = self.minfactor * smin
        self.emax = self.maxfactor * smax
        self.radius = rad
        self.current = True
        return out

    def apply(self, x):
        from petsctpu.ksp.api import KSP_REGISTRY

        if not self.current:
            return self._estimate(x)
        if self.cheap_type == "richardson":
            scale = self.richfactor / self.radius if self.radius else 1.0
            cfg = KSPConfig(ksp_type="richardson", maxits=self.cheap_maxits,
                            rtol=0.0, atol=0.0, norm_type="none",
                            richardson_scale=scale)
        else:
            cfg = KSPConfig(ksp_type="chebyshev", maxits=self.cheap_maxits,
                            rtol=0.0, atol=0.0, norm_type="none",
                            cheby_emin=self.emin, cheby_emax=self.emax)
        res = KSP_REGISTRY[cfg.ksp_type](self.A, x, jnp.zeros_like(x),
                                         self.pc, cfg, None)
        return res.x


def solve_fgmres_host(A, b, x0, pc, cfg: KSPConfig, axis=None) \
        -> SolveResult:
    """Host-driven flexible GMRES: the Arnoldi loop runs in Python so
    the preconditioner may be ANY callable — including host-stateful
    ones (SpecEstPC) and adaptive/non-traceable callbacks. Matvecs run
    jitted on device. Right-preconditioned, unpreconditioned norm,
    classical Gram-Schmidt (fgmres.c conventions); supports restart."""
    assert axis is None, "fgmres_host is a serial/host path"
    dt = np.float64
    bn = np.asarray(b, dt)
    x = np.asarray(x0, dt).copy()
    maxits = cfg.maxits
    restart = max(cfg.restart, 1)
    history = np.full(maxits + 1, np.nan)
    r = bn - np.asarray(A.mult(jnp.asarray(x)), dt)
    beta = float(np.linalg.norm(r))
    rnorm0 = beta
    history[0] = beta
    if cfg.monitor:
        _monitor_print(0, beta)
    its = 0
    reason = ConvergedReason.ITERATING
    ttol = max(cfg.rtol * rnorm0, cfg.atol)
    if beta <= cfg.atol:
        reason = ConvergedReason.CONVERGED_ATOL
    while reason == ConvergedReason.ITERATING:
        m = min(restart, maxits - its)
        n = bn.shape[0]
        V = np.zeros((m + 1, n))
        Z = np.zeros((m, n))
        H = np.zeros((m + 1, m))
        cs = np.zeros(m)
        sn = np.zeros(m)
        g = np.zeros(m + 1)
        V[0] = r / beta
        g[0] = beta
        k = 0
        for j in range(m):
            zj = np.asarray(pc.apply(jnp.asarray(V[j])), dt) \
                if pc is not None else V[j]
            Z[j] = zj
            w = np.asarray(A.mult(jnp.asarray(zj)), dt)
            h = V[:j + 1] @ w
            w = w - V[:j + 1].T @ h
            if cfg.cgs_refine == "always":
                h2 = V[:j + 1] @ w
                w = w - V[:j + 1].T @ h2
                h = h + h2
            H[:j + 1, j] = h
            hj1 = float(np.linalg.norm(w))
            H[j + 1, j] = hj1
            if hj1 != 0.0:
                V[j + 1] = w / hj1
            # apply stored Givens rotations, then the new one
            for i in range(j):
                t = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
                H[i + 1, j] = -sn[i] * H[i, j] + cs[i] * H[i + 1, j]
                H[i, j] = t
            rho = np.hypot(H[j, j], H[j + 1, j])
            if rho == 0.0:
                cs[j], sn[j] = 1.0, 0.0
            else:
                cs[j], sn[j] = H[j, j] / rho, H[j + 1, j] / rho
            H[j, j] = rho
            H[j + 1, j] = 0.0
            g[j + 1] = -sn[j] * g[j]
            g[j] = cs[j] * g[j]
            rnorm = abs(g[j + 1])
            its += 1
            k = j + 1
            history[its] = rnorm
            if cfg.monitor:
                _monitor_print(its, rnorm)
            if np.isnan(rnorm) or np.isinf(rnorm):
                reason = ConvergedReason.DIVERGED_NANORINF
            elif rnorm <= cfg.atol:
                reason = ConvergedReason.CONVERGED_ATOL
            elif rnorm <= ttol:
                reason = ConvergedReason.CONVERGED_RTOL
            elif rnorm > cfg.divtol * rnorm0:
                reason = ConvergedReason.DIVERGED_DTOL
            elif its >= maxits:
                reason = ConvergedReason.DIVERGED_ITS
            if reason != ConvergedReason.ITERATING:
                break
        # form the cycle's solution from the flexible basis Z
        if k > 0:
            y = np.linalg.solve(H[:k, :k], g[:k])
            x = x + Z[:k].T @ y
        if reason != ConvergedReason.ITERATING:
            break
        r = bn - np.asarray(A.mult(jnp.asarray(x)), dt)
        beta = float(np.linalg.norm(r))
    dtype = jnp.asarray(b).dtype
    return SolveResult(jnp.asarray(x, dtype),
                       jnp.asarray(its, jnp.int32),
                       jnp.asarray(int(reason), jnp.int32),
                       jnp.asarray(history[its], dtype),
                       jnp.asarray(history, dtype))
