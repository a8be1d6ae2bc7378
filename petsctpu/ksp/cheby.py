"""Chebyshev iteration and Richardson — the reduction-free smoothers.

Reference: KSPSolve_Chebychev (src/ksp/ksp/impls/cheby/cheby.c:345):
no inner products in the hot loop, which is why it is the default MG
smoother — on a device mesh this means ZERO collectives per
iteration (SURVEY §2.10 P4). Eigenvalue bounds are auto-estimated like
the reference's `specest`/estimate-eigenvalues option: a few power
iterations on M⁻¹A, then (emin, emax) = (0.1, 1.1)·λmax — matching
the reference's default transform factors.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from petsctpu.core.errors import ConvergedReason
from petsctpu.ksp.common import (
    KSPConfig, SolveResult, NORM_NONE, NORM_PRECONDITIONED, apply_pc,
    check_convergence, init_history, monitor_cb, record,
)
from petsctpu.vec import ops


def estimate_lambda_max(A, pc, n, dtype, axis=None, iters: int = 12,
                        seed: int = 7):
    """Power-iteration estimate of λmax(M⁻¹A) (deterministic start)."""
    # deterministic pseudo-random start vector (no RNG under shard_map)
    i = jnp.arange(n, dtype=dtype)
    v = jnp.sin(i * 12.9898 + 78.233) + 0.01
    v = v / ops.norm(v, axis)

    def body(_, carry):
        v, lam = carry
        w = apply_pc(pc, A.mult(v))
        nw = ops.norm(w, axis)
        lam = nw
        v = w / jnp.where(nw > 0, nw, 1.0)
        return (v, lam)

    rt = jnp.zeros((), dtype).real.dtype    # the estimate is a norm —
    _, lam = lax.fori_loop(0, iters, body,  # real for complex scalars
                           (v, jnp.ones((), rt)))
    return lam


def _arnoldi_hessenberg(A, pc, b, iters: int = 10):
    """A fixed number (default 10, KSPSetTolerances cheby.c:77) of
    left-preconditioned GMRES/Arnoldi steps on the solve's actual
    right-hand side with classical Gram-Schmidt (the est-GMRES
    default, borthog2.c, REFINE_NEVER). Returns the (k+1)×k
    Hessenberg, host numpy fp64."""
    import numpy as np

    v = np.asarray(apply_pc(pc, b), np.float64)
    beta = float(np.linalg.norm(v))
    n = v.shape[0]
    m = min(iters, n)
    V = np.zeros((m + 1, n))
    H = np.zeros((m + 1, m))
    if beta == 0.0:
        return H[:1, :0]
    V[0] = v / beta
    k = m
    for j in range(m):
        w = np.asarray(apply_pc(pc, A.mult(jnp.asarray(V[j]))), np.float64)
        h = V[:j + 1] @ w
        w = w - V[:j + 1].T @ h
        H[:j + 1, j] = h
        hj1 = float(np.linalg.norm(w))
        H[j + 1, j] = hj1
        if hj1 == 0.0:
            k = j + 1
            break
        V[j + 1] = w / hj1
    return H[:k + 1, :k]


def estimate_eigen_arnoldi(A, pc, b, iters: int = 10):
    """(min, max) of the real parts of the Hessenberg Ritz values —
    the KSPComputeEigenvalues_GMRES convention (gmreig.c geev path).
    NOTE: the chebyest GOLDEN outputs correspond to the SINGULAR-value
    convention below (estimate_extreme_singular_arnoldi), not this
    one; see that docstring."""
    import numpy as np

    H = _arnoldi_hessenberg(A, pc, b, iters)
    k = H.shape[1]
    if k == 0:
        return 0.0, 0.0
    ritz = np.linalg.eigvals(H[:k, :k])
    return float(ritz.real.min()), float(ritz.real.max())


def estimate_extreme_singular_arnoldi(A, pc, b, iters: int = 10):
    """Extreme SINGULAR values of the full (k+1)×k Hessenberg — the
    KSPComputeExtremeSingularValues_GMRES convention (gmreig.c gesvd
    of hh_origin). This is the estimator the reference's chebyest
    golden outputs were generated with: reproducing
    ex2_chebyest_1.out requires (σmin, σmax) of H̄₁₁ₓ₁₀, which this
    returns digit-exact (0.0357405/1.1495838 on the 80×80 ex2 system)
    — the tree's cheby.c:387 reads KSPComputeEigenvalues, whose
    Hessenberg-eigenvalue Ritz pair (0.0249, 1.1490) does NOT
    reproduce the golden; the goldens predate/postdate that line.
    Apply the a,b,c,d transform at the call site:
    emin = a·min + b·max, emax = c·min + d·max."""
    import numpy as np

    H = _arnoldi_hessenberg(A, pc, b, iters)
    if H.shape[1] == 0:
        return 0.0, 0.0
    s = np.linalg.svd(H, compute_uv=False)
    return float(s.min()), float(s.max())


def solve_chebyshev(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    dtype = b.dtype
    x = x0 if cfg.guess_nonzero else jnp.zeros_like(b)

    if cfg.cheby_emax > 0:
        emin = jnp.asarray(cfg.cheby_emin, dtype)
        emax = jnp.asarray(cfg.cheby_emax, dtype)
    else:
        lam = estimate_lambda_max(A, pc, b.shape[0], dtype, axis)
        emin = 0.1 * lam     # reference default transform (0, 0.1, 0, 1.1)
        emax = 1.1 * lam

    theta = 0.5 * (emax + emin)
    delta = 0.5 * (emax - emin)
    sigma = theta / delta

    norm_type = cfg.norm_type or NORM_PRECONDITIONED
    want_norm = norm_type != NORM_NONE

    r = b - A.mult(x)
    z = apply_pc(pc, r)
    # NO initial monitor: the reference applies the first correction
    # p[k] = x + scale·B⁻¹r BEFORE the counted loop, and the first
    # monitor (labelled 0, at ksp->its == 1) shows the residual AFTER
    # it; KSPDefaultConverged's rnorm0 snapshot is therefore that
    # after-one-correction norm (cheby.c:429-488).
    history = init_history(cfg, dtype)
    reason = jnp.int32(ConvergedReason.ITERATING)

    d0 = z / theta

    def cond(c):
        return c["reason"] == ConvergedReason.ITERATING

    def body(c):
        its = c["its"]
        x = c["x"] + c["d"]
        r = c["r"] - A.mult(c["d"])
        z = apply_pc(pc, r)
        rho = 1.0 / (2.0 * sigma - c["rho_old"])
        d = rho * c["rho_old"] * c["d"] + (2.0 * rho / delta) * z
        its = its + 1
        if want_norm:
            dp = ops.norm(z if norm_type == NORM_PRECONDITIONED else r, axis)
            rnorm0 = jnp.where(its == 1, dp, c["rnorm0"])
            # history index = reference monitor label = its - 1
            history = record(c["history"], its - 1, dp)
            monitor_cb(cfg, its - 1, dp)
            reason = check_convergence(dp, rnorm0, its, cfg)
        else:
            history = c["history"]
            rnorm0 = c["rnorm0"]
            reason = jnp.where(its >= cfg.maxits,
                               jnp.int32(ConvergedReason.CONVERGED_ITS),
                               jnp.int32(ConvergedReason.ITERATING))
        return dict(x=x, r=r, d=d, rho_old=rho, its=its, history=history,
                    rnorm0=rnorm0, reason=reason)

    init = dict(x=x, r=r, d=d0, rho_old=1.0 / sigma, its=jnp.int32(0),
                rnorm0=jnp.zeros((), jnp.zeros((), dtype).real.dtype),
                history=history, reason=reason)
    out = lax.while_loop(cond, body, init)
    # KSPSolve_Chebyshev applies the initial scale·B⁻¹r step BEFORE its
    # counted loop, so a max_it-bounded solve ends with max_it+1 total
    # corrections — the last applied after the final convergence check
    # (cheby.c: pre-loop VecAYPX + for-loop; monitored early exits break
    # before completing the update). Match that: one extra correction
    # when the loop exited on the iteration cap rather than convergence.
    capped = (out["reason"] == ConvergedReason.CONVERGED_ITS) \
        | (out["reason"] == ConvergedReason.DIVERGED_ITS)
    xf = jnp.where(capped, out["x"] + out["d"], out["x"])
    return SolveResult(xf, out["its"], out["reason"],
                       out["history"][jnp.maximum(out["its"] - 1, 0)],
                       out["history"])


def solve_richardson(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """Richardson x ← x + s·M⁻¹r (src/ksp/ksp/impls/rich)."""
    dtype = b.dtype
    x = x0 if cfg.guess_nonzero else jnp.zeros_like(b)
    s = cfg.richardson_scale
    norm_type = cfg.norm_type or NORM_PRECONDITIONED
    want_norm = norm_type != NORM_NONE

    r = b - A.mult(x)
    z = apply_pc(pc, r)
    if want_norm:
        dp = ops.norm(z if norm_type == NORM_PRECONDITIONED else r, axis)
    else:
        dp = jnp.zeros((), dtype)
    history = record(init_history(cfg, dtype), 0, dp)
    monitor_cb(cfg, 0, dp)
    reason = (check_convergence(dp, dp, jnp.int32(0), cfg) if want_norm
              else jnp.int32(ConvergedReason.ITERATING))
    rnorm0 = dp

    def cond(c):
        return c["reason"] == ConvergedReason.ITERATING

    def body(c):
        its = c["its"]
        if cfg.richardson_self_scale:
            # rich.c:84-92: y = BABr; scale = zᵀy/yᵀy; update x, r,
            # AND z by the same scale (z is kept consistent, not
            # recomputed — one PC apply per iteration)
            z = c["z"]
            w = A.mult(z)
            y = apply_pc(pc, w)
            rdot = ops.dot(z, y, axis)
            abr = ops.dot(y, y, axis)
            ss = rdot / abr
            x = c["x"] + ss * z
            r = c["r"] - ss * w
            z = z - ss * y
        else:
            x = c["x"] + s * c["z"]
            r = c["r"] - s * A.mult(c["z"])
            z = apply_pc(pc, r)
        its = its + 1
        if want_norm:
            dp = ops.norm(z if norm_type == NORM_PRECONDITIONED else r, axis)
            history = record(c["history"], its, dp)
            monitor_cb(cfg, its, dp)
            reason = check_convergence(dp, rnorm0, its, cfg)
        else:
            history = c["history"]
            reason = jnp.where(its >= cfg.maxits,
                               jnp.int32(ConvergedReason.CONVERGED_ITS),
                               jnp.int32(ConvergedReason.ITERATING))
        return dict(x=x, r=r, z=z, its=its, history=history, reason=reason)

    init = dict(x=x, r=r, z=z, its=jnp.int32(0), history=history,
                reason=reason)
    out = lax.while_loop(cond, body, init)
    return SolveResult(out["x"], out["its"], out["reason"],
                       out["history"][out["its"]], out["history"])


def solve_preonly(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """x = M⁻¹ b (src/ksp/ksp/impls/preonly) — one PC application."""
    x = apply_pc(pc, b)
    dtype = b.dtype
    history = init_history(cfg, dtype)
    return SolveResult(x, jnp.int32(1),
                       jnp.int32(ConvergedReason.CONVERGED_ITS),
                       jnp.zeros((), dtype), history)


def ksp_compute_eigenvalues(A, pc, b, iters: int = 30):
    """KSPComputeEigenvalues analog (-ksp_compute_eigenvalues,
    gmreig.c KSPComputeEigenvalues_GMRES): Ritz values of the
    preconditioned operator M⁻¹A from an `iters`-step Arnoldi run on
    the solve's right-hand side. Returns a complex numpy array
    (host). For the extreme singular values (KSPComputeExtreme-
    SingularValues analog) use ksp_compute_extreme_singular_values."""
    import numpy as np

    v = np.asarray(apply_pc(pc, b), np.float64)
    beta = float(np.linalg.norm(v))
    n = v.shape[0]
    m = min(iters, n)
    if beta == 0.0:
        return np.zeros(0, np.complex128)
    V = np.zeros((m + 1, n))
    H = np.zeros((m + 1, m))
    V[0] = v / beta
    k = m
    for j in range(m):
        w = np.asarray(apply_pc(pc, A.mult(jnp.asarray(V[j]))),
                       np.float64)
        h = V[:j + 1] @ w
        w = w - V[:j + 1].T @ h
        h2 = V[:j + 1] @ w            # reorthogonalize (refinement):
        w = w - V[:j + 1].T @ h2      # full-dimension Arnoldi needs it
        H[:j + 1, j] = h + h2
        hj1 = float(np.linalg.norm(w))
        H[j + 1, j] = hj1
        if hj1 == 0.0:
            k = j + 1
            break
        V[j + 1] = w / hj1
    return np.linalg.eigvals(H[:k, :k])


def ksp_compute_extreme_singular_values(A, pc, b, iters: int = 30):
    """KSPComputeExtremeSingularValues analog (gmreig.c:21): extreme
    singular values of the preconditioned operator from the Arnoldi
    upper-Hessenberg (SVD of H̄ₘ). Returns (smin, smax)."""
    import numpy as np

    v = np.asarray(apply_pc(pc, b), np.float64)
    beta = float(np.linalg.norm(v))
    n = v.shape[0]
    m = min(iters, n)
    if beta == 0.0:
        return 0.0, 0.0
    V = np.zeros((m + 1, n))
    H = np.zeros((m + 1, m))
    V[0] = v / beta
    k = m
    for j in range(m):
        w = np.asarray(apply_pc(pc, A.mult(jnp.asarray(V[j]))),
                       np.float64)
        h = V[:j + 1] @ w
        w = w - V[:j + 1].T @ h
        h2 = V[:j + 1] @ w
        w = w - V[:j + 1].T @ h2
        H[:j + 1, j] = h + h2
        hj1 = float(np.linalg.norm(w))
        H[j + 1, j] = hj1
        if hj1 == 0.0:
            k = j + 1
            break
        V[j + 1] = w / hj1
    s = np.linalg.svd(H[:k + 1, :k], compute_uv=False)
    return float(s.min()), float(s.max())
