"""Mixed-precision iterative refinement — an extra beyond the reference.

The reference is fixed-precision per build. fp32 moves half the bytes
of fp64, while fp32 Krylov stalls near its rounding floor. Iterative refinement
gets both: the inner Krylov solve runs entirely in fast fp32 (where
the SpMV/reduction flops are), while the outer loop computes true
residuals and accumulates the solution in fp64 — classic Wilkinson IR
with a Krylov inner solver.

    ‖r_k‖ contracts by roughly the inner solve's fp32-achievable
    reduction each sweep, so a handful of cheap fp32 solves reach
    fp64-level accuracy.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from petsctpu.core.errors import ConvergedReason
from petsctpu.ksp.common import KSPConfig, SolveResult


def solve_ir(A64, A32, b, pc32=None, cfg: KSPConfig = None,
             inner_cfg: KSPConfig = None, max_refine: int = 10,
             axis: Optional[str] = None, **kw) -> SolveResult:
    """Iterative refinement: fp64 residuals, fp32 inner Krylov solves.

    A64 : fp64 device operator (residual evaluation)
    A32 : the same operator in fp32 (inner solve; e.g. rebuilt with
          dtype=np.float32)
    pc32: optional fp32 preconditioner for the inner solve
    cfg : OUTER tolerance (fp64 true-residual rtol/atol)
    inner_cfg: inner solver config (defaults: gmres, rtol 1e-5)
    """
    from petsctpu.ksp.api import KSP_REGISTRY

    cfg = replace(cfg or KSPConfig(rtol=1e-12), **kw) if kw \
        else (cfg or KSPConfig(rtol=1e-12))
    inner_cfg = inner_cfg or KSPConfig(ksp_type="gmres", rtol=1e-5,
                                       maxits=200)
    inner = KSP_REGISTRY[inner_cfg.ksp_type]
    b64 = jnp.asarray(b, jnp.float64)

    @jax.jit
    def sweep(x64):
        r64 = b64 - A64.mult(x64)
        r32 = r64.astype(jnp.float32)
        d = inner(A32, r32, jnp.zeros_like(r32), pc32, inner_cfg, axis)
        x64 = x64 + d.x.astype(jnp.float64)
        rn = jnp.linalg.norm(b64 - A64.mult(x64))
        return x64, rn, d.its

    x = jnp.zeros_like(b64)
    rnorm0 = float(jnp.linalg.norm(b64))
    history = np.full(max_refine + 1, np.nan)
    history[0] = rnorm0
    its_total = 0
    reason = ConvergedReason.ITERATING
    rn = rnorm0
    for k in range(1, max_refine + 1):
        x, rn_j, inner_its = sweep(x)
        rn_prev, rn = rn, float(rn_j)
        its_total += int(inner_its)
        history[k] = rn
        if not np.isfinite(rn):
            reason = ConvergedReason.DIVERGED_NANORINF
            break
        if rn <= max(cfg.rtol * rnorm0, cfg.atol):
            reason = ConvergedReason.CONVERGED_RTOL
            break
        if rn >= 0.9 * rn_prev:                  # fp32 floor reached
            reason = (ConvergedReason.CONVERGED_RTOL
                      if rn <= 1e-6 * rnorm0
                      else ConvergedReason.DIVERGED_DTOL)
            break
    else:
        reason = ConvergedReason.DIVERGED_ITS

    return SolveResult(x, jnp.int32(its_total), jnp.int32(int(reason)),
                       jnp.asarray(rn), jnp.asarray(history))
