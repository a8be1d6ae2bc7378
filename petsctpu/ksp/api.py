"""KSP public interface: registry, functional solve, and KSP object.

The reference's KSP interface (src/ksp/ksp/interface/itfunc.c:335
KSPSolve; registry itcreate.c/itregis.c:69-98; options itcl.c). The
dynamic string→constructor registry survives as KSP_REGISTRY /
register_ksp so `ksp_type="gmres"` selects implementations at runtime,
composable from the options DB exactly like `-ksp_type gmres`.
"""

from __future__ import annotations

import functools
from dataclasses import replace
from typing import Optional

import jax
import jax.numpy as jnp

from petsctpu.core.logging import log_event
from petsctpu.core.options import Options
from petsctpu.ksp.common import KSPConfig, SolveResult
from petsctpu.ksp.cg import solve_cg, solve_pipecg
from petsctpu.ksp.gmres import solve_gmres, solve_fgmres
from petsctpu.ksp.bcgs import solve_bcgs, solve_cgsq, solve_bicg
from petsctpu.ksp.cheby import solve_chebyshev, solve_richardson, solve_preonly
from petsctpu.ksp.minres import solve_minres, solve_lsqr
from petsctpu.ksp.extra import (solve_cr, solve_tfqmr, solve_cgne,
                               solve_fbcgs, solve_fbcgsr)
from petsctpu.ksp.more import (
    solve_symmlq, solve_gcr, solve_bcgsl, solve_stcg, solve_lgmres,
)
from petsctpu.ksp.lcd_tcqmr import solve_lcd, solve_tcqmr
from petsctpu.ksp.ibcgs import solve_ibcgs
from petsctpu.ksp.dgmres import solve_dgmres

# host-driven solvers (between-cycle LAPACK work): never wrapped in jit
HOST_DRIVEN = {"dgmres", "agmres", "fgmres_host"}

KSP_REGISTRY = {
    "dgmres": solve_dgmres,
    "agmres": solve_dgmres,    # augmented/deflated restart family
    "lcd": solve_lcd,
    "tcqmr": solve_tcqmr,
    "ibcgs": solve_ibcgs,
    "symmlq": solve_symmlq,
    "gcr": solve_gcr,
    "bcgsl": solve_bcgsl,
    "lgmres": solve_lgmres,
    "stcg": solve_stcg,
    "nash": solve_stcg,        # same TR-CG interface; boundary step to sphere
    "gltr": solve_stcg,
    "qcg": solve_stcg,
    "pgmres": solve_gmres,     # CGS orth already fuses to ONE reduction/iter
    "cr": solve_cr,
    "pipecr": solve_cr,        # fused-reduction CR (same device structure)
    "tfqmr": solve_tfqmr,
    "cgne": solve_cgne,
    "fbcgs": solve_fbcgs,
    "fbcgsr": solve_fbcgsr,
    "cg": solve_cg,
    "pipecg": solve_pipecg,
    "groppcg": solve_pipecg,    # same single-reduction structure here
    "gmres": solve_gmres,
    "fgmres": solve_fgmres,
    "fgmres_host": None,       # filled below (import-cycle: needs registry)
    "bcgs": solve_bcgs,
    "cgs": solve_cgsq,
    "bicg": solve_bicg,
    "chebyshev": solve_chebyshev,
    "specest": solve_chebyshev,  # one-shot functional view (auto bounds);
                                 # the TRUE stateful two-phase KSPSPECEST is
                                 # ksp/specest.SpecEstPC (+ fgmres_host)
    "richardson": solve_richardson,
    "preonly": solve_preonly,
    "minres": solve_minres,
    "lsqr": solve_lsqr,
}


from petsctpu.ksp.specest import solve_fgmres_host  # noqa: E402
KSP_REGISTRY["fgmres_host"] = solve_fgmres_host


def register_ksp(name: str, fn) -> None:
    """Dynamic registration (KSPRegisterDynamic analog)."""
    KSP_REGISTRY[name] = fn


@functools.lru_cache(maxsize=256)
def _compiled(ksp_type: str, cfg: KSPConfig, axis: Optional[str]):
    fn = KSP_REGISTRY[ksp_type]

    def run(A, b, x0, pc):
        return fn(A, b, x0, pc, cfg, axis)

    # Inside shard_map (axis set) the caller controls jit; serial path jits.
    if ksp_type in HOST_DRIVEN:
        return run
    return run if axis is not None else jax.jit(run)


def config_from_options(opts: Options, defaults: KSPConfig = None) -> KSPConfig:
    """Consume -ksp_* options (itcl.c KSPSetFromOptions analog)."""
    if opts.get_bool("info", False):
        from petsctpu.core.logging import info_on
        info_on()
    cfg = defaults or KSPConfig()
    cfg = replace(
        cfg,
        ksp_type=opts.get_str("ksp_type", cfg.ksp_type),
        rtol=opts.get_real("ksp_rtol", cfg.rtol),
        atol=opts.get_real("ksp_atol", cfg.atol),
        divtol=opts.get_real("ksp_divtol", cfg.divtol),
        maxits=opts.get_int("ksp_max_it", cfg.maxits),
        restart=opts.get_int("ksp_gmres_restart", cfg.restart),
        norm_type=opts.get("ksp_norm_type", cfg.norm_type),
        monitor=opts.get_bool("ksp_monitor", cfg.monitor)
        or opts.get_bool("ksp_monitor_short", False),
        monitor_true=opts.get_bool("ksp_monitor_true_residual",
                                   cfg.monitor_true),
        cgs_refine=opts.get_str("ksp_gmres_cgs_refinement_type",
                                cfg.cgs_refine).replace("refine_", ""),
        orth="mgs" if opts.get_bool("ksp_gmres_modifiedgramschmidt", False)
        else cfg.orth,
        richardson_scale=opts.get_real("ksp_richardson_scale",
                                       cfg.richardson_scale),
        cheby_emin=opts.get_real("ksp_chebyshev_emin", cfg.cheby_emin),
        cheby_emax=opts.get_real("ksp_chebyshev_emax", cfg.cheby_emax),
        guess_nonzero=opts.get_bool("ksp_initial_guess_nonzero",
                                    cfg.guess_nonzero),
        radius=opts.get_real("ksp_cg_radius", cfg.radius),
        aug_dim=opts.get_int("ksp_lgmres_augment", cfg.aug_dim),
        bcgsl_ell=opts.get_int("ksp_bcgsl_ell", cfg.bcgsl_ell),
        lag_norm=opts.get_bool("ksp_lag_norm", cfg.lag_norm),
        cg_single_reduction=opts.get_bool("ksp_cg_single_reduction",
                                          cfg.cg_single_reduction),
    )
    # -ksp_pc_side right on gmres: right preconditioning with a fixed
    # (linear) PC is exactly FGMRES's iteration — map to it (the
    # reference's KSPSetPCSide; monitors then show true residuals)
    if (opts.get_str("ksp_pc_side", "left") == "right"
            and cfg.ksp_type == "gmres"):
        cfg = replace(cfg, ksp_type="fgmres")
    # GMRES only supports the unpreconditioned norm RIGHT-preconditioned
    # (KSPSetSupportedNorm gmres.c:910) — the reference silently flips
    # the side; right preconditioning with a fixed PC is FGMRES
    if (cfg.norm_type == "unpreconditioned" and cfg.ksp_type == "gmres"):
        cfg = replace(cfg, ksp_type="fgmres")
    return cfg


def ksp_solve(A, b, x0=None, pc=None, axis: Optional[str] = None,
              cfg: KSPConfig = None, nullspace=None, **kw) -> SolveResult:
    """Solve A x = b. kw overrides KSPConfig fields (e.g. ksp_type="cg").

    nullspace: optional NullSpace of a singular-but-consistent A
    (MatSetNullSpace + KSP_RemoveNullSpace analog): projected out of
    b, out of every preconditioned residual, and out of x."""
    cfg = replace(cfg or KSPConfig(), **kw) if (kw or cfg is None) else cfg
    # host-stateful PCs (SpecEstPC & friends) cannot be traced inside a
    # jitted while_loop — route the flexible outer to the host driver
    if getattr(pc, "host_stateful", False) and cfg.ksp_type == "fgmres":
        cfg = replace(cfg, ksp_type="fgmres_host")
    if x0 is None:
        x0 = jnp.zeros_like(b)      # preserves b's (possibly grid) shape
    if nullspace is not None:
        from petsctpu.mat.nullspace import _NullSpacePC
        from petsctpu.pc.simple import NonePC
        b = nullspace.remove(b)
        x0 = nullspace.remove(x0)
        pc = _NullSpacePC(pc if pc is not None else NonePC(), nullspace)
    run = _compiled(cfg.ksp_type, cfg, axis)
    with log_event(f"KSPSolve[{cfg.ksp_type}]"):
        res = run(A, b, x0, pc)
    _log_solve_flops(A, b, cfg, res)
    return res


def _log_solve_flops(A, b, cfg, res) -> None:
    """Post-hoc analytic flop model (reference convention: SpMV counts
    2·nnz − nrows, aij.c:1219; plus ~10n of vector work per iteration)."""
    from petsctpu.core import logging as plog

    if not plog.log_enabled():
        return
    try:
        its = int(res.its)
    except Exception:
        return   # still traced (inside jit) — skip host accounting
    spmv = getattr(A, "flops_per_mult", lambda: 0.0)()
    n = b.shape[0]
    plog.log_flops(f"KSPSolve[{cfg.ksp_type}]",
                   flops=its * (spmv + 10.0 * n))
    plog.log_flops("MatMult", flops=its * spmv)


class KSP:
    """Stateful wrapper mirroring the reference KSP lifecycle:
    create → set_operators → set_from_options → solve (repeatedly)."""

    def __init__(self, options: Options = None, prefix: str = ""):
        self.opts = (options or Options()).prefixed(prefix)
        self.cfg = KSPConfig()
        self.A = None
        self.A_host = None
        self.pc = None
        self.axis = None
        self.guess = None            # KSPFischerGuess state
        self.nullspace = None        # MatNullSpace of the operator
        self._setup = False

    def set_operators(self, A, A_host=None):
        """A: device operator; A_host: scipy matrix for PC setup paths
        that need host-side symbolic work (ILU/LU/AMG)."""
        self.A = A
        self.A_host = A_host
        self._setup = False
        return self

    def set_pc(self, pc):
        self.pc = pc
        self._setup = False
        return self

    def set_from_options(self):
        self.cfg = config_from_options(self.opts, self.cfg)
        return self

    def setup(self):
        if self._setup:
            return self
        if self.pc is None:
            from petsctpu.pc import make_pc
            pc_type = self.opts.get_str("pc_type", "ilu" if self.A_host
                                        is not None else "jacobi")
            self.pc = make_pc(pc_type, A=self.A, A_host=self.A_host,
                              options=self.opts, axis=self.axis)
        self._setup = True
        return self

    def set_use_fischer_guess(self, model: int = 1, size: int = 10):
        """KSPSetUseFischerGuess analog (itfunc.c:371 lifecycle: form
        before each solve, update after)."""
        from petsctpu.ksp.guess import make_fischer_guess
        n = self.A.shape[0]
        dt = getattr(self.A, "dtype", None)
        self.guess = make_fischer_guess(n, size=size, model=model, dtype=dt)
        return self

    def set_nullspace(self, nullspace):
        """MatSetNullSpace analog: projected during every solve."""
        self.nullspace = nullspace
        return self

    def solve(self, b, x0=None) -> SolveResult:
        self.set_from_options()
        self.setup()
        if x0 is None and self.guess is not None:
            x0 = self.guess.form(b)
            if self.cfg.ksp_type not in ("preonly",):
                self.cfg = replace(self.cfg, guess_nonzero=True)
        res = ksp_solve(self.A, b, x0=x0, pc=self.pc, axis=self.axis,
                        cfg=self.cfg, nullspace=self.nullspace)
        if self.guess is not None:
            self.guess = self.guess.update(res.x, self.A.mult(res.x))
        if self.opts.get_bool("ksp_view", False):
            print(self.view())
        if self.opts.get_bool("help", False):
            print(self.opts.help_text())
        if self.opts.get_bool("ksp_monitor_draw", False):
            from petsctpu.core.draw import monitor_draw
            monitor_draw(res,
                         save=self.opts.get("ksp_monitor_draw_save"))
        return res

    def view(self) -> str:
        """-ksp_view analog: textual solver configuration (itfunc.c
        KSPView / PCView output shape)."""
        c = self.cfg
        lines = ["KSP Object: 1 MPI processes", f"  type: {c.ksp_type}"]
        if "gmres" in c.ksp_type:
            orth = ("Classical (unmodified) Gram-Schmidt"
                    if c.orth == "cgs" else "Modified Gram-Schmidt")
            refine = {"never": "no", "always": "one step of",
                      "ifneeded": "as-needed"}.get(c.cgs_refine, "no")
            lines.append(f"    GMRES: restart={c.restart}, using {orth} "
                         f"Orthogonalization with {refine} iterative "
                         "refinement")
        lines.append(f"  maximum iterations={c.maxits}, initial guess is "
                     + ("nonzero" if c.guess_nonzero else "zero"))
        lines.append(f"  tolerances:  relative={c.rtol:g}, "
                     f"absolute={c.atol:g}, divergence={c.divtol:g}")
        lines.append("  left preconditioning")
        nt = c.norm_type or ("unpreconditioned" if c.ksp_type in
                             ("fgmres", "fbcgs", "fbcgsr", "lsqr") else "preconditioned")
        lines.append(f"  using {nt.upper()} norm type for convergence test")
        lines.append("PC Object: 1 MPI processes")
        lines.append(f"  type: {type(self.pc).__name__ if self.pc is not None else 'none'}")
        return "\n".join(lines)


def ksp_solve_transpose(A, b, x0=None, pc=None, axis=None,
                        cfg: KSPConfig = None, **kw) -> SolveResult:
    """KSPSolveTranspose (itfunc.c:539): solve Aᵀ x = b.

    The operator is wrapped implicitly (MATTRANSPOSE analog); `pc` must
    apply the transposed preconditioner — e.g. make_lu(A_host,
    transpose=True) for the PCApplyTranspose of an LU factorization,
    or any symmetric PC (jacobi/none/icc) unchanged."""
    from petsctpu.mat.base import Transpose

    return ksp_solve(Transpose(A), b, x0=x0, pc=pc, axis=axis,
                     cfg=cfg, **kw)


def diagonal_scale_system(A_host, b):
    """KSPSetDiagonalScale analog (-ksp_diagonal_scale; itfunc.c:237-263
    builds d_i = 1/sqrt(|a_ii|) (1 where a_ii = 0), :380 scales the
    rhs, :436 unscales the solution): returns the symmetrically scaled
    host system (D A D, D b) plus d, so callers solve the scaled
    system — monitors then show the scaled norms exactly like the
    reference — and recover x = D x̃. The reference's
    -ksp_diagonal_scale_fix (restore the caller's matrix after the
    solve) is implicit here: the input matrix is never mutated."""
    import numpy as np
    import scipy.sparse as sp

    d = np.asarray(A_host.diagonal(), np.float64)
    d = np.where(d != 0.0, 1.0 / np.sqrt(np.abs(d)), 1.0)
    D = sp.diags(d)
    return (D @ A_host @ D).tocsr(), d * np.asarray(b, np.float64), d
