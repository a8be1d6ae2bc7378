"""Specialty preconditioners: Galerkin, redistribute, LSC, SVD, CP,
Eisenstat.

Reference impls: src/ksp/pc/impls/{galerkin,redistribute,lsc,svd,cp,
eisens}. Setup is host-side symbolic work (scipy); apply is jit-safe
device code, matching the rest of the PC layer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


# ---------------------------------------------------------------------------
# PCGalerkin — P-projected preconditioner
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class GalerkinPC:
    """x ← P · inner((Rᵀ=Pᵀ) x): solve in a user subspace
    (src/ksp/pc/impls/galerkin/galerkin.c — PCGalerkinSetInterpolation/
    SetRestriction; here restriction defaults to Pᵀ)."""

    P: object                       # interpolation op: mult (c→f), multT
    inner: object                   # PC/solver on the coarse space

    def apply(self, x):
        return self.P.mult(self.inner.apply(self.P.multT(x)))


def make_galerkin(A_host, P, P_host=None, dtype=None, inner=None):
    """P: device op (mult/multT). If inner is None, the coarse operator
    PᵀAP is formed on host and LU-factored."""
    if inner is None:
        from petsctpu.pc.factor import make_lu
        if P_host is None:
            raise ValueError("pc galerkin needs P_host (scipy) or an "
                             "explicit inner solver")
        Ac = (P_host.T @ A_host @ P_host).tocsc()
        inner = make_lu(Ac, dtype=dtype)
    return GalerkinPC(P, inner)


# ---------------------------------------------------------------------------
# PCRedistribute — strip Dirichlet(-only) rows, solve the reduced system
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class RedistributePC:
    """Rows whose only nonzero is the diagonal (Dirichlet rows) are
    solved directly (x_i = b_i/a_ii); the remaining coupled rows are
    solved by an inner PC on the reduced matrix with the Dirichlet
    contribution moved to the right-hand side
    (src/ksp/pc/impls/redistribute/redistribute.c)."""

    keep: jax.Array                 # indices of coupled rows
    drop: jax.Array                 # indices of Dirichlet rows
    ddiag_inv: jax.Array            # 1/a_ii on dropped rows
    coupling: object                # device op: A[keep, drop] (AIJ)
    inner: object                   # PC on A[keep, keep]
    n: int = field(metadata=dict(static=True), default=0)

    def apply(self, b):
        if self.coupling is None:        # no Dirichlet rows to strip
            return self.inner.apply(b)
        xd = self.ddiag_inv * b[self.drop]
        rhs = b[self.keep] - self.coupling.mult(xd)
        xk = self.inner.apply(rhs)
        x = jnp.zeros(self.n, b.dtype)
        return x.at[self.drop].set(xd).at[self.keep].set(xk)


def make_redistribute(A_host, dtype=None, inner_factory=None):
    from petsctpu.mat.ell import aij_from_scipy
    from petsctpu.pc.factor import make_lu

    A = sp.csr_matrix(A_host)
    n = A.shape[0]
    nnz_per_row = np.diff(A.indptr)
    only_diag = np.zeros(n, bool)
    for i in np.where(nnz_per_row == 1)[0]:
        only_diag[i] = A.indices[A.indptr[i]] == i
    drop = np.where(only_diag)[0]
    keep = np.where(~only_diag)[0]
    if drop.size == 0:                  # nothing to strip: plain inner solve
        inner = (inner_factory(A) if inner_factory is not None
                 else make_lu(A, dtype=dtype))
        return RedistributePC(jnp.asarray(keep), jnp.asarray(drop),
                              jnp.zeros(0, dtype or np.float64), None,
                              inner, n)
    diag = A.diagonal()
    ddiag_inv = np.where(diag[drop] != 0, 1.0 / np.where(diag[drop] != 0,
                                                         diag[drop], 1.0), 1.0)
    Akk = A[keep][:, keep].tocsr()
    Akd = A[keep][:, drop].tocsr()
    inner = (inner_factory(Akk) if inner_factory is not None
             else make_lu(Akk, dtype=dtype))
    return RedistributePC(jnp.asarray(keep), jnp.asarray(drop),
                          jnp.asarray(ddiag_inv, dtype or np.float64),
                          aij_from_scipy(Akd, dtype=dtype), inner, n)


# ---------------------------------------------------------------------------
# PCLSC — least-squares commutator (Stokes Schur complements)
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class LSCPC:
    """S⁻¹ ≈ L⁻¹ (B A Bᵀ) L⁻¹ with L = B Bᵀ
    (src/ksp/pc/impls/lsc/lsc.c; Elman–Howle–Shadid–Shuttleworth–
    Tuminaro). B is the divergence block A10, A the momentum block A00;
    L solves via an inner PC (default LU of BBᵀ)."""

    B: object                       # device op with mult/multT
    A00: object                     # device op
    Linner: object                  # PC for L = B Bᵀ

    def apply(self, x):
        y = self.Linner.apply(x)
        z = self.B.mult(self.A00.mult(self.B.multT(y)))
        return self.Linner.apply(z)


def make_lsc(A00_host, B_host, dtype=None, shift: float = 1e-12):
    from petsctpu.mat.ell import aij_from_scipy
    from petsctpu.pc.factor import make_lu

    B = sp.csr_matrix(B_host)
    L = (B @ B.T).tocsr()
    L = L + shift * sp.eye(L.shape[0], format="csr")
    return LSCPC(aij_from_scipy(B, dtype=dtype),
                 aij_from_scipy(sp.csr_matrix(A00_host), dtype=dtype),
                 make_lu(L, dtype=dtype))


# ---------------------------------------------------------------------------
# PCSVD — dense pseudo-inverse with singular-value cutoff
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SVDPC:
    """x ← V Σ⁺ Uᵀ x (src/ksp/pc/impls/svd/svd.c): exact for small /
    rank-deficient systems; zeroed singular values below rtol·σ_max.
    Apply is two dense matmuls."""

    U: jax.Array
    sinv: jax.Array
    Vt: jax.Array

    def apply(self, x):
        return self.Vt.T @ (self.sinv * (self.U.T @ x))


def make_svd(A_host, dtype=None, rtol: float = 1e-12) -> SVDPC:
    Ad = np.asarray(A_host.todense() if sp.issparse(A_host) else A_host,
                    dtype or np.float64)
    U, s, Vt = np.linalg.svd(Ad)
    cutoff = rtol * (s[0] if s.size else 1.0)
    sinv = np.where(s > cutoff, 1.0 / np.where(s > cutoff, s, 1.0), 0.0)
    return SVDPC(jnp.asarray(U), jnp.asarray(sinv), jnp.asarray(Vt))


# ---------------------------------------------------------------------------
# PCCP — column projections (Gauss-Seidel on the normal equations)
# ---------------------------------------------------------------------------

def make_cp(A_host, dtype=None, omega: float = 1.0, sweeps: int = 1):
    """PCCP (src/ksp/pc/impls/cp/cp.c): cyclic column-projection
    sweeps x_j ← x_j + aⱼ·r/‖aⱼ‖² — algebraically Gauss-Seidel on the
    normal equations AᵀA x = Aᵀ b. Setup forms AᵀA on host and reuses
    the level-scheduled SOR kernels; apply(b) expects b ALREADY in
    residual form (as a PC: x = sweeps of NE-GS from 0 on AᵀA y = Aᵀb)."""
    from petsctpu.mat.ell import aij_from_scipy
    from petsctpu.pc.sor import make_sor

    A = sp.csr_matrix(A_host)
    AtA = (A.T @ A).tocsr()
    sor = make_sor(AtA, omega=omega, sweeps=sweeps, symmetric=False,
                   dtype=dtype)
    At = aij_from_scipy(sp.csr_matrix(A.T), dtype=dtype)
    return _NormalEqPC(At, sor)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class _NormalEqPC:
    At: object
    inner: object

    def apply(self, b):
        return self.inner.apply(self.At.mult(b))


# ---------------------------------------------------------------------------
# PCEisenstat — SSOR via Eisenstat's trick
# ---------------------------------------------------------------------------

def make_eisenstat(A_host, omega: float = 1.0, dtype=None):
    """Eisenstat's trick (src/ksp/pc/impls/eisens/eisen.c) produces
    iterations IDENTICAL to SSOR preconditioning while halving the
    per-iteration flops of the CPU triangular sweeps. Here the solve
    is level-scheduled and fused by XLA, so the framework keeps the
    SSOR formulation (same preconditioned operator, same convergence
    history) — this factory exists for option-level parity. For the
    reference's literal transformed-system formulation (whose
    *monitored* preconditioned norms match output/ex2_4.out), use
    make_eisenstat_system."""
    from petsctpu.pc.sor import make_sor

    return make_sor(A_host, omega=omega, sweeps=1, symmetric=True,
                    dtype=dtype)


def make_eisenstat_system(A_host, omega: float = 1.0, usediag: bool = True,
                          dtype=None):
    """The reference's literal Eisenstat formulation: returns
    (shell, pc, presolve, postsolve).

    With A = L + D + U and E = D/ω, KSP solves the transformed system
      Ã y = b̃,  Ã = (E+L)⁻¹ A (E+U)⁻¹,  b̃ = (E+L)⁻¹ b,  x = (E+U)⁻¹ y
    (PCPreSolve_Eisenstat eisen.c:84, PCPostSolve_Eisenstat :103).
    The shell mult uses Eisenstat's trick (MatSOR SOR_EISENSTAT branch,
    aij.c:1510-1527): x₁ = (E+U)⁻¹b; t = b − (2/ω−1)·D·x₁;
    x = x₁ + (E+L)⁻¹t — one L-solve + one U-solve, no products with A.
    The PC is diagonal scaling by D (PCApply_Eisenstat eisen.c:40-48,
    usediag default)."""
    import scipy.sparse as sp

    from petsctpu.mat.base import Shell
    from petsctpu.mat.factor import make_sptrsv_plan

    A = sp.csr_matrix(A_host)
    D = A.diagonal()
    E = D / omega
    Lmat = (sp.tril(A, k=-1, format="csr") + sp.diags(E)).tocsr()
    Umat = (sp.triu(A, k=1, format="csr") + sp.diags(E)).tocsr()
    Lp = make_sptrsv_plan(Lmat, lower=True, unit_diag=False, dtype=dtype)
    Up = make_sptrsv_plan(Umat, lower=False, unit_diag=False, dtype=dtype)
    scale = 2.0 / omega - 1.0
    d = jnp.asarray(D if dtype is None else D.astype(dtype))

    def _mult(ctx, b):
        Lp, Up, d = ctx
        x1 = Up.solve(b)
        t = b - scale * d * x1
        return x1 + Lp.solve(t)

    shell = Shell(ctx=(Lp, Up, d), mult_fn=_mult, shape=A.shape)
    pc = _DiagMultPC(d) if usediag else None
    return shell, pc, Lp.solve, Up.solve


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class _DiagMultPC:
    """y = D·x (PCApply_Eisenstat's VecPointwiseMult with the matrix
    diagonal, eisen.c:46)."""

    d: jax.Array

    def apply(self, x):
        return self.d * x
