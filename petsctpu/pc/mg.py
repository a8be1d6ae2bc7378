"""PCMG — multigrid preconditioner framework.

Reference: src/ksp/pc/impls/mg/mg.c (PCMGMCycle_Private :10,
PCSetUp_MG :529, PCApply_MG :296): a level hierarchy with per-level
smoothers, interpolation/restriction operators, and a coarse solve;
V/W cycles. Design choices:

  * default smoother is Chebyshev+Jacobi — like the reference's MG
    default (mg.c sets cheby+sor; we use the dot-product-free pair
    that needs ZERO collectives per smoothing step, SURVEY §2.10 P4);
    eigenvalue bounds are computed once at setup (host power
    iteration) and baked in;
  * the level loop is a statically unrolled Python recursion (level
    count is static), so XLA sees one straight-line program;
  * coarse solve is an exact sparse LU (level-scheduled device solve);
  * Galerkin coarse operators (PᵀAP): the geometric path rebuilds the
    whole hierarchy ON DEVICE in one jitted program
    (make_geometric_mg_device + mat/stencil.galerkin_coarsen); the
    algebraic refresh path is
    pc/gamg_device.GAMGDevicePlan (frozen symbolic SpGEMM plans).
    First-time host setup uses scipy PtAP like the reference's
    MatPtAP at PCSetUp_GAMG/MG time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from petsctpu.core.options import Options
from petsctpu.pc.factor import LUPC, make_lu
from petsctpu.pc.simple import JacobiPC


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ChebySmoother:
    """Fixed-iteration Chebyshev smoother.

    Preconditioner: Jacobi (dinv) by default, or any pc pytree (e.g.
    an SSOR plan — the reference's MG default smoother is
    chebyshev+SOR local_symmetric, mg.c:220-224). Bounds follow the
    reference's [0.1·λmax, 1.1·λmax] estimate transform of M⁻¹A."""

    dinv: jax.Array
    emin: jax.Array
    emax: jax.Array
    its: int = field(metadata=dict(static=True), default=2)
    pc: Any = None

    def _prec(self, r):
        return self.pc.apply(r) if self.pc is not None else self.dinv * r

    def smooth(self, A, b, x):
        # KSPSolve_Chebyshev semantics: the scale·M⁻¹r step happens
        # BEFORE the max_it-counted loop, so its=k applies k+1
        # corrections total (cheby.c pre-loop VecAYPX + k updates)
        theta = 0.5 * (self.emax + self.emin)
        delta = 0.5 * (self.emax - self.emin)
        sigma = theta / delta
        rho = 1.0 / sigma
        r = b - A.mult(x)
        d = self._prec(r) / theta
        for _ in range(self.its):
            x = x + d
            r = r - A.mult(d)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * self._prec(r)
            rho = rho_new
        return x + d


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class MGLevel:
    A: Any                      # operator on this level
    P: Any                      # prolongation coarser→this level
    smoother: ChebySmoother
    # explicit restriction operator (= Pᵀ as its own fast-format
    # matrix); None falls back to P.multT scatter-add
    R: Any = None

    def restrict(self, r):
        return self.R.mult(r) if self.R is not None else self.P.multT(r)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class MGPC:
    """Apply one multigrid cycle as a preconditioner: x = MG(b)."""

    levels: Tuple                # fine..(second-coarsest) MGLevel
    coarse: LUPC                 # exact solve on coarsest
    coarse_A: Any
    cycles: int = field(metadata=dict(static=True), default=1)  # 1=V 2=W
    # PCMGType (mg.c PCMGSetType): multiplicative | additive | full | kaskade
    mg_type: str = field(metadata=dict(static=True), default="multiplicative")

    def apply(self, b):
        if self.mg_type == "full":
            return self._full(0, b)
        if self.mg_type == "kaskade":
            return self._kaskade(0, b)
        if self.mg_type == "additive":
            return self._additive(b)
        return self._cycle(0, b)

    def _cycle(self, l, b):
        if l == len(self.levels):
            return self.coarse.apply(b)
        lev = self.levels[l]
        x = lev.smoother.smooth(lev.A, b, jnp.zeros_like(b))
        for _ in range(self.cycles):
            r = b - lev.A.mult(x)
            rc = lev.restrict(r)
            xc = self._cycle(l + 1, rc)
            x = x + lev.P.mult(xc)
        x = lev.smoother.smooth(lev.A, b, x)
        return x

    def _full(self, l, b):
        """F-cycle (PCMGFCycle_Private mg.c): solve coarse first, take
        the interpolant as the initial guess, then one V-cycle."""
        if l == len(self.levels):
            return self.coarse.apply(b)
        lev = self.levels[l]
        x = lev.P.mult(self._full(l + 1, lev.restrict(b)))
        # V-cycle with nonzero initial guess
        x = lev.smoother.smooth(lev.A, b, x)
        r = b - lev.A.mult(x)
        x = x + lev.P.mult(self._cycle(l + 1, lev.restrict(r)))
        x = lev.smoother.smooth(lev.A, b, x)
        return x

    def _kaskade(self, l, b):
        """Kaskade (PCMGKCycle_Private): coarse solve, interpolate up,
        post-smooth only — no downward residual correction."""
        if l == len(self.levels):
            return self.coarse.apply(b)
        lev = self.levels[l]
        x = lev.P.mult(self._kaskade(l + 1, lev.restrict(b)))
        return lev.smoother.smooth(lev.A, b, x)

    def _additive(self, b):
        """Additive MG (PCApply_MG additive branch): every level
        smooths the restricted RHS independently; corrections sum."""
        rs = [b]
        for lev in self.levels:
            rs.append(lev.restrict(rs[-1]))
        x = self.coarse.apply(rs[-1])
        for l in range(len(self.levels) - 1, -1, -1):
            lev = self.levels[l]
            s = lev.smoother.smooth(lev.A, rs[l], jnp.zeros_like(rs[l]))
            x = s + lev.P.mult(x)
        return x


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------
@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PackedMGPC:
    """MGPC shipped to device as TWO flat buffers and carved back into
    the level structure at trace time (static offsets — the slicing
    fuses into the consuming jit, costing no extra executables).
    One fp32 + one int32 host-to-device transfer replaces one transfer
    per level array (~30 for a 4-level hierarchy)."""

    fbuf: jax.Array
    ibuf: jax.Array
    metas: tuple = field(metadata=dict(static=True), default=())
    coarse_meta: tuple = field(metadata=dict(static=True), default=())
    sm_its: int = field(metadata=dict(static=True), default=2)
    cycles: int = field(metadata=dict(static=True), default=1)
    mg_type: str = field(metadata=dict(static=True),
                         default="multiplicative")

    def _getf(self, off_shape):
        off, shape = off_shape
        size = int(np.prod(shape))
        return jax.lax.dynamic_slice(self.fbuf, (off,),
                                     (size,)).reshape(shape)

    def _geti(self, off_shape):
        off, shape = off_shape
        size = int(np.prod(shape))
        return jax.lax.dynamic_slice(self.ibuf, (off,),
                                     (size,)).reshape(shape)

    def _unpack_op(self, amref):
        from petsctpu.mat.ell import AIJ
        if amref[0] == "ell":
            _, ci, vi, sha, nza = amref
            return AIJ(self._geti(ci), self._getf(vi), sha, nza), sha
        if amref[0] == "rectband":
            from petsctpu.mat.rectband import RectBandMat
            _, bref, s_, off_, sha, nnz, bshape = amref
            return RectBandMat(self._getf((bref[0], bshape)), s_, off_,
                               sha, nnz), sha
        if amref[0] == "dense":
            from petsctpu.mat.dense import Dense
            _, dref, sha, nnz = amref
            return Dense(self._getf((dref[0], sha))), sha
        from petsctpu.mat.sell import SellMat
        (_, vi, ii, qi, wi, di, sha, nnz, G, S, Lp, vshape,
         mode) = amref
        vals = self._getf((vi[0], vshape))
        idx32 = self._geti((ii[0], (int(np.prod(vshape)) // 4,)))
        idx = jax.lax.bitcast_convert_type(idx32, jnp.int8) \
            .reshape(vshape)
        qs = self._geti((qi[0], vshape[:2]))
        winstart = self._geti((wi[0], (vshape[0],)))
        diag = self._getf((di[0], (sha[0],)))
        return SellMat(vals, idx, qs, winstart, diag, sha, nnz, G, S,
                       Lp, mode), sha

    def unpack(self) -> MGPC:
        from petsctpu.mat.ell import AIJ
        from petsctpu.pc.gamg_device import DenseLUPC
        levels = []
        for (amref, pref, rref, do, lam) in self.metas:
            A, sha = self._unpack_op(amref)
            P, _ = self._unpack_op(pref)
            R = self._unpack_op(rref)[0] if rref is not None else None
            dinv = self._getf((do, (sha[0],)))
            sdt = np.dtype(self.fbuf.dtype).type
            levels.append(MGLevel(A, P, ChebySmoother(
                dinv, sdt(0.1 * lam), sdt(1.1 * lam), self.sm_its), R))
        ci, vi, shc, nzc, lum, pivo = self.coarse_meta
        coarse_A = AIJ(self._geti(ci), self._getf(vi), shc, nzc)
        coarse = DenseLUPC(self._getf(lum),
                           self._geti((pivo, (shc[0],))))
        return MGPC(tuple(levels), coarse, coarse_A, self.cycles,
                    self.mg_type)

    def apply(self, b):
        return self.unpack().apply(b)

    @property
    def levels(self):
        return self.unpack().levels

    @property
    def coarse(self):
        return self.unpack().coarse


def _power_lambda_max(A: sp.csr_matrix, dinv: np.ndarray,
                      iters: int = 20) -> float:
    """Host power iteration for λmax(D⁻¹A)."""
    rng = np.random.default_rng(11)
    v = rng.standard_normal(A.shape[0])
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = dinv * (A @ v)
        lam = np.linalg.norm(w)
        if lam == 0:
            return 1.0
        v = w / lam
    return float(lam)


def _arnoldi_lambda_max(matvec, n: int, iters: int = 10) -> float:
    """Host Arnoldi Ritz estimate of max Re λ(M⁻¹A) — the reference's
    Chebyshev-smoother eigenvalue estimation (10 GMRES steps,
    cheby.c:77); converges to the extreme eigenvalue far faster than
    power iteration on SSOR-preconditioned operators."""
    rng = np.random.default_rng(11)
    v = rng.standard_normal(n)
    nv = np.linalg.norm(v)
    v /= nv
    m = min(iters, n)
    V = np.zeros((m + 1, n))
    H = np.zeros((m + 1, m))
    V[0] = v
    k = m
    for j in range(m):
        w = matvec(V[j])
        h = V[:j + 1] @ w
        w = w - V[:j + 1].T @ h
        H[:j + 1, j] = h
        hj1 = np.linalg.norm(w)
        H[j + 1, j] = hj1
        if hj1 == 0:
            k = j + 1
            break
        V[j + 1] = w / hj1
    ritz = np.linalg.eigvals(H[:k, :k])
    lam = float(ritz.real.max())
    return lam if lam > 0 else 1.0


def _cheby_smoother(Ah: sp.csr_matrix, dtype, its: int,
                    pc_type: str = "jacobi") -> ChebySmoother:
    d = Ah.diagonal()
    d = np.where(d != 0, d, 1.0)
    dinv = (1.0 / d).astype(dtype)
    if pc_type == "sor":
        # the reference's MG smoother default: chebyshev + SSOR
        # (local_symmetric, its=1, ω=1 — mg.c:224 + sor defaults)
        from petsctpu.pc.sor import make_sor
        ssor = make_sor(Ah, omega=1.0, sweeps=1, symmetric=True,
                        dtype=dtype)
        # host power iteration for λmax(M⁻¹A) with M = SSOR
        import scipy.sparse.linalg as spla
        Lm = sp.tril(Ah, k=0).tocsr()
        Um = sp.triu(Ah, k=0).tocsr()

        def m_inv(r):
            y = spla.spsolve_triangular(Lm, r, lower=True)
            y = d * y
            return spla.spsolve_triangular(Um, y, lower=False)

        lam = _arnoldi_lambda_max(lambda v: m_inv(Ah @ v), Ah.shape[0])
        return ChebySmoother(jnp.asarray(dinv),
                             jnp.asarray(dtype(0.1 * lam)),
                             jnp.asarray(dtype(1.1 * lam)), its, ssor)
    lam = _power_lambda_max(Ah, dinv)
    return ChebySmoother(jnp.asarray(dinv),
                         jnp.asarray(dtype(0.1 * lam)),
                         jnp.asarray(dtype(1.1 * lam)), its)


def make_geometric_mg(A_host, da, dtype=None, options: Options = None):
    """Geometric MG on a DA grid hierarchy with Galerkin PᵀAP coarse
    operators and matrix-free Q1 transfer (PCSetUp_MG analog)."""
    from petsctpu.dm.da import q1_interp_scipy
    from petsctpu.mat.stencil import stencil_from_scipy

    opts = options or Options()
    dtype = np.dtype(dtype or A_host.dtype).type
    max_levels = opts.get_int("pc_mg_levels", 0)
    coarse_n = opts.get_int("pc_mg_coarse_size", 65)
    sm_its = opts.get_int("mg_levels_ksp_max_it", 2)
    sm_pc = opts.get_str("mg_levels_pc_type", "jacobi")
    cycles = 2 if opts.get_str("pc_mg_cycle_type", "v") == "w" else 1
    mg_type = opts.get_str("pc_mg_type", "multiplicative")

    levels = []
    Ah = sp.csr_matrix(A_host)
    cur = da
    while cur.can_coarsen() and Ah.shape[0] > coarse_n and \
            (max_levels == 0 or len(levels) < max_levels - 1):
        coarse = cur.coarsen()
        Pd = cur.interpolation(coarse)
        Ps = q1_interp_scipy(cur.grid, coarse.grid)
        Ad = stencil_from_scipy(Ah, cur.grid, dtype=dtype)
        levels.append(MGLevel(Ad, Pd,
                              _cheby_smoother(Ah, dtype, sm_its, sm_pc)))
        Ah = (Ps.T @ Ah @ Ps).tocsr()
        cur = coarse
    coarse_pc = make_lu(Ah, dtype=dtype)
    from petsctpu.mat.stencil import stencil_from_scipy as s2
    coarse_A = s2(Ah, cur.grid, dtype=dtype)
    return MGPC(tuple(levels), coarse_pc, coarse_A, cycles, mg_type)


def _lambda_max_device(A, dinv, v0, iters: int = 20):
    """Device power iteration for λmax(D⁻¹A) — same recurrence as the
    host _power_lambda_max, jit-safe (runs inside the per-level setup
    program so Galerkin coarsening + smoother calibration is ONE
    compiled computation per level)."""
    def body(_, carry):
        v, lam = carry
        w = dinv * A.mult(v)
        nrm = jnp.linalg.norm(w)
        safe = nrm > 0.0
        v = jnp.where(safe, w / jnp.where(safe, nrm, 1.0), v)
        lam = jnp.where(safe, nrm, 1.0)
        return v, lam
    _, lam = jax.lax.fori_loop(0, iters, body,
                               (v0, jnp.ones((), v0.dtype)))
    return lam


def make_geometric_mg_device(Ad, da, dtype=None, options: Options = None):
    """Geometric MG with Galerkin coarse operators built ON DEVICE.

    The host path (make_geometric_mg) mirrors the reference's
    PCSetUp_MG: scipy PtAP per level + per-level host↔device plane
    transfers. When the fine operator is already a device StencilMat,
    the device setup is one jitted program per level — comb-probe
    Galerkin coarsening (mat/stencil.galerkin_coarsen), diagonal
    extraction, and a power-iteration Chebyshev bound — so setup cost
    is a handful of device launches and the only host transfer is the
    tiny coarsest operator for its exact LU. Smoother semantics are
    identical to the host path (Chebyshev+Jacobi, bounds
    [0.1, 1.1]·λmax of D⁻¹A)."""
    from petsctpu.mat.stencil import galerkin_coarsen, stencil_to_scipy

    opts = options or Options()
    dtype = np.dtype(dtype or Ad.dtype).type
    max_levels = opts.get_int("pc_mg_levels", 0)
    coarse_n = opts.get_int("pc_mg_coarse_size", 65)
    sm_its = opts.get_int("mg_levels_ksp_max_it", 2)
    cycles = 2 if opts.get_str("pc_mg_cycle_type", "v") == "w" else 1
    mg_type = opts.get_str("pc_mg_type", "multiplicative")
    if opts.get_str("mg_levels_pc_type", "jacobi") != "jacobi":
        raise ValueError("device MG setup supports the Chebyshev+Jacobi "
                         "smoother; use the host path for SSOR smoothers")

    # static hierarchy plan (grids only — no numeric work)
    das = [da]
    while das[-1].can_coarsen() and das[-1].n > coarse_n and \
            (max_levels == 0 or len(das) < max_levels):
        das.append(das[-1].coarsen())
    Ps = [das[l].interpolation(das[l + 1]) for l in range(len(das) - 1)]
    rng = np.random.default_rng(11)
    v0s = tuple(rng.standard_normal(d.n).astype(dtype) for d in das[:-1])

    grids = tuple(d.grid for d in das)
    setup = _mg_device_setup_program(grids, np.dtype(dtype).name)
    out, Acoarse = setup(Ad, tuple(Ps), v0s)
    levels = [MGLevel(A, P, ChebySmoother(dinv, emin, emax, sm_its))
              for (A, dinv, emin, emax), P in zip(out, Ps)]
    coarse_pc = make_lu(stencil_to_scipy(Acoarse), dtype=dtype)
    return MGPC(tuple(levels), coarse_pc, Acoarse, cycles, mg_type)


import functools as _functools


@_functools.lru_cache(maxsize=None)
def _mg_device_setup_program(grids: tuple, dtype_name: str):
    """The ENTIRE hierarchy setup as ONE jitted program: per level,
    Jacobi diagonal + power-iteration Chebyshev bound + comb-probe
    Galerkin coarsening feeding the next level. One device dispatch
    per PCSetUp in place of one eager dispatch per operation (the
    reference pays one MPI MatPtAP per level here, gamg.c:156). Cached
    per hierarchy shape so operator REBUILDS with new coefficients —
    every Newton step of a SNES-MG solve, every implicit TS stage —
    reuse the compiled program: re-setup cost is one dispatch, not a
    retrace."""
    dtype = np.dtype(dtype_name).type

    @jax.jit
    def setup(Afine, Ps, v0s):
        from petsctpu.mat.stencil import galerkin_coarsen
        out, A = [], Afine
        for l, P in enumerate(Ps):
            d = A.diagonal()
            dinv = jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1.0), 1.0)
            v0 = v0s[l] / jnp.linalg.norm(v0s[l])
            lam = _lambda_max_device(A, dinv, v0)
            Ac = galerkin_coarsen(A, P, grids[l + 1])
            out.append((A, dinv, (0.1 * lam).astype(dtype),
                        (1.1 * lam).astype(dtype)))
            A = Ac
        return out, A

    return setup


def make_algebraic_mg_from_hierarchy(As, Ps, dtype=None, sm_its: int = 2,
                                     cycles: int = 1,
                                     mg_type: str = "multiplicative",
                                     sm_pc: str = "jacobi",
                                     fmt: str = "auto"):
    """Assemble an MGPC from explicit (A_l, P_l) scipy hierarchies —
    used by GAMG (pc/gamg.py) after aggregation builds the transfers,
    and directly for rediscretized (non-Galerkin) grid hierarchies
    (the KSPSetComputeOperators pattern, e.g. ksp ex29).

    fmt="band": level operators run through the dense-tiled BandMat
    path — each level is RCM-permuted internally and the transfers are
    conjugated with the per-level permutations, so the cycle is
    mathematically identical; the returned PC is PermutedPC-wrapped so
    it applies in the ORIGINAL ordering (two n-gathers per apply).

    fmt="sell": same RCM conjugation, but SELL-viable levels use
    SellMat (wide-band irregular operators where BandMat is
    infeasible, fp32); non-viable levels fall back to ELL, and the
    packed hierarchy packs its transfers as SELL too.

    fmt="auto" (default — the reference's default kernel IS its fast
    kernel, aij.c:1173): SELL-viable fp32 level operators take
    SellMat, others ELL, no reordering; an explicit fmt="ell" forces
    plain ELL everywhere."""
    from petsctpu.mat.ell import aij_from_scipy

    dtype = np.dtype(dtype or As[0].dtype).type
    if fmt in ("band", "sell"):
        from petsctpu.mat.order import get_ordering
        if fmt == "band":
            from petsctpu.mat.band import band_from_scipy
        perms = [get_ordering(sp.csr_matrix(A), "rcm") for A in As]
        As = [sp.csr_matrix(A)[p][:, p].tocsr()
              for A, p in zip(As, perms)]
        Ps = [sp.csr_matrix(P)[perms[l]][:, perms[l + 1]].tocsr()
              for l, P in enumerate(Ps)]

    def _level_op(Ah):
        if fmt == "band":
            return band_from_scipy(Ah, dtype=dtype)
        if fmt in ("sell", "auto") and np.dtype(dtype) == np.float32:
            from petsctpu.mat.sell import sell_from_scipy, sell_viable
            Ah2 = sp.csr_matrix(Ah).astype(np.float32)
            Ah2.sum_duplicates()
            if sell_viable(Ah2):
                return sell_from_scipy(Ah2)
        n_ = sp.csr_matrix(Ah).shape[0]
        if fmt == "auto" and np.dtype(dtype) == np.float32 \
                and n_ <= 4096 and n_ * n_ * 4 <= 64 * 2**20:
            # small SELL-inviable levels (coarse elasticity operators
            # densify): a dense matvec beats the ELL gather ~100x
            from petsctpu.mat.dense import Dense
            return Dense(jnp.asarray(
                sp.csr_matrix(Ah).toarray().astype(dtype)))
        return aij_from_scipy(Ah, dtype=dtype)

    if fmt in ("ell", "auto", "sell") and sm_pc == "jacobi" \
            and As[-1].shape[0] <= 192:
        # packed setup: every host array is concatenated into ONE fp32
        # + ONE int32 flat buffer (2 host-to-device transfers), and the
        # hierarchy is carved back out of the buffers AT TRACE TIME
        # inside the consuming jit (static offsets → zero extra
        # executables). Coarse solve is a dense LU.
        import scipy.linalg as sla
        from petsctpu.mat.ell import aij_pack

        fbuf, ibuf, metas = [], [], []
        fo = io = 0

        def putf(a):
            nonlocal fo
            fbuf.append(np.asarray(a, dtype).ravel())
            fo += fbuf[-1].size
            return fo - fbuf[-1].size, a.shape

        def puti(a):
            nonlocal io
            ibuf.append(np.asarray(a, np.int32).ravel())
            io += ibuf[-1].size
            return io - ibuf[-1].size, a.shape

        # SELL operators only under an explicit fmt="sell" request
        use_sell = fmt == "sell" and np.dtype(dtype) == np.float32

        DENSE_MAX_BYTES = 64 * 1024 * 1024

        def pack_dense_or_none(M):
            """Small operators run densified as one dense matvec in
            place of an ELL gather; also serves mid-size transfers
            (R1/P1). Gated by footprint."""
            m_, n_ = M.shape
            if (m_ * n_ * np.dtype(dtype).itemsize <= DENSE_MAX_BYTES
                    and min(m_, n_) <= 4096):
                D = np.asarray(sp.csr_matrix(M).toarray(), dtype)
                return ("dense", putf(D), (m_, n_),
                        int(sp.csr_matrix(M).nnz))
            return None

        def pack_op(M):
            """op meta: SELL when requested and viable, else dense or
            ELL. Applied to level operators AND transfers, so
            restriction can be packed as an explicit R = Pᵀ operator
            rather than a scatter-add."""
            if use_sell:
                from petsctpu.mat.sell import sell_pack, sell_plan_stats
                Ml = sp.csr_matrix(M).astype(np.float32)
                Ml.sum_duplicates()
                # G chosen by predicted padded-slot cost: square level
                # operators align at G=16; rectangular transfers have
                # a fine/coarse chunk-rate mismatch that breaks the
                # q = chunk(col) - g alignment, which chunk mode avoids
                bestG = None
                for G, md in ((16, "diag"), (16, "chunk"), (8, "chunk")):
                    if Ml.shape[0] < G * 128:
                        continue
                    try:
                        P_, K_, S_, _ = sell_plan_stats(Ml, G=G, mode=md)
                    except Exception:
                        continue
                    nt_ = -(-Ml.shape[0] // (G * 128))
                    cost = nt_ * P_ * G * 128
                    if S_ <= 8192 and (bestG is None or cost < bestG[1]):
                        bestG = ((G, md), cost)
                avg = Ml.nnz / max(Ml.shape[0], 1)
                if bestG is not None \
                        and bestG[1] <= 8 * max(avg, 1e-9) * Ml.shape[0]:
                    try:
                        arrs, st = sell_pack(Ml, G=bestG[0][0],
                                             mode=bestG[0][1])
                        # int8 idx rides the int32 buffer (bitcast)
                        return ("sell",
                                putf(arrs["vals"]),
                                puti(arrs["idx"].ravel()
                                     .view(np.int32).reshape(-1)),
                                puti(arrs["qs"]),
                                puti(arrs["winstart"]),
                                putf(arrs["diag"]),
                                st["shape"], st["nnz"], st["G"],
                                st["S"], st["Lp"],
                                tuple(arrs["vals"].shape), st["mode"])
                    except ValueError:
                        pass
            dref = pack_dense_or_none(M)
            if dref is not None:
                return dref
            ca, va, sha, nza = aij_pack(M, dtype=dtype)
            return ("ell", puti(ca), putf(va), sha, nza)

        def pack_restrict(RT, pref):
            """R = Pᵀ: slant-band when the aggregate numbering keeps
            columns advancing at ~constant rate (mat/rectband.py — no
            gathers at all); when neither dense nor slant-band apply
            and P itself packed as chunk-SELL, return None so the
            cycle restricts through P.multT (a scatter-add over P's
            own layout); else the generic packer."""
            from petsctpu.mat.rectband import rectband_from_scipy, \
                rectband_plan
            dref = pack_dense_or_none(RT)
            if dref is not None:
                return dref
            pl_ = rectband_plan(RT)
            if pl_ is not None:
                s_, off_, W_ = pl_
                if RT.shape[0] * W_ <= 8.0 * max(RT.nnz, 1):
                    B = np.zeros((RT.shape[0], W_), dtype)
                    coo = RT.tocoo()
                    d_ = (coo.col.astype(np.int64)
                          - s_ * coo.row.astype(np.int64) - off_)
                    B[coo.row, d_] = coo.data.astype(dtype)
                    return ("rectband", putf(B), s_, off_,
                            RT.shape, int(RT.nnz), B.shape)
            if pref[0] == "sell" and pref[-1] == "chunk":
                return None
            return pack_op(RT)

        for l in range(len(Ps)):
            amref = pack_op(As[l])
            Pl = sp.csr_matrix(Ps[l])
            Pl.sum_duplicates()
            Pl.sort_indices()
            pref = pack_op(Pl)
            rref = pack_restrict(Pl.T.tocsr(), pref)
            d = As[l].diagonal()
            d = np.where(d != 0, d, 1.0)
            dinv = (1.0 / d).astype(dtype)
            lam = _power_lambda_max(As[l], dinv)
            metas.append((amref, pref, rref,
                          putf(dinv)[0], float(lam)))
        ca, va, shc, nzc = aij_pack(As[-1], dtype=dtype)
        lu, piv = sla.lu_factor(As[-1].toarray().astype(dtype))
        coarse_meta = (puti(ca), putf(va), shc, nzc,
                       putf(lu), puti(piv)[0])
        pmg = PackedMGPC(jnp.asarray(np.concatenate(fbuf)),
                         jnp.asarray(np.concatenate(ibuf)),
                         tuple(metas), coarse_meta, sm_its, cycles,
                         mg_type)
        if fmt == "sell":
            # the hierarchy was RCM-conjugated above — apply in the
            # caller's original ordering
            from petsctpu.pc.factor import PermutedPC
            return PermutedPC(pmg, jnp.asarray(perms[0], jnp.int32))
        return pmg

    def _transfer_ops(Pl):
        """(P_op, R_op|None) for the non-packed cycle: dense for small
        transfers, else ELL with restriction by P.multT scatter-add."""
        Pl = sp.csr_matrix(Pl)
        Pl.sum_duplicates()
        Pl.sort_indices()
        m_, n_ = Pl.shape
        if np.dtype(dtype) == np.float32 \
                and m_ * n_ * 4 <= 64 * 1024 * 1024 \
                and min(m_, n_) <= 4096:
            from petsctpu.mat.dense import Dense
            D = np.asarray(Pl.toarray(), dtype)
            return (Dense(jnp.asarray(D)),
                    Dense(jnp.asarray(np.ascontiguousarray(D.T))))
        return aij_from_scipy(Pl, dtype=dtype), None

    levels = []
    for l in range(len(Ps)):
        Ad = _level_op(As[l])
        Pd, Rd = _transfer_ops(Ps[l])
        levels.append(MGLevel(Ad, Pd,
                              _cheby_smoother(As[l], dtype, sm_its,
                                              sm_pc), Rd))
    coarse_pc = make_lu(As[-1], dtype=dtype)
    coarse_A = aij_from_scipy(As[-1], dtype=dtype)
    mg = MGPC(tuple(levels), coarse_pc, coarse_A, cycles, mg_type)
    if fmt in ("band", "sell"):
        from petsctpu.pc.factor import PermutedPC
        return PermutedPC(mg, jnp.asarray(perms[0], jnp.int32))
    return mg


# ---------------------------------------------------------------------------
# Reference-exact Chebyshev smoother + estimated-on-first-application MG
# ---------------------------------------------------------------------------
@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class RefChebySmoother:
    """KSPSolve_Chebyshev's omega/c recurrence verbatim (cheby.c:
    scale = 2/(emax+emin), pre-loop p₁ = p₀ + scale·B⁻¹r, then maxit
    steps of p⁺ = ω(p + scale·B⁻¹r) + (1−ω)p⁻). `denull` removes the
    constant null space after every preconditioner application — the
    KSP_PCApply → MatNullSpaceRemove path a singular (Neumann) level
    operator triggers (kspimpl.h:185)."""

    pc: Any                     # SSOR/Jacobi plan (apply())
    emin: jax.Array
    emax: jax.Array
    its: int = field(metadata=dict(static=True), default=2)
    denull: bool = field(metadata=dict(static=True), default=False)

    def _prec(self, r):
        z = self.pc.apply(r)
        if self.denull:
            z = z - jnp.mean(z)
        return z

    def smooth(self, A, b, x):
        scale = 2.0 / (self.emax + self.emin)
        alpha = 1.0 - scale * self.emin
        mu = 1.0 / alpha
        omegaprod = 2.0 / alpha
        ckm1, ck = jnp.ones_like(mu), mu
        pkm1 = x
        r = b - A.mult(pkm1)
        pk = pkm1 + scale * self._prec(r)
        for _ in range(self.its):
            ckp1 = 2.0 * mu * ck - ckm1
            omega = omegaprod * ck / ckp1
            r = b - A.mult(pk)
            z = self._prec(r)
            pkp1 = omega * (pk + scale * z) + (1.0 - omega) * pkm1
            ckm1, ck = ck, ckp1
            pkm1, pk = pk, pkp1
        return pk


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PinvCoarsePC:
    """Dense pseudo-inverse coarse solve with constant-null-space
    removal — numerically equivalent to the reference's shifted-LU +
    MatNullSpaceRemove coarse stack on singular Neumann coarse grids
    (the solution component in range(A) is identical; the null
    component is projected out either way)."""

    Ainv: jax.Array
    denull: bool = field(metadata=dict(static=True), default=True)

    def apply(self, r):
        if self.denull:
            r = r - jnp.mean(r)
        y = self.Ainv @ r
        if self.denull:
            y = y - jnp.mean(y)
        return y


def _ssor_minv_host(Ah: sp.csr_matrix):
    """Host SSOR(ω=1) preconditioner apply: (D+U)⁻¹ D (D+L)⁻¹ —
    MatSOR SOR_LOCAL_SYMMETRIC_SWEEP, the mg.c default smoother PC."""
    import scipy.sparse.linalg as spla

    L = sp.tril(Ah, 0).tocsr()
    U = sp.triu(Ah, 0).tocsr()
    d = Ah.diagonal()

    def m_inv(r):
        y = spla.spsolve_triangular(L, r, lower=True)
        return spla.spsolve_triangular(U, d * y, lower=False)

    return m_inv


def _est_hessenberg_host(Ah: sp.csr_matrix, m_inv, b: np.ndarray,
                         iters: int = 10) -> np.ndarray:
    """The Chebyshev smoother's est-GMRES Krylov process replayed on
    host (cheby.c est-on-first-application): `iters` classical-Gram-
    Schmidt Arnoldi steps of the left-SSOR-preconditioned operator
    starting from M⁻¹b, WITHOUT null-space removal (the est KSP shares
    the PC object but not the operators — cheby.c:68 KSPSetPC — so
    KSP_RemoveNullSpace never fires inside the estimation). Returns
    the (k+1)×k Hessenberg."""
    v = m_inv(np.asarray(b, np.float64))
    beta = np.linalg.norm(v)
    n = v.shape[0]
    m = min(iters, n)
    H = np.zeros((m + 1, m))
    if beta == 0.0:
        return H[:1, :0]
    V = np.zeros((m + 1, n))
    V[0] = v / beta
    for j in range(m):
        w = m_inv(Ah @ V[j])
        h = V[:j + 1] @ w
        w = w - V[:j + 1].T @ h
        H[:j + 1, j] = h
        H[j + 1, j] = np.linalg.norm(w)
        if H[j + 1, j] == 0.0:
            return H[:j + 2, :j + 1]
        V[j + 1] = w / H[j + 1, j]
    return H


def _est_sigma_max_host(Ah: sp.csr_matrix, m_inv, b: np.ndarray,
                        iters: int = 10,
                        convention: str = "svd") -> float:
    """Extreme estimate from the replayed est-GMRES Hessenberg. TWO
    conventions exist in the reference's history, and both are needed:

    * "svd": σmax of H̄ (KSPComputeExtremeSingularValues_GMRES, gesvd
      of the triangularized R, gmreig.c; σ(R) = σ(H̄)). This is the
      convention the CHECKED-IN GOLDEN OUTPUTS were generated with —
      ksp ex34_1's per-level view bounds (1.10187/1.10662) and monitor
      stream reproduce digit-exact only with it (same finding as the
      ex2_chebyest goldens).
    * "eigen": max Re of the Ritz values of the square H
      (KSPComputeEigenvalues geev path) — what the TREE's cheby.c:329
      KSPChebyshevComputeExtremeEigenvalues_Private actually calls; a
      hand-built oracle of the reference source confirms its runtime
      bounds match this (e.g. ksp ex29 -da_refine 8 level bounds
      1.09883/1.09843/... reproduced to all printed digits)."""
    H = _est_hessenberg_host(Ah, m_inv, b, iters)
    k = H.shape[1]
    if k == 0:
        return 1.0
    if convention == "eigen":
        return float(np.linalg.eigvals(H[:k, :k]).real.max())
    return float(np.linalg.svd(H, compute_uv=False).max())


def make_full_mg_ref(As, Ps, b, dtype=None, sm_its: int = 2,
                     mg_type: str = "full", cycles: int = 1,
                     nullspace: bool = False, est_its: int = 10,
                     est_convention: str = "svd"):
    """MG stack with the reference's DEFAULT smoother configuration
    reproduced exactly: per-level Chebyshev(+SSOR) whose eigenvalue
    bounds are estimated at setup by replaying cheby.c's
    est-on-first-application — the est input on level l is the outer
    rhs restricted down the F-cycle's b-chain (PCMGFCycle_Private
    fmg.c restricts b through all levels BEFORE any smoothing, so the
    first smoother call on level l sees exactly that vector) — with
    bounds transform [0, 0.1; 0, 1.1] (cheby.c defaults).

    nullspace=True: singular Neumann levels — the smoothers remove the
    constant component after each SSOR application and the coarse
    solve is a null-space-projected pseudo-inverse (ksp ex34's
    configuration; its golden output is digit-exact through this
    path)."""
    from petsctpu.mat.ell import aij_from_scipy
    from petsctpu.pc.sor import make_sor

    dtype = np.dtype(dtype or As[0].dtype).type
    # restrict the outer rhs down the chain (est inputs per level)
    bs = [np.asarray(b, np.float64)]
    for P in Ps:
        bs.append(P.T @ bs[-1])

    levels = []
    for l in range(len(Ps)):
        Ah = sp.csr_matrix(As[l])
        smax = _est_sigma_max_host(Ah, _ssor_minv_host(Ah), bs[l],
                                   est_its, est_convention)
        ssor = make_sor(Ah, omega=1.0, sweeps=1, symmetric=True,
                        dtype=dtype)
        sm = RefChebySmoother(ssor, jnp.asarray(dtype(0.1 * smax)),
                              jnp.asarray(dtype(1.1 * smax)), sm_its,
                              nullspace)
        levels.append(MGLevel(aij_from_scipy(As[l], dtype=dtype),
                              aij_from_scipy(Ps[l], dtype=dtype), sm))
    Ac = sp.csr_matrix(As[-1])
    if nullspace:
        coarse_pc = PinvCoarsePC(jnp.asarray(
            np.linalg.pinv(Ac.toarray()).astype(dtype)))
    else:
        coarse_pc = make_lu(Ac, dtype=dtype)
    return MGPC(tuple(levels), coarse_pc, aij_from_scipy(Ac, dtype=dtype),
                cycles, mg_type)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class GmresSmoother:
    """KSPGMRES as an MG level smoother — `its` Arnoldi steps of
    LEFT-preconditioned GMRES with classical Gram-Schmidt and Givens
    least-squares (KSPSolve_GMRES/KSPGMRESCycle gmres.c:118,213 with
    max_it=its and nonzero initial guess, the
    `-mg_levels_ksp_type gmres -mg_levels_ksp_max_it 1` smoother
    configuration of ksp ex28). The smoother's rtol test can't fire
    before max_it at these iteration counts, so the fixed-step loop is
    iteration-exact with the reference."""

    pc: Any
    its: int = field(metadata=dict(static=True), default=1)

    def smooth(self, A, b, x):
        z = self.pc.apply(b - A.mult(x))
        beta = jnp.linalg.norm(z)
        safe = beta > 0.0
        V = [z * jnp.where(safe, 1.0 / jnp.where(safe, beta, 1.0), 0.0)]
        g = [beta] + [jnp.zeros_like(beta)] * self.its
        cs, sn = [], []
        Hcols = []
        for j in range(self.its):
            w = self.pc.apply(A.mult(V[j]))
            col = [jnp.vdot(V[i], w) for i in range(j + 1)]
            for i in range(j + 1):
                w = w - col[i] * V[i]
            hj1 = jnp.linalg.norm(w)
            V.append(w * jnp.where(hj1 > 0.0,
                                   1.0 / jnp.where(hj1 > 0.0, hj1, 1.0),
                                   0.0))
            col = col + [hj1]
            for i in range(j):
                t = cs[i] * col[i] + sn[i] * col[i + 1]
                col[i + 1] = -sn[i] * col[i] + cs[i] * col[i + 1]
                col[i] = t
            rho = jnp.hypot(col[j], col[j + 1])
            ok = rho > 0.0
            c = jnp.where(ok, col[j] / jnp.where(ok, rho, 1.0), 1.0)
            s = jnp.where(ok, col[j + 1] / jnp.where(ok, rho, 1.0), 0.0)
            cs.append(c)
            sn.append(s)
            col[j] = rho
            g[j + 1] = -s * g[j]
            g[j] = c * g[j]
            Hcols.append(col[:j + 1])
        # back substitution on the triangularized Hessenberg
        y = [None] * self.its
        for i in reversed(range(self.its)):
            t = g[i]
            for k in range(i + 1, self.its):
                t = t - Hcols[k][i] * y[k]
            di = Hcols[i][i]
            ok = di != 0.0
            y[i] = jnp.where(ok, t / jnp.where(ok, di, 1.0), 0.0)
        dx = x
        for j in range(self.its):
            dx = dx + y[j] * V[j]
        return jnp.where(safe, dx, x)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SelfScaleRichardsonSmoother:
    """KSPRichardson with -ksp_richardson_self_scale as an MG level
    smoother (rich.c:59-92 selfscale branch with pc none: per-step
    optimal damping ss = zᵀ(Az)/(Az)ᵀ(Az), z updated in place — the
    `-mg_levels_ksp_type richardson -mg_levels_pc_type none
    -mg_levels_ksp_richardson_self_scale` configuration of snes
    ex35_7). pc=None means B = identity; plug any pc pytree for the
    preconditioned variant (then y = B·A·z)."""

    pc: Any = None
    its: int = field(metadata=dict(static=True), default=2)

    def _prec(self, r):
        return self.pc.apply(r) if self.pc is not None else r

    def smooth(self, A, b, x):
        r = b - A.mult(x)
        z = self._prec(r)
        for _ in range(self.its):
            w = A.mult(z)
            y = self._prec(w)
            ss = jnp.vdot(z, y) / jnp.vdot(y, y)
            x = x + ss * z
            r = r - ss * w
            z = z - ss * y
        return x


def make_mg_selfscale_richardson(As, Ps, dtype=None, sm_its: int = 2,
                                 mg_type: str = "multiplicative",
                                 cycles: int = 1):
    """MG with self-scaled Richardson (pc none) level smoothers and an
    exact-LU coarse solve — snes ex35_7's preconditioner."""
    from petsctpu.mat.ell import aij_from_scipy

    dtype = np.dtype(dtype or As[0].dtype).type
    levels = []
    for l in range(len(Ps)):
        sm = SelfScaleRichardsonSmoother(None, sm_its)
        levels.append(MGLevel(aij_from_scipy(As[l], dtype=dtype),
                              aij_from_scipy(Ps[l], dtype=dtype), sm))
    coarse_pc = make_lu(sp.csr_matrix(As[-1]), dtype=dtype)
    return MGPC(tuple(levels), coarse_pc,
                aij_from_scipy(sp.csr_matrix(As[-1]), dtype=dtype),
                cycles, mg_type)


def make_full_mg_gmres_ilu(As, Ps, dtype=None, sm_its: int = 1,
                           mg_type: str = "full", cycles: int = 1):
    """MG with GMRES(its)+ILU(0) level smoothers and an exact-LU
    coarse solve — the ksp ex28 configuration (-pc_type mg
    -pc_mg_type full -mg_levels_ksp_type gmres -mg_levels_ksp_max_it 1
    -mg_levels_pc_type ilu); rediscretized (non-Galerkin) hierarchies
    pass their own As."""
    from petsctpu.mat.ell import aij_from_scipy
    from petsctpu.pc.factor import make_ilu

    dtype = np.dtype(dtype or As[0].dtype).type
    levels = []
    for l in range(len(Ps)):
        Ah = sp.csr_matrix(As[l])
        sm = GmresSmoother(make_ilu(Ah, dtype=dtype), sm_its)
        levels.append(MGLevel(aij_from_scipy(As[l], dtype=dtype),
                              aij_from_scipy(Ps[l], dtype=dtype), sm))
    coarse_pc = make_lu(sp.csr_matrix(As[-1]), dtype=dtype)
    return MGPC(tuple(levels), coarse_pc,
                aij_from_scipy(sp.csr_matrix(As[-1]), dtype=dtype),
                cycles, mg_type)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class RichardsonSmoother:
    """KSPRichardson as an MG smoother (KSPSolve_Richardson with
    KSPSkipConverged/norm NONE: exactly `its` applications of
    x += scale·B⁻¹(b − A x), rich.c)."""

    pc: Any
    scale: float = field(metadata=dict(static=True), default=1.0)
    its: int = field(metadata=dict(static=True), default=1)

    def smooth(self, A, b, x):
        for _ in range(self.its):
            x = x + self.scale * self.pc.apply(b - A.mult(x))
        return x


def make_mg_richardson_ilu(As, Ps, dtype=None, sm_its: int = 1,
                           mg_type: str = "multiplicative",
                           cycles: int = 1):
    """MG with Richardson+ILU(0) level smoothers — the
    `-mg_levels_ksp_type richardson -mg_levels_ksp_max_it 1
    -mg_levels_pc_type bjacobi` configuration of ksp ex45 run
    serially (block Jacobi with one block = ILU(0) on the level
    operator); coarse = exact LU."""
    from petsctpu.mat.ell import aij_from_scipy
    from petsctpu.pc.factor import make_ilu

    dtype = np.dtype(dtype or As[0].dtype).type
    levels = []
    for l in range(len(Ps)):
        Ah = sp.csr_matrix(As[l])
        sm = RichardsonSmoother(make_ilu(Ah, dtype=dtype), 1.0, sm_its)
        levels.append(MGLevel(aij_from_scipy(As[l], dtype=dtype),
                              aij_from_scipy(Ps[l], dtype=dtype), sm))
    coarse_pc = make_lu(sp.csr_matrix(As[-1]), dtype=dtype)
    return MGPC(tuple(levels), coarse_pc,
                aij_from_scipy(sp.csr_matrix(As[-1]), dtype=dtype),
                cycles, mg_type)
