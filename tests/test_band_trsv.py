"""Banded (dense-tile) triangular solves — the fast MatSolve path."""

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from petsctpu.core.options import Options
from petsctpu.ksp import ksp_solve
from petsctpu.mat import aij_from_scipy
from petsctpu.mat.factor import ilu0, make_band_trsv_plan
from petsctpu.models import ex2_system
from petsctpu.pc import make_pc
from petsctpu.pc.factor import make_ilu


class TestBandTRSV:
    def test_matches_dense_solve(self):
        A, b, u = ex2_system(14, 14)
        L, U = ilu0(A)
        x = np.random.default_rng(0).standard_normal(196)
        for Tm, lower, unit in ((L, True, True), (U, False, False)):
            plan = make_band_trsv_plan(Tm, lower=lower, unit_diag=unit)
            y = np.asarray(jax.jit(lambda p, v: p.solve(v))(
                plan, jnp.asarray(x)))
            Td = Tm.toarray()
            if unit:
                np.fill_diagonal(Td, 1.0)
            np.testing.assert_allclose(y, np.linalg.solve(Td, x), atol=1e-12)

    def test_ilu_band_equals_level(self):
        A, b, u = ex2_system(12, 12)
        p_level = make_ilu(A)
        p_band = make_ilu(A, tri="band")
        y1 = np.asarray(p_level.apply(jnp.asarray(b)))
        y2 = np.asarray(p_band.apply(jnp.asarray(b)))
        np.testing.assert_allclose(y1, y2, atol=1e-12)

    def test_solve_same_iterations(self):
        """GMRES+ILU(band) reproduces GMRES+ILU(level) exactly."""
        A, b, u = ex2_system(10, 10)
        Ad = aij_from_scipy(A)
        r1 = ksp_solve(Ad, jnp.asarray(b), pc=make_pc("ilu", A=Ad, A_host=A),
                       ksp_type="gmres", rtol=1e-10)
        r2 = ksp_solve(Ad, jnp.asarray(b),
                       pc=make_pc("ilu", A=Ad, A_host=A, options=Options(
                           {"pc_factor_tri_solve": "band"})),
                       ksp_type="gmres", rtol=1e-10)
        assert int(r1.its) == int(r2.its)
        np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r2.x),
                                   atol=1e-10)

    def test_odd_size_uneven_tiles(self):
        A, b, u = ex2_system(13, 11)          # n = 143, not tile-aligned
        p_band = make_ilu(A, tri="band")
        p_level = make_ilu(A)
        y1 = np.asarray(p_level.apply(jnp.asarray(b)))
        y2 = np.asarray(p_band.apply(jnp.asarray(b)))
        np.testing.assert_allclose(y1, y2, atol=1e-12)


class TestHierBandTRSV:
    """Two-phase blocked band solve (BandTRSVHierPlan): exact vs scipy
    for lower/upper, non-divisible tile counts, both dtypes."""

    def _mk(self, n, bw, seed=0):
        rng = np.random.default_rng(seed)
        L = sp.diags([rng.standard_normal(n - k) * 0.3 for k in range(bw)],
                     [-k for k in range(bw)]).tolil()
        L.setdiag(np.abs(L.diagonal()) + 2.0)
        return sp.csr_matrix(L)

    def test_lower_upper_exact(self):
        from petsctpu.mat.factor import make_band_trsv_hier_plan
        for n, bw, tile in [(50, 7, 16), (300, 25, 64), (777, 40, 128)]:
            Lm = self._mk(n, bw)
            b = np.random.default_rng(1).standard_normal(n)
            pl = make_band_trsv_hier_plan(Lm, lower=True, unit_diag=False,
                                          tile=tile)
            np.testing.assert_allclose(
                np.asarray(pl.solve(jnp.asarray(b))),
                spla.spsolve_triangular(Lm, b, lower=True), atol=1e-10)
            U = Lm.T.tocsr()
            pu = make_band_trsv_hier_plan(U, lower=False, unit_diag=False,
                                          tile=tile)
            np.testing.assert_allclose(
                np.asarray(pu.solve(jnp.asarray(b))),
                spla.spsolve_triangular(U, b, lower=False), atol=1e-10)

    def test_matches_flat_band_plan(self):
        from petsctpu.mat.factor import (make_band_trsv_hier_plan,
                                         make_band_trsv_plan)
        from petsctpu.models import laplacian_2d
        from petsctpu.mat.factor import ilu0
        A = laplacian_2d(20, 20)
        L, U = ilu0(A)
        b = np.random.default_rng(2).standard_normal(400)
        flat = make_band_trsv_plan(L, lower=True, unit_diag=True, tile=64)
        hier = make_band_trsv_hier_plan(L, lower=True, unit_diag=True,
                                        tile=64)
        np.testing.assert_allclose(np.asarray(hier.solve(jnp.asarray(b))),
                                   np.asarray(flat.solve(jnp.asarray(b))),
                                   atol=1e-12)

    def test_ilu_band2_pc(self):
        from petsctpu.core.options import Options
        from petsctpu.ksp import ksp_solve
        from petsctpu.mat import aij_from_scipy
        from petsctpu.models import laplacian_2d
        from petsctpu.pc import make_pc
        A = laplacian_2d(16, 16)
        Ad = aij_from_scipy(A)
        pc = make_pc("ilu", A=Ad, A_host=A,
                     options=Options({"pc_factor_tri_solve": "band2"}))
        b = jnp.asarray(np.ones(256))
        r = ksp_solve(Ad, b, pc=pc, ksp_type="gmres", rtol=1e-8, maxits=60)
        assert r.converged
        np.testing.assert_allclose(A @ np.asarray(r.x), 1.0, atol=1e-6)


class TestHierWideWindow:
    """Regression: the hier plan's baked-reversal upper chain must flip
    the T-blocks of the off-column window when W > T (the window holds
    produced tiles in reversed tile order). W == T hid this."""

    def test_upper_multi_block_window(self):
        from petsctpu.mat.factor import make_band_trsv_hier_plan
        rng = np.random.default_rng(7)
        n, tile = 700, 64
        # band reaching ~2.5 tiles beyond the diagonal tile -> W = 3T
        diags = [rng.standard_normal(n - k) * 0.2 for k in range(0, 160, 13)]
        U = sp.diags(diags, [k for k in range(0, 160, 13)]).tolil()
        U.setdiag(np.abs(U.diagonal()) + 3.0)
        U = sp.csr_matrix(U)
        b = rng.standard_normal(n)
        pu = make_band_trsv_hier_plan(U, lower=False, unit_diag=False,
                                      tile=tile)
        assert pu.off_tiles.shape[-1] > tile      # exercises W > T
        np.testing.assert_allclose(
            np.asarray(pu.solve(jnp.asarray(b))),
            spla.spsolve_triangular(U, b, lower=False), atol=1e-8)

    def test_ilu_band2_equals_level_wide(self):
        """3-D ILU(0) factors (RCM) — the W>T case band2 now serves."""
        from petsctpu.mat.factor import (make_band_trsv_hier_plan,
                                         make_sptrsv_plan)
        from petsctpu.mat.order import get_ordering
        mi = 12
        e = np.ones(mi)
        T1 = sp.diags([-e[:-1], 2 * e, -e[:-1]], [-1, 0, 1])
        I1 = sp.eye(mi)
        A = (sp.kron(sp.kron(T1, I1), I1) + sp.kron(sp.kron(I1, T1), I1)
             + sp.kron(sp.kron(I1, I1), T1)).tocsr()
        perm = get_ordering(A, "rcm")
        Ap = A[perm][:, perm].tocsr()
        L, U = ilu0(Ap)
        b = np.random.default_rng(3).standard_normal(mi ** 3)
        lev = make_sptrsv_plan(U, lower=False, unit_diag=False)
        hier = make_band_trsv_hier_plan(U, lower=False, unit_diag=False,
                                        tile=64)
        np.testing.assert_allclose(np.asarray(hier.solve(jnp.asarray(b))),
                                   np.asarray(lev.solve(jnp.asarray(b))),
                                   rtol=2e-6, atol=1e-8)


class TestAutoTriASM:
    """bjacobi/ASM auto triangular-solve strategy + stacked band plans."""

    def test_bjacobi_band_equals_level(self):
        """fp32 + rcm sub-ordering selects band2; solutions match the
        forced-level route and iteration counts are identical."""
        from petsctpu.core.options import Options
        from petsctpu.ksp import ksp_solve
        from petsctpu.mat import aij_from_scipy
        from petsctpu.mat.factor import BandTRSVHierPlan
        from petsctpu.pc import make_pc
        mi = 12
        e = np.ones(mi)
        T1 = sp.diags([-e[:-1], 2 * e, -e[:-1]], [-1, 0, 1])
        I1 = sp.eye(mi)
        A = (sp.kron(sp.kron(T1, I1), I1) + sp.kron(sp.kron(I1, T1), I1)
             + sp.kron(sp.kron(I1, I1), T1)).tocsr().astype(np.float32)
        Ad = aij_from_scipy(A, dtype=np.float32)
        b = jnp.asarray(np.random.default_rng(5)
                        .standard_normal(mi ** 3).astype(np.float32))
        opts = {"pc_bjacobi_blocks": 4, "sub_pc_type": "ilu",
                "sub_pc_factor_mat_ordering_type": "rcm"}
        pc_auto = make_pc("bjacobi", A=Ad, A_host=A, options=Options(opts))
        assert isinstance(pc_auto.Lplans, BandTRSVHierPlan)
        assert pc_auto.contiguous
        pc_level = make_pc("bjacobi", A=Ad, A_host=A, options=Options(
            {**opts, "sub_pc_factor_tri_solve": "level"}))
        y1 = np.asarray(pc_auto.apply(b))
        y2 = np.asarray(pc_level.apply(b))
        np.testing.assert_allclose(y1, y2, rtol=2e-4, atol=1e-5)
        r1 = ksp_solve(Ad, b, pc=pc_auto, ksp_type="cg", rtol=1e-6,
                       maxits=80)
        r2 = ksp_solve(Ad, b, pc=pc_level, ksp_type="cg", rtol=1e-6,
                       maxits=80)
        assert int(r1.its) == int(r2.its)

    def test_fp64_auto_stays_level(self):
        from petsctpu.core.options import Options
        from petsctpu.mat import aij_from_scipy
        from petsctpu.mat.factor import SpTRSVPlan
        from petsctpu.models import laplacian_2d
        from petsctpu.pc import make_pc
        A = laplacian_2d(16, 16)
        Ad = aij_from_scipy(A)               # float64
        pc = make_pc("bjacobi", A=Ad, A_host=A, options=Options(
            {"pc_bjacobi_blocks": 2, "sub_pc_type": "ilu",
             "sub_pc_factor_mat_ordering_type": "rcm"}))
        assert isinstance(pc.Lplans, SpTRSVPlan)

    def test_asm_overlap_band(self):
        """Overlapping (non-contiguous) ASM through the band route."""
        from petsctpu.core.options import Options
        from petsctpu.mat import aij_from_scipy
        from petsctpu.models import laplacian_2d
        from petsctpu.pc import make_pc
        A = laplacian_2d(20, 20).astype(np.float32)
        Ad = aij_from_scipy(A, dtype=np.float32)
        b = jnp.asarray(np.random.default_rng(6)
                        .standard_normal(400).astype(np.float32))
        mk = lambda tri: make_pc("asm", A=Ad, A_host=A, options=Options(
            {"pc_asm_blocks": 4, "pc_asm_overlap": 1,
             "sub_pc_factor_mat_ordering_type": "rcm",
             "sub_pc_factor_tri_solve": tri}))
        y1 = np.asarray(mk("band2").apply(b))
        y2 = np.asarray(mk("level").apply(b))
        np.testing.assert_allclose(y1, y2, rtol=2e-4, atol=1e-5)
