import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from petsctpu.mat import aij_from_scipy, baij_from_scipy_bsr
from petsctpu.mat.factor import ilu0, make_sptrsv_plan
from petsctpu.models import laplacian_2d
from petsctpu.pc import make_pc


class TestSpTRSV:
    def test_lower_and_upper(self):
        rng = np.random.default_rng(0)
        n = 40
        L = sp.tril(sp.random(n, n, density=0.15, random_state=rng),
                    k=-1).tocsr() + sp.eye(n) * 2.0
        b = rng.standard_normal(n)
        plan = make_sptrsv_plan(L.tocsr(), lower=True, unit_diag=False)
        x = np.asarray(plan.solve(jnp.asarray(b)))
        np.testing.assert_allclose(x, spla.spsolve_triangular(L.tocsr(), b,
                                                              lower=True),
                                   rtol=1e-10)
        U = L.T.tocsr()
        planU = make_sptrsv_plan(U, lower=False, unit_diag=False)
        xU = np.asarray(planU.solve(jnp.asarray(b)))
        np.testing.assert_allclose(xU, spla.spsolve_triangular(U, b,
                                                               lower=False),
                                   rtol=1e-10)

    def test_unit_diag(self):
        n = 20
        L = sp.tril(laplacian_2d(4, 5), k=-1).tocsr()
        b = np.arange(1.0, n + 1)
        plan = make_sptrsv_plan(L, lower=True, unit_diag=True)
        ref = spla.spsolve_triangular((L + sp.eye(n)).tocsr(), b, lower=True)
        np.testing.assert_allclose(np.asarray(plan.solve(jnp.asarray(b))),
                                   ref, rtol=1e-12)


class TestILU0:
    def test_factor_matches_naive_dense(self):
        A = laplacian_2d(6, 6)
        L, U = ilu0(A)
        n = A.shape[0]
        M = A.toarray().copy()
        patt = A.toarray() != 0
        for i in range(1, n):
            for k in range(i):
                if patt[i, k]:
                    M[i, k] /= M[k, k]
                    for j in range(k + 1, n):
                        if patt[i, j]:
                            M[i, j] -= M[i, k] * M[k, j]
        np.testing.assert_allclose(L.toarray(), np.tril(M, -1), atol=1e-12)
        np.testing.assert_allclose(U.toarray(), np.triu(M), atol=1e-12)

    def test_ilu_pc_apply(self):
        A = laplacian_2d(6, 6)
        Ad = aij_from_scipy(A)
        pc = make_pc("ilu", A=Ad, A_host=A)
        b = np.random.default_rng(1).standard_normal(36)
        L, U = ilu0(A)
        ref = spla.spsolve_triangular(
            sp.csr_matrix(U), spla.spsolve_triangular(
                (L + sp.eye(36)).tocsr(), b, lower=True), lower=False)
        np.testing.assert_allclose(np.asarray(pc.apply(jnp.asarray(b))), ref,
                                   rtol=1e-10)


class TestLU:
    def test_exact_solve(self):
        rng = np.random.default_rng(2)
        A = laplacian_2d(5, 7) + sp.random(35, 35, density=0.05,
                                           random_state=rng)
        A = A.tocsr()
        Ad = aij_from_scipy(A)
        pc = make_pc("lu", A=Ad, A_host=A)
        b = rng.standard_normal(35)
        np.testing.assert_allclose(np.asarray(pc.apply(jnp.asarray(b))),
                                   spla.spsolve(A, b), atol=1e-9)


class TestJacobi:
    def test_variants(self):
        A = laplacian_2d(4, 4)
        Ad = aij_from_scipy(A)
        x = jnp.asarray(np.arange(16.0) + 1)
        pc = make_pc("jacobi", A=Ad)
        np.testing.assert_allclose(np.asarray(pc.apply(x)),
                                   np.asarray(x) / 4.0)
        from petsctpu.core.options import Options
        A2 = (laplacian_2d(4, 4) + sp.eye(16)).tocsr()   # nonzero row sums
        Ad2 = aij_from_scipy(A2)
        pc2 = make_pc("jacobi", A=Ad2,
                      options=Options({"pc_jacobi_type": "rowsum"}))
        rs = np.asarray(A2.sum(axis=1)).ravel()
        np.testing.assert_allclose(np.asarray(pc2.apply(x)),
                                   np.asarray(x) / rs)
        pc3 = make_pc("jacobi", A=Ad2,
                      options=Options({"pc_jacobi_type": "rowmax"}))
        np.testing.assert_allclose(np.asarray(pc3.apply(x)),
                                   np.asarray(x) / 5.0)

    def test_pbjacobi(self):
        bs = 2
        rng = np.random.default_rng(3)
        blocks = rng.standard_normal((5, bs, bs)) + 3 * np.eye(bs)
        A = sp.block_diag([b for b in blocks]).tocsr() + \
            sp.diags(np.ones(8), offsets=2, shape=(10, 10)) * 0.1
        A = A.tocsr()
        Ab = baij_from_scipy_bsr(A, bs=bs)
        pc = make_pc("pbjacobi", A=Ab)
        x = rng.standard_normal(10)
        Dblk = sp.block_diag(
            [A[i * bs:(i + 1) * bs, i * bs:(i + 1) * bs].toarray()
             for i in range(5)])
        ref = spla.spsolve(Dblk.tocsc(), x)
        np.testing.assert_allclose(np.asarray(pc.apply(jnp.asarray(x))), ref,
                                   rtol=1e-10)


class TestSOR:
    def test_one_symmetric_sweep(self):
        A = laplacian_2d(5, 5)
        b = np.random.default_rng(4).standard_normal(25)
        Ad = aij_from_scipy(A)
        pc = make_pc("sor", A=Ad, A_host=A)
        # reference: x1 = (D+L)^-1 b ; x = (D+U)^-1 (b - L x1 + 0)
        D = sp.diags(A.diagonal())
        L = sp.tril(A, -1)
        U = sp.triu(A, 1)
        x1 = spla.spsolve((D + L).tocsc(), b)
        xref = spla.spsolve((D + U).tocsc(), b - L @ x1)
        np.testing.assert_allclose(np.asarray(pc.apply(jnp.asarray(b))), xref,
                                   rtol=1e-10)


class TestILUDropTol:
    """-pc_factor_drop_tolerance: threshold ILU (ILUTP via SuperLU)."""

    def test_ilutp_solves_nonsymmetric(self):
        from petsctpu.core.options import Options
        from petsctpu.ksp import ksp_solve
        rng = np.random.default_rng(7)
        n = 400
        A = (sp.random(n, n, density=0.02, random_state=rng)
             + sp.diags(np.full(n, 4.0))).tocsr()
        Ad = aij_from_scipy(A)
        b = jnp.asarray(rng.standard_normal(n))
        pct = make_pc("ilu", A=Ad, A_host=A,
                      options=Options({"pc_factor_drop_tolerance": 1e-4}))
        rt = ksp_solve(Ad, b, pc=pct, ksp_type="gmres", rtol=1e-10,
                       maxits=200)
        assert rt.converged
        x = np.asarray(rt.x)
        np.testing.assert_allclose(A @ x, np.asarray(b), atol=1e-7)

    def test_drop_tol_controls_fill(self):
        import scipy.sparse.linalg as spla
        A = laplacian_2d(16, 16).tocsc()
        loose = spla.spilu(A, drop_tol=1e-1, fill_factor=20.0)
        tight = spla.spilu(A, drop_tol=1e-6, fill_factor=20.0)
        assert tight.nnz > loose.nnz      # threshold drives the fill

    def test_ilutp_tight_tol_is_exact(self):
        from petsctpu.core.options import Options
        from petsctpu.ksp import ksp_solve
        A = laplacian_2d(10, 10)
        Ad = aij_from_scipy(A)
        b = jnp.asarray(np.ones(100))
        pc = make_pc("ilu", A=Ad, A_host=A,
                     options=Options({"pc_factor_drop_tolerance": 1e-14,
                                      "pc_factor_fill": 100.0}))
        r = ksp_solve(Ad, b, pc=pc, ksp_type="richardson", rtol=1e-10,
                      maxits=5)
        # drop_tol→0 is a complete LU: Richardson converges immediately
        assert int(r.its) <= 2


class TestILUTDenseFallback:
    """Band-inviable small ILUT factors take a dense triangular
    solve instead of deep level scheduling (the 1000-level SuperLU
    fill pattern ran ~1e9 scalar gathers in one program)."""

    def _sys(self):
        from petsctpu.models import ex2_system
        import scipy.sparse as sp
        A, b, _ = ex2_system(24, 24)
        return sp.csr_matrix(A).astype(np.float64), np.asarray(b)

    def test_dense_tri_matches_level(self):
        from petsctpu.pc.factor import make_ilu
        A, b = self._sys()
        pcd = make_ilu(A, drop_tol=1e-5, fill_factor=20.0, tri="dense")
        pcl = make_ilu(A, drop_tol=1e-5, fill_factor=20.0, tri="level")
        zd = np.asarray(pcd.apply(jnp.asarray(b)))
        zl = np.asarray(pcl.apply(jnp.asarray(b)))
        np.testing.assert_allclose(zd, zl, rtol=1e-10, atol=1e-12)

    def test_auto_falls_back_dense(self, monkeypatch):
        import petsctpu.pc.parallel as par
        from petsctpu.mat.factor import DenseTRSVPlan
        from petsctpu.pc.factor import make_ilu
        A, b = self._sys()
        monkeypatch.setattr(par, "band_solve_viable",
                            lambda *a, **k: False)
        pc = make_ilu(A, drop_tol=1e-5, fill_factor=20.0, tri="auto")
        assert isinstance(pc.Lplan, DenseTRSVPlan), type(pc.Lplan)
        z = np.asarray(pc.apply(jnp.asarray(b)))
        assert np.isfinite(z).all()


class TestInodeSOR:
    """MatSOR_SeqAIJ_Inode analog (pc/sor.InodeSORPC): block sweeps
    over identical-pattern row groups. Stream parity is pinned by
    tests/test_sweep.py sw2_ex10b_*_inodesor; here: exactness vs a
    sequential numpy block-GS and the make_pc wiring."""

    def _blocked(self, nb=30, bs=3, seed=0):
        import scipy.sparse as sp
        rng = np.random.default_rng(seed)
        Bs = sp.random(nb, nb, density=0.15, random_state=1,
                       format="csr")
        Bs = Bs + Bs.T + 3 * sp.eye(nb)
        A = sp.bmat([[sp.csr_matrix(rng.standard_normal((bs, bs))
                                    + (6 * np.eye(bs) if i == j else 0))
                      if Bs[i, j] != 0 else None
                      for j in range(nb)] for i in range(nb)],
                    format="csr")
        return A

    def test_matches_sequential_block_gs(self):
        from petsctpu.pc.sor import make_inode_sor
        A = self._blocked()
        n = A.shape[0]
        rng = np.random.default_rng(2)
        b = rng.standard_normal(n)
        pc = make_inode_sor(A, sweeps=2, symmetric=True)
        assert pc is not None
        z = np.asarray(pc.apply(jnp.asarray(b)))
        Ad = A.toarray()
        starts = np.arange(0, n + 1, 3)
        x = np.zeros(n)
        t = np.zeros(n)
        for s in range(2):
            for i in range(n // 3):
                r = slice(starts[i], starts[i + 1])
                if s == 0:
                    rhs = b[r] - Ad[r, :starts[i]] @ x[:starts[i]]
                    t[r] = rhs
                else:
                    rhs = (b[r] - Ad[r, :starts[i]] @ x[:starts[i]]
                           - Ad[r, starts[i + 1]:] @ x[starts[i + 1]:])
                x[r] = np.linalg.solve(Ad[r, r], rhs)
            for i in range(n // 3 - 1, -1, -1):
                r = slice(starts[i], starts[i + 1])
                if s == 0:
                    rhs = t[r] - Ad[r, starts[i + 1]:] @ x[starts[i + 1]:]
                else:
                    rhs = (b[r] - Ad[r, :starts[i]] @ x[:starts[i]]
                           - Ad[r, starts[i + 1]:] @ x[starts[i + 1]:])
                x[r] = np.linalg.solve(Ad[r, r], rhs)
        np.testing.assert_allclose(z, x, rtol=1e-12, atol=1e-13)

    def test_make_pc_default_and_no_inode(self):
        from petsctpu.core.options import Options
        from petsctpu.pc import make_pc
        from petsctpu.pc.sor import InodeSORPC, SORPC
        A = self._blocked()
        pc = make_pc("sor", A_host=A, options=Options({}))
        assert isinstance(pc, InodeSORPC)
        pc2 = make_pc("sor", A_host=A,
                      options=Options({"mat_no_inode": "true"}))
        assert isinstance(pc2, SORPC)
        # omega != 1: reference refuses inode SOR -> scalar fallback
        pc3 = make_pc("sor", A_host=A,
                      options=Options({"pc_sor_omega": "1.3"}))
        assert isinstance(pc3, SORPC)
        # matrices without inodes stay scalar
        from petsctpu.models import ex2_system
        import scipy.sparse as sp
        A2, _, _ = ex2_system(8, 8)
        pc4 = make_pc("sor", A_host=sp.csr_matrix(A2),
                      options=Options({}))
        assert isinstance(pc4, SORPC)
