"""SellMat — sliced-ELL SpMV over window-grouped passes.

Checked against scipy on CPU; chip_smoke.py's formats phase compares it
with scipy on the card. Reference kernel being replaced:
MatMult_SeqAIJ (aij.c:1173)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from petsctpu.mat.sell import (sell_from_scipy, sell_plan_stats,
                               sell_viable)


def banded_random(n, bw, k, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    rows = np.tile(np.arange(n), k)
    cols = np.clip(rows + rng.integers(-bw, bw, k * n), 0, n - 1)
    A = sp.coo_matrix((rng.standard_normal(k * n).astype(dtype),
                       (rows, cols)), shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


class TestSellMat:
    @pytest.mark.parametrize("n,bw,k,G", [
        (2 * 8 * 128 + 300, 700, 12, 8),     # non-multiple n
        (4 * 4 * 128, 60, 5, 4),             # narrow band
        (3 * 8 * 128, 2500, 9, 8),           # wide band
    ])
    def test_mult_matches_scipy(self, n, bw, k, G):
        A = banded_random(n, bw, k)
        M = sell_from_scipy(A, G=G)
        x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
        y = np.asarray(M.mult(jnp.asarray(x)))
        yref = A @ x
        err = np.abs(y - yref).max() / np.abs(yref).max()
        assert err < 1e-5, err
        np.testing.assert_allclose(np.asarray(M.diagonal()), A.diagonal())

    def test_stencil_matrix_low_slop(self):
        """Structured 5-point stencil: bucket structure is tight, so
        the pass count stays near the ELL width."""
        from petsctpu.models import laplacian_2d
        m = 64
        A = laplacian_2d(m, m, dtype=np.float32).tocsr()
        P, K, S, slop = sell_plan_stats(A, G=4)
        assert K == 5
        assert slop < 3.0, (P, K, slop)
        M = sell_from_scipy(A, G=4)
        x = np.random.default_rng(2).standard_normal(m * m) \
            .astype(np.float32)
        y = np.asarray(M.mult(jnp.asarray(x)))
        np.testing.assert_allclose(y, A @ x, rtol=1e-5, atol=1e-5)

    def test_viability_guard(self):
        # tiny matrix: not worth a tile
        A = banded_random(200, 10, 3)
        assert not sell_viable(A, G=8)
        # adversarially random: window spans everything
        n = 2 * 8 * 128
        rng = np.random.default_rng(3)
        A = sp.random(n, n, density=0.005, random_state=3,
                      format="csr", dtype=np.float32)
        A = A + sp.eye(n, dtype=np.float32)
        with pytest.raises(ValueError):
            sell_from_scipy(A.tocsr(), G=8, max_span_rows=4)

    def test_factory_sell_and_auto(self):
        """-mat_type sell|auto route (MatSetFromOptions analog):
        explicit sell returns the permuted-space SellMat; auto picks
        BandMat only for a band whose storage stays within twice the
        nonzeros (a filled band), not for a sparse 5-point band."""
        from petsctpu.mat.factory import mat_from_options
        from petsctpu.models import laplacian_2d

        rng = np.random.default_rng(7)
        n, B = 1024, 192
        Af = sp.diags([rng.standard_normal(n - abs(k))
                       for k in range(-B, B + 1)],
                      list(range(-B, B + 1))).tocsr()
        M, perm = mat_from_options(Af, mat_type="auto")
        assert type(M).__name__ == "BandMat" and perm is None
        x = rng.standard_normal(n)
        np.testing.assert_allclose(np.asarray(M.mult(jnp.asarray(x))),
                                   Af @ x, rtol=1e-10, atol=1e-10)
        A = laplacian_2d(24, 24, dtype=np.float64).tocsr()
        M, perm = mat_from_options(A, mat_type="auto")
        assert type(M).__name__ != "BandMat"
        p = rng.permutation(24 * 24)
        As = laplacian_2d(24, 24, dtype=np.float32).tocsr()[p][:, p]
        M2, p2 = mat_from_options(As.tocsr(), mat_type="sell")
        x = rng.standard_normal(24 * 24).astype(np.float32)
        Ap = As.tocsr()[p2][:, p2]
        y = np.asarray(M2.mult(jnp.asarray(x)))
        np.testing.assert_allclose(y, Ap @ x, rtol=2e-5, atol=2e-5)

    def test_gamg_levels_through_sell(self):
        """fmt="sell" AMG: level operators on SellMat, same
        convergence as the ELL route."""
        from petsctpu.ksp import ksp_solve
        from petsctpu.mat import aij_from_scipy
        from petsctpu.models import laplacian_2d
        from petsctpu.pc.gamg import gamg_hierarchy
        from petsctpu.pc.mg import make_algebraic_mg_from_hierarchy

        rng = np.random.default_rng(0)
        A = laplacian_2d(48, 48, dtype=np.float64).tocsr()
        p = rng.permutation(A.shape[0])
        As = (A[p][:, p]).tocsr()
        Asys, Ps = gamg_hierarchy(As, coarse_n=64)
        b = jnp.asarray(rng.standard_normal(As.shape[0])
                        .astype(np.float32))
        Ad = aij_from_scipy(As.astype(np.float32), dtype=np.float32)
        its = {}
        for fmt in ("ell", "sell"):
            pc = make_algebraic_mg_from_hierarchy(
                Asys, Ps, dtype=np.float32, fmt=fmt)
            r = ksp_solve(Ad, b, pc=pc, ksp_type="cg", rtol=1e-5,
                          maxits=60)
            assert int(r.reason) > 0, fmt
            its[fmt] = int(r.its)
        assert abs(its["sell"] - its["ell"]) <= 2, its

    def test_ksp_solve_through_sell(self):
        """A SellMat drives a CG solve end-to-end (format has mult/
        diagonal — enough for cg+jacobi)."""
        from petsctpu.ksp import ksp_solve
        from petsctpu.pc.simple import JacobiPC
        n = 8 * 128
        A = banded_random(n, 50, 4, seed=5)
        A = (A + A.T).tocsr()
        A = (A @ A.T + sp.eye(n) * (abs(A).sum(axis=1).max() * 2)).tocsr()
        A = A.astype(np.float32)
        M = sell_from_scipy(A, G=8)
        b = np.random.default_rng(6).standard_normal(n).astype(np.float32)
        pc = JacobiPC(1.0 / np.asarray(M.diagonal()))
        r = ksp_solve(M, jnp.asarray(b), pc=pc, ksp_type="cg",
                      rtol=1e-5, maxits=500)
        assert int(r.reason) > 0
        x = np.asarray(r.x)
        assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-4


class TestSellBAIJ:
    """Blocked operators through the scalar SELL kernel (fmt=auto/sell
    on baij_from_scipy_bsr; reference fast path: MatMult_SeqBAIJ_N,
    baij2.c:387)."""

    def test_sell_baij_matches_block_ell(self):
        from petsctpu.mat.bsr import SellBAIJ, baij_from_scipy_bsr
        rng = np.random.default_rng(0)
        nb, bs = 900, 3                       # 2700 rows >= G*128
        rows = np.tile(np.arange(nb), 6)
        cols = np.clip(rows + rng.integers(-40, 40, rows.size), 0,
                       nb - 1)
        D = (sp.coo_matrix((np.ones(rows.size), (rows, cols)),
                           shape=(nb, nb)) + sp.eye(nb)).tocsr()
        A = sp.kron(D, np.ones((bs, bs))).tocsr().astype(np.float32)
        A.data = rng.standard_normal(A.nnz).astype(np.float32)
        A.sum_duplicates()
        Ab = baij_from_scipy_bsr(A, bs=bs, dtype=np.float32, fmt="sell")
        assert isinstance(Ab, SellBAIJ)
        Ae = baij_from_scipy_bsr(A, bs=bs, dtype=np.float32)
        x = jnp.asarray(rng.standard_normal(nb * bs).astype(np.float32))
        y1 = np.asarray(Ab.mult(x))
        y2 = np.asarray(Ae.mult(x))
        np.testing.assert_allclose(y1, y2, rtol=2e-5, atol=1e-4)
        # blocked metadata still served
        np.testing.assert_allclose(np.asarray(Ab.diagonal()),
                                   np.asarray(Ae.diagonal()))
        np.testing.assert_allclose(np.asarray(Ab.multT(x)),
                                   np.asarray(Ae.multT(x)), rtol=2e-5,
                                   atol=1e-4)


class TestShardedSell:
    """ShardedAIJ diag blocks through SELL (fmt='sell'): the local
    SpMV of a distributed solve runs SellMat
    (MatMult_MPIAIJ's local MatMult_SeqAIJ, mpiaij.c:1102)."""

    def test_dist_mult_matches_ell(self):
        import jax
        from jax.sharding import Mesh, PartitionSpec as P
        from jax import shard_map
        from petsctpu.parallel.pmat import sharded_aij_from_scipy
        if len(jax.devices()) < 4:
            import pytest
            pytest.skip("needs 4 devices")
        n = 4 * 2048                           # each shard SELL-viable
        A = (sp.diags([np.ones(n - 1), 4 * np.ones(n), np.ones(n - 1)],
                      [-1, 0, 1])
             + sp.diags([np.ones(n - 64), np.ones(n - 64)], [-64, 64])) \
            .tocsr().astype(np.float32)
        Ms, _ = sharded_aij_from_scipy(A, 4, dtype=np.float32,
                                       fmt="sell")
        assert Ms.diag_sell is not None
        Me, _ = sharded_aij_from_scipy(A, 4, dtype=np.float32)
        x = np.random.default_rng(3).standard_normal(n) \
            .astype(np.float32)
        mesh = Mesh(np.array(jax.devices()[:4]), ("rows",))
        xd = jnp.asarray(x.reshape(4, -1))

        def run(M, xs):
            def body(Ml, xl):
                return Ml.local().mult(xl[0])[None]
            return shard_map(body, mesh=mesh,
                             in_specs=(P("rows"), P("rows")),
                             out_specs=P("rows"),
                             check_vma=False)(M, xs)

        y1 = np.asarray(run(Ms, xd)).reshape(-1)
        y2 = np.asarray(run(Me, xd)).reshape(-1)
        np.testing.assert_allclose(y1, y2, rtol=2e-5, atol=1e-4)
        np.testing.assert_allclose(y1, A @ x, rtol=2e-4, atol=1e-3)

    def test_dist_gamg_levels_use_sell(self):
        """make_dist_gamg fmt plumb: pc_gamg_mat_type='sell' puts the
        sharded level operators on the SELL kernel."""
        import jax
        if len(jax.devices()) < 4:
            import pytest
            pytest.skip("needs 4 devices")
        from petsctpu.core.options import Options
        from petsctpu.models import laplacian_2d
        from petsctpu.pc.distmg import make_dist_gamg
        A = laplacian_2d(96, 96, dtype=np.float32).tocsr()
        pc = make_dist_gamg(A, 4, dtype=np.float32,
                            options=Options(
                                {"pc_gamg_mat_type": "sell",
                                 "pc_mg_repl_size": 3000}))
        assert pc.levels[0].A.diag_sell is not None


class TestSellMultT:
    """Chunk-mode transpose product (y = Aᵀr) — the scatter-add
    used by packed MG restriction (MatMultTranspose_SeqAIJ
    analog, aij.c:1307; pc/mg.py pack_restrict returns None so the
    cycle rides P.multT when no dense/slant-band R applies)."""

    @pytest.mark.parametrize("G", [8, 16])
    def test_multT_matches_scipy(self, G):
        rng = np.random.default_rng(5)
        m, n = G * 128 * 3 + 77, 1400
        # prolongator-like: few nnz/row, columns clustered by row blocks
        rows = np.repeat(np.arange(m), 3)
        cols = np.clip((rows // (m // n + 1))
                       + rng.integers(-40, 40, rows.size), 0, n - 1)
        A = sp.coo_matrix((rng.standard_normal(rows.size)
                           .astype(np.float32), (rows, cols)),
                          shape=(m, n)).tocsr()
        A.sum_duplicates()
        M = sell_from_scipy(A, G=G, mode="chunk")
        r = rng.standard_normal(m).astype(np.float32)
        y = np.asarray(M.multT(jnp.asarray(r)))
        ref = A.T @ r
        np.testing.assert_allclose(y, ref, rtol=2e-5, atol=2e-4)

    def test_multT_diag_mode_raises(self):
        A = banded_random(8 * 128 * 2, 60, 5)
        M = sell_from_scipy(A, G=8, mode="diag")
        with pytest.raises(NotImplementedError):
            M.multT(jnp.zeros(A.shape[0], jnp.float32))

    def test_packed_mg_restrict_via_multT(self):
        """GAMG packed metas under pc_gamg_mat_type sell: when P packs
        as chunk-SELL and R has no dense/slant-band route, rref is None
        and the cycle restricts through P.multT — result must match
        the explicit-ELL apply of the same RCM-conjugated hierarchy.
        A 64x256 strip keeps the RCM-ordered level-0 prolongator
        chunk-SELL-viable."""
        from petsctpu.core.options import Options
        from petsctpu.mat import aij_from_scipy
        from petsctpu.mat.order import get_ordering
        from petsctpu.models import laplacian_2d
        from petsctpu.pc import make_pc
        from petsctpu.pc.gamg import gamg_hierarchy
        from petsctpu.pc.mg import make_algebraic_mg_from_hierarchy

        A = laplacian_2d(64, 256, dtype=np.float32).tocsr()
        Ad = aij_from_scipy(A, dtype=np.float32)
        pc = make_pc("gamg", A=Ad, A_host=A,
                     options=Options({"pc_gamg_coarse_eq_limit": 64,
                                      "pc_gamg_mat_type": "sell"}))
        metas = pc.inner.metas          # PermutedPC around PackedMGPC
        kinds = [m[2][0] if m[2] is not None else None for m in metas]
        prefs = [(m[1][0], m[1][-1]) for m in metas]
        assert kinds[0] is None, (kinds, prefs)
        assert prefs[0] == ("sell", "chunk"), prefs
        b = jnp.asarray(np.random.default_rng(0)
                        .standard_normal(A.shape[0]).astype(np.float32))
        y = np.asarray(pc.apply(b))
        # reference: the same hierarchy in the same RCM frame on ELL
        As, Ps = gamg_hierarchy(A, coarse_n=64)
        perms = [get_ordering(sp.csr_matrix(M), "rcm") for M in As]
        Asp = [sp.csr_matrix(M)[p][:, p].tocsr()
               for M, p in zip(As, perms)]
        Psp = [sp.csr_matrix(P)[perms[l]][:, perms[l + 1]].tocsr()
               for l, P in enumerate(Ps)]
        ref = make_algebraic_mg_from_hierarchy(Asp, Psp, dtype=np.float32,
                                               fmt="ell")
        y2 = np.zeros_like(y)
        y2[perms[0]] = np.asarray(ref.apply(b[jnp.asarray(perms[0])]))
        scale = np.abs(y2).max()
        np.testing.assert_allclose(y / scale, y2 / scale,
                                   rtol=2e-4, atol=2e-5)
