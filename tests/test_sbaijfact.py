"""SBAIJ blocked Cholesky / IC(k) (mat/sbaijfact).

Reference: MatCholeskyFactorNumeric_SeqSBAIJ_N
(src/mat/impls/sbaij/seq/sbaijfact.c) — block-pivot UᵀDU over the
block upper triangle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from petsctpu.ksp import ksp_solve
from petsctpu.mat import aij_from_scipy
from petsctpu.mat.sbaijfact import (_dense_udu, make_sbaij_cholesky,
                                    sbaij_cholesky_factor)


def block_spd(nb=30, bs=3, seed=0, coupling=1.0):
    """Block tridiagonal SPD matrix with dense bs-blocks (elasticity-
    like node coupling)."""
    rng = np.random.default_rng(seed)
    n = nb * bs
    blocks = {}
    for k in range(nb - 1):
        B = coupling * rng.standard_normal((bs, bs))
        blocks[(k, k + 1)] = B
    rows = []
    for k in range(nb):
        row = []
        for j in range(nb):
            if (k, j) in blocks:
                row.append(blocks[(k, j)])
            elif (j, k) in blocks:
                row.append(blocks[(j, k)].T)
            else:
                row.append(np.zeros((bs, bs)))
        rows.append(np.concatenate(row, axis=1))
    A = np.concatenate(rows, axis=0)
    A = A + A.T
    A += np.eye(n) * (np.abs(A).sum(axis=1).max() + 1.0)
    M = sp.csr_matrix(A)
    M.data[np.abs(M.data) < 1e-14] = 0.0
    M.eliminate_zeros()
    return M.tocsr()


class TestDenseUDU:
    def test_reconstructs(self):
        rng = np.random.default_rng(1)
        B = rng.standard_normal((4, 4))
        A = B @ B.T + 4 * np.eye(4)
        u, d = _dense_udu(A)
        np.testing.assert_allclose(u.T @ np.diag(d) @ u, A, atol=1e-12)


class TestSBAIJCholesky:
    def test_full_fill_is_exact(self):
        """levels=None (full fill): the blocked factor is an EXACT
        Cholesky — one application solves the system."""
        A = block_spd(24, 3)
        pc = make_sbaij_cholesky(A, bs=3, levels=None)
        rng = np.random.default_rng(2)
        xex = rng.standard_normal(A.shape[0])
        b = jnp.asarray(A @ xex)
        x = np.asarray(pc.apply(b))
        np.testing.assert_allclose(x, xex, rtol=1e-9, atol=1e-9)

    def test_reconstruction_identity(self):
        """A == (I+W)ᵀ D (I+W) exactly at full fill."""
        A = block_spd(12, 2, seed=3)
        W, d = sbaij_cholesky_factor(A, bs=2, levels=None)
        n = A.shape[0]
        U = sp.eye(n) + W
        R = (U.T @ sp.diags(d) @ U).toarray()
        np.testing.assert_allclose(R, A.toarray(), atol=1e-9)

    def test_ic0_preconditions_cg(self):
        A = block_spd(80, 3, seed=4)
        Ad = aij_from_scipy(A, dtype=np.float64)
        rng = np.random.default_rng(5)
        b = jnp.asarray(rng.standard_normal(A.shape[0]))
        pc = make_sbaij_cholesky(A, bs=3, levels=0)
        r_pc = ksp_solve(Ad, b, pc=pc, ksp_type="cg", rtol=1e-10,
                         maxits=300)
        r_plain = ksp_solve(Ad, b, ksp_type="cg", rtol=1e-10,
                            maxits=300)
        assert int(r_pc.reason) > 0
        assert int(r_pc.its) < int(r_plain.its)

    def test_block_beats_scalar_icc_on_strong_coupling(self):
        """Strong intra-node coupling: block pivots capture what the
        scalar IC(0) cannot — fewer CG iterations (the reason
        sbaijfact.c exists)."""
        from petsctpu.pc.factor import make_icc

        A = block_spd(100, 4, seed=6, coupling=3.0)
        Ad = aij_from_scipy(A, dtype=np.float64)
        rng = np.random.default_rng(7)
        b = jnp.asarray(rng.standard_normal(A.shape[0]))
        r_blk = ksp_solve(Ad, b, pc=make_sbaij_cholesky(A, bs=4,
                                                        levels=0),
                          ksp_type="cg", rtol=1e-10, maxits=400)
        r_sca = ksp_solve(Ad, b, pc=make_icc(A, levels=0),
                          ksp_type="cg", rtol=1e-10, maxits=400)
        assert int(r_blk.reason) > 0
        assert int(r_blk.its) <= int(r_sca.its), (int(r_blk.its),
                                                  int(r_sca.its))

    def test_ex10_19_sbaij_stream_equality(self):
        """runex10_19 (ksp tutorials makefile:622-634): the reference
        asserts that CG+ICC(k) streams through AIJ and through SBAIJ
        are IDENTICAL (its own golden is the diff of the two runs).
        Same check here on a shipped SPD datafile for k = 0, 2, 4:
        scalar-ICC and the sbaij blocked path (bs=1) must produce
        identical convergence histories."""
        import os
        path = ("/root/reference/share/petsc/datafiles/matrices/"
                "spd-real-int32-float64")
        if not os.path.exists(path):
            pytest.skip("reference datafiles not mounted")
        from petsctpu.io.viewer import petsc_binary_read_mat
        from petsctpu.pc.factor import make_icc

        A = petsc_binary_read_mat(path, complex_scalars=False)
        Ad = aij_from_scipy(A.tocsr(), dtype=np.float64)
        b = jnp.asarray(np.ones(A.shape[0]))
        for k in (0, 2, 4):
            r_aij = ksp_solve(Ad, b, pc=make_icc(A, levels=k,
                                                 shift_type="none"),
                              ksp_type="cg", rtol=1e-8, maxits=200)
            r_sb = ksp_solve(Ad, b, pc=make_sbaij_cholesky(A, bs=1,
                                                           levels=k),
                             ksp_type="cg", rtol=1e-8, maxits=200)
            assert int(r_aij.its) == int(r_sb.its), (k, int(r_aij.its),
                                                     int(r_sb.its))
            ha = np.asarray(r_aij.history[: int(r_aij.its) + 1])
            hs = np.asarray(r_sb.history[: int(r_sb.its) + 1])
            # the reference diffs the PRINTED -ksp_monitor_short
            # streams (%.6g); the factors agree to ~1e-13 but the
            # block recurrence sums in a different order
            np.testing.assert_allclose(ha, hs, rtol=5e-7, atol=1e-14)

    def test_native_matches_python(self):
        """The C++ sbaij_block_udu kernel and the Python recurrence
        produce the same factor to roundoff."""
        from petsctpu import native
        from petsctpu.mat import sbaijfact as sf
        if not native.available():
            pytest.skip("native library unavailable")
        A = block_spd(40, 3, seed=9)
        W1, d1 = sf.sbaij_cholesky_factor(A, bs=3, levels=0)
        orig = native.available
        try:
            native.available = lambda: False
            W2, d2 = sf.sbaij_cholesky_factor(A, bs=3, levels=0)
        finally:
            native.available = orig
        np.testing.assert_allclose(d1, d2, rtol=1e-13)
        assert W1.nnz == W2.nnz
        np.testing.assert_allclose(W1.toarray(), W2.toarray(),
                                   atol=1e-14)

    def test_bs1_matches_scalar_icc(self):
        """bs=1 blocked IC(0) == the scalar aijfact route (same
        algorithm at block size 1), digit-exact factors."""
        from petsctpu.mat.factor import icc_factor

        A = block_spd(40, 1, seed=8)
        W, d = sbaij_cholesky_factor(A, bs=1, levels=0)
        Us, ds, _, _ = icc_factor(A, shift_type="none")
        np.testing.assert_allclose(d, ds, rtol=1e-13)
        np.testing.assert_allclose(W.toarray(), Us.toarray(),
                                   rtol=1e-12, atol=1e-15)
