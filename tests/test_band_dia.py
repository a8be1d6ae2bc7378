"""DIA and dense-tiled band formats (the general irregular SpMV paths)."""

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from petsctpu.ksp import ksp_solve
from petsctpu.mat import band_from_scipy, dia_fill, dia_from_scipy
from petsctpu.mat.order import get_ordering
from petsctpu.models import laplacian_2d


def _scrambled(n_side=20, seed=0):
    rng = np.random.default_rng(seed)
    n = n_side * n_side
    p = rng.permutation(n)
    A = laplacian_2d(n_side, n_side).tocsr()[p][:, p]
    return A


class TestDia:
    def test_mult_multT_diag(self):
        A = _scrambled()
        perm = get_ordering(A, "rcm")
        M = dia_from_scipy(A, perm=perm, max_fill=512)
        Ap = sp.csr_matrix(A)[perm][:, perm]
        x = np.random.default_rng(1).standard_normal(400)
        np.testing.assert_allclose(
            np.asarray(jax.jit(lambda M, v: M.mult(v))(M, jnp.asarray(x))),
            Ap @ x, atol=1e-11)
        np.testing.assert_allclose(
            np.asarray(jax.jit(lambda M, v: M.multT(v))(M, jnp.asarray(x))),
            Ap.T @ x, atol=1e-11)
        np.testing.assert_allclose(np.asarray(M.diagonal()), Ap.diagonal(),
                                   atol=1e-14)

    def test_fill_guard(self):
        A = _scrambled(32)
        try:
            dia_from_scipy(A, max_fill=2.0)
            assert False, "expected fill guard"
        except ValueError:
            pass
        D, fill = dia_fill(A, get_ordering(A, "rcm"))
        assert fill > 2.0


class TestBand:
    def test_mult_multT_diag(self):
        A = _scrambled()
        perm = get_ordering(A, "rcm")
        M = band_from_scipy(A, perm=perm)
        Ap = sp.csr_matrix(A)[perm][:, perm]
        x = np.random.default_rng(2).standard_normal(400)
        np.testing.assert_allclose(
            np.asarray(jax.jit(lambda M, v: M.mult(v))(M, jnp.asarray(x))),
            Ap @ x, atol=1e-11)
        np.testing.assert_allclose(
            np.asarray(jax.jit(lambda M, v: M.multT(v))(M, jnp.asarray(x))),
            Ap.T @ x, atol=1e-11)
        np.testing.assert_allclose(np.asarray(M.diagonal()), Ap.diagonal(),
                                   atol=1e-14)

    def test_odd_sizes_and_tiles(self):
        """n not divisible by tile, wide band vs tile."""
        A = _scrambled(13, seed=3)           # n = 169
        perm = get_ordering(A, "rcm")
        for tile in (128, 256):
            M = band_from_scipy(A, perm=perm, tile=tile)
            Ap = sp.csr_matrix(A)[perm][:, perm]
            x = np.random.default_rng(4).standard_normal(169)
            np.testing.assert_allclose(
                np.asarray(M.mult(jnp.asarray(x))), Ap @ x, atol=1e-11,
                err_msg=f"tile={tile}")

    def test_cg_solve_through_band(self):
        """KSP is format-agnostic: CG over the band operator."""
        A = _scrambled(16, seed=5)
        perm = get_ordering(A, "rcm")
        M = band_from_scipy(A, perm=perm)
        Ap = sp.csr_matrix(A)[perm][:, perm]
        b = np.random.default_rng(6).standard_normal(256)
        res = ksp_solve(M, jnp.asarray(b), ksp_type="cg", rtol=1e-10,
                        maxits=600)
        assert res.converged
        np.testing.assert_allclose(np.asarray(res.x), spla.spsolve(Ap, b),
                                   atol=1e-7)
