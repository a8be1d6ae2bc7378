"""Bratu problem (solid-fuel ignition) — SNES ex5 analog.

Reference: src/snes/examples/tutorials/ex5.c — 2-D Bratu
−Δu − λ·eᵘ = 0 on the unit square, u = 0 on the boundary, discretized
with a 5-point stencil on an m×n vertex grid; residual scaled like the
reference's FormFunctionLocal exactly (ex5.c:270-286 — interior:
(2u−uW−uE)·hy/hx + (2u−uN−uS)·hx/hy − λ·hx·hy·eᵘ with boundary
NEIGHBORS hard-coded to 0, decoupling the interior from boundary
values; boundary rows: 2(hy/hx + hx/hy)·u, scaled like the interior
diagonal). The decoupling matters under FAS, where boundary values
take nonzero intermediate values."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from petsctpu.dm.da import DA


def bratu_residual(da: DA, lam: float = 6.0):
    """Returns jit-safe F(u_flat) -> residual_flat."""
    m, n = da.grid
    hx = 1.0 / (m - 1)
    hy = 1.0 / (n - 1)

    def F(u):
        U = u.reshape(m, n)
        i = jnp.arange(m)[:, None]
        j = jnp.arange(n)[None, :]
        boundary = (i == 0) | (i == m - 1) | (j == 0) | (j == n - 1)
        Ub = jnp.where(boundary, 0.0, U)     # ex5.c: boundary nbrs ≡ 0
        P = jnp.pad(Ub, 1)
        uW, uE = P[:-2, 1:-1], P[2:, 1:-1]
        uS, uN = P[1:-1, :-2], P[1:-1, 2:]
        interior = ((2 * U - uW - uE) * (hy / hx)
                    + (2 * U - uS - uN) * (hx / hy)
                    - lam * hx * hy * jnp.exp(U))
        bscale = 2.0 * (hy / hx + hx / hy)
        return jnp.where(boundary, bscale * U, interior).reshape(-1)

    return F


def bratu_residual_sharded(da: DA, nshards: int, mloc: int = None,
                           lam: float = 6.0, axis: str = "rows"):
    """Per-shard Bratu residual for shard_map: the leading grid axis
    (the reference's DMDA x-partition, ex5.c runs on an arbitrary
    DMDA decomposition) is sharded over `axis`; each evaluation
    exchanges one boundary row with each neighbor shard via
    `lax.ppermute` — the device form of the DMGlobalToLocal ghost scatter
    the reference performs before FormFunctionLocal (dm.c:1620).

    Rows past the true grid (leading-axis padding to nshards*mloc)
    get identity residual F=u, matching the identity pad rows of the
    sharded operators. Returns (F_local, padded_grid)."""
    import jax
    from jax import lax

    m, n = da.grid
    if mloc is None:
        mloc = -(-m // nshards)
    assert mloc * nshards >= m
    m_pad = mloc * nshards
    hx = 1.0 / (m - 1)
    hy = 1.0 / (n - 1)

    def F(u_loc):
        U = u_loc.reshape(mloc, n)
        me = lax.axis_index(axis)
        gi = me * mloc + jnp.arange(mloc)[:, None]
        j = jnp.arange(n)[None, :]
        boundary = (gi == 0) | (gi == m - 1) | (j == 0) | (j == n - 1)
        pad_row = gi >= m
        Ub = jnp.where(boundary | pad_row, 0.0, U)   # ex5.c: bnd nbrs ≡ 0
        if nshards > 1:
            fwd = [(i, i + 1) for i in range(nshards - 1)]
            bwd = [(i + 1, i) for i in range(nshards - 1)]
            above = lax.ppermute(Ub[-1:], axis, fwd)   # prev shard's last
            below = lax.ppermute(Ub[:1], axis, bwd)    # next shard's first
        else:
            above = jnp.zeros_like(Ub[:1])
            below = jnp.zeros_like(Ub[:1])
        Ue = jnp.concatenate([above, Ub, below], axis=0)   # [mloc+2, n]
        uW, uE = Ue[:-2, :], Ue[2:, :]
        Pj = jnp.pad(Ub, ((0, 0), (1, 1)))
        uS, uN = Pj[:, :-2], Pj[:, 2:]
        interior = ((2 * U - uW - uE) * (hy / hx)
                    + (2 * U - uS - uN) * (hx / hy)
                    - lam * hx * hy * jnp.exp(U))
        bscale = 2.0 * (hy / hx + hx / hy)
        out = jnp.where(boundary, bscale * U, interior)
        return jnp.where(pad_row, U, out).reshape(-1)

    return F, (m_pad, n)


def bratu_jacobian_template(da: DA, dtype=np.float64):
    """Stencil template (pattern donor) for FD-coloring assembly."""
    from petsctpu.mat.stencil import StencilMat
    import jax.numpy as jnp

    offs = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
    m, n = da.grid
    C = np.zeros((5, m, n), dtype)
    C[0] = 1.0
    C[1, 1:-1, 1:-1] = 1.0
    C[2, 1:-1, 1:-1] = 1.0
    C[3, 1:-1, 1:-1] = 1.0
    C[4, 1:-1, 1:-1] = 1.0
    return StencilMat(jnp.asarray(C), offs, (m, n))


def bratu_initial_guess(da: DA, lam: float = 6.0):
    """ex5.c FormInitialGuess: temp·min(dist to boundary)."""
    m, n = da.grid
    hx = 1.0 / (m - 1)
    hy = 1.0 / (n - 1)
    temp1 = lam / (lam + 1.0)
    i = np.arange(m)[:, None]
    j = np.arange(n)[None, :]
    tx = np.minimum(i, m - 1 - i) * hx
    ty = np.minimum(j, n - 1 - j) * hy
    U = temp1 * np.sqrt(np.minimum(tx, ty))
    U[0, :] = U[-1, :] = 0.0
    U[:, 0] = U[:, -1] = 0.0
    return jnp.asarray(U.reshape(-1))


def bratu_nonlinear_gs(da: DA, lam: float = 6.0, sweeps: int = 1,
                       max_its: int = 50, rtol: float = 1e-5,
                       atol: float = 1e-15, stol: float = 1e-12):
    """ex5.c's user NonlinearGS (ex5.c:485-584, registered via
    SNESSetGS at ex5.c:109) as a jittable SEQUENTIAL lexicographic
    sweep: per interior point, up to `max_its` scalar Newton steps on
    the 1-dof Bratu equation
        F = (2u−uE−uW)·hy/hx + (2u−uN−uS)·hx/hy − λ·hx·hy·eᵘ − b,
        J = 2(hy/hx + hx/hy) − λ·hx·hy·eᵘ,
    with the reference's verbatim early-exit test AFTER each update
    (atol > |F| or rtol·|F0| > |F| or stol·|u| > |y|); boundary points
    are assigned 0 (zero Dirichlet). Already-visited neighbors read
    UPDATED values (Gauss-Seidel). Defaults mirror SNESCreate_GS
    (snesgs.c:376-380: sweeps=1, rtol=1e-5, atol=1e-15, stol=1e-12,
    max_its=50). Returns smooth(xflat, bflat=None) usable as an NGMRES
    nonlinear preconditioner or FAS level smoother."""
    import jax
    from jax import lax

    m, n = da.grid
    hx, hy = 1.0 / (m - 1), 1.0 / (n - 1)
    sc = hx * hy * lam
    hxdhy, hydhx = hx / hy, hy / hx

    def smooth(xflat, bflat=None):
        X0 = xflat.reshape(m, n)
        Bg = None if bflat is None else bflat.reshape(m, n)

        def point(X, idx):
            # sweep order matches ex5.c NonlinearGS: y (axis 1) outer,
            # x (axis 0, the hx axis) inner
            j, i = idx // m, idx % m
            boundary = (i == 0) | (i == m - 1) | (j == 0) | (j == n - 1)
            u0 = X[i, j]
            uW, uE = X[i - 1, j], X[(i + 1) % m, j]
            uS, uN = X[i, j - 1], X[i, (j + 1) % n]
            bij = 0.0 if Bg is None else Bg[i, j]

            def newton_body(carry):
                u, F0, k, _ = carry
                eu = jnp.exp(u)
                Fv = ((2.0 * u - uW - uE) * hydhx
                      + (2.0 * u - uS - uN) * hxdhy - sc * eu - bij)
                F0 = jnp.where(k == 0, Fv, F0)
                J = 2.0 * (hydhx + hxdhy) - sc * eu
                y = Fv / J
                u = u - y
                done = ((atol > jnp.abs(Fv))
                        | (rtol * jnp.abs(F0) > jnp.abs(Fv))
                        | (stol * jnp.abs(u) > jnp.abs(y)))
                return u, F0, k + 1, done

            def newton_cond(carry):
                _, _, k, done = carry
                return (k < max_its) & jnp.logical_not(done)

            u, _, _, _ = lax.while_loop(
                newton_cond, newton_body,
                (u0, jnp.zeros_like(u0), jnp.int32(0),
                 jnp.zeros((), bool)))
            unew = jnp.where(boundary, jnp.zeros_like(u0), u)
            return X.at[i, j].set(unew), None

        X = X0
        for _ in range(sweeps):
            X, _ = lax.scan(point, X, jnp.arange(m * n))
        return X.reshape(-1)

    return smooth
