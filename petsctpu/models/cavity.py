"""Driven-cavity flow (velocity-vorticity, with temperature) — SNES ex19.

Reference: src/snes/examples/tutorials/ex19.c FormFunctionLocal — 4
fields per node (u, v, omega, temp) on a 2-D DMDA, 5-point star
stencil with first-order upwinding of the convective terms; boundary
rows use one-sided formulas applied in the reference's order (bottom,
top, left, right — later edges own the corners). Defaults match ex19:
lidvelocity = 1/(mx·my), prandtl = 1, grashof = 1.

State layout: x.reshape(my, mx, 4) with fields (u, v, omega, temp);
j (y) is the slow axis exactly like the reference's x[j][i].
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax


def cavity_residual(mx: int, my: int, lidvelocity: float = None,
                    prandtl: float = 1.0, grashof: float = 1.0):
    if lidvelocity is None:
        lidvelocity = 1.0 / (mx * my)
    dhx, dhy = float(mx - 1), float(my - 1)
    hx, hy = 1.0 / dhx, 1.0 / dhy
    hxdhy, hydhx = hx * dhy, hy * dhx

    def F(xflat):
        X = xflat.reshape(my, mx, 4)
        P = jnp.pad(X, ((1, 1), (1, 1), (0, 0)))
        C = X
        W = P[1:-1, :-2]
        E = P[1:-1, 2:]
        S = P[:-2, 1:-1]
        N = P[2:, 1:-1]
        u, v, om, te = C[..., 0], C[..., 1], C[..., 2], C[..., 3]

        vx, vy = u, v
        avx, avy = jnp.abs(vx), jnp.abs(vy)
        vxp, vxm = 0.5 * (vx + avx), 0.5 * (vx - avx)
        vyp, vym = 0.5 * (vy + avy), 0.5 * (vy - avy)

        def lap(c, w, e, s, n):
            return (2.0 * c - w - e) * hydhx + (2.0 * c - s - n) * hxdhy

        fu = lap(u, W[..., 0], E[..., 0], S[..., 0], N[..., 0]) \
            - 0.5 * (N[..., 2] - S[..., 2]) * hx
        fv = lap(v, W[..., 1], E[..., 1], S[..., 1], N[..., 1]) \
            + 0.5 * (E[..., 2] - W[..., 2]) * hy
        fo = lap(om, W[..., 2], E[..., 2], S[..., 2], N[..., 2]) \
            + (vxp * (om - W[..., 2]) + vxm * (E[..., 2] - om)) * hy \
            + (vyp * (om - S[..., 2]) + vym * (N[..., 2] - om)) * hx \
            - 0.5 * grashof * (E[..., 3] - W[..., 3]) * hy
        ft = lap(te, W[..., 3], E[..., 3], S[..., 3], N[..., 3]) \
            + prandtl * ((vxp * (te - W[..., 3])
                          + vxm * (E[..., 3] - te)) * hy
                         + (vyp * (te - S[..., 3])
                            + vym * (N[..., 3] - te)) * hx)
        Fg = jnp.stack([fu, fv, fo, ft], axis=-1)

        # boundary overrides, reference order: bottom, top, left, right
        Fg = Fg.at[0, :, 0].set(u[0, :])
        Fg = Fg.at[0, :, 1].set(v[0, :])
        Fg = Fg.at[0, :, 2].set(om[0, :] + (u[1, :] - u[0, :]) * dhy)
        Fg = Fg.at[0, :, 3].set(te[0, :] - te[1, :])

        Fg = Fg.at[-1, :, 0].set(u[-1, :] - lidvelocity)
        Fg = Fg.at[-1, :, 1].set(v[-1, :])
        Fg = Fg.at[-1, :, 2].set(om[-1, :] + (u[-1, :] - u[-2, :]) * dhy)
        Fg = Fg.at[-1, :, 3].set(te[-1, :] - te[-2, :])

        Fg = Fg.at[:, 0, 0].set(u[:, 0])
        Fg = Fg.at[:, 0, 1].set(v[:, 0])
        Fg = Fg.at[:, 0, 2].set(om[:, 0] - (v[:, 1] - v[:, 0]) * dhx)
        Fg = Fg.at[:, 0, 3].set(te[:, 0])

        Fg = Fg.at[:, -1, 0].set(u[:, -1])
        Fg = Fg.at[:, -1, 1].set(v[:, -1])
        Fg = Fg.at[:, -1, 2].set(om[:, -1] - (v[:, -1] - v[:, -2]) * dhx)
        Fg = Fg.at[:, -1, 3].set(te[:, -1] - float(grashof > 0))

        return Fg.reshape(-1)

    return F


def cavity_residual_sharded(mx: int, my: int, nshards: int,
                            mloc: int = None, lidvelocity: float = None,
                            prandtl: float = 1.0, grashof: float = 1.0,
                            axis: str = "rows"):
    """Per-shard ex19 residual for shard_map: the j (my) axis is
    sharded; each evaluation exchanges one full (mx, 4) boundary row
    with each neighbor shard via `lax.ppermute` — the DMDA ghost
    scatter of the reference's distributed ex19 run. Boundary formulas
    are applied by global-row masks in the reference's
    bottom/top/left/right order (later edges own the
    corners, ex19.c FormFunctionLocal); rows past the true grid get
    identity residual. Returns (F_local, padded_grid)."""
    if lidvelocity is None:
        lidvelocity = 1.0 / (mx * my)
    if mloc is None:
        mloc = -(-my // nshards)
    assert mloc * nshards >= my
    my_pad = mloc * nshards
    dhx, dhy = float(mx - 1), float(my - 1)
    hx, hy = 1.0 / dhx, 1.0 / dhy
    hxdhy, hydhx = hx * dhy, hy * dhx

    def F(xflat):
        X = xflat.reshape(mloc, mx, 4)
        me = lax.axis_index(axis)
        gj = me * mloc + jnp.arange(mloc)
        pad_row = (gj >= my)[:, None, None]
        Xt = jnp.where(pad_row, 0.0, X)
        if nshards > 1:
            fwd = [(i, i + 1) for i in range(nshards - 1)]
            bwd = [(i + 1, i) for i in range(nshards - 1)]
            above = lax.ppermute(Xt[-1:], axis, fwd)   # my j-1 halo
            below = lax.ppermute(Xt[:1], axis, bwd)    # my j+1 halo
        else:
            above = jnp.zeros_like(Xt[:1])
            below = jnp.zeros_like(Xt[:1])
        Xe = jnp.concatenate([above, Xt, below], axis=0)
        S, N = Xe[:-2], Xe[2:]
        Pi = jnp.pad(Xt, ((0, 0), (1, 1), (0, 0)))
        W, E = Pi[:, :-2], Pi[:, 2:]
        C = X
        u, v, om, te = C[..., 0], C[..., 1], C[..., 2], C[..., 3]

        vx, vy = u, v
        avx, avy = jnp.abs(vx), jnp.abs(vy)
        vxp, vxm = 0.5 * (vx + avx), 0.5 * (vx - avx)
        vyp, vym = 0.5 * (vy + avy), 0.5 * (vy - avy)

        def lap(c, w, e, s, n):
            return (2.0 * c - w - e) * hydhx + (2.0 * c - s - n) * hxdhy

        fu = lap(u, W[..., 0], E[..., 0], S[..., 0], N[..., 0]) \
            - 0.5 * (N[..., 2] - S[..., 2]) * hx
        fv = lap(v, W[..., 1], E[..., 1], S[..., 1], N[..., 1]) \
            + 0.5 * (E[..., 2] - W[..., 2]) * hy
        fo = lap(om, W[..., 2], E[..., 2], S[..., 2], N[..., 2]) \
            + (vxp * (om - W[..., 2]) + vxm * (E[..., 2] - om)) * hy \
            + (vyp * (om - S[..., 2]) + vym * (N[..., 2] - om)) * hx \
            - 0.5 * grashof * (E[..., 3] - W[..., 3]) * hy
        ft = lap(te, W[..., 3], E[..., 3], S[..., 3], N[..., 3]) \
            + prandtl * ((vxp * (te - W[..., 3])
                          + vxm * (E[..., 3] - te)) * hy
                         + (vyp * (te - S[..., 3])
                            + vym * (N[..., 3] - te)) * hx)
        Fg = jnp.stack([fu, fv, fo, ft], axis=-1)

        # boundary overrides, reference order: bottom, top, left, right
        bottom = (gj == 0)[:, None, None]
        top = (gj == my - 1)[:, None, None]
        Fb = jnp.stack([u, v, om + (N[..., 0] - u) * dhy,
                        te - N[..., 3]], axis=-1)
        Ft = jnp.stack([u - lidvelocity, v, om + (u - S[..., 0]) * dhy,
                        te - S[..., 3]], axis=-1)
        Fg = jnp.where(bottom, Fb, Fg)
        Fg = jnp.where(top, Ft, Fg)

        Fg = Fg.at[:, 0, 0].set(u[:, 0])
        Fg = Fg.at[:, 0, 1].set(v[:, 0])
        Fg = Fg.at[:, 0, 2].set(om[:, 0] - (v[:, 1] - v[:, 0]) * dhx)
        Fg = Fg.at[:, 0, 3].set(te[:, 0])

        Fg = Fg.at[:, -1, 0].set(u[:, -1])
        Fg = Fg.at[:, -1, 1].set(v[:, -1])
        Fg = Fg.at[:, -1, 2].set(om[:, -1] - (v[:, -1] - v[:, -2]) * dhx)
        Fg = Fg.at[:, -1, 3].set(te[:, -1] - float(grashof > 0))

        Fg = jnp.where(pad_row, X, Fg)
        return Fg.reshape(-1)

    return F, (my_pad, mx, 4)


def cavity_initial_guess(mx: int, my: int, grashof: float = 1.0,
                         dtype=np.float64):
    """ex19.c FormInitialGuess: zero flow, linear temperature ramp."""
    dx = 1.0 / (mx - 1)
    X = np.zeros((my, mx, 4), dtype)
    i = np.arange(mx)
    X[:, :, 3] = (grashof > 0) * i[None, :] * dx
    return jnp.asarray(X.reshape(-1))


def cavity_jacobian_pattern(mx: int, my: int):
    """Host sparsity superset for FD coloring: full 4x4 blocks on the
    5-point star (what DMDA preallocation produces, fdda.c)."""
    import scipy.sparse as sp

    n = mx * my
    Ii = np.arange(n)
    j = Ii // mx
    i = Ii % mx
    rows, cols = [Ii], [Ii]
    for cond, off in ((i > 0, -1), (i < mx - 1, 1),
                      (j > 0, -mx), (j < my - 1, mx)):
        r = Ii[cond]
        rows.append(r)
        cols.append(r + off)
    adj = sp.coo_matrix((np.ones(sum(len(r) for r in rows)),
                         (np.concatenate(rows), np.concatenate(cols))),
                        shape=(n, n)).tocsr()
    return sp.kron(adj, np.ones((4, 4)), format="csr")


def cavity_nonlinear_gs(mx: int, my: int, lidvelocity: float = None,
                        prandtl: float = 1.0, grashof: float = 1.0,
                        sweeps: int = 1, max_its: int = 50,
                        rtol: float = 1e-5, atol: float = 1e-15,
                        stol: float = 1e-12):
    """ex19.c's user NonlinearGS (ex19.c:375-...) as a jittable
    SEQUENTIAL lexicographic sweep: per point, a pointwise Newton on
    the 4×4 lower-triangular local system (u,v decoupled; ω,T
    back-substituted), boundary rows handled exactly as the C code —
    u/v boundary pre-assignments before the sweep (bottom, top, left,
    right — later edges win the corners), ω/T boundary constraint
    branches applied IN ORDER (i==0, i==mx−1, j==0, j==my−1; corners
    run two branches sequentially). The per-point convergence test
    replicates the reference verbatim INCLUDING its quirk that pfnorm
    is overwritten with √pynorm (the update norm). Returns
    smooth(xflat, bflat=None) for use as a FAS level smoother (b is
    the FAS τ-corrected rhs)."""
    if lidvelocity is None:
        lidvelocity = 1.0 / (mx * my)
    lid = lidvelocity
    dhx, dhy = float(mx - 1), float(my - 1)
    hx, hy = 1.0 / dhx, 1.0 / dhy
    hxdhy, hydhx = hx * dhy, hy * dhx

    def point_newton(x4, nbrs, b4, interior, is_w, is_e, is_s, is_n):
        W, E, S, N = nbrs

        def body(carry):
            x, l, pf0, done = carry
            u, v, o, t = x[0], x[1], x[2], x[3]
            # interior 4x4 Newton step (ex19.c NonlinearGS body)
            uxx = (2.0 * u - W[0] - E[0]) * hydhx
            uyy = (2.0 * u - S[0] - N[0]) * hxdhy
            fu = uxx + uyy - .5 * (N[2] - S[2]) * hx - b4[0]
            dfudu = 2.0 * (hydhx + hxdhy)
            vxx = (2.0 * v - W[1] - E[1]) * hydhx
            vyy = (2.0 * v - S[1] - N[1]) * hxdhy
            fv = vxx + vyy + .5 * (E[2] - W[2]) * hy - b4[1]
            dfvdv = 2.0 * (hydhx + hxdhy)
            avx, avy = jnp.abs(u), jnp.abs(v)
            vxp, vxm = .5 * (u + avx), .5 * (u - avx)
            vyp, vym = .5 * (v + avy), .5 * (v - avy)
            oxx = (2.0 * o - W[2] - E[2]) * hydhx
            oyy = (2.0 * o - S[2] - N[2]) * hxdhy
            fo = (oxx + oyy
                  + (vxp * (o - W[2]) + vxm * (E[2] - o)) * hy
                  + (vyp * (o - S[2]) + vym * (N[2] - o)) * hx
                  - .5 * grashof * (E[3] - W[3]) * hy - b4[2])
            dfodo = 2.0 * (hydhx + hxdhy) + ((vxp - vxm) * hy
                                             + (vyp - vym) * hx)
            dfodu = jnp.where(u > 0.0, (o - W[2]) * hy, (E[2] - o) * hy)
            dfodv = jnp.where(v > 0.0, (o - S[2]) * hx, (N[2] - o) * hx)
            txx = (2.0 * t - W[3] - E[3]) * hydhx
            tyy = (2.0 * t - S[3] - N[3]) * hxdhy
            ft = (txx + tyy + prandtl * (
                (vxp * (t - W[3]) + vxm * (E[3] - t)) * hy
                + (vyp * (t - S[3]) + vym * (N[3] - t)) * hx) - b4[3])
            dftdt = 2.0 * (hydhx + hxdhy) + prandtl * (
                (vxp - vxm) * hy + (vyp - vym) * hx)
            dftdu = jnp.where(u > 0.0, prandtl * (t - W[3]) * hy,
                              prandtl * (E[3] - t) * hy)
            dftdv = jnp.where(v > 0.0, prandtl * (t - S[3]) * hx,
                              prandtl * (N[3] - t) * hx)
            yu = fu / dfudu
            yv = fv / dfvdv
            yo = (fo - (dfodu * yu + dfodv * yv)) / dfodo
            yt = (ft - (dftdu * yu + dftdv * yv)) / dftdt
            xi = jnp.stack([u - yu, v - yv, o - yo, t - yt])
            x = jnp.where(interior, xi, x)
            yu = jnp.where(interior, yu, 0.0)
            yv = jnp.where(interior, yv, 0.0)
            yo = jnp.where(interior, yo, 0.0)
            yt = jnp.where(interior, yt, 0.0)
            # boundary constraint branches, IN ORDER (ex19.c:232-263)
            o_, t_ = x[2], x[3]
            fo1 = o_ - (E[1] - x[1]) * dhx - b4[2]
            ft1 = t_ - b4[3]
            o_ = jnp.where(is_w, o_ - fo1, o_)
            t_ = jnp.where(is_w, t_ - ft1, t_)
            yo = jnp.where(is_w, fo1, yo)
            yt = jnp.where(is_w, ft1, yt)
            fo2 = o_ - (x[1] - W[1]) * dhx - b4[2]
            ft2 = t_ - float(grashof > 0) - b4[3]
            o_ = jnp.where(is_e, o_ - fo2, o_)
            t_ = jnp.where(is_e, t_ - ft2, t_)
            yo = jnp.where(is_e, fo2, yo)
            yt = jnp.where(is_e, ft2, yt)
            fo3 = o_ + (N[0] - x[0]) * dhy - b4[2]
            ft3 = t_ - N[3] - b4[3]
            o_ = jnp.where(is_s, o_ - fo3, o_)
            t_ = jnp.where(is_s, t_ - ft3, t_)
            yo = jnp.where(is_s, fo3, yo)
            yt = jnp.where(is_s, ft3, yt)
            fo4 = o_ + (x[0] - S[0]) * dhy - b4[2]
            ft4 = t_ - S[3] - b4[3]
            o_ = jnp.where(is_n, o_ - fo4, o_)
            t_ = jnp.where(is_n, t_ - ft4, t_)
            yo = jnp.where(is_n, fo4, yo)
            yt = jnp.where(is_n, ft4, yt)
            x = x.at[2].set(o_).at[3].set(t_)
            # convergence (ex19.c:265-275 verbatim incl. the
            # pfnorm = sqrt(pynorm) overwrite)
            pynorm = yu * yu + yv * yv + yo * yo + yt * yt
            pfnorm = jnp.sqrt(pynorm)
            pxnorm = jnp.sqrt(jnp.sum(x * x))
            pf0 = jnp.where(l == 0, pfnorm, pf0)
            conv = ((rtol * pf0 > pfnorm) | (atol > pfnorm)
                    | (pxnorm * stol > pynorm))
            return (x, l + 1, pf0, conv)

        def cond(carry):
            _, l, _, done = carry
            return (l < max_its) & ~done

        x, _, _, _ = lax.while_loop(
            cond, body, (x4, jnp.int32(0), jnp.zeros((), x4.dtype),
                         jnp.zeros((), bool)))
        return x

    def smooth(xflat, bflat=None):
        X = xflat.reshape(my, mx, 4)
        B = (jnp.zeros_like(X) if bflat is None
             else bflat.reshape(my, mx, 4))
        # u/v Dirichlet pre-assignments (bottom, top, left, right —
        # the later edges win the corners, ex19.c NonlinearGS)
        X = X.at[0, :, 0].set(B[0, :, 0]).at[0, :, 1].set(B[0, :, 1])
        X = X.at[-1, :, 0].set(lid + B[-1, :, 0]).at[-1, :, 1].set(
            B[-1, :, 1])
        X = X.at[:, 0, 0].set(B[:, 0, 0]).at[:, 0, 1].set(B[:, 0, 1])
        X = X.at[:, -1, 0].set(B[:, -1, 0]).at[:, -1, 1].set(B[:, -1, 1])

        def point(Xc, ji):
            j = ji // mx
            i = ji % mx
            jm = jnp.maximum(j - 1, 0)
            jp = jnp.minimum(j + 1, my - 1)
            im = jnp.maximum(i - 1, 0)
            ip = jnp.minimum(i + 1, mx - 1)
            nbrs = (Xc[j, im], Xc[j, ip], Xc[jm, i], Xc[jp, i])
            x4 = point_newton(
                Xc[j, i], nbrs, B[j, i],
                (i != 0) & (i != mx - 1) & (j != 0) & (j != my - 1),
                i == 0, i == mx - 1, j == 0, j == my - 1)
            return Xc.at[j, i].set(x4), None

        for _ in range(sweeps):
            X, _ = lax.scan(point, X, jnp.arange(my * mx))
        return X.reshape(-1)

    return smooth


class _FieldQ1:
    """Q1 interpolation ⊗ I_dof on a (my, mx, dof) grid — the MAIJ
    transfer DMDA builds for dof>1 (dainterp.c MatCreateMAIJ)."""

    def __init__(self, fine, coarse, dof=4):
        self.fine, self.coarse, self.dof = fine, coarse, dof

    def mult(self, xc):
        from petsctpu.dm.da import _interp_axis
        X = xc.reshape(self.coarse + (self.dof,))
        for ax in (0, 1):
            X = _interp_axis(X, ax, self.fine[ax])
        return X.reshape(-1)

    def multT(self, xf):
        from petsctpu.dm.da import _restrict_axis
        X = xf.reshape(self.fine + (self.dof,))
        for ax in (0, 1):
            X = _restrict_axis(X, ax, self.coarse[ax])
        return X.reshape(-1)


def cavity_fas_levels(m0: int, nlevels: int, lidvelocity: float,
                      prandtl: float = 1.0, grashof: float = 1.0,
                      gs_kw: dict = None):
    """FAS hierarchy for snes ex19: rediscretized cavity residuals on
    the 2m−1 vertex chain, MAIJ Q1 transfers, node injection, and the
    user NonlinearGS smoother per level (SNESSetGS). Returns
    (levels, smoothers) — fine first."""
    from petsctpu.snes.fas import FASLevel

    sizes = [m0]
    for _ in range(nlevels - 1):
        sizes.append((sizes[-1] + 1) // 2)
    levels, smoothers = [], []
    for l, m in enumerate(sizes):
        F = cavity_residual(m, m, lidvelocity, prandtl, grashof)
        smoothers.append(cavity_nonlinear_gs(
            m, m, lidvelocity, prandtl, grashof, **(gs_kw or {})))
        colors = np.zeros(m * m * 4, np.int32)       # unused with "user"
        if l < nlevels - 1:
            mc = (m + 1) // 2
            interp = _FieldQ1((m, m), (mc, mc))
            idx = np.arange(m * m * 4).reshape(m, m, 4)
            inject = idx[::2, ::2, :].reshape(-1).copy()
            levels.append(FASLevel(F, colors, 1, interp, inject, None))
        else:
            levels.append(FASLevel(F, colors, 1))
    return levels, smoothers
