"""Distributed Newton-Krylov / TS under shard_map (parallel.psnes).

The reference runs SNES ex5/ex19 and TS under real MPI with golden
iteration counts; here the SAME axis-parametric solver code runs on
the 8-device CPU mesh, and the distributed iteration counts and
solutions must match the serial run (SURVEY §4's mpiuni/localhost
equivalence). Reference: SNESSolve snes.c:3585 + snesj2.c:36 colored
Jacobians, distributed Newton-Krylov-GAMG.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from petsctpu.core.options import Options
from petsctpu.dm.da import DA
from petsctpu.ksp.common import KSPConfig
from petsctpu.mat.coloring import greedy_color
from petsctpu.models.bratu import (bratu_initial_guess, bratu_residual,
                                   bratu_residual_sharded)
from petsctpu.models.cavity import (cavity_initial_guess,
                                    cavity_jacobian_pattern,
                                    cavity_residual,
                                    cavity_residual_sharded)
from petsctpu.parallel import (ShardedFDJac, par_snes_solve, par_ts_solve,
                               unshard_vector)
from petsctpu.snes.api import SNESConfig, snes_solve
from petsctpu.snes.fdjac import ColoredJacobian
from petsctpu.ts.steppers import TSConfig, ts_solve

P = 8
STAR5 = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))


def mesh8():
    return Mesh(np.array(jax.devices()[:P]), ("rows",))


def cavity_offsets():
    return tuple((oj, oi, od) for (oj, oi) in STAR5
                 for od in range(-3, 4))


class TestShardedFDJac:
    def test_bratu_jacobian_matches_serial(self):
        """Sharded colored-FD J·v equals the serial colored-FD J·v."""
        m = n = 11
        da = DA((m, n))
        lam = 5.0
        Fs = bratu_residual(da, lam)
        x0 = bratu_initial_guess(da, lam)

        from petsctpu.models.bratu import bratu_jacobian_template
        plan_s = ColoredJacobian.from_stencil(bratu_jacobian_template(da))
        Js = plan_s.assemble(Fs, x0, Fs(x0))

        Fp, grid_pad = bratu_residual_sharded(da, P, lam=lam)
        plan = ShardedFDJac.plan((m, n), STAR5, P)
        assert plan.grid == grid_pad
        n_pad = plan.n_pad
        mesh = mesh8()

        from functools import partial
        from jax import shard_map
        from jax.sharding import PartitionSpec as PS

        xp = np.zeros(n_pad)
        xp[: m * n] = np.asarray(x0)

        @jax.jit
        @partial(shard_map, mesh=mesh,
                 in_specs=(PS("rows"), PS("rows"),
                           jax.tree.map(lambda _: PS("rows"), plan)),
                 out_specs=PS("rows"), check_vma=False)
        def apply_J(xloc, vloc, plan_st):
            pl = plan_st.local()
            J = pl.assemble(Fp, xloc, Fp(xloc))
            return J.mult(vloc)

        rng = np.random.default_rng(0)
        for _ in range(4):
            v = np.zeros(n_pad)
            v[: m * n] = rng.standard_normal(m * n)
            out = np.asarray(apply_J(jnp.asarray(xp), jnp.asarray(v),
                                     plan))[: m * n]
            ref = np.asarray(Js.mult(jnp.asarray(v[: m * n])))
            np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-8)


class TestParSNES:
    def test_bratu_newton_matches_serial(self):
        """Distributed Newton-Krylov (colored-FD J, GMRES) reproduces
        the serial iteration count and solution."""
        m = n = 17
        da = DA((m, n))
        lam = 6.0
        kcfg = KSPConfig(ksp_type="gmres", rtol=1e-8, maxits=400)
        scfg = SNESConfig(rtol=1e-8, atol=1e-12)

        Fs = bratu_residual(da, lam)
        x0 = bratu_initial_guess(da, lam)
        from petsctpu.models.bratu import bratu_jacobian_template
        plan_s = ColoredJacobian.from_stencil(bratu_jacobian_template(da))
        rs = snes_solve(Fs, x0, jac=plan_s, ksp_cfg=kcfg, cfg=scfg)
        assert int(rs.reason) > 0

        Fp, _ = bratu_residual_sharded(da, P, lam=lam)
        plan = ShardedFDJac.plan((m, n), STAR5, P)
        rp = par_snes_solve(mesh8(), Fp, np.asarray(x0), jac=plan,
                            cfg=scfg, ksp_cfg=kcfg)
        assert int(rp.reason) > 0
        assert int(rp.its) == int(rs.its)
        xs = np.asarray(rs.x)
        xp = unshard_layoutless(rp.x, m * n)
        np.testing.assert_allclose(xp, xs, rtol=1e-6, atol=1e-8)

    def test_bratu_newton_distmg(self):
        """BASELINE config 5 shape: distributed Newton-Krylov with
        GMRES + distributed geometric MG (lagged PC from the initial
        Jacobian), Newton counts matching serial."""
        from petsctpu.pc.distmg import make_dist_mg

        m = n = 33
        da = DA((m, n))
        lam = 6.0
        kcfg = KSPConfig(ksp_type="fgmres", rtol=1e-8, maxits=100)
        scfg = SNESConfig(rtol=1e-8, atol=1e-12)

        Fs = bratu_residual(da, lam)
        x0 = bratu_initial_guess(da, lam)
        from petsctpu.models.bratu import bratu_jacobian_template
        plan_s = ColoredJacobian.from_stencil(bratu_jacobian_template(da))
        rs = snes_solve(Fs, x0, jac=plan_s, cfg=scfg,
                        ksp_cfg=KSPConfig(ksp_type="fgmres", rtol=1e-8,
                                          maxits=2000, restart=200))
        assert int(rs.reason) > 0

        # host Jacobian at the initial guess feeds the lagged MG PC
        J0 = plan_s.assemble(Fs, x0, Fs(x0))
        import scipy.sparse as sp
        J0h = sp.csr_matrix(
            np.array([np.asarray(J0.mult(v)) for v in np.eye(m * n)]).T)
        pc = make_dist_mg(J0h, (m, n), P, dtype=np.float64,
                          options=Options({"pc_mg_repl_size": 600}))
        mloc = pc.A.mloc

        Fp, _ = bratu_residual_sharded(da, P, mloc=mloc, lam=lam)
        plan = ShardedFDJac.plan((m, n), STAR5, P, mloc=mloc)
        rp = par_snes_solve(mesh8(), Fp, np.asarray(x0), jac=plan, pc=pc,
                            cfg=scfg, ksp_cfg=kcfg)
        assert int(rp.reason) > 0
        assert int(rp.its) == int(rs.its)
        xp = unshard_layoutless(rp.x, m * n)
        np.testing.assert_allclose(xp, np.asarray(rs.x), rtol=1e-6,
                                   atol=1e-8)

    def test_cavity_newton_matches_serial(self):
        """Distributed ex19 driven cavity (4-dof nodes, upwinded
        convection) matches the serial Newton count and solution."""
        mx, my = 12, 16          # my % P == 0: no padding
        kcfg = KSPConfig(ksp_type="gmres", rtol=1e-8, maxits=400)
        scfg = SNESConfig(rtol=1e-8, atol=1e-12)

        Fs = cavity_residual(mx, my)
        x0 = cavity_initial_guess(mx, my)
        patt = cavity_jacobian_pattern(mx, my)
        from petsctpu.mat.ell import aij_from_scipy
        plan_s = ColoredJacobian.from_sparsity(
            patt, aij_from_scipy(patt, dtype=np.float64))
        rs = snes_solve(Fs, x0, jac=plan_s, ksp_cfg=kcfg, cfg=scfg)
        assert int(rs.reason) > 0

        Fp, grid_pad = cavity_residual_sharded(mx, my, P)
        assert grid_pad == (my, mx, 4)
        plan = ShardedFDJac.plan((my, mx, 4), cavity_offsets(), P)
        rp = par_snes_solve(mesh8(), Fp, np.asarray(x0), jac=plan,
                            cfg=scfg, ksp_cfg=kcfg)
        assert int(rp.reason) > 0
        assert int(rp.its) == int(rs.its)
        np.testing.assert_allclose(np.asarray(rp.x), np.asarray(rs.x),
                                   rtol=1e-6, atol=1e-8)

    def test_cavity_newton_dist_gamg(self):
        """Distributed Newton-Krylov-GAMG on the cavity Jacobian —
        the full BASELINE config 5 stack (ex19-style + GMRES + GAMG)."""
        from petsctpu.pc.distmg import make_dist_gamg

        mx, my = 12, 16
        kcfg = KSPConfig(ksp_type="fgmres", rtol=1e-8, maxits=200)
        scfg = SNESConfig(rtol=1e-8, atol=1e-12)

        Fs = cavity_residual(mx, my)
        x0 = cavity_initial_guess(mx, my)
        # host Jacobian at x0 (dense via jvp columns — tiny problem)
        n = 4 * mx * my
        Jcols = jax.vmap(lambda v: jax.jvp(Fs, (x0,), (v,))[1])(jnp.eye(n))
        import scipy.sparse as sp
        J0h = sp.csr_matrix(np.asarray(Jcols).T)
        pc = make_dist_gamg(J0h, P, dtype=np.float64,
                            options=Options({"pc_mg_repl_size": 200}))

        rs = snes_solve(Fs, x0, jac="jvp", ksp_cfg=kcfg, cfg=scfg)
        Fp, _ = cavity_residual_sharded(mx, my, P)
        plan = ShardedFDJac.plan((my, mx, 4), cavity_offsets(), P)
        rp = par_snes_solve(mesh8(), Fp, np.asarray(x0), jac=plan, pc=pc,
                            cfg=scfg, ksp_cfg=kcfg)
        assert int(rp.reason) > 0
        assert int(rp.its) == int(rs.its)
        np.testing.assert_allclose(np.asarray(rp.x), np.asarray(rs.x),
                                   rtol=1e-5, atol=1e-7)


class TestParTS:
    def test_heat_beuler_matches_serial(self):
        """Distributed implicit TS (beuler, colored stage Jacobian):
        the sharded run reproduces the serial trajectory."""
        m, n = 16, 9             # m % P == 0
        alpha = 1.0
        h = 1.0 / (m + 1)

        def rhs_serial(t, u):
            U = u.reshape(m, n)
            Pd = jnp.pad(U, 1)
            lap = (Pd[:-2, 1:-1] + Pd[2:, 1:-1] + Pd[1:-1, :-2]
                   + Pd[1:-1, 2:] - 4 * U)
            return (alpha / h ** 2 * lap).reshape(-1)

        def rhs_sharded(t, u):
            from jax import lax
            U = u.reshape(m // P, n)
            fwd = [(i, i + 1) for i in range(P - 1)]
            bwd = [(i + 1, i) for i in range(P - 1)]
            above = lax.ppermute(U[-1:], "rows", fwd)
            below = lax.ppermute(U[:1], "rows", bwd)
            Ue = jnp.concatenate([above, U, below], axis=0)
            Pd = jnp.pad(Ue, ((0, 0), (1, 1)))
            lap = (Pd[:-2, 1:-1] + Pd[2:, 1:-1] + Pd[1:-1, :-2]
                   + Pd[1:-1, 2:] - 4 * U)
            return (alpha / h ** 2 * lap).reshape(-1)

        ij = np.indices((m, n))
        u0 = np.sin(np.pi * (ij[0] + 1) / (m + 1)) \
            * np.sin(np.pi * (ij[1] + 1) / (n + 1))
        u0 = u0.reshape(-1)

        cfg = TSConfig(ts_type="beuler", dt=1e-3, max_steps=5,
                       max_time=5e-3,
                       ksp=KSPConfig(ksp_type="cg", rtol=1e-10,
                                     maxits=500))
        rs = ts_solve(rhs_serial, jnp.asarray(u0), cfg=cfg, jac="jvp")

        plan = ShardedFDJac.plan((m, n), STAR5, P)
        rp = par_ts_solve(mesh8(), rhs_sharded, u0, cfg=cfg, jac=plan)
        assert int(rp.steps) == int(rs.steps)
        np.testing.assert_allclose(np.asarray(rp.u), np.asarray(rs.u),
                                   rtol=1e-8, atol=1e-10)


def unshard_layoutless(x, ntrue):
    return np.asarray(x)[:ntrue]
