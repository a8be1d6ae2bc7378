"""Smoke run of the solver stack's main path on one GPU.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # 4 cards: distributed solves only

Phases (one process, one card), each a function of its size so the CPU
tests can run it small:

  formats   every device format's mult (and multT where it exists)
            against scipy's fp64 A @ x, fp32 and fp64
  ksp_mg    ex45 3-D Poisson, CG + geometric MG (pc_mg_da), fp64
  ksp_gamg  ex55 2-D elasticity, -mat_type auto, CG + GAMG with
            rigid-body modes, fp64 and fp32
  ksp_ilu   ex45 3-D Poisson, CG + BJacobi(ILU0, RCM), fp32 and fp64
  snes      ex5 Bratu through SNES(options), fp64
  golden    ksp ex2_1 with -ksp_monitor_short against output/ex2_1.out

Every phase prints one JSON line with the card's name and power limit,
its sizes, host setup, compile and solve seconds (solves end in
block_until_ready), iterations, converged reason, the true relative
residual ||b - A x|| / ||b|| computed by scipy in fp64 on the host, and
the device's peak_bytes_in_use so far. A failed check raises. The last
line of standard output is the run's result:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

The script needs a GPU: it exits non-zero, printing no result, when JAX
finds none.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time

import numpy as np

from bench import card_name_and_power, scrambled_27pt, timed

FP32_FORMAT_TOL = 1e-5      # TF32 products land near 1e-3
FP64_FORMAT_TOL = 1e-12
# one fp32 preconditioner application against the fp64 one built from
# the same host hierarchy: only fp32 rounding separates them (TF32
# products land near 1e-3)
FP32_PC_TOL = 1e-5
# fp32 CG may take more iterations than fp64 to the same rtol (its
# rounding erodes conjugacy); a preconditioner weakened by a wrong
# level kernel or transfer costs far more
FP32_ITS_SLACK = 1.5


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------
class Reporter:
    """Prints one JSON line per case, tagged with the card."""

    def __init__(self, card: str):
        self.card = card

    def __call__(self, phase: str, **fields):
        import jax
        stats = jax.devices()[0].memory_stats() or {}
        rec = {"phase": phase, "card": self.card, **fields,
               "peak_bytes_in_use": stats.get("peak_bytes_in_use")}
        print(json.dumps(rec), flush=True)
        return rec


def _relres(A, x, b) -> float:
    b = np.asarray(b, np.float64)
    r = b - A @ np.asarray(x, np.float64)
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def _check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# formats
# ---------------------------------------------------------------------------
def _stencil7(g: int, rng):
    """Variable-coefficient 3-D 7-point operator on a g³ grid, as
    StencilMat coefficients [7, g, g, g] and as scipy CSR."""
    import scipy.sparse as sp
    offs = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
            (0, 0, -1), (0, 0, 1))
    C = rng.uniform(-1.0, 1.0, (7, g, g, g))
    C[0] += 8.0
    idx = np.arange(g)
    rows, cols, vals = [], [], []
    flat = np.arange(g ** 3).reshape(g, g, g)
    for k, off in enumerate(offs):
        ok = np.ones((g, g, g), bool)
        for ax, o in enumerate(off):
            shape = [1, 1, 1]
            shape[ax] = g
            inside = ((idx + o >= 0) & (idx + o < g)).reshape(shape)
            ok &= inside
        C[k][~ok] = 0.0
        rows.append(flat[ok])
        cols.append(flat[ok] + off[0] * g * g + off[1] * g + off[2])
        vals.append(C[k][ok])
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(g ** 3, g ** 3))
    return C, offs, A


def _mult_error(M, A, x, dtype, transpose=False):
    """(||y - y_ref||_inf / || |A| |x| ||_inf, compile seconds, mult
    seconds) with y_ref = A x from the SAME rounded values in fp64 on
    the host; the first call compiles, the second is timed."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp
    Ar = sp.csr_matrix(A).astype(dtype).astype(np.float64)
    if transpose:
        Ar = Ar.T.tocsr()
    xr = np.asarray(x, dtype).astype(np.float64)
    # M goes in as an argument: closed over, its arrays would be baked
    # into the program as constants
    f = jax.jit(lambda M, v: M.multT(v) if transpose else M.mult(v))
    xd = jnp.asarray(xr.astype(dtype))
    _, first_s = timed(lambda: f(M, xd))
    y, mult_s = timed(lambda: f(M, xd))
    y = np.asarray(y, np.float64)
    yref = Ar @ xr
    scale = np.max(abs(Ar) @ np.abs(xr))
    err = float(np.max(np.abs(y.reshape(-1) - yref)) / scale)
    return err, max(first_s - mult_s, 0.0), mult_s


def phase_formats(report, stencil_g=256, irr_g=64, band_m=1024,
                  baij_ne=512, dense_n=4096,
                  dtypes=("float32", "float64")):
    import jax.numpy as jnp
    import scipy.sparse as sp

    from petsctpu.core.options import Options
    from petsctpu.mat import aij_from_scipy, baij_from_scipy_bsr
    from petsctpu.mat.dense import Dense
    from petsctpu.mat.factory import mat_from_options
    from petsctpu.mat.sell import sell_from_scipy
    from petsctpu.mat.stencil import StencilMat
    from petsctpu.models import laplacian_2d
    from petsctpu.models.elasticity import ex55_system

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    C7, offs7, A7 = _stencil7(stencil_g, rng)
    A27 = scrambled_27pt(irr_g, rng)
    A5 = laplacian_2d(band_m, band_m).tocsr()
    A55 = ex55_system(baij_ne)[0]
    Ad = sp.csr_matrix(rng.standard_normal((dense_n, dense_n)))
    host_s = time.perf_counter() - t0

    def builders(dt):
        yield ("StencilMat", f"7-point {stencil_g}^3", A7,
               lambda: StencilMat(jnp.asarray(C7.astype(dt)), offs7,
                                  (stencil_g,) * 3))
        yield ("AIJ", f"scrambled 27-point {irr_g}^3, RCM", A27,
               lambda: aij_from_scipy(A27, dtype=dt))
        if dt == np.float32:     # SellMat is fp32 only
            yield ("SellMat", f"scrambled 27-point {irr_g}^3, RCM", A27,
                   lambda: sell_from_scipy(A27))
            yield ("SellMat[chunk]", f"scrambled 27-point {irr_g}^3, RCM",
                   A27, lambda: sell_from_scipy(A27, mode="chunk"))
        yield ("auto", f"5-point {band_m}^2", A5,
               lambda: mat_from_options(A5, mat_type="auto", dtype=dt))
        yield ("band", f"5-point {band_m}^2, natural ordering", A5,
               lambda: mat_from_options(
                   A5, Options({"mat_type": "band",
                                "mat_ordering_type": "natural"}),
                   dtype=dt))
        yield ("BAIJ", f"ex55 ne={baij_ne}, bs=2", A55,
               lambda: baij_from_scipy_bsr(A55, bs=2, dtype=dt))
        yield ("Dense", f"{dense_n}^2", Ad,
               lambda: Dense(jnp.asarray(Ad.toarray().astype(dt))))

    for dname in dtypes:
        dt = np.dtype(dname).type
        tol = FP32_FORMAT_TOL if dt == np.float32 else FP64_FORMAT_TOL
        for fmt, case, A, build in builders(dt):
            t0 = time.perf_counter()
            M = build()
            perm = None
            if isinstance(M, tuple):            # mat_from_options
                M, perm = M
            setup_s = time.perf_counter() - t0
            Ap = A if perm is None else sp.csr_matrix(A)[perm][:, perm]
            x = rng.standard_normal(A.shape[1])
            err, compile_s, mult_s = _mult_error(M, Ap, x, dt)
            errT = None
            if hasattr(M, "multT") and fmt != "SellMat":
                errT = _mult_error(M, Ap, rng.standard_normal(A.shape[0]),
                                   dt, transpose=True)[0]
            report("formats", format=type(M).__name__, requested=fmt,
                   case=case, n=A.shape[0], nnz=int(A.nnz), dtype=dname,
                   host_build_s=host_s, setup_s=setup_s,
                   compile_s=compile_s, mult_s=mult_s, err_mult=err,
                   err_multT=errT, tol=tol)
            _check(err <= tol, f"{fmt} mult error {err} > {tol} ({dname})")
            _check(errT is None or errT <= tol,
                   f"{fmt} multT error {errT} > {tol} ({dname})")
            del M


# ---------------------------------------------------------------------------
# Krylov phases
# ---------------------------------------------------------------------------
def _ksp_case(report, phase, case, A_dev, A_host, b, opts, dtype,
              setup_extra_s=0.0, floor=0.0):
    """Set up a KSP from options, solve twice (the first call compiles),
    and hold the true residual to 2*rtol. `floor` is the residual the
    dtype can resolve on this system, computed by the caller from a
    fixed reference (never from this solve's output); where it reaches
    rtol the residual is only reported, and the caller checks the
    solve by other means. Returns (record, result, ksp)."""
    import jax.numpy as jnp

    from petsctpu.ksp import KSP
    t0 = time.perf_counter()
    ksp = KSP(options=opts)
    ksp.set_operators(A_dev, A_host=A_host)
    ksp.set_from_options()
    ksp.setup()
    setup_s = time.perf_counter() - t0 + setup_extra_s
    bj = jnp.asarray(np.asarray(b, dtype))
    res, first_s = timed(lambda: ksp.solve(bj))
    res, solve_s = timed(lambda: ksp.solve(bj))
    relres = _relres(A_host, res.x, b)
    rtol = ksp.cfg.rtol
    levels = getattr(ksp.pc, "levels", None)
    rec = report(phase, case=case, n=A_host.shape[0],
                 dtype=np.dtype(dtype).name, ksp=ksp.cfg.ksp_type,
                 pc=type(ksp.pc).__name__,
                 operator=type(A_dev).__name__,
                 level_operators=None if levels is None
                 else [type(lev.A).__name__ for lev in levels],
                 norm=ksp.cfg.norm_type, setup_s=setup_s,
                 compile_s=max(first_s - solve_s, 0.0), solve_s=solve_s,
                 its=int(res.its), reason=int(res.reason),
                 true_relres=relres, rtol=rtol, residual_floor=floor,
                 residual_checked=floor < rtol)
    _check(int(res.reason) > 0, f"{phase} {case}: reason {int(res.reason)}")
    _check(floor >= rtol or relres <= 2 * rtol,
           f"{phase} {case}: true residual {relres} > 2*rtol")
    return rec, res, ksp


def phase_ksp_mg(report, g=257):
    """ex45: 3-D 7-point Poisson on a g³ grid (g = 2^k + 1 so the DA
    coarsens to the bottom), fp64, CG + geometric MG, the route
    examples/ex45.py takes."""
    from petsctpu.core.options import Options
    from petsctpu.dm import DA
    from petsctpu.mat import aij_from_scipy
    from petsctpu.models import ex45_system

    t0 = time.perf_counter()
    A, b, _ = ex45_system(g, g, g)
    Ad = aij_from_scipy(A)
    host_s = time.perf_counter() - t0
    opts = Options({"ksp_type": "cg", "pc_type": "mg",
                    "pc_mg_da": DA((g, g, g)), "ksp_rtol": 1e-8,
                    "ksp_norm_type": "unpreconditioned"})
    _ksp_case(report, "ksp_mg", f"ex45 {g}^3", Ad, A, b, opts,
              np.float64, setup_extra_s=host_s)


def phase_ksp_gamg(report, ne=1024):
    """ex55 2-D Q1 elasticity with a soft inclusion, -mat_type auto,
    CG + GAMG (smoothed aggregation on the rigid-body modes): fp64 to
    rtol 1e-8, then fp32 to rtol 1e-4.

    fp32 cannot resolve this system's residual: evaluating A x* in
    fp32, with x* the fp64 solution, errs by eps32*|| |A||x*| ||, which
    grows like the condition number (h^-2 times the 1e3 contrast) and
    passes ||b|| near ne=1024. Where that floor reaches rtol, the fp32
    run is held instead to (a) one application of its preconditioner
    matching the fp64 one on the same vector to FP32_PC_TOL (both come
    from the same host hierarchy and host eigenvalue estimates, so a
    wrong level operator, transfer or TF32 product shows there), and
    (b) its iteration count within FP32_ITS_SLACK of the fp64 solve to
    the same rtol."""
    from dataclasses import replace

    import jax
    import jax.numpy as jnp

    from petsctpu.core.options import Options
    from petsctpu.ksp import ksp_solve
    from petsctpu.mat.factory import mat_from_options
    from petsctpu.models.elasticity import ex55_system

    A, b, coords = ex55_system(ne)
    case = f"ex55 ne={ne}"
    runs = {}
    for dt, rtol in ((np.float64, 1e-8), (np.float32, 1e-4)):
        t0 = time.perf_counter()
        Ad, perm = mat_from_options(A, Options({"mat_type": "auto"}),
                                    dtype=dt)
        # the coordinates pair with dofs in the natural ordering
        _check(perm is None, f"ksp_gamg: auto reordered ex55 ({Ad})")
        host_s = time.perf_counter() - t0
        o = Options({"ksp_type": "cg", "pc_type": "gamg",
                     "ksp_norm_type": "unpreconditioned", "ksp_rtol": rtol,
                     "ksp_max_it": 500, "pc_gamg_dof": 2,
                     "pc_gamg_coordinates": coords})
        floor = 0.0
        if dt == np.float32:
            x64 = np.abs(np.asarray(runs[np.float64][1].x, np.float64))
            floor = float(np.finfo(np.float32).eps
                          * np.linalg.norm(abs(A) @ x64) / np.linalg.norm(b))
        _, res, ksp = _ksp_case(report, "ksp_gamg", case, Ad, A, b, o, dt,
                                setup_extra_s=host_s, floor=floor)
        runs[dt] = (ksp, res, Ad)

    ksp64, _, Ad64 = runs[np.float64]
    ksp32, res32, _ = runs[np.float32]
    res64 = ksp_solve(Ad64, jnp.asarray(b), pc=ksp64.pc,
                      cfg=replace(ksp64.cfg, rtol=ksp32.cfg.rtol))
    v = np.random.default_rng(1).standard_normal(b.shape[0])
    apply = jax.jit(lambda pc, v: pc.apply(v))
    y64 = np.asarray(apply(ksp64.pc, jnp.asarray(v)))
    y32 = np.asarray(apply(ksp32.pc, jnp.asarray(v, jnp.float32)),
                     np.float64)
    pc_diff = float(np.linalg.norm(y32 - y64) / np.linalg.norm(y64))
    its32, its64 = int(res32.its), int(res64.its)
    report("ksp_gamg", case=case, check="fp32 against fp64",
           rtol=ksp32.cfg.rtol, pc_apply_rel_diff=pc_diff,
           pc_apply_tol=FP32_PC_TOL, its_fp32=its32,
           its_fp64_same_rtol=its64, reason_fp64_same_rtol=int(res64.reason),
           its_slack=FP32_ITS_SLACK)
    _check(pc_diff <= FP32_PC_TOL,
           f"ksp_gamg: fp32 PC apply differs from fp64 by {pc_diff}")
    _check(int(res64.reason) > 0 and its32 <= FP32_ITS_SLACK * its64,
           f"ksp_gamg: fp32 {its32} its vs fp64 {its64} to the same rtol")


def phase_ksp_ilu(report, g=96, dtypes=("float32", "float64")):
    """ex45 Poisson, CG + BJacobi(8 blocks, ILU0 on RCM-ordered
    blocks): fp32 takes the band2 tile solves, fp64 the level-scheduled
    triangular solves."""
    from petsctpu.core.options import Options
    from petsctpu.mat import aij_from_scipy
    from petsctpu.models import ex45_system

    A, b, _ = ex45_system(g, g, g)
    for dname in dtypes:
        dt = np.dtype(dname).type
        opts = Options({"ksp_type": "cg", "pc_type": "bjacobi",
                        "pc_bjacobi_blocks": 8, "sub_pc_type": "ilu",
                        "sub_pc_factor_mat_ordering_type": "rcm",
                        "ksp_norm_type": "unpreconditioned",
                        "ksp_rtol": 1e-8 if dt == np.float64 else 1e-4,
                        "ksp_max_it": 2000})
        _ksp_case(report, "ksp_ilu", f"ex45 {g}^3",
                  aij_from_scipy(A, dtype=dt), A, b, opts, dt)


def _bratu_residual_host(u, m, lam):
    """Plain numpy ex5 residual (same scaling as models/bratu.py)."""
    h = 1.0 / (m - 1)
    U = u.reshape(m, m)
    F = (2.0 * (1.0 + 1.0)) * U            # boundary rows: 2(hy/hx+hx/hy)u
    Ub = U.copy()
    Ub[0, :] = Ub[-1, :] = Ub[:, 0] = Ub[:, -1] = 0.0
    In = U[1:-1, 1:-1]
    F[1:-1, 1:-1] = ((2 * In - Ub[:-2, 1:-1] - Ub[2:, 1:-1])
                     + (2 * In - Ub[1:-1, :-2] - Ub[1:-1, 2:])
                     - lam * h * h * np.exp(In))
    return F.reshape(-1)


def phase_snes(report, m=513, lam=6.0):
    """ex5 Bratu on an m×m grid through SNES(options): Newton with a
    matrix-free (jvp) Jacobian and unpreconditioned CG."""
    from petsctpu.core.options import Options
    from petsctpu.dm import DA
    from petsctpu.models.bratu import bratu_initial_guess, bratu_residual
    from petsctpu.snes import SNES

    da = DA((m, m))
    opts = Options({"snes_rtol": 1e-8, "ksp_type": "cg",
                    "ksp_max_it": 5000})
    t0 = time.perf_counter()
    snes = SNES(options=opts)
    snes.set_function(bratu_residual(da, lam))
    x0 = bratu_initial_guess(da, lam)
    setup_s = time.perf_counter() - t0
    res, first_s = timed(lambda: snes.solve(x0))
    res, solve_s = timed(lambda: snes.solve(x0))
    f0 = np.linalg.norm(_bratu_residual_host(np.asarray(x0), m, lam))
    f = np.linalg.norm(_bratu_residual_host(np.asarray(res.x), m, lam))
    rtol = 1e-8
    report("snes", case=f"ex5 {m}^2 lambda={lam}", n=m * m,
           dtype="float64", setup_s=setup_s,
           compile_s=max(first_s - solve_s, 0.0), solve_s=solve_s,
           its=int(res.its), reason=int(res.reason),
           true_relres=float(f / f0), rtol=rtol)
    _check(int(res.reason) > 0, f"snes: reason {int(res.reason)}")
    _check(f / f0 <= 2 * rtol, f"snes: ||F||/||F0|| {f / f0} > 2*rtol")


EX2_1_GOLDEN = ("  0 KSP Residual norm 3.21109 \n"
                "  1 KSP Residual norm 0.93268 \n"
                "  2 KSP Residual norm 0.103515 \n"
                "  3 KSP Residual norm 0.00787798 \n"
                "  4 KSP Residual norm 0.000387275 \n"
                "Norm of error 0.000392701 iterations 4\n")


def phase_golden(report):
    """ksp ex2_1: -m 5 -n 5, GMRES + ILU(0), refine_always,
    -ksp_monitor_short, against the reference's output/ex2_1.out. The
    golden uses the preconditioned norm, so the true residual is
    printed, not held to 2*rtol."""
    import jax
    import jax.numpy as jnp

    from petsctpu.core.errors import ConvergedReason
    from petsctpu.core.options import Options
    from petsctpu.ksp import KSP
    from petsctpu.mat import aij_from_scipy
    from petsctpu.models import ex2_system

    A, b, u = ex2_system(5, 5)
    opts = Options({"ksp_type": "gmres", "pc_type": "ilu",
                    "ksp_monitor_short": None, "ksp_rtol": 1e-2 / 36,
                    "ksp_atol": 1e-50,
                    "ksp_gmres_cgs_refinement_type": "refine_always"})
    t0 = time.perf_counter()
    ksp = KSP(options=opts)
    ksp.set_operators(aij_from_scipy(A), A_host=A)
    ksp.set_from_options()
    ksp.setup()
    setup_s = time.perf_counter() - t0
    bj = jnp.asarray(b)
    texts, times = [], []
    for _ in range(2):                 # the first call compiles
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res, t = timed(lambda: ksp.solve(bj))
            jax.effects_barrier()
        texts.append(buf.getvalue())
        times.append(t)
    err = np.linalg.norm(np.asarray(res.x) - u)
    text = texts[0] + f"Norm of error {err:g} iterations {int(res.its)}\n"
    report("golden", case="ex2_1", n=A.shape[0], dtype="float64",
           setup_s=setup_s, compile_s=max(times[0] - times[1], 0.0),
           solve_s=times[1], its=int(res.its), reason=int(res.reason),
           true_relres=_relres(A, res.x, b),
           text_matches=text == EX2_1_GOLDEN)
    _check(int(res.its) == 4, f"golden: its {int(res.its)} != 4")
    _check(int(res.reason) == int(ConvergedReason.CONVERGED_RTOL),
           f"golden: reason {int(res.reason)}")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------
def _poisson_stencil7(grid):
    """Constant-coefficient 3-D 7-point Dirichlet Laplacian as host
    StencilMat coefficients [7, *grid]."""
    offs = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
            (0, 0, -1), (0, 0, 1))
    C = np.zeros((7,) + tuple(grid))
    C[0] = 6.0
    for k, off in enumerate(offs[1:], start=1):
        sl = tuple(slice(1, None) if o < 0 else slice(0, -1) if o > 0
                   else slice(None) for o in off)
        C[k][sl] = -1.0
    return C, offs


def _assert_spread(tree, ndev: int, platform: str):
    import jax
    for leaf in jax.tree.leaves(tree):
        devs = leaf.sharding.device_set
        _check(len(devs) == ndev and
               all(d.platform == platform for d in devs),
               f"operand on {sorted(d.id for d in devs)}, "
               f"want {ndev} {platform} devices")


def phase_four_cards(report, stencil_grid=(512, 128, 128), aij_g=160,
                     gamg_m=2896, ndev=4):
    """The distributed path on a ("rows",) mesh of `ndev` cards, each
    solve compared with the same global solve on one card: iterations
    within 1, solutions within 1e-6 relative. Default sizes give each
    card 2.1M stencil rows, 1.0M AIJ rows and 2.1M GAMG rows."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from petsctpu.core.options import Options
    from petsctpu.ksp import KSP, ksp_solve
    from petsctpu.mat import aij_from_scipy
    from petsctpu.mat.stencil import StencilMat
    from petsctpu.models import laplacian_2d, poisson_3d
    from petsctpu.parallel import (par_ksp_solve, sharded_aij_from_scipy,
                                   sharded_stencil_from)
    from petsctpu.parallel.api import operator_specs, place_on_mesh
    from petsctpu.pc import make_pc
    from petsctpu.pc.distmg import make_dist_gamg
    from petsctpu.pc.parallel import make_par_pc

    devs = jax.devices()
    _check(len(devs) >= ndev, f"needs {ndev} devices, found {len(devs)}")
    mesh = Mesh(np.array(devs[:ndev]), ("rows",))
    platform = devs[0].platform
    rng = np.random.default_rng(0)

    def compare(case, n, solve_multi, solve_one, operands):
        t0 = time.perf_counter()
        placed = operands()
        setup_s = time.perf_counter() - t0
        _assert_spread(placed, ndev, platform)
        r4, first4 = timed(lambda: solve_multi(*placed))
        r4, t4 = timed(lambda: solve_multi(*placed))
        r1, first1 = timed(solve_one)
        r1, t1 = timed(solve_one)
        x4 = np.asarray(r4.x)[:n]
        x1 = np.asarray(r1.x).reshape(-1)[:n]
        diff = float(np.linalg.norm(x4 - x1) / np.linalg.norm(x1))
        report("four_cards", case=case, n=n, dtype="float64", ndev=ndev,
               setup_s=setup_s, compile_s=max(first4 - t4, 0.0),
               solve_s=t4, its=int(r4.its), reason=int(r4.reason),
               one_card_solve_s=t1, one_card_its=int(r1.its),
               one_card_reason=int(r1.reason), rel_diff=diff)
        _check(int(r4.reason) > 0 and int(r1.reason) > 0,
               f"{case}: reasons {int(r4.reason)}, {int(r1.reason)}")
        _check(abs(int(r4.its) - int(r1.its)) <= 1,
               f"{case}: its {int(r4.its)} vs {int(r1.its)}")
        _check(diff <= 1e-6, f"{case}: solutions differ by {diff}")

    # 1) CG and PIPECG on a sharded 3-D Poisson stencil
    C, offs = _poisson_stencil7(stencil_grid)
    n = int(np.prod(stencil_grid))
    b = rng.standard_normal(n)
    S1 = StencilMat(jnp.asarray(C), offs, tuple(stencil_grid))
    for kt in ("cg", "pipecg"):
        def operands():
            Sh = sharded_stencil_from(StencilMat(C, offs,
                                                 tuple(stencil_grid)), ndev)
            Sh = place_on_mesh(mesh, Sh, operator_specs(Sh, "rows"))
            bp = np.zeros(Sh.shape[0])
            bp[:n] = b
            bs = jax.device_put(jnp.asarray(bp),
                                NamedSharding(mesh, P("rows")))
            return Sh, bs
        cfg = dict(ksp_type=kt, rtol=1e-10, maxits=20000,
                   norm_type="unpreconditioned")
        compare(f"{kt} stencil {stencil_grid}", n,
                lambda Sh, bs, cfg=cfg: par_ksp_solve(mesh, Sh, bs, **cfg),
                lambda cfg=cfg: ksp_solve(S1, jnp.asarray(b), **cfg),
                operands)
    del S1

    # 2) GMRES + block Jacobi (ILU0 per shard) on a sharded AIJ
    A = poisson_3d(aij_g, aij_g, aij_g)
    n = A.shape[0]
    b = rng.standard_normal(n)

    def operands_bj():
        Ash, part = sharded_aij_from_scipy(A, ndev)
        pc = make_par_pc("bjacobi", Ash, part)
        Ash = place_on_mesh(mesh, Ash, operator_specs(Ash, "rows"))
        pc = place_on_mesh(mesh, pc, operator_specs(pc, "rows"))
        return Ash, pc

    ksp1 = KSP(Options({"ksp_type": "gmres", "pc_type": "bjacobi",
                        "pc_bjacobi_blocks": ndev, "sub_pc_type": "ilu",
                        "ksp_rtol": 1e-10}))
    ksp1.set_operators(aij_from_scipy(A), A_host=A)
    compare(f"gmres+bjacobi poisson {aij_g}^3", n,
            lambda Ash, pc: par_ksp_solve(mesh, Ash, b, pc=pc,
                                          ksp_type="gmres", rtol=1e-10),
            lambda: ksp1.solve(jnp.asarray(b)), operands_bj)
    del ksp1

    # 3) CG + distributed GAMG against serial GAMG
    A = laplacian_2d(gamg_m, gamg_m).tocsr()
    n = A.shape[0]
    b = rng.standard_normal(n)

    def operands_gamg():
        pc = make_dist_gamg(A, ndev)
        pc = place_on_mesh(mesh, pc, pc.shard_specs("rows"))
        return pc.A, pc

    Ad = aij_from_scipy(A)
    pc1 = make_pc("gamg", A=Ad, A_host=A)
    compare(f"cg+gamg laplacian {gamg_m}^2", n,
            lambda Ash, pc: par_ksp_solve(mesh, Ash, b, pc=pc,
                                          ksp_type="cg", rtol=1e-10),
            lambda: ksp_solve(Ad, jnp.asarray(b), pc=pc1, ksp_type="cg",
                              rtol=1e-10), operands_gamg)


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the distributed path on 4 GPUs and "
                         "its one-card comparison")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_enable_x64", True)
    import petsctpu
    from petsctpu import native

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2

    card = card_name_and_power()
    print(f"card: {card}")
    print(f"device_kind: {dev.device_kind}")
    print(f"jax: {jax.__version__}")
    print(f"matmul_precision: {jax.config.jax_default_matmul_precision}")
    print(f"compile_cache: {jax.config.jax_compilation_cache_dir}")
    print(f"native_plan_library: {native.available()}")
    print(f"petsctpu: {petsctpu.__version__}", flush=True)
    report = Reporter(card.splitlines()[0])

    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(report)
    else:
        for phase in (phase_formats, phase_ksp_mg, phase_ksp_gamg,
                      phase_ksp_ilu, phase_snes, phase_golden):
            phase(report)
    print(f"total_s: {time.perf_counter() - t0:.1f}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
