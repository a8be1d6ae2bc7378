"""The reference's headline single-chip benchmark, reproduced.

Reference: src/benchmarks/results/performance_medium — ex10 on the
"medium" matrix (bs=3 BAIJ, n≈1e4), GMRES(unmodified GS)+ILU(0),
1 processor; the published MFlop/s rows are MatMult 30-108, MatSolve
21-93, VecMDot 22-73, SLESSolve total 18-66 (1996 hardware).

This driver builds an equivalent bs=3 blocked system (elasticity-like
coupling on a 2-D grid), runs the same solver configuration, times
each event on-device with the loop-delta method, and prints the same
table. Each event is timed as N chained calls inside one jitted loop,
on the host clock around a call that ends in block_until_ready (best
of three). One JSON summary line at the end names the card.
"""

from __future__ import annotations

import json
import sys

sys.path.insert(0, ".")

import numpy as np
import scipy.sparse as sp


def build_medium(gx=60, gy=60, bs=3, dtype=np.float32, seed=0):
    """bs=3 block system, n = gx*gy*bs ≈ the reference matrix's 1e4."""
    from petsctpu.models import laplacian_2d
    rng = np.random.default_rng(seed)
    L = laplacian_2d(gx, gy)
    nb = gx * gy
    blocks = rng.standard_normal((nb, bs, bs)) * 0.2
    Bd = sp.block_diag([np.eye(bs) * 2 + 0.5 * (b + b.T) for b in blocks])
    A = sp.csr_matrix(sp.kron(L, np.eye(bs)) + Bd).astype(dtype)
    return A


def main():
    import jax
    import jax.numpy as jnp
    from jax import lax

    from bench import best_time, card_name_and_power

    from petsctpu.mat import baij_from_scipy_bsr
    from petsctpu.pc import make_pc
    from petsctpu.ksp import ksp_solve

    dtype = np.float32
    A = build_medium(dtype=dtype)
    n = A.shape[0]
    Ab = baij_from_scipy_bsr(A, bs=3, dtype=dtype)
    from petsctpu.core.options import Options
    pc = make_pc("ilu", A=Ab, A_host=A,
                 options=Options({"pc_factor_tri_solve": "band2"}))
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal(n).astype(dtype))
    V = jnp.asarray(rng.standard_normal((31, n)).astype(dtype))

    rows = []

    def event(name, flops, run_one, iters=200):
        @jax.jit
        def chain(v):
            def body(_, v):
                return run_one(v) * np.float32(0.5)
            return lax.fori_loop(0, iters, body, v)

        dt = best_time(chain, x) / iters
        rows.append((name, dt, flops, flops / dt / 1e6))

    nnz = A.nnz
    event("MatMult", 2.0 * nnz - n, lambda v: Ab.mult(v))
    event("MatSolve", 2.0 * nnz - n, lambda v: pc.apply(v))
    event("VecMDot", 2.0 * 31 * n,
          lambda v: (V @ v) @ V / jnp.float32(31.0), iters=10000)
    event("VecNorm", 2.0 * n,
          lambda v: v * jnp.linalg.norm(v) / jnp.float32(n),
          iters=10000)
    # coefficients must depend on the carry or XLA hoists the V
    # combination out of the timing loop entirely
    event("VecMAXPY", 2.0 * 31 * n,
          lambda v: v + (v[:31] * np.float32(1e-9)) @ V, iters=10000)

    # full GMRES(30)+ILU solve (the SLESSolve row): a fixed iteration
    # count (rtol→0 disables convergence)
    b = jnp.asarray((A @ rng.standard_normal(n)).astype(dtype))
    kw = dict(pc=pc, ksp_type="gmres", restart=30, rtol=1e-30, atol=1e-30,
              orth="cgs")
    n_its = 120
    t_iter = best_time(lambda: ksp_solve(Ab, b, maxits=n_its, **kw).x) \
        / n_its
    # analytic flops per iteration (reference convention): MatMult +
    # MatSolve (≈2nnz) + CGS orthogonalization + vector updates
    iter_flops = 2.0 * (2 * nnz - n) + 2.0 * 31 * n + 8.0 * n
    rows.append(("KSPSolve(GMRES30+ILU0)", t_iter, iter_flops,
                 iter_flops / t_iter / 1e6))
    res = ksp_solve(Ab, b, pc=pc, ksp_type="gmres", restart=30, rtol=1e-7,
                    maxits=300, orth="cgs")

    card = card_name_and_power()
    dev = jax.devices()[0]
    print(f"card: {card}")
    print(f"medium-analog: n={n}, nnz={nnz}, bs=3, fp32, "
          f"its={int(res.its)}, reason={int(res.reason)}")
    print(f"{'Event':24s} {'s/call':>12s} {'MFlop/s':>12s}   "
          f"(reference 1996: MatMult 30-108, MatSolve 21-93, "
          f"VecMDot 22-73, total 18-66)")
    for name, dt, fl, mf in rows:
        print(f"{name:24s} {dt:12.3e} {mf:12.1f}")
    best = {name: mf for name, _, _, mf in rows}
    print(json.dumps({"metric": "medium_matmult_mflops",
                      "value": best["MatMult"],
                      "unit": "MFlop/s",
                      "vs_baseline": best["MatMult"] / 108.0,
                      "device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": len(jax.devices()),
                                 "card": card},
                      "detail": best}))


if __name__ == "__main__":
    main()
