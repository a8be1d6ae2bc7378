"""Time-to-solution: geometric-MG-preconditioned CG on the big Poisson.

The reference's lap2d benchmark solves the 1000² Laplacian with
unpreconditioned GMRES(30) — 500 iterations, 455 s on 2 SP2 procs
(1996). A solver framework's real figure of merit is time-to-solution
with its best preconditioner: here CG + geometric multigrid
(V-cycles, Chebyshev+Jacobi smoothers, Galerkin coarse operators,
matrix-free Q1 transfers) on the 1025² grid (2^k+1 for the vertex
hierarchy). Prints one JSON line, naming the card, with the solve time
(best of three calls ending in block_until_ready) and the equivalent
figure for the reference workload.

Setup runs the DEVICE path (pc/mg.make_geometric_mg_device): the whole
hierarchy — comb-probe Galerkin PtAP, Jacobi diagonals, Chebyshev
power-iteration bounds — is ONE jitted program, so operator rebuilds
(the Newton/TS case) cost one dispatch. Both first-build and rebuild
setup times are reported.
"""

from __future__ import annotations

import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from bench import best_time, card_name_and_power
    from petsctpu.core.hostmem import prefault
    from petsctpu.core.options import Options
    from petsctpu.dm.da import DA
    from petsctpu.ksp import ksp_solve
    from petsctpu.mat.stencil import stencil_from_scipy
    from petsctpu.models import laplacian_2d
    from petsctpu.pc import make_pc

    prefault()
    m = 1025
    dtype = np.float32
    t0 = time.perf_counter()
    Ah = laplacian_2d(m, m)
    Ad = stencil_from_scipy(Ah.astype(dtype), (m, m), dtype=dtype)
    jax.block_until_ready(Ad.coeffs)
    t_build = time.perf_counter() - t0

    def build_pc():
        t0 = time.perf_counter()
        pc = make_pc("mg", A=Ad, options=Options({"pc_mg_da": DA((m, m))}))
        jax.block_until_ready(pc.levels[-1].A.coeffs)
        return time.perf_counter() - t0, pc

    t_setup, pc = build_pc()
    t_resetup, pc = build_pc()     # compiled-program reuse (Newton rebuild)
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal(m * m).astype(dtype))

    kw = dict(pc=pc, ksp_type="cg", rtol=1e-5, maxits=60)

    res = ksp_solve(Ad, b, **kw)
    its = int(res.its)

    t_solve = best_time(lambda: ksp_solve(Ad, b, **kw).x)
    card = card_name_and_power()
    dev = jax.devices()[0]
    print(f"MG-CG 1025^2 Poisson: rtol 1e-5 in {its} its, "
          f"{t_solve * 1e3:.1f} ms on {card} (setup {t_setup:.1f} s first / "
          f"{t_resetup * 1e3:.0f} ms rebuild, operator build {t_build:.1f} s);"
          f" reference lap2d workload: 500 GMRES its, 38.63 s on 32 SP2 "
          f"procs")
    print(json.dumps({
        "metric": "mg_cg_1025sq_solve_ms",
        "value": t_solve * 1e3,
        "unit": "ms",
        "vs_baseline": 38.63 / t_solve,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
        "detail": {"its": its, "setup_s": t_setup,
                   "resetup_ms": t_resetup * 1e3,
                   "converged": bool(res.converged)}}))


if __name__ == "__main__":
    main()
