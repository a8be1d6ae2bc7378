"""The reference's lap2d strong-scaling workload on one chip.

Reference: src/benchmarks/results/lap2d.m — 2-D Laplacian on a
1000×1000 grid, GMRES(30) with no preconditioner, 500 iterations.
Published numbers (1996): MatMult total 95.54 s on 2 IBM SP2 procs
(6.88 s on 32); full KSP solve 455.5 s on 2 procs (38.63 s on 32).

Here the same 500-iteration solve runs on one GPU with the operator in
stencil (DIA) layout, timed around calls that end in block_until_ready
(best of three after a warm-up). Prints one JSON line naming the card.
"""

from __future__ import annotations

import json
import sys

sys.path.insert(0, ".")

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from bench import best_time, card_name_and_power
    from petsctpu.ksp import ksp_solve
    from petsctpu.mat.stencil import StencilMat

    m = 1000
    n = m * m
    dtype = np.float32
    C = np.zeros((5, m, m), dtype)
    C[0] = 4.0
    C[1, 1:, :] = -1.0
    C[2, :-1, :] = -1.0
    C[3, :, 1:] = -1.0
    C[4, :, :-1] = -1.0
    A = StencilMat(jnp.asarray(C),
                   ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)), (m, m))
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal(n).astype(dtype))

    kw = dict(ksp_type="gmres", restart=30, rtol=1e-30, atol=1e-30,
              orth="cgs")

    t500 = best_time(lambda: ksp_solve(A, b, maxits=500, **kw).x)
    t_iter = t500 / 500.0

    nnz = 5 * n - 4 * m                       # boundary-clipped stencil
    matmult_total = 500.0 * (2.0 * nnz - n) / (t_iter * 500.0) / 1e6
    card = card_name_and_power()
    dev = jax.devices()[0]
    print(f"lap2d analog: 1000x1000 GMRES(30) no PC, 500 its in "
          f"{t500:.3f} s on {card} (reference 1996: 455.5 s on 2 SP2 "
          f"procs, 38.63 s on 32)")
    print(json.dumps({
        "metric": "lap2d_500it_solve_seconds",
        "value": t500,
        "unit": "s",
        "vs_baseline": 38.63 / t500,             # vs 32-proc SP2
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
        "detail": {"s_per_iter": t_iter,
                   "matmult_mflops": matmult_total,
                   "ref_2proc_s": 455.5, "ref_32proc_s": 38.63}}))


if __name__ == "__main__":
    main()
