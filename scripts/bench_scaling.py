"""Weak/strong scaling driver — the reference's lap2d benchmark analog.

Reference: src/benchmarks/results/lap2d.m (2-D Laplacian, fixed-
iteration Krylov, 2→32 procs strong scaling; SURVEY §6). Here:
PIPECG on a sharded stencil Laplacian over an N-device mesh; reports
time per iteration and parallel efficiency.

Run on the GPUs of one host (or the CPU mesh for plumbing validation):
    python scripts/bench_scaling.py --mode weak --base 1024 --iters 200
"""

from __future__ import annotations

import argparse
import json
import sys

sys.path.insert(0, ".")

import numpy as np


def run(nshards, m, iters):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from bench import best_time
    from petsctpu.mat.stencil import StencilMat
    from petsctpu.parallel import par_ksp_solve, sharded_stencil_from
    from petsctpu.pc.simple import JacobiPC

    devs = jax.devices()[:nshards]
    mesh = Mesh(np.array(devs), ("rows",))
    # build the stencil directly (assembly-free, like bench.py)
    C = np.zeros((5, m, m), np.float32)
    C[0] = 4.0
    C[1, 1:, :] = -1.0
    C[2, :-1, :] = -1.0
    C[3, :, 1:] = -1.0
    C[4, :, :-1] = -1.0
    S = StencilMat(jnp.asarray(C), ((0, 0), (-1, 0), (1, 0), (0, -1),
                                    (0, 1)), (m, m))
    Sh = sharded_stencil_from(S, nshards)
    d = np.full(Sh.shape[0], 0.25, np.float32)
    pc = JacobiPC(jnp.asarray(d.reshape(nshards, -1)))
    b = np.ones(m * m, np.float32)

    def solve():
        return par_ksp_solve(mesh, Sh, b, pc=pc, ksp_type="pipecg",
                             rtol=1e-30, maxits=iters).x

    return best_time(solve) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["weak", "strong"], default="weak")
    ap.add_argument("--base", type=int, default=512,
                    help="grid size per device (weak) or total (strong)")
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args()

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit("bench_scaling: times need GPUs; JAX found "
                         f"{dev.platform!r}")
    ndev = len(jax.devices())
    results = []
    shards = [s for s in (1, 2, 4, 8, 16, 32) if s <= ndev]
    for s in shards:
        if args.mode == "weak":
            m = int(args.base * np.sqrt(s))
        else:
            m = args.base
        t = run(s, m, args.iters)
        results.append(dict(nshards=s, grid=m, s_per_iter=t))
    t1 = results[0]["s_per_iter"]
    for r in results:
        if args.mode == "weak":
            r["efficiency"] = round(t1 / r["s_per_iter"], 3)
        else:
            r["efficiency"] = round(t1 / (r["s_per_iter"] * r["nshards"]), 3)
    from bench import card_name_and_power
    print(json.dumps({"mode": args.mode, "results": results,
                      "device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": ndev,
                                 "card": card_name_and_power()}}))


if __name__ == "__main__":
    main()
