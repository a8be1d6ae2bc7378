"""fp32 SpMV: plain-JAX SELL (SellMat) against ELL (AIJ) on one GPU.

    python scripts/bench_sell_vs_ell.py

Two operators: the RCM-ordered scrambled 3-D 27-point operator on a
64³ grid (bench.py's irregular case) and ksp ex55's 2-D elasticity
operator at 1024×1024 elements (the fine level of chip_smoke.py's
GAMG hierarchy). Each format runs 100 chained mults inside one
jitted loop, timed on the host clock around a call that ends in
block_until_ready, best of five. Prints one JSON line per operator, with the card, the SELL plan
(passes, slop = passes / average row length) and microseconds per
mult, after checking both formats against scipy's fp64 product.
"""

from __future__ import annotations

import json
import sys

sys.path.insert(0, ".")

import numpy as np

ITERS = 100


def compare(name, A, card, rng):
    import jax.numpy as jnp
    import scipy.sparse as sp

    from bench import best_time, spmv_chain

    from petsctpu.mat import aij_from_scipy
    from petsctpu.mat.sell import sell_from_scipy, sell_plan_stats

    A = sp.csr_matrix(A).astype(np.float32)
    A.sum_duplicates()
    passes, _, _, slop = sell_plan_stats(A)
    x = rng.standard_normal(A.shape[0]).astype(np.float32)
    yref = A.astype(np.float64) @ x.astype(np.float64)
    scale = float(np.max(abs(A) @ np.ones(A.shape[0])))
    rec = {"operator": name, "card": card, "n": A.shape[0],
           "nnz": int(A.nnz), "sell_passes": int(passes),
           "sell_slop": float(slop)}
    xd = jnp.asarray(x)
    for key, M in (("ell", aij_from_scipy(A, dtype=np.float32)),
                   ("sell", sell_from_scipy(A))):
        err = np.max(np.abs(np.asarray(M.mult(xd), np.float64) - yref))
        if err > 1e-5 * np.max(abs(A) @ np.abs(x)):
            raise AssertionError(f"{name} {key}: mult error {err}")
        chain = spmv_chain(ITERS, 1.0 / scale)
        rec[f"{key}_us_per_mult"] = \
            best_time(chain, M, xd, repeats=5) / ITERS * 1e6
    print(json.dumps(rec), flush=True)
    return rec


def run(g: int, ne: int, card: str):
    from bench import scrambled_27pt

    from petsctpu.models.elasticity import ex55_system

    rng = np.random.default_rng(0)
    return [compare(f"scrambled 27-point {g}^3, RCM",
                    scrambled_27pt(g, rng), card, rng),
            compare(f"ex55 ne={ne}", ex55_system(ne)[0], card, rng)]


def main():
    from bench import card_name_and_power
    run(64, 1024, card_name_and_power())


if __name__ == "__main__":
    main()
