"""Benchmark: SpMV throughput against the HBM roofline on one GPU.

Prints ONE JSON line: the fraction of the card's HBM bandwidth that
the stencil SpMV reaches on a large 2-D variable-coefficient operator,
with details for an irregular operator, two solver configurations and
the compile-time collective counts of the distributed solvers.

Method: N chained SpMVs run inside one jitted lax.fori_loop (each
iteration rescaled to stay bounded); a run is timed on the host clock
around a call that ends in block_until_ready, the best of three runs
counts, and the per-SpMV time is that over N. A STREAM triad measured
the same way gives the achievable bandwidth.

Roofline model (fp32 stencil, K offsets): compulsory traffic per mult
= K coefficient arrays + x read + y write = 4n(K+2) bytes.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np

# Published peaks, keyed by jax device_kind. Source: NVIDIA H100 data
# sheet (SXM part, 700 W): HBM3 at 3.35 TB/s.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbs": 3350.0,
                              "source": "NVIDIA H100 SXM data sheet"},
}


def peak(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device {device_kind!r}; "
                       "add it to bench.PEAKS with its source")
    return PEAKS[device_kind]


def card_name_and_power() -> str:
    """nvidia-smi's name and power limit, from a child process."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def timed(fn, *args):
    """(fn(*args), wall seconds of the call ending in
    block_until_ready)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def best_time(fn, *args, repeats: int = 3) -> float:
    """Best wall time of fn(*args) over `repeats` runs after a warm-up
    call; every run ends in block_until_ready."""
    timed(fn, *args)
    return min(timed(fn, *args)[1] for _ in range(repeats))


def scrambled_27pt(m: int, rng, dtype=np.float64):
    """3-D 27-point operator on an m³ grid, rows and columns scrambled
    by a random permutation and then RCM-ordered, with random values:
    the irregular operator the reference serves with MatMult_SeqAIJ
    (aij.c:1173)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    e = np.ones(m)
    T1 = sp.diags([e[:-1], e, e[:-1]], [-1, 0, 1])
    A = sp.kron(sp.kron(T1, T1), T1).tocsr()
    p = rng.permutation(A.shape[0])
    A = A[p][:, p]
    q = reverse_cuthill_mckee(A.tocsr(), symmetric_mode=True)
    A = A[q][:, q].tocsr()
    A.sum_duplicates()
    A.data = rng.standard_normal(A.nnz).astype(dtype)
    return A


def build_stencil_laplacian(m: int, dtype=np.float32):
    """5-point variable-coefficient stencil on an m×m grid, built
    directly in DIA/stencil layout (what the DMDA layer produces)."""
    import jax.numpy as jnp
    from petsctpu.mat.stencil import StencilMat

    C = np.zeros((5, m, m), dtype)
    C[0] = 4.0
    C[1, 1:, :] = -1.0    # (-1, 0)
    C[2, :-1, :] = -1.0   # (+1, 0)
    C[3, :, 1:] = -1.0    # (0, -1)
    C[4, :, :-1] = -1.0   # (0, +1)
    offsets = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
    return StencilMat(jnp.asarray(C), offsets, (m, m))


def spmv_chain(iters: int, scale: float):
    """jit(M, v) -> v after `iters` chained scaled SpMVs."""
    import jax

    @jax.jit
    def chain(M, v):
        def body(_, v):
            return M.mult(v) * np.float32(scale)
        return jax.lax.fori_loop(0, iters, body, v)
    return chain


def main():
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    dev = jax.devices()[0]
    pk = peak(dev.device_kind)
    card = card_name_and_power()

    m = 4096                       # 16.8M rows, ~84M nnz
    n = m * m
    Ad = build_stencil_laplacian(m)
    K = len(Ad.offsets)
    # grid-shaped operand: StencilMat.mult is shape-preserving, so the
    # chain never pays a flat<->grid relayout
    x = jnp.asarray(np.random.default_rng(0).standard_normal((m, m))
                    .astype(np.float32))
    iters = 200
    dt = best_time(spmv_chain(iters, 0.125), Ad, x) / iters

    # STREAM triad on operands far larger than the 50 MB L2
    ns = 64 * 1024 * 1024
    a = jnp.asarray(np.random.default_rng(1).standard_normal(ns)
                    .astype(np.float32))
    v0 = jnp.asarray(np.random.default_rng(2).standard_normal(ns)
                     .astype(np.float32))
    t_iters = 100

    @jax.jit
    def triad(a, v):
        def body(_, v):
            return a + np.float32(0.5) * v          # read a, v; write out
        return jax.lax.fori_loop(0, t_iters, body, v)

    dt_triad = best_time(triad, a, v0) / t_iters
    stream_gbs = 3.0 * 4.0 * ns / dt_triad / 1e9

    # ---- irregular SpMV: a scrambled 3-D 27-point operator after RCM,
    # routed through -mat_type auto (mat/factory.py)
    from petsctpu.mat.factory import mat_from_options

    rngp = np.random.default_rng(5)
    A3 = scrambled_27pt(64, rngp, np.float32)
    ni = A3.shape[0]
    t0 = time.perf_counter()
    Ms, _ = mat_from_options(A3, mat_type="auto", dtype=np.float32)
    plan_s = time.perf_counter() - t0
    xi = jnp.asarray(rngp.standard_normal(ni).astype(np.float32))
    dti = best_time(spmv_chain(1000, 0.05), Ms, xi) / 1000
    irr = {"irregular_nnz_per_s": f"{A3.nnz / dti:.3e}",
           "irregular_ms": dti * 1e3,
           "irregular_frac_ideal_csr":
               A3.nnz * 8.0 / dti / 1e9 / max(stream_gbs, pk["hbm_gbs"]),
           "irregular_n": ni,
           "irregular_plan_s": plan_s,
           "irregular_format": f"auto -> {type(Ms).__name__} "
                               "(scrambled 3-D 27-point)"}

    # ---- solver configurations: ms per iteration at a fixed iteration
    # count (an unreachable tolerance keeps the loop running), and the
    # iterations to rtol 1e-5
    from petsctpu.core.options import Options
    from petsctpu.ksp import ksp_solve
    from petsctpu.mat import aij_from_scipy
    from petsctpu.models import laplacian_2d
    from petsctpu.pc import make_pc

    def per_iteration(Aop, bj, pc, its_fixed=40):
        r = ksp_solve(Aop, bj, pc=pc, ksp_type="cg", rtol=1e-5,
                      atol=1e-30, maxits=500)

        def run(b):
            return ksp_solve(Aop, b, pc=pc, ksp_type="cg", rtol=1e-30,
                             atol=1e-38, maxits=its_fixed)
        ran = int(run(bj).its)        # a breakdown may end the loop early
        return best_time(run, bj) / max(ran, 1), int(r.its)

    cfgs = {}
    # ex45-style 3-D 7-point Poisson, CG + BJacobi(ILU0, RCM blocks)
    mi = 48
    e = np.ones(mi)
    T1 = sp.diags([-e[:-1], 2 * e, -e[:-1]], [-1, 0, 1])
    I1 = sp.eye(mi)
    A45 = (sp.kron(sp.kron(T1, I1), I1) + sp.kron(sp.kron(I1, T1), I1)
           + sp.kron(sp.kron(I1, I1), T1)).tocsr().astype(np.float32)
    Ad45 = aij_from_scipy(A45, dtype=np.float32)
    pc45 = make_pc("bjacobi", A=Ad45, A_host=A45,
                   options=Options({
                       "pc_bjacobi_blocks": 8, "sub_pc_type": "ilu",
                       "sub_pc_factor_mat_ordering_type": "rcm"}))
    b45 = jnp.asarray(np.random.default_rng(1)
                      .standard_normal(mi ** 3).astype(np.float32))
    per_it, its = per_iteration(Ad45, b45, pc45)
    cfgs["ex45_cg_bjacobi_ms_per_it"] = per_it * 1e3
    cfgs["ex45_its_to_rtol1e-5"] = its

    # GAMG on 2-D Poisson — setup + per-iteration
    m4 = 256
    A4 = laplacian_2d(m4, m4, dtype=np.float32).tocsr()
    Aop4, p4 = mat_from_options(A4, mat_type="auto", dtype=np.float32)
    if p4 is not None:
        Aop4 = aij_from_scipy(A4, dtype=np.float32)
    t0 = time.perf_counter()
    pc4 = make_pc("gamg", A=Aop4, A_host=A4,
                  options=Options({"pc_gamg_coarse_eq_limit": 64}))
    cfgs["gamg_setup_s"] = time.perf_counter() - t0
    cfgs["gamg_outer_format"] = type(Aop4).__name__
    b4 = jnp.asarray(np.random.default_rng(3)
                     .standard_normal(m4 * m4).astype(np.float32))
    per4, its4 = per_iteration(Aop4, b4, pc4, its_fixed=12)
    cfgs["gamg_cg_ms_per_it"] = per4 * 1e3
    cfgs["gamg_its_to_rtol1e-5"] = its4

    # ---- communication-volume audit: trace the 8-shard distributed
    # CG / PIPECG programs over an AbstractMesh (no devices needed) and
    # report per-iteration collective counts/bytes + the halo plan's
    # static volume — the reference's -log_summary Mess/MessLen/
    # Reductions columns (plog.c:1264), counted at compile time
    from petsctpu.core.commaudit import halo_audit
    from petsctpu.parallel import sharded_aij_from_scipy
    from petsctpu.parallel.api import audit_par_ksp

    comm = {}
    mi8 = 24
    e8 = np.ones(mi8)
    T18 = sp.diags([-e8[:-1], 2 * e8, -e8[:-1]], [-1, 0, 1])
    I18 = sp.eye(mi8)
    A8 = (sp.kron(sp.kron(T18, I18), I18)
          + sp.kron(sp.kron(I18, T18), I18)
          + sp.kron(sp.kron(I18, I18), T18)).tocsr().astype(np.float32)
    Sh8, part8 = sharded_aij_from_scipy(A8, 8, dtype=np.float32)
    b8 = jnp.zeros(Sh8.shape[0], jnp.float32)
    for kt in ("cg", "pipecg", "gmres", "ibcgs"):
        a = audit_par_ksp(8, Sh8, b8, ksp_type=kt, maxits=10)
        comm[f"{kt}_collectives_per_it"] = a.per_iteration.summary()
    comm["halo_plan"] = halo_audit(part8.halo, np.float32)

    bytes_moved = 4.0 * n * (K + 2)
    gbs = bytes_moved / dt / 1e9
    frac = gbs / pk["hbm_gbs"]
    print(json.dumps({
        "metric": "spmv_hbm_roofline_frac",
        "value": frac,
        "unit": "fraction_of_peak_hbm_bw",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
        "detail": {"gbs": gbs, "nnz_per_s": f"{Ad.nnz / dt:.3e}",
                   "ms_per_spmv": dt * 1e3, "n": n,
                   "stencil_width": K, "peak_gbs": pk["hbm_gbs"],
                   "peak_source": pk["source"],
                   "stream_gbs": stream_gbs,
                   "stream_frac_of_peak": stream_gbs / pk["hbm_gbs"],
                   "format": "stencil/DIA (2-D 5-point, variable coeff)",
                   **irr, **cfgs, "comm_audit_8shard": comm},
    }))


if __name__ == "__main__":
    main()
