"""chip_smoke.py's phases at tiny sizes on CPU, its refusal to run
without a GPU, and the process-wide settings `import petsctpu` makes
(compile-cache location, fp32 matmul precision)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_PHASES = {
    "formats": lambda r: chip_smoke.phase_formats(
        r, stencil_g=10, irr_g=13, band_m=40, baij_ne=12, dense_n=64),
    "ksp_mg": lambda r: chip_smoke.phase_ksp_mg(r, g=17),
    "ksp_gamg": lambda r: chip_smoke.phase_ksp_gamg(r, ne=24),
    "ksp_ilu": lambda r: chip_smoke.phase_ksp_ilu(r, g=12),
    "snes": lambda r: chip_smoke.phase_snes(r, m=33),
    "golden": chip_smoke.phase_golden,
    "four_cards": lambda r: chip_smoke.phase_four_cards(
        r, stencil_grid=(16, 6, 6), aij_g=10, gamg_m=24),
}


class _Collect:
    def __init__(self):
        self.records = []

    def __call__(self, phase, **fields):
        self.records.append({"phase": phase, **fields})
        return self.records[-1]


@pytest.mark.parametrize("phase", sorted(TINY_PHASES))
def test_phase_runs_tiny(phase):
    """Each phase passes its own checks at a tiny size and reports."""
    rep = _Collect()
    TINY_PHASES[phase](rep)
    assert rep.records and all(r["phase"] == phase for r in rep.records)
    if phase == "formats":
        kinds = {r["format"] for r in rep.records}
        assert {"StencilMat", "AIJ", "SellMat", "BandMat", "BAIJ",
                "Dense"} <= kinds
        assert {r["dtype"] for r in rep.records} == {"float32", "float64"}
    elif phase == "four_cards":
        assert len(rep.records) == 4
        assert all(abs(r["its"] - r["one_card_its"]) <= 1
                   for r in rep.records)
    elif phase == "ksp_gamg":
        solves = [r for r in rep.records if "reason" in r]
        check, = [r for r in rep.records if "check" in r]
        assert [r["dtype"] for r in solves] == ["float64", "float32"]
        assert all(r["reason"] > 0 for r in solves)
        assert check["pc_apply_rel_diff"] <= check["pc_apply_tol"]
    else:
        assert all(r["reason"] > 0 for r in rep.records)


def test_gamg_fp32_check_catches_low_precision_levels(monkeypatch):
    """The fp32 GAMG run cannot resolve ex55's residual, so it is held
    to its preconditioner matching fp64 and to its iteration count:
    level products computed at bfloat16 precision must fail that."""
    from petsctpu.mat.dense import Dense

    def low_mult(self, x):
        return jnp.dot(self.M.astype(jnp.bfloat16),
                       x.astype(jnp.bfloat16)).astype(x.dtype)

    monkeypatch.setattr(Dense, "mult", low_mult)
    with pytest.raises(AssertionError, match="fp32"):
        chip_smoke.phase_ksp_gamg(_Collect(), ne=24)


def test_bench_sell_vs_ell_tiny():
    """The SELL-vs-ELL timing script checks both formats against scipy
    and reports microseconds per mult for each operator."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import bench_sell_vs_ell
    finally:
        sys.path.pop(0)
    recs = bench_sell_vs_ell.run(13, 32, "cpu")
    assert [r["n"] for r in recs] == [13 ** 3, 2 * 33 ** 2]
    for r in recs:
        assert r["ell_us_per_mult"] > 0 and r["sell_us_per_mult"] > 0
        assert r["sell_slop"] >= 1.0


def test_refuses_without_gpu():
    """Under JAX_PLATFORMS=cpu the script exits non-zero and prints no
    result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is a
    fixed directory inside the checkout, keyed by the host CPU."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    code = ("import json, jax, petsctpu; print(json.dumps(["
            "jax.config.jax_compilation_cache_dir,"
            " petsctpu.compile_cache_dir()]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    used, default = json.loads(out.stdout.strip().splitlines()[-1])
    if env_set:
        assert used == str(tmp_path)
    else:
        assert used == default
        assert os.path.dirname(default) == os.path.join(REPO, ".jax_cache")


def _fp32_band():
    from petsctpu.mat import band_from_scipy
    from petsctpu.models import laplacian_2d
    A = laplacian_2d(16, 16, dtype=np.float32).tocsr()
    return band_from_scipy(A, dtype=np.float32)


def _fp32_baij():
    from petsctpu.mat import baij_from_scipy_bsr
    from petsctpu.models import laplacian_2d
    A = laplacian_2d(16, 16, dtype=np.float32).tocsr()
    return baij_from_scipy_bsr(A, bs=2, dtype=np.float32)


@pytest.mark.parametrize("build", [_fp32_band, _fp32_baij],
                         ids=["BandMat", "BAIJ"])
def test_fp32_mult_lowers_at_highest_precision(build):
    """The package-wide matmul precision reaches every fp32 product: a
    TF32 product would keep ~3 digits and change Krylov histories."""
    M = build()
    x = jnp.ones(M.shape[1], jnp.float32)
    text = jax.jit(lambda M, v: M.mult(v)).lower(M, x).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert dots
    assert all("precision = [HIGHEST, HIGHEST]" in ln for ln in dots), dots


def _ex55_loop(ne, soft_alpha=1e-3):
    """Element-by-element assembly of ksp ex55 (ex55.c:30-200): the
    reference for the vectorized models.elasticity.ex55_system."""
    import scipy.sparse as sp

    from petsctpu.models.elasticity import ex55_element_blocks
    DD1, DD2 = ex55_element_blocks()
    n1 = ne + 1
    nn = n1 * n1
    h = 1.0 / ne
    rows, cols, vals = [], [], []
    for Ii in range(nn):
        j, i = Ii // n1, Ii % n1
        if i < ne and j < ne:
            x, y = h * i, h * j
            nodes = np.array([Ii, Ii + 1, Ii + n1 + 1, Ii + n1])
            dof = np.stack([2 * nodes, 2 * nodes + 1], 1).reshape(-1)
            radius = np.sqrt((x - .5 + h / 2) ** 2 + (y - .5 + h / 2) ** 2)
            alpha = soft_alpha if radius < 0.25 else 1.0
            DD = alpha * (DD1 if j > 0 else DD2)
            rows.append(np.repeat(dof, 8))
            cols.append(np.tile(dof, 8))
            vals.append(DD.reshape(-1))
    return sp.csr_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(2 * nn, 2 * nn))


@pytest.mark.parametrize("ne", [3, 16, 37])
def test_ex55_vectorized_assembly_matches_loop(ne):
    """Same entries in the same summation order: bitwise equal."""
    from petsctpu.models.elasticity import ex55_system
    A = ex55_system(ne)[0]
    R = _ex55_loop(ne)
    A.sort_indices()
    R.sort_indices()
    np.testing.assert_array_equal(A.indptr, R.indptr)
    np.testing.assert_array_equal(A.indices, R.indices)
    np.testing.assert_array_equal(A.data, R.data)


def test_bench_peaks_refuse_unknown_device():
    """A device without published peaks is an error, not a default."""
    import bench
    assert bench.peak("NVIDIA H100 80GB HBM3")["hbm_gbs"] == 3350.0
    with pytest.raises(KeyError):
        bench.peak("cpu")
