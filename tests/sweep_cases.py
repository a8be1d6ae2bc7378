"""Declarative golden-parity sweep table — single source of truth for
BOTH the oracle minting (scripts/mint_sweep.py) and the parity test
(tests/test_sweep.py).

Modeled on the reference's declarative test DB
(/root/reference/config/builder.py:14-30 regressionParameters and the
makefile runex* targets, src/ksp/ksp/examples/tutorials/makefile:317):
each entry names a tutorial system, the exact option flags, and the
process count; the minter runs the hand-built reference oracle
(scripts/build_reference_oracle.sh) with those flags and captures the
-ksp_monitor_short / -snes_monitor_short stream, and the test replays
the SAME flags through petsctpu's options-driven constructors and
checks iteration counts exactly and residual streams to fp tolerance.

np > 1 cases: the oracle is mpiuni (single process), so the reference
side of an np-rank DEFAULT solve is minted with its exact serial
equivalent (-pc_type bjacobi -pc_bjacobi_blocks np -sub_pc_type ilu —
PETSc's np-rank default PC is per-rank ILU(0) block Jacobi over the
PETSC_DECIDE row split, bjacobi.c:14), and the repo side runs the
REAL distributed path on an np-device CPU mesh (shard_map + collective
plans). Agreement is exact in iteration counts because the block
split matches PetscLayout's.

sys specs: "ex1:n=120" (1-D [-1,2,-1], u*=1), "ex2:m=12,n=12" (2-D
five-point Laplacian, ex2.c), "ex23:n=80" (1-D tridiag, ex23.c),
"file:<name>.bin" (ex10 datafile route).
"""

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Case:
    tag: str              # unique; oracle stream = oracle_sweep/<tag>.txt
    sys: str              # system spec (see module docstring)
    args: str             # option flags, shared by oracle and driver
    np: int = 1
    check: str = "stream"     # stream | its (iteration count only)
    rtol: float = 3e-5        # stream comparison tolerance
    note: str = ""            # oracle annotation (known deltas)
    oracle_args: str = ""     # oracle-side EXTRA flags (np emulation)


K = "-ksp_monitor_short "          # every ksp case captures the stream

CASES = [
    # ---- ksp ex2 20x20 rtol 1e-6: solver/pc pairs not covered by the
    # r1-r4 batches (new sizes/flags) -------------------------------------
    Case("sw_ex2_cg_none", "ex2:m=20,n=20",
         "-ksp_type cg -pc_type none -ksp_rtol 1e-6"),
    Case("sw_ex2_cg_sor15", "ex2:m=20,n=20",
         "-ksp_type cg -pc_type sor -pc_sor_symmetric -pc_sor_omega 1.5 "
         "-ksp_rtol 1e-6"),
    Case("sw_ex2_cg_icc", "ex2:m=20,n=20",
         "-ksp_type cg -pc_type icc -ksp_rtol 1e-6"),
    Case("sw_ex2_cg_bjacobi4", "ex2:m=20,n=20",
         "-ksp_type cg -pc_type bjacobi -pc_bjacobi_blocks 4 "
         "-sub_pc_type ilu -ksp_rtol 1e-6"),
    Case("sw_ex2_cg_lu", "ex2:m=20,n=20",
         "-ksp_type cg -pc_type lu -ksp_rtol 1e-6"),
    Case("sw_ex2_gmres_restart10", "ex2:m=20,n=20",
         "-ksp_type gmres -pc_type jacobi -ksp_gmres_restart 10 "
         "-ksp_rtol 1e-6"),
    Case("sw_ex2_gmres_mgs", "ex2:m=20,n=20",
         "-ksp_type gmres -pc_type jacobi "
         "-ksp_gmres_modifiedgramschmidt -ksp_rtol 1e-6"),
    Case("sw_ex2_gmres_cgs_always", "ex2:m=20,n=20",
         "-ksp_type gmres -pc_type ilu "
         "-ksp_gmres_cgs_refinement_type refine_always -ksp_rtol 1e-6"),
    Case("sw_ex2_gmres_unpre", "ex2:m=20,n=20",
         "-ksp_type gmres -pc_type jacobi -ksp_norm_type unpreconditioned "
         "-ksp_rtol 1e-6"),
    Case("sw_ex2_gmres_right", "ex2:m=20,n=20",
         "-ksp_type gmres -pc_type jacobi -ksp_pc_side right "
         "-ksp_rtol 1e-6"),
    Case("sw_ex2_bcgs_ilu1", "ex2:m=20,n=20",
         "-ksp_type bcgs -pc_type ilu -pc_factor_levels 1 -ksp_rtol 1e-6"),
    # NOTE sor/bicg: the reference ABORTS (PCApplyTranspose missing
    # for SOR, precon.c:515) — jacobi variant pinned instead
    Case("sw_ex2_bicg_jacobi20", "ex2:m=20,n=20",
         "-ksp_type bicg -pc_type jacobi -ksp_rtol 1e-6"),
    Case("sw_ex2_tfqmr_jacobi", "ex2:m=20,n=20",
         "-ksp_type tfqmr -pc_type jacobi -ksp_rtol 1e-6"),
    Case("sw_ex2_cgs_ilu", "ex2:m=20,n=20",
         "-ksp_type cgs -pc_type ilu -ksp_rtol 1e-6"),
    Case("sw_ex2_cr_icc", "ex2:m=20,n=20",
         "-ksp_type cr -pc_type icc -ksp_rtol 1e-6"),
    Case("sw_ex2_minres_ssor", "ex2:m=20,n=20",
         "-ksp_type minres -pc_type sor -pc_sor_symmetric -ksp_rtol 1e-6"),
    Case("sw_ex2_symmlq_icc", "ex2:m=20,n=20",
         "-ksp_type symmlq -pc_type icc -ksp_rtol 1e-6"),
    # lsqr/cgne run on the normal equations (condition squared):
    # fp64 trajectories diverge from the oracle mid-solve though the
    # iteration counts coincide exactly — pinned on its
    Case("sw_ex2_lsqr_none", "ex2:m=20,n=20",
         "-ksp_type lsqr -pc_type none -ksp_rtol 1e-6", check="its"),
    Case("sw_ex2_gcr_jacobi", "ex2:m=20,n=20",
         "-ksp_type gcr -pc_type jacobi -ksp_rtol 1e-6"),
    Case("sw_ex2_lcd_jacobi", "ex2:m=20,n=20",
         "-ksp_type lcd -pc_type jacobi -ksp_rtol 1e-6"),
    Case("sw_ex2_cheby_jacobi", "ex2:m=20,n=20",
         "-ksp_type chebyshev -pc_type jacobi "
         "-ksp_chebyshev_eigenvalues 0.0980581,3.9019419 -ksp_rtol 1e-6",
         check="stream"),
    Case("sw_ex2_rich_jacobi_s05", "ex2:m=20,n=20",
         "-ksp_type richardson -pc_type jacobi -ksp_richardson_scale 0.5 "
         "-ksp_rtol 1e-3"),
    Case("sw_ex2_ibcgs_ilu", "ex2:m=20,n=20",
         "-ksp_type ibcgs -pc_type ilu -ksp_rtol 1e-6"),
    Case("sw_ex2_fbcgs_jacobi", "ex2:m=20,n=20",
         "-ksp_type fbcgs -pc_type jacobi -ksp_rtol 1e-6"),
    Case("sw_ex2_bcgsl_ell3", "ex2:m=20,n=20",
         "-ksp_type bcgsl -pc_type ilu -ksp_bcgsl_ell 3 -ksp_rtol 1e-6"),
    Case("sw_ex2_cgne_jacobi", "ex2:m=20,n=20",
         "-ksp_type cgne -pc_type jacobi -ksp_rtol 1e-6", check="its"),
    Case("sw_ex2_preonly_lu", "ex2:m=20,n=20",
         "-ksp_type preonly -pc_type lu", check="its"),
    Case("sw_ex2_cg_eisenstat", "ex2:m=20,n=20",
         "-ksp_type cg -pc_type eisenstat -ksp_rtol 1e-6"),
    Case("sw_ex2_gmres_rcm_ilu", "ex2:m=20,n=20",
         "-ksp_type gmres -pc_type ilu -pc_factor_mat_ordering_type rcm "
         "-ksp_rtol 1e-6"),
    Case("sw_ex2_cg_asm4", "ex2:m=20,n=20",
         "-ksp_type cg -pc_type bjacobi -pc_bjacobi_blocks 2 "
         "-sub_pc_type icc -ksp_rtol 1e-6"),

    # ---- ksp ex1 / ex23 (1-D tridiagonal) -------------------------------
    Case("sw_ex1_cg_jacobi", "ex1:n=120",
         "-ksp_type cg -pc_type jacobi -ksp_rtol 1e-5"),
    Case("sw_ex1_gmres_ilu", "ex1:n=120",
         "-ksp_type gmres -pc_type ilu -ksp_rtol 1e-5", check="its"),
    # bcgs on the kappa~6e3 tridiagonal: 4 tail entries drift to
    # ~6e-4 relative (fp accumulation); values identical to 3+ digits
    Case("sw_ex1_bcgs_sor", "ex1:n=120",
         "-ksp_type bcgs -pc_type sor -ksp_rtol 1e-5", rtol=2e-3),
    Case("sw_ex23_cg_icc", "ex23:n=80",
         "-ksp_type cg -pc_type icc -ksp_rtol 1e-8"),
    Case("sw_ex23_minres_jacobi", "ex23:n=80",
         "-ksp_type minres -pc_type jacobi -ksp_rtol 1e-8"),
    Case("sw_ex23_cr_none", "ex23:n=80",
         "-ksp_type cr -pc_type none -ksp_rtol 1e-8"),

    # ---- ksp ex10 datafiles: new solver/pc pairs ------------------------
    # NOTE pipecg: the 3.3-era reference pipecg.c DIVERGES on these
    # SPD systems (oscillating residuals from it 0, hits max_it) —
    # pipecr/groppcg pinned instead; our pipecg is validated against
    # serial CG iteration counts in test_parallel.py
    Case("sw_ex10p_pipecr_icc", "file:ex10_poisson.bin",
         "-ksp_type pipecr -pc_type icc -ksp_rtol 1e-5"),
    Case("sw_ex10p_groppcg_icc", "file:ex10_poisson.bin",
         "-ksp_type groppcg -pc_type icc -ksp_rtol 1e-5"),
    Case("sw_ex10p_symmlq_sor", "file:ex10_poisson.bin",
         "-ksp_type symmlq -pc_type sor -pc_sor_symmetric -ksp_rtol 1e-5"),
    # 370-iteration Golub-Kahan recursion: fp trajectory divergence
    # makes the last hair of convergence land +-1 iteration off
    Case("sw_ex10p_lsqr_jacobi", "file:ex10_poisson.bin",
         "-ksp_type lsqr -pc_type jacobi -ksp_rtol 1e-5",
         check="its_approx"),
    Case("sw_ex10p_cg_ilu_rcm", "file:ex10_poisson.bin",
         "-ksp_type cg -pc_type ilu -pc_factor_mat_ordering_type rcm "
         "-ksp_rtol 1e-5"),
    Case("sw_ex10n_gmres_sor", "file:ex10_nonsym.bin",
         "-ksp_type gmres -pc_type sor -ksp_rtol 1e-5"),
    Case("sw_ex10n_tfqmr_jacobi", "file:ex10_nonsym.bin",
         "-ksp_type tfqmr -pc_type jacobi -ksp_rtol 1e-5"),
    Case("sw_ex10n_gcr_ilu1", "file:ex10_nonsym.bin",
         "-ksp_type gcr -pc_type ilu -pc_factor_levels 1 -ksp_rtol 1e-5"),
    Case("sw_ex10n_lgmres_jacobi", "file:ex10_nonsym.bin",
         "-ksp_type lgmres -pc_type jacobi -ksp_rtol 1e-5"),
    Case("sw_ex10n_rich_sor", "file:ex10_nonsym.bin",
         "-ksp_type richardson -pc_type sor -ksp_rtol 1e-3"),
    Case("sw_ex10b_gmres_icc", "file:ex10_baij3.bin",
         "-ksp_type gmres -pc_type icc -ksp_rtol 1e-5"),
    Case("sw_ex10b_cg_pbjacobi", "file:ex10_baij3.bin",
         "-mat_type baij -matload_block_size 3 "
         "-ksp_type cg -pc_type pbjacobi -ksp_rtol 1e-5"),
    # the reference silently routes this bs=3 matrix through its
    # Inode-blocked SOR (MatSOR_SeqAIJ_Inode — node-wise sweeps, a
    # different operator from scalar SSOR). Both paths are pinned:
    # -mat_no_inode (shared flag) = scalar SSOR, default = the
    # r5 InodeSORPC block sweep (pc/sor.py)
    Case("sw_ex10b_bcgs_sor", "file:ex10_baij3.bin",
         "-ksp_type bcgs -pc_type sor -mat_no_inode -ksp_rtol 1e-5"),

    # ---- np in {2,4}: real distributed solves on the CPU mesh vs the
    # oracle's exact serial equivalent of the np-rank default PC --------
    Case("sw_np2_ex2_gmres_default", "ex2:m=12,n=12",
         "-ksp_type gmres -pc_type bjacobi -sub_pc_type ilu "
         "-ksp_rtol 1e-6", np=2,
         oracle_args="-pc_bjacobi_blocks 2"),
    Case("sw_np4_ex2_gmres_default", "ex2:m=12,n=12",
         "-ksp_type gmres -pc_type bjacobi -sub_pc_type ilu "
         "-ksp_rtol 1e-6", np=4,
         oracle_args="-pc_bjacobi_blocks 4"),
    Case("sw_np2_ex2_cg_jacobi", "ex2:m=12,n=12",
         "-ksp_type cg -pc_type jacobi -ksp_rtol 1e-6", np=2),
    Case("sw_np4_ex2_cg_jacobi", "ex2:m=12,n=12",
         "-ksp_type cg -pc_type jacobi -ksp_rtol 1e-6", np=4),
    Case("sw_np2_ex2_groppcg_jacobi", "ex2:m=12,n=12",
         "-ksp_type groppcg -pc_type jacobi -ksp_rtol 1e-6", np=2),
    Case("sw_np4_ex2_bcgs_bjacobi", "ex2:m=12,n=12",
         "-ksp_type bcgs -pc_type bjacobi -sub_pc_type ilu "
         "-ksp_rtol 1e-6", np=4,
         oracle_args="-pc_bjacobi_blocks 4"),
    Case("sw_np2_ex23_gmres_default", "ex23:n=80",
         "-ksp_type gmres -pc_type bjacobi -sub_pc_type ilu "
         "-ksp_rtol 1e-8", np=2,
         oracle_args="-pc_bjacobi_blocks 2"),
    Case("sw_np2_ex2_gmres_bjlu", "ex2:m=12,n=12",
         "-ksp_type gmres -pc_type bjacobi -sub_pc_type lu "
         "-ksp_rtol 1e-6", np=2,
         oracle_args="-pc_bjacobi_blocks 2"),

    # ---- batch 2: KSP norm types / orderings / subdomain PCs -----------
    Case("sw_ex2_cg_natural", "ex2:m=20,n=20",
         "-ksp_type cg -pc_type jacobi -ksp_norm_type natural "
         "-ksp_rtol 1e-6"),
    Case("sw_ex2_cg_unpre_icc", "ex2:m=20,n=20",
         "-ksp_type cg -pc_type icc -ksp_norm_type unpreconditioned "
         "-ksp_rtol 1e-6"),
    Case("sw_ex2_gmres_icc", "ex2:m=20,n=20",
         "-ksp_type gmres -pc_type icc -ksp_rtol 1e-6"),
    Case("sw_ex2_cg_ilu2", "ex2:m=20,n=20",
         "-ksp_type cg -pc_type ilu -pc_factor_levels 2 -ksp_rtol 1e-6"),
    # self-scaled Richardson is a nonlinear recurrence: fp
    # trajectories drift over ~600 iterations (stream matches for the
    # first few hundred) — pinned within 3%
    Case("sw_ex2_rich_selfscale", "ex2:m=20,n=20",
         "-ksp_type richardson -ksp_richardson_self_scale "
         "-pc_type jacobi -ksp_rtol 1e-4", check="its_approx"),
    Case("sw_ex2_gmres_jacobi_rowmax", "ex2:m=20,n=20",
         "-ksp_type gmres -pc_type jacobi -pc_jacobi_rowmax "
         "-ksp_rtol 1e-6"),
    Case("sw_ex2_gmres_asm4", "ex2:m=20,n=20",
         "-ksp_type gmres -pc_type asm -pc_asm_blocks 4 "
         "-pc_asm_overlap 1 -ksp_rtol 1e-6"),
    Case("sw_ex2_preonly_cholesky", "ex2:m=20,n=20",
         "-ksp_type preonly -pc_type cholesky", check="its"),
    Case("sw_ex2_fgmres_sor", "ex2:m=20,n=20",
         "-ksp_type fgmres -pc_type sor -ksp_rtol 1e-6"),
    Case("sw_ex2_gmres_restart5_ilu", "ex2:m=20,n=20",
         "-ksp_type gmres -pc_type ilu -ksp_gmres_restart 5 "
         "-ksp_rtol 1e-6"),

    # ---- batch 2: np-semantics on the datafile workloads ----------------
    Case("sw_np2_ex10p_cg_bjacobi", "file:ex10_poisson.bin",
         "-ksp_type cg -pc_type bjacobi -sub_pc_type ilu "
         "-ksp_rtol 1e-5", np=2, oracle_args="-pc_bjacobi_blocks 2"),
    Case("sw_np4_ex10n_gmres_bjacobi", "file:ex10_nonsym.bin",
         "-ksp_type gmres -pc_type bjacobi -sub_pc_type ilu "
         "-ksp_rtol 1e-5", np=4, oracle_args="-pc_bjacobi_blocks 4"),
    Case("sw_np2_ex10b_bcgs_bjacobi", "file:ex10_baij3.bin",
         "-ksp_type bcgs -pc_type bjacobi -sub_pc_type ilu "
         "-ksp_rtol 1e-5", np=2, oracle_args="-pc_bjacobi_blocks 2"),

    # ---- batch 2: snes ex5 Bratu (function-norm streams; inexact
    # Newton in the oracle -> r4 compare policy: 6e-4 on the stream,
    # bounded final) ------------------------------------------------------
    Case("sw_snes5_l2_m10", "snes_ex5:m=10,par=2.0",
         "-snes_rtol 1e-8", check="snes"),
    Case("sw_snes5_l4_m10", "snes_ex5:m=10,par=4.0",
         "-snes_rtol 1e-8", check="snes"),
    Case("sw_snes5_l5_m16", "snes_ex5:m=16,par=5.0",
         "-snes_rtol 1e-8", check="snes"),
    Case("sw_snes5_l6_m12", "snes_ex5:m=12,par=6.0",
         "-snes_rtol 1e-8", check="snes"),
    Case("sw_snes5_l3_m16_basic", "snes_ex5:m=16,par=3.0",
         "-snes_rtol 1e-8 -snes_ls basic", check="snes"),
    Case("sw_snes5_l45_m12_basic", "snes_ex5:m=12,par=4.5",
         "-snes_rtol 1e-8 -snes_ls basic", check="snes"),

    # ---- batch 2: ts ex4 1-D heat error-vs-analytic streams -------------
    # beuler needs -time_dependent_rhs in this era (without it the
    # oracle's second step reuses a stale solver operator and blows
    # up); the inner KSP is tightened so the oracle steps are exact.
    # The oracle's TSCN diverges on this problem EVEN with the flag
    # (growth ~2x/step from step 2) — a reference defect, not pinned;
    # our Crank-Nicolson is validated against the analytic solution
    # in tests/test_ts.py instead.
    Case("sw_ts4_beuler", "ts_ex4:m=60",
         "-ts_type beuler -ts_max_steps 40 -time_dependent_rhs "
         "-ksp_rtol 1e-12", check="ts"),
    Case("sw_ts4_beuler_m40", "ts_ex4:m=40",
         "-ts_type beuler -ts_max_steps 30 -time_dependent_rhs "
         "-ksp_rtol 1e-12", check="ts"),
    Case("sw_ts4_euler_m80", "ts_ex4:m=80",
         "-ts_type euler -ts_max_steps 40", check="ts"),

    # ---- snes ex14: 3-D Bratu with -fdcoloring — the FD-coloring
    # Jacobian pipeline end-to-end (DMDA stencil colors = fdda.c's
    # (i%3)+3(j%3)+9(k%3), ds differencing fdmatrix.c:583, inner
    # GMRES(30)+ILU(0) rtol 1e-5 reproduced exactly) -----------------------
    Case("sw_snes14_fdcolor_l5", "snes_ex14:m=8,par=5.0",
         "-fdcoloring -snes_rtol 1e-8", check="snes14"),
    Case("sw_snes14_fdcolor_l3", "snes_ex14:m=10,par=3.0",
         "-fdcoloring -snes_rtol 1e-8", check="snes14"),

    # ---- batch 4: breadth fill (new sizes/flag combos) ------------------
    Case("sw_ex2b_cg_icc28", "ex2:m=28,n=28",
         "-ksp_type cg -pc_type icc -ksp_rtol 1e-7"),
    Case("sw_ex2b_gmres_ilu28", "ex2:m=28,n=28",
         "-ksp_type gmres -pc_type ilu -ksp_rtol 1e-7"),
    # bcgs tails: fp accumulation reaches ~0.5% relative near the
    # deep-convergence end (values identical to 2-3 digits)
    Case("sw_ex2b_bcgs_jacobi28", "ex2:m=28,n=28",
         "-ksp_type bcgs -pc_type jacobi -ksp_rtol 1e-7", rtol=1e-2),
    Case("sw_ex2b_minres_jacobi28", "ex2:m=28,n=28",
         "-ksp_type minres -pc_type jacobi -ksp_rtol 1e-7"),
    Case("sw_ex1b_cg_icc", "ex1:n=200",
         "-ksp_type cg -pc_type icc -ksp_rtol 1e-6"),
    Case("sw_ex1b_cr_jacobi", "ex1:n=200",
         "-ksp_type cr -pc_type jacobi -ksp_rtol 1e-6"),
    Case("sw_ex23b_gmres_jacobi", "ex23:n=120",
         "-ksp_type gmres -pc_type jacobi -ksp_rtol 1e-4"),
    Case("sw_ex23b_symmlq_jacobi", "ex23:n=120",
         "-ksp_type symmlq -pc_type jacobi -ksp_rtol 1e-7"),
    Case("sw_ex10p_cg_sor12", "file:ex10_poisson.bin",
         "-ksp_type cg -pc_type sor -pc_sor_symmetric "
         "-pc_sor_omega 1.2 -ksp_rtol 1e-5"),
    Case("sw_ex10p_gmres_icc1", "file:ex10_poisson.bin",
         "-ksp_type gmres -pc_type icc -pc_factor_levels 1 "
         "-ksp_rtol 1e-5"),
    Case("sw_ex10p_bicg_jacobi", "file:ex10_poisson.bin",
         "-ksp_type bicg -pc_type jacobi -ksp_rtol 1e-5"),
    Case("sw_ex10n_bcgsl_ilu2", "file:ex10_nonsym.bin",
         "-ksp_type bcgsl -pc_type ilu -ksp_rtol 1e-5"),
    Case("sw_ex10n_cgs_sor", "file:ex10_nonsym.bin",
         "-ksp_type cgs -pc_type sor -ksp_rtol 1e-5"),
    Case("sw_ex10n_fgmres_ilu1", "file:ex10_nonsym.bin",
         "-ksp_type fgmres -pc_type ilu -pc_factor_levels 1 "
         "-ksp_rtol 1e-5"),
    Case("sw_np2_ex1_cg_jacobi", "ex1:n=120",
         "-ksp_type cg -pc_type jacobi -ksp_rtol 1e-5", np=2),
    Case("sw_np4_ex23_bcgs_bjacobi", "ex23:n=80",
         "-ksp_type bcgs -pc_type bjacobi -sub_pc_type ilu "
         "-ksp_rtol 1e-8", np=4, oracle_args="-pc_bjacobi_blocks 4",
         rtol=1e-2),
    Case("sw_np2_ex10p_gmres_bjacobi", "file:ex10_poisson.bin",
         "-ksp_type gmres -pc_type bjacobi -sub_pc_type ilu "
         "-ksp_rtol 1e-5", np=2, oracle_args="-pc_bjacobi_blocks 2"),
    Case("sw_np4_ex2_groppcg_jacobi", "ex2:m=16,n=16",
         "-ksp_type groppcg -pc_type jacobi -ksp_rtol 1e-6", np=4),
]


def by_tag(tag):
    for c in CASES:
        if c.tag == tag:
            return c
    raise KeyError(tag)

# ---- round-5 batch 2: +26 configs widening solver/pc coverage --------------
CASES += [
    # tfqmr / cgne / lgmres / ibcgs / fbcgs depth (1-2 cases each before)
    Case("sw2_ex2_tfqmr_ilu30", "ex2:m=30,n=30",
         "-ksp_type tfqmr -pc_type ilu -ksp_rtol 1e-6"),
    Case("sw2_ex2_tfqmr_sor", "ex2:m=20,n=20",
         "-ksp_type tfqmr -pc_type sor -ksp_rtol 1e-6"),
    Case("sw2_ex2_cgne_jacobi24", "ex2:m=24,n=24",
         "-ksp_type cgne -pc_type jacobi -ksp_rtol 1e-6",
         check="its"),              # normal equations: fp-trajectory
    Case("sw2_ex2_lgmres_jacobi", "ex2:m=24,n=24",
         "-ksp_type lgmres -pc_type jacobi -ksp_gmres_restart 12 "
         "-ksp_lgmres_augment 2 -ksp_rtol 1e-6"),
    Case("sw2_ex2_lgmres_ilu_aug4", "ex2:m=24,n=24",
         "-ksp_type lgmres -pc_type ilu -ksp_gmres_restart 16 "
         "-ksp_lgmres_augment 4 -ksp_rtol 1e-6"),
    Case("sw2_ex2_ibcgs_ilu24", "ex2:m=24,n=24",
         "-ksp_type ibcgs -pc_type ilu -ksp_rtol 1e-6"),
    Case("sw2_ex2_fbcgs_sor24", "ex2:m=24,n=24",
         "-ksp_type fbcgs -pc_type sor -ksp_rtol 1e-6"),
    Case("sw2_ex2_lcd_ilu24", "ex2:m=24,n=24",
         "-ksp_type lcd -pc_type ilu -ksp_rtol 1e-6"),
    Case("sw2_ex2_pipecr_jacobi24", "ex2:m=24,n=24",
         "-ksp_type pipecr -pc_type jacobi -ksp_rtol 1e-6"),
    Case("sw2_ex2_cheby_jacobi_ev", "ex2:m=20,n=20",
         "-ksp_type chebyshev -pc_type jacobi "
         "-ksp_chebyshev_eigenvalues 0.05,1.95 -ksp_rtol 1e-4"),
    Case("sw2_ex2_gcr_ilu24", "ex2:m=24,n=24",
         "-ksp_type gcr -pc_type ilu -ksp_rtol 1e-6"),
    Case("sw2_ex2_cgs_icc24", "ex2:m=24,n=24",
         "-ksp_type cgs -pc_type icc -ksp_rtol 1e-6"),
    Case("sw2_ex2_bcgsl_ell4", "ex2:m=24,n=24",
         "-ksp_type bcgsl -ksp_bcgsl_ell 4 -pc_type ilu -ksp_rtol 1e-6"),
    Case("sw2_ex2_minres_sor24", "ex2:m=24,n=24",
         "-ksp_type minres -pc_type sor -ksp_rtol 1e-6"),
    Case("sw2_ex2_symmlq_icc24", "ex2:m=24,n=24",
         "-ksp_type symmlq -pc_type icc -ksp_rtol 1e-6"),
    # eisenstat (PCPreSolve/PostSolve shell route)
    Case("sw2_ex2_cg_eisenstat24", "ex2:m=24,n=24",
         "-ksp_type cg -pc_type eisenstat -ksp_rtol 1e-6"),
    Case("sw2_ex2_gmres_eisenstat_om14", "ex2:m=20,n=20",
         "-ksp_type gmres -pc_type eisenstat -pc_eisenstat_omega 1.4 "
         "-ksp_rtol 1e-6"),
    # asm variants
    Case("sw2_ex2_gmres_asm2_basic", "ex2:m=20,n=20",
         "-ksp_type gmres -pc_type asm -pc_asm_blocks 2 "
         "-pc_asm_type basic -sub_pc_type lu -ksp_rtol 1e-6",
         note="serial multiblock ASM ignores -pc_asm_type: the "
              "localization scatter (asm.c:248) restricts writes to "
              "owned rows regardless — pinned as restricted"),
    Case("sw2_ex2_gmres_asm4_ov2", "ex2:m=20,n=20",
         "-ksp_type gmres -pc_type asm -pc_asm_blocks 4 "
         "-pc_asm_overlap 2 -sub_pc_type lu -ksp_rtol 1e-6"),
    # 1-D systems, other sizes
    Case("sw2_ex1_gmres_ilu200", "ex1:n=200",
         "-ksp_type gmres -pc_type ilu -ksp_rtol 1e-7"),
    Case("sw2_ex23_cg_sor120", "ex23:n=120",
         "-ksp_type cg -pc_type sor -ksp_rtol 1e-7", rtol=5e-3,
         note="51-it SSOR-CG: 3 tail values drift to 4e-3 rel "
              "(abs ~7e-10 vs rnorm0 0.96 — sweep-order fp noise)"),
    Case("sw2_ex2_rich_omega08", "ex2:m=16,n=16",
         "-ksp_type richardson -ksp_richardson_scale 0.8 -pc_type sor "
         "-ksp_rtol 1e-4"),
    Case("sw2_ex2_preonly_ilu", "ex2:m=20,n=20",
         "-ksp_type preonly -pc_type ilu", check="its"),
    Case("sw2_ex2_cg_natural", "ex2:m=20,n=20",
         "-ksp_type cg -ksp_norm_type natural -pc_type jacobi "
         "-ksp_rtol 1e-6"),
    # np > 1 (distributed path on the CPU mesh; oracle = serial
    # bjacobi equivalent, see module docstring)
    # reference-DEFAULT SOR on the bs=3 matrix: the silent Inode
    # block sweep, now implemented (InodeSORPC) — no flags needed
    Case("sw2_ex10b_bcgs_inodesor", "file:ex10_baij3.bin",
         "-ksp_type bcgs -pc_type sor -ksp_rtol 1e-5"),
    Case("sw2_ex10b_gmres_inodesor", "file:ex10_baij3.bin",
         "-ksp_type gmres -pc_type sor -ksp_rtol 1e-5"),
    Case("sw2_np2_ex2_cg_bjacobi", "ex2:m=16,n=16",
         "-ksp_type cg -pc_type bjacobi -sub_pc_type ilu "
         "-ksp_rtol 1e-6", np=2, oracle_args="-pc_bjacobi_blocks 2"),
    Case("sw2_np4_ex1_gmres_bjacobi", "ex1:n=160",
         "-ksp_type gmres -pc_type bjacobi -sub_pc_type ilu "
         "-ksp_rtol 1e-7", np=4, oracle_args="-pc_bjacobi_blocks 4"),
]

# ---- round-5 batch 3: +8 snes/ts depth -------------------------------------
CASES += [
    Case("sw3_snes5_l2_m14", "snes_ex5:m=14,par=2.0",
         "-snes_rtol 1e-8", check="snes"),
    Case("sw3_snes5_l55_m20", "snes_ex5:m=20,par=5.5",
         "-snes_rtol 1e-8", check="snes"),
    Case("sw3_snes5_l1_m8", "snes_ex5:m=8,par=1.0",
         "-snes_rtol 1e-8", check="snes"),
    Case("sw3_snes14_fdcolor_l4", "snes_ex14:m=9,par=4.0",
         "-fdcoloring -snes_rtol 1e-8", check="snes14"),
    Case("sw3_snes14_fdcolor_l2", "snes_ex14:m=12,par=2.0",
         "-fdcoloring -snes_rtol 1e-8", check="snes14"),
    Case("sw3_ts4_beuler_m80", "ts_ex4:m=80",
         "-ts_type beuler -ts_max_steps 25 -time_dependent_rhs "
         "-ksp_rtol 1e-12", check="ts"),
    Case("sw3_ts4_euler_m40", "ts_ex4:m=40",
         "-ts_type euler -ts_max_steps 60", check="ts"),
    Case("sw3_ts4_beuler_dt", "ts_ex4:m=50",
         "-ts_type beuler -ts_max_steps 30 -ts_init_time_step 0.0005 "
         "-time_dependent_rhs -ksp_rtol 1e-12", check="ts"),
]

# ---- round-5 batch 4: distributed SNES vs oracle stream --------------------
CASES += [
    Case("sw4_np4_snes5_l5_m16", "snes_ex5:m=16,par=5.0",
         "-snes_rtol 1e-8", np=4, check="snes_np"),
    Case("sw4_np8_snes5_l4_m12", "snes_ex5:m=12,par=4.0",
         "-snes_rtol 1e-8", np=8, check="snes_np"),
]

# ---- round-5 batch 5: +4 more distributed KSP configs ----------------------
CASES += [
    Case("sw5_np2_ex23_cg_jacobi", "ex23:n=160",
         "-ksp_type cg -pc_type jacobi -ksp_rtol 1e-7", np=2),
    Case("sw5_np4_ex2_tfqmr_bjacobi", "ex2:m=18,n=18",
         "-ksp_type tfqmr -pc_type bjacobi -sub_pc_type ilu "
         "-ksp_rtol 1e-6", np=4, oracle_args="-pc_bjacobi_blocks 4"),
    Case("sw5_np2_ex10n_fgmres_bjacobi", "file:ex10_nonsym.bin",
         "-ksp_type fgmres -pc_type bjacobi -sub_pc_type ilu "
         "-ksp_rtol 1e-5", np=2, oracle_args="-pc_bjacobi_blocks 2"),
    Case("sw5_np8_ex2_pipecg_jacobi", "ex2:m=24,n=24",
         "-ksp_type pipecg -pc_type jacobi -ksp_rtol 1e-6", np=8,
         check="its", oracle_args="-ksp_type cg",
         note="oracle side runs CG: the 3.3-era reference PIPECG "
         "diverges (PARITY); pipecg == cg mathematically, pinned on "
         "exact iteration count"),
]

# ---- round-5 batch 6: serial breadth across underrepresented axes ----------
CASES += [
    Case("sw6_ex2_cg_icc1", "ex2:m=26,n=26",
         "-ksp_type cg -pc_type icc -pc_factor_levels 1 -ksp_rtol 1e-6"),
    Case("sw6_ex2_cg_icc2", "ex2:m=26,n=26",
         "-ksp_type cg -pc_type icc -pc_factor_levels 2 -ksp_rtol 1e-6"),
    Case("sw6_ex2_rich_sor_fwd", "ex2:m=16,n=16",
         "-ksp_type richardson -pc_type sor -pc_sor_forward "
         "-ksp_rtol 1e-4"),
    Case("sw6_ex2_rich_sor_bwd", "ex2:m=16,n=16",
         "-ksp_type richardson -pc_type sor -pc_sor_backward "
         "-ksp_rtol 1e-4"),
    Case("sw6_ex2_gmres_restart45", "ex2:m=30,n=30",
         "-ksp_type gmres -pc_type jacobi -ksp_gmres_restart 45 "
         "-ksp_rtol 1e-6"),
    Case("sw6_ex2_cgs_ilu1", "ex2:m=24,n=24",
         "-ksp_type cgs -pc_type ilu -pc_factor_levels 1 "
         "-ksp_rtol 1e-6"),
    Case("sw6_ex2_bicg_icc", "ex2:m=20,n=20",
         "-ksp_type bicg -pc_type icc -ksp_rtol 1e-6"),
    Case("sw6_ex2_minres_icc", "ex2:m=24,n=24",
         "-ksp_type minres -pc_type icc -ksp_rtol 1e-6"),
    Case("sw6_ex2_symmlq_sor", "ex2:m=24,n=24",
         "-ksp_type symmlq -pc_type sor -ksp_rtol 1e-6"),
    Case("sw6_ex2_cr_icc", "ex2:m=24,n=24",
         "-ksp_type cr -pc_type icc -ksp_rtol 1e-6"),
    Case("sw6_ex2_groppcg_sor", "ex2:m=24,n=24",
         "-ksp_type groppcg -pc_type sor -ksp_rtol 1e-6"),
    Case("sw6_ex1_lsqr_jacobi200", "ex1:n=200",
         "-ksp_type lsqr -pc_type jacobi -ksp_rtol 1e-7",
         check="its_approx",
         note="507-it normal-equations run: fp drift accumulates to "
              "~2% of the iteration count (PARITY annotated class)"),
    Case("sw6_ex23_preonly_cholesky", "ex23:n=100",
         "-ksp_type preonly -pc_type cholesky", check="its"),
    Case("sw6_ex2_cheby_icc_ev", "ex2:m=20,n=20",
         "-ksp_type chebyshev -pc_type icc "
         "-ksp_chebyshev_eigenvalues 0.1,1.9 -ksp_rtol 1e-4"),
]

CASES += [
    # inode SOR its>1: exercises InodeSORPC's nonzero-guess sweep
    # branches (forward rhs = b - Ub x_old; backward explicit lower
    # residual) against the reference's general inode path
    Case("sw6_ex10b_rich_inodesor2", "file:ex10_baij3.bin",
         "-ksp_type richardson -pc_type sor -pc_sor_its 2 "
         "-ksp_rtol 1e-3"),
    Case("sw6_ex10b_gmres_inodesor2", "file:ex10_baij3.bin",
         "-ksp_type gmres -pc_type sor -pc_sor_its 2 -ksp_rtol 1e-5"),
]

CASES += [
    # ---- batch 7: factor orderings (SPARSPAK ports must be
    # vector-exact for these streams to match digit-for-digit:
    # genrcm/gennd/genqmd/gen1wd, src/mat/order/) -----------------------
    Case("sw7_ex2_gmres_ilu_nd", "ex2:m=20,n=20",
         "-ksp_type gmres -pc_type ilu -pc_factor_mat_ordering_type nd "
         "-ksp_rtol 1e-6"),
    Case("sw7_ex2_gmres_ilu_qmd", "ex2:m=20,n=20",
         "-ksp_type gmres -pc_type ilu -pc_factor_mat_ordering_type qmd "
         "-ksp_rtol 1e-6"),
    Case("sw7_ex2_gmres_ilu_1wd", "ex2:m=20,n=20",
         "-ksp_type gmres -pc_type ilu -pc_factor_mat_ordering_type 1wd "
         "-ksp_rtol 1e-6"),
    Case("sw7_ex2_cg_icc_rcm", "ex2:m=20,n=20",
         "-ksp_type cg -pc_type icc -pc_factor_mat_ordering_type rcm "
         "-ksp_rtol 1e-6"),
    Case("sw7_ex2_gmres_ilu3", "ex2:m=24,n=24",
         "-ksp_type gmres -pc_type ilu -pc_factor_levels 3 "
         "-ksp_rtol 1e-6"),
    Case("sw7_ex10p_cg_icc3", "file:ex10_poisson.bin",
         "-ksp_type cg -pc_type icc -pc_factor_levels 3 -ksp_rtol 1e-7"),
    # ---- batch 7: compositional PCs (composite.c additive/
    # multiplicative, PCKSP inner-solver, PCSVD, PCREDUNDANT serial) ----
    Case("sw7_ex2_cg_composite_add", "ex2:m=20,n=20",
         "-ksp_type cg -pc_type composite -pc_composite_pcs jacobi,sor "
         "-pc_composite_type additive -ksp_rtol 1e-6"),
    Case("sw7_ex2_gmres_composite_mult", "ex2:m=20,n=20",
         "-ksp_type gmres -pc_type composite -pc_composite_pcs "
         "jacobi,sor -pc_composite_type multiplicative -ksp_rtol 1e-6"),
    Case("sw7_ex2_fgmres_ksppc", "ex2:m=20,n=20",
         # fixed-sweep inner solve (norm_type none => exactly max_it
         # richardson sweeps): the PC is a deterministic linear
         # operator, so the outer stream pins digit-exact (an
         # rtol-stopped inner would compare solver-internal noise)
         "-ksp_type fgmres -pc_type ksp -ksp_ksp_type richardson "
         "-ksp_ksp_max_it 5 -ksp_ksp_norm_type none "
         "-ksp_pc_type sor -ksp_rtol 1e-6"),
    Case("sw7_ex2_gmres_svd", "ex2:m=16,n=16",
         "-ksp_type gmres -pc_type svd -ksp_rtol 1e-6"),
    Case("sw7_ex2_cg_redundant", "ex2:m=20,n=20",
         "-ksp_type cg -pc_type redundant -ksp_rtol 1e-6"),
    # ---- batch 7: solver breadth on the serial sweep systems ----------
    Case("sw7_ex2_fbcgsr_jacobi", "ex2:m=20,n=20",
         "-ksp_type fbcgsr -pc_type jacobi -ksp_rtol 1e-6"),
    Case("sw7_ex23_rich_sor_its3", "ex23:n=80",
         "-ksp_type richardson -pc_type sor -pc_sor_its 3 "
         "-ksp_rtol 1e-5"),
    Case("sw7_ex2_tcqmr_ilu", "ex2:m=20,n=20",
         "-ksp_type tcqmr -pc_type ilu -ksp_rtol 1e-6"),
]

CASES += [
    # ---- batch 8: transpose-PC solvers on nonsymmetric factors ------
    # (-pc_factor_transpose_solves is petsctpu's knob to pre-build the
    # transpose factor plans; the oracle ignores unknown options —
    # the reference builds M^-T on the fly inside PCApplyTranspose)
    Case("sw8_ex2_bicg_ilu", "ex2:m=20,n=20",
         "-ksp_type bicg -pc_type ilu -pc_factor_transpose_solves "
         "-ksp_rtol 1e-6"),
    Case("sw8_ex10n_bicg_ilu", "file:ex10_nonsym.bin",
         "-ksp_type bicg -pc_type ilu -pc_factor_transpose_solves "
         "-ksp_rtol 1e-6"),
    Case("sw8_ex2_cgne_ilu", "ex2:m=20,n=20",
         "-ksp_type cgne -pc_type ilu -pc_factor_transpose_solves "
         "-ksp_rtol 1e-6"),
    # ---- batch 8: Crank-Nicolson heat ladder (TSCN, theta=1/2) ------
    # NOTE cn: the 3.3-era reference TSCN DIVERGES on this linear
    # heat problem (error 2.2 -> 6.6 -> 15 from step 2 — a reference
    # defect; CN is unconditionally stable here). The oracle side is
    # minted with the equivalent correct stepper -ts_type theta
    # -ts_theta_theta 0.5 (last option wins), which our cn must match.
    Case("sw8_ts4_cn_m60", "ts_ex4:m=60",
         "-ts_type cn -ts_max_steps 40 -time_dependent_rhs "
         "-ksp_rtol 1e-12", check="ts",
         oracle_args="-ts_type theta -ts_theta_theta 0.5",
         note="oracle minted as theta(0.5); 3.3 TSCN diverges"),
    Case("sw8_ts4_cn_m40", "ts_ex4:m=40",
         "-ts_type cn -ts_max_steps 60 -time_dependent_rhs "
         "-ksp_rtol 1e-12", check="ts",
         oracle_args="-ts_type theta -ts_theta_theta 0.5",
         note="oracle minted as theta(0.5); 3.3 TSCN diverges"),
    # ---- batch 8: SBAIJ MatLoad route (-mat_type sbaij stores the
    # upper triangle; MatMult sums U + strict(U)^T contributions) ----
    Case("sw8_ex10p_sbaij_cg_icc", "file:ex10_poisson.bin",
         "-mat_type sbaij -ksp_type cg -pc_type icc -ksp_rtol 1e-7"),
    Case("sw8_ex10p_sbaij_cg_jacobi", "file:ex10_poisson.bin",
         "-mat_type sbaij -ksp_type cg -pc_type jacobi -ksp_rtol 1e-7"),
]

CASES += [
    # ---- batch 9: the reference's OWN regression targets for the
    # stateful spectral-estimate PC (makefile runex2_specest_1/_2,
    # src/ksp/ksp/examples/tutorials/makefile:365,:369) ---------------
    Case("sw9_ex2_fgmres_ksppc_specest", "ex2:m=80,n=80",
         "-ksp_type fgmres -pc_type ksp -ksp_ksp_type specest"),
    Case("sw9_ex2_fgmres_ksppc_specest_cg", "ex2:m=80,n=80",
         "-ksp_type fgmres -pc_type ksp -ksp_ksp_type specest "
         "-ksp_specest_ksp_type cg"),
    # ---- batch 9: trust-region CG family (infinite default radius ->
    # interior solve; validates the stcg/nash/gltr natural-norm
    # recurrence against the reference) ------------------------------
    Case("sw9_ex2_stcg_jacobi", "ex2:m=20,n=20",
         "-ksp_type stcg -pc_type jacobi -ksp_rtol 1e-6"),
    Case("sw9_ex2_nash_icc", "ex2:m=20,n=20",
         "-ksp_type nash -pc_type icc -ksp_rtol 1e-6"),
]

CASES += [
    # ---- batch 10: KSPCGUseSingleReduction + KSPSetDiagonalScale
    # (the reference's runex10_19 / runex10_6 feature axes on our
    # datafiles: -ksp_cg_single_reduction cg.c:349, -ksp_diagonal_scale
    # itfunc.c:237) ---------------------------------------------------
    Case("sw10_ex2_cg_sr_icc", "ex2:m=20,n=20",
         "-ksp_type cg -pc_type icc -ksp_cg_single_reduction "
         "-ksp_rtol 1e-6"),
    Case("sw10_ex2_cg_sr_natural", "ex2:m=20,n=20",
         "-ksp_type cg -pc_type jacobi -ksp_cg_single_reduction "
         "-ksp_norm_type natural -ksp_rtol 1e-6"),
    # (the sbaij variant of runex10_19 aborts in the 3.3 oracle:
    # SBAIJ has no MatSOR for PCEisenstat — pinned on aij instead)
    Case("sw10_ex10p_cg_eisen_sr", "file:ex10_poisson.bin",
         "-ksp_type cg -pc_type eisenstat "
         "-ksp_cg_single_reduction -ksp_rtol 1e-7"),
    Case("sw10_ex2_gmres_dscale", "ex2:m=20,n=20",
         "-ksp_type gmres -pc_type jacobi -ksp_diagonal_scale "
         "-ksp_diagonal_scale_fix -ksp_rtol 1e-6"),
    Case("sw10_ex10n_gmres_dscale_ilu", "file:ex10_nonsym.bin",
         "-ksp_type gmres -pc_type ilu -ksp_diagonal_scale "
         "-ksp_diagonal_scale_fix -ksp_rtol 1e-6"),
    Case("sw10_ex2_cg_dscale_eisen", "ex2:m=20,n=20",
         "-ksp_type cg -pc_type eisenstat -ksp_diagonal_scale "
         "-ksp_diagonal_scale_fix -ksp_rtol 1e-6"),
]

CASES += [
    # ---- batch 11: distributed variants of the round-5 features —
    # jacobi is rank-count-invariant so the mpiuni oracle's stream is
    # the exact distributed expectation ------------------------------
    Case("sw11_np4_ex2_cg_sr_jacobi", "ex2:m=24,n=24",
         "-ksp_type cg -pc_type jacobi -ksp_cg_single_reduction "
         "-ksp_rtol 1e-6", np=4),
    Case("sw11_np8_ex23_cg_sr_jacobi", "ex23:n=96",
         "-ksp_type cg -pc_type jacobi -ksp_cg_single_reduction "
         "-ksp_rtol 1e-8", np=8),
]

CASES += [
    # ---- batch 12: solver breadth on the 1-D systems + larger ex2 ---
    Case("sw12_ex1_tcqmr_jacobi", "ex1:n=200",
         "-ksp_type tcqmr -pc_type jacobi -ksp_rtol 1e-5"),
    Case("sw12_ex1_gcr_ilu", "ex1:n=200",
         "-ksp_type gcr -pc_type ilu -ksp_rtol 1e-5"),
    # the two jacobi cases run ~36/77 transient-spiky iterations on
    # the kappa~6e3 tridiagonal: fp accumulation drifts the tail by
    # +/-1 iteration (the PARITY-annotated drift class) — its_approx
    Case("sw12_ex23_bcgsl_jacobi", "ex23:n=120",
         "-ksp_type bcgsl -pc_type jacobi -ksp_rtol 1e-8",
         check="its_approx",
         note="long ill-conditioned run: +/-1 it fp drift"),
    Case("sw12_ex23_fbcgs_ilu", "ex23:n=120",
         "-ksp_type fbcgs -pc_type ilu -ksp_rtol 1e-8"),
    Case("sw12_ex23_fbcgsr_jacobi", "ex23:n=120",
         "-ksp_type fbcgsr -pc_type jacobi -ksp_rtol 1e-8",
         check="its_approx",
         note="long ill-conditioned run: +/-1 it fp drift"),
    # (ibcgs+sor aborts in the reference: IBCGS needs
    # PCApplyTranspose, which PCSOR lacks — precon.c:515)
    Case("sw12_ex23_ibcgs_ilu", "ex23:n=120",
         "-ksp_type ibcgs -pc_type ilu -pc_factor_transpose_solves "
         "-ksp_rtol 1e-8"),
    Case("sw12_ex2_lgmres_icc_aug2", "ex2:m=24,n=24",
         "-ksp_type lgmres -pc_type icc -ksp_lgmres_augment 2 "
         "-ksp_gmres_restart 12 -ksp_rtol 1e-6"),
    Case("sw12_ex2_minres_icc1", "ex2:m=24,n=24",
         "-ksp_type minres -pc_type icc -pc_factor_levels 1 "
         "-ksp_rtol 1e-6"),
    Case("sw12_ex2_symmlq_ssor14", "ex2:m=24,n=24",
         "-ksp_type symmlq -pc_type sor -pc_sor_symmetric "
         "-pc_sor_omega 1.4 -ksp_rtol 1e-6"),
    Case("sw12_ex2_cr_bjacobi8", "ex2:m=24,n=24",
         "-ksp_type cr -pc_type bjacobi -pc_bjacobi_blocks 8 "
         "-sub_pc_type icc -ksp_rtol 1e-6"),
]
