"""petsctpu — a sparse linear-algebra and solver framework on JAX.

A from-scratch reimplementation of the capabilities of PETSc (reference:
erdc/petsc-dev) for accelerators: sharded vectors/matrices over
`jax.sharding.Mesh`, ELL-packed and structured SpMV layouts, halo
exchange via collectives inside `shard_map`, and Krylov/multigrid/Newton
solvers expressed as `lax.while_loop` programs.

Layer map (mirrors reference SURVEY.md §1):
  core     — options DB, logging/flops, error reasons, layouts   (≈ src/sys)
  vec      — vector ops, reductions, index sets                  (≈ src/vec)
  mat      — sparse/dense formats, assembly, factorizations      (≈ src/mat)
  parallel — device mesh, comm plans, sharded operators          (≈ MPI+VecScatter)
  ksp      — Krylov solvers                                      (≈ src/ksp/ksp)
  pc       — preconditioners                                     (≈ src/ksp/pc)
  snes     — nonlinear solvers                                   (≈ src/snes)
  ts       — time steppers                                       (≈ src/ts)
  dm       — structured grid manager (DMDA analog)               (≈ src/dm)
  models   — example problem builders (ex2/ex45/ex19 analogs)

Importing the package sets two process-wide JAX defaults, each only
when the user has not set it already:
  * matmul precision "highest": fp32 products and einsums run in full
    fp32, never TF32 (which keeps ~3 digits and would change Krylov
    histories); fp64 is unaffected;
  * a persistent compilation cache (see _enable_compile_cache).
"""

__version__ = "0.2.0"

from petsctpu.core.hostmem import tune_host_allocator as _tune

_tune()  # plan-time (host setup) allocator tuning; see core/hostmem.py


def _host_cpu_tag() -> str:
    """Short fingerprint of the host CPU's feature set. XLA:CPU AOT
    results embed the compile machine's features, and loading an
    executable built on a different host can SIGILL/segfault, so each
    CPU type gets its own cache subdirectory."""
    import hashlib
    import platform

    src = platform.machine() + platform.processor()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    src += line
                    break
    except OSError:
        pass
    return hashlib.sha1(src.encode()).hexdigest()[:10]


def compile_cache_dir() -> str:
    """Where the persistent XLA cache lives when JAX_COMPILATION_CACHE_DIR
    is not set: a fixed, git-ignored path inside the checkout
    (<repo>/.jax_cache/<host-cpu-tag>), so every process run from one
    checkout on one machine shares it."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, ".jax_cache", _host_cpu_tag())


def _enable_compile_cache():
    """Persistent XLA compilation cache (opt out:
    PETSCTPU_NO_COMPILE_CACHE=1). Solver setup compiles one program per
    (solver, operator-shape) pair, and the cache turns every repeat run
    (tests, benches, restarts) into a replay. JAX_COMPILATION_CACHE_DIR,
    when set, is JAX's own setting and is left alone."""
    import os

    if os.environ.get("PETSCTPU_NO_COMPILE_CACHE"):
        return
    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR") is None and \
            jax.config.jax_compilation_cache_dir is None:
        path = compile_cache_dir()
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def _set_matmul_precision():
    import jax

    if jax.config.jax_default_matmul_precision is None:
        jax.config.update("jax_default_matmul_precision", "highest")


_set_matmul_precision()
_enable_compile_cache()

from petsctpu.core.options import Options
from petsctpu.core.errors import ConvergedReason

__all__ = ["Options", "ConvergedReason", "__version__"]
