"""Vector operations, serial and SPMD.

The reference's Vec layer (reference: src/vec — _VecOps vtable
include/petsc-private/vecimpl.h:222; VecNorm_MPI = local norm +
MPI_Allreduce at src/vec/vec/impls/mpi/pvec2.c:48). Here a "vector" is
just a jax.Array; distribution is expressed by running the SAME code
inside `shard_map` over a mesh axis, with `axis=<name>` turning local
reductions into `lax.psum` collectives. `axis=None` means
serial — the single code path covers both, the device analog of the
reference's mpiuni trick (src/sys/mpiuni/mpi.c).

The fused multi-reduction `reduce_all` is the analog of the reference's
split-phase VecDotBegin/VecNormBegin...End machinery
(src/vec/vec/utils/comb.c:57 PetscSplitReduction): batch several inner
products into ONE psum so a GMRES/CG iteration pays a single collective
latency.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax import lax


def psum(x, axis: Optional[str]):
    """All-reduce sum over the mesh axis; identity when serial."""
    if axis is None:
        return x
    return lax.psum(x, axis)


def dot(a: jax.Array, b: jax.Array, axis: Optional[str] = None):
    """Global inner product aᴴb (VecDot)."""
    local = jnp.vdot(a, b)
    return psum(local, axis)


def norm(a: jax.Array, axis: Optional[str] = None):
    """Global 2-norm (VecNorm NORM_2): local sum-of-squares then psum."""
    local = jnp.vdot(a, a).real
    return jnp.sqrt(psum(local, axis))


def norm_1(a: jax.Array, axis: Optional[str] = None):
    return psum(jnp.sum(jnp.abs(a)), axis)


def norm_inf(a: jax.Array, axis: Optional[str] = None):
    local = jnp.max(jnp.abs(a))
    if axis is None:
        return local
    return lax.pmax(local, axis)


def mdot(x: jax.Array, V: jax.Array, axis: Optional[str] = None):
    """Batched inner products x·V[i] for a stack of vectors V [k, n].

    The reference's VecMDot (src/vec/vec/impls/seq/dvec2.c:36) — the
    GMRES orthogonalization hot spot. Here this is a single
    matrix-vector product followed by one psum.
    """
    local = V.conj() @ x  # [k]  (VecMDot conjugates V, vdot semantics;
    #                        conj is a no-op for real dtypes)
    return psum(local, axis)


def axpy(y, alpha, x):
    """y ← y + alpha·x (VecAXPY)."""
    return y + alpha * x


def aypx(y, alpha, x):
    """y ← x + alpha·y (VecAYPX)."""
    return x + alpha * y


def waxpy(alpha, x, y):
    """w = alpha·x + y (VecWAXPY)."""
    return alpha * x + y


def pointwise_mult(x, y):
    return x * y


def pointwise_divide(x, y):
    return x / y


def reduce_all(locals_: Sequence, axis: Optional[str]):
    """Fuse several scalar reductions into one psum (comb.c analog).

    Pass the LOCAL partial values (e.g. local dots); returns the tuple
    of globally reduced values. With axis=None it is a no-op.
    """
    if axis is None:
        return tuple(locals_)
    stacked = jnp.stack([jnp.asarray(v) for v in locals_])
    red = lax.psum(stacked, axis)
    return tuple(red[i] for i in range(len(locals_)))
