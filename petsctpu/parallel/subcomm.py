"""Subcommunicator nesting — sub-meshes of the device mesh (SURVEY P8).

Reference: PetscSubcomm (src/sys/objects/subcomm.c) and its consumers
PCREDUNDANT (gather to k subcomms, each solves redundantly) and PCHMPI.
Device equivalent: a 2-axis device mesh ("sub", "rows") — collectives
that name only "rows" span a SUBGROUP of devices, which IS the
subcommunicator. A k-group nested solve is then just the ordinary
sharded solver run under a 2-axis shard_map with the extra leading
"sub" batch axis on its operands; no new solver code.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from petsctpu.ksp.api import KSP_REGISTRY
from petsctpu.ksp.common import KSPConfig, SolveResult


def nested_mesh(nsub: int, devices=None, axis_sub: str = "sub",
                axis_rows: str = "rows") -> Mesh:
    """PetscSubcommCreate analog: split the device set into nsub groups
    of equal size; reductions over axis_rows stay inside a group."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if devices.size % nsub:
        raise ValueError(f"{devices.size} devices not divisible by "
                         f"nsub={nsub}")
    return Mesh(devices.reshape(nsub, devices.size // nsub),
                (axis_sub, axis_rows))


def _stack(trees):
    return jax.tree.map(lambda *ls: jnp.stack(ls), *trees)


def sub_ksp_solve(mesh: Mesh, A_list, b_list, cfg: KSPConfig = None,
                  pc_list=None, **kw) -> SolveResult:
    """Solve nsub independent systems, one per subgroup, CONCURRENTLY —
    each with axis_rows-way distributed parallelism (the PCREDUNDANT /
    PCHMPI execution shape: outer embarrassingly parallel, inner
    collective). A_list/b_list: one ShardedAIJ (built with
    nshards = mesh rows size) and padded global vector per subgroup."""
    from dataclasses import replace
    cfg = replace(cfg or KSPConfig(), **kw) if (kw or cfg is None) else cfg
    axis_sub, axis_rows = mesh.axis_names
    nsub = mesh.devices.shape[0]
    assert len(A_list) == nsub and len(b_list) == nsub
    # concurrent subgroups iterate their while-loops DIFFERENT numbers
    # of times; XLA:CPU's collective-permute rendezvous expects every
    # local device thread at each permute, so the ppermute halo style
    # deadlocks (40 s rendezvous abort) when one group finishes first.
    # all_to_all rendezvouses per replica group — coerce.
    A_list = [replace(A, style="alltoall")
              if getattr(A, "style", None) in ("ppermute", "auto")
              else A for A in A_list]
    A_st = _stack(A_list)                       # leaves [nsub, P, ...]
    npad = A_list[0].shape[0]
    bs = []
    for b in b_list:
        bh = np.asarray(b)
        bp = np.zeros(npad, bh.dtype)
        bp[: len(bh)] = bh
        bs.append(jnp.asarray(bp))
    b_st = jnp.stack(bs)
    if pc_list is not None:
        pc_st = _stack(pc_list)
        pc_spec = jax.tree.map(lambda _: P(axis_sub, axis_rows), pc_st)
    else:
        pc_st, pc_spec = None, None
    fn = KSP_REGISTRY[cfg.ksp_type]
    axis = A_list[0].axis

    @jax.jit
    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(axis_sub, axis_rows), P(axis_sub, axis_rows), pc_spec),
        out_specs=SolveResult(P(axis_sub, axis_rows), P(axis_sub),
                              P(axis_sub), P(axis_sub), P(axis_sub)),
        check_vma=False)
    def run(A_g, b_g, pc_g):
        # strip the length-1 sub axis, then the length-1 rows axis
        A_loc = jax.tree.map(lambda a: a[0], A_g)
        A = A_loc.local()
        pc = None
        if pc_g is not None:
            pc = jax.tree.map(lambda a: a[0][0], pc_g)
        b = b_g[0]
        res = fn(A, b, jnp.zeros_like(b), pc, cfg, axis_rows)
        return SolveResult(res.x[None], res.its[None], res.reason[None],
                           res.rnorm[None], res.history[None])

    return run(A_st, b_st, pc_st)
