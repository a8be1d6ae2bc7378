"""Distributed solves: shard_map wrapper around the axis-parametric KSP.

The same solver code that runs serially runs here inside
`shard_map` over a 1-D device mesh; collectives appear only through
vec.ops (psum) and ShardedAIJ.ghosts (all_to_all/all_gather). This is
the device equivalent of the reference running the identical source
under real MPI vs mpiuni (SURVEY.md §2.10 P1-P4).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from petsctpu.core.layout import Layout
from petsctpu.ksp.api import KSP_REGISTRY
from petsctpu.ksp.common import KSPConfig, SolveResult
from petsctpu.parallel.pmat import ShardedAIJ
from petsctpu.parallel.plan import PartitionedCSR


def shard_vector(mesh: Mesh, axis: str, x: np.ndarray, layout: Layout):
    """Place a padded global vector row-sharded on the mesh."""
    xp = layout.pad_vector(np.asarray(x))
    return jax.device_put(jnp.asarray(xp), NamedSharding(mesh, P(axis)))


def place_on_mesh(mesh: Mesh, tree, specs):
    """device_put every leaf of `tree` with NamedSharding(mesh, spec)
    for its PartitionSpec in `specs` (a spec pytree of the same
    structure, as `shard_map` takes). Stacked operators and PCs are
    built on one device; this spreads them over the mesh once, and is
    a no-op for leaves already placed."""
    if tree is None:
        return None
    shardings = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                             is_leaf=lambda s: isinstance(s, P))
    return jax.device_put(tree, shardings)


def operator_specs(A, axis: str):
    """Spec pytree of a stacked sharded operator: every leaf splits its
    leading shard axis over `axis`."""
    return jax.tree.map(lambda _: P(axis), A)


def unshard_vector(x, layout: Layout) -> np.ndarray:
    return np.asarray(x)[: layout.n]


def _local(tree):
    if tree is None:
        return None
    if hasattr(tree, "local"):
        return tree.local()
    return jax.tree.map(lambda a: a[0], tree)


def _pc_specs(pc, axis):
    """Spec pytree for a PC argument: stacked leaves shard on axis 0;
    PCs with mixed layouts (e.g. DistMGPC's replicated coarse
    hierarchy) declare their own via `shard_specs(axis)`."""
    if pc is None:
        return None
    if hasattr(pc, "shard_specs"):
        return pc.shard_specs(axis)
    return jax.tree.map(lambda _: P(axis), pc)


_PAR_CACHE: dict = {}


def _compiled_par(ksp_type: str, cfg: KSPConfig, axis: str, mesh_key,
                  pc_spec):
    spec_leaves, spec_def = jax.tree.flatten(pc_spec)
    key = (ksp_type, cfg, axis, mesh_key, tuple(map(str, spec_leaves)),
           str(spec_def))
    if key in _PAR_CACHE:
        return _PAR_CACHE[key]
    mesh = mesh_key.mesh
    fn = KSP_REGISTRY[ksp_type]

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), pc_spec),
        out_specs=SolveResult(P(axis), P(), P(), P(), P()),
        check_vma=False)
    def run_inner(A_st, b_loc, x0_loc, pc_st):
        A = A_st.local()
        pc = _local(pc_st)
        return fn(A, b_loc, x0_loc, pc, cfg, axis)

    run_jit = jax.jit(run_inner)
    pctag = format(abs(hash(str(spec_def))) % 16 ** 4, "04x")
    cfgtag = format(abs(hash(cfg)) % 16 ** 4, "04x")
    akey_base = (f"ksp:{ksp_type}[{'x'.join(map(str, mesh.devices.shape))}]"
                 f"/pc:{pctag}/cfg:{cfgtag}")

    def run(A_st, b_loc, x0_loc, pc_st):
        # compile-time collective audit (the -log_summary Mess ledger;
        # core/commaudit): trace once per PROGRAM (the key carries the
        # problem size and solver config — different programs must not
        # share Mess numbers). Tracing costs about as much as the jit
        # trace itself, so it only runs when someone will read it
        # (logging enabled, or AUDIT_ALWAYS set by the dryrun).
        from petsctpu.core import commaudit
        from petsctpu.core import logging as plog
        akey = f"{akey_base}/n{b_loc.shape[0]}"
        if (plog.log_enabled() or commaudit.AUDIT_ALWAYS) \
                and akey not in commaudit.COMM_AUDITS:
            try:
                commaudit.COMM_AUDITS[akey] = commaudit.audit_collectives(
                    run_inner, A_st, b_loc, x0_loc, pc_st)
            except Exception:
                commaudit.COMM_AUDITS[akey] = None
        res = run_jit(A_st, b_loc, x0_loc, pc_st)
        if plog.log_enabled() \
                and commaudit.COMM_AUDITS.get(akey) is not None:
            a = commaudit.COMM_AUDITS[akey]
            its = int(res.its)          # sync is fine: logging is opt-in
            plog.log_comm(
                f"KSPSolve_{ksp_type}",
                a.once.total_count + its * a.per_iteration.total_count,
                a.once.total_bytes + its * a.per_iteration.total_bytes)
        return res

    _PAR_CACHE[key] = run
    return run


class _MeshKey:
    """Hashable wrapper so meshes can key the compile cache."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __hash__(self):
        return hash((self.mesh.axis_names, self.mesh.devices.shape,
                     tuple(d.id for d in self.mesh.devices.flat)))

    def __eq__(self, other):
        return isinstance(other, _MeshKey) and hash(self) == hash(other)


def par_ksp_solve(mesh: Mesh, A: ShardedAIJ, b, x0=None, pc=None,
                  cfg: KSPConfig = None, **kw) -> SolveResult:
    """Distributed KSP solve. b may be a host global vector (auto-padded
    and sharded) or an already-sharded padded device array."""
    from dataclasses import replace
    cfg = replace(cfg or KSPConfig(), **kw) if (kw or cfg is None) else cfg
    axis = A.axis
    if isinstance(b, np.ndarray) or (hasattr(b, "shape")
                                     and b.shape[0] != A.shape[0]):
        bh = np.asarray(b)
        bp = np.zeros(A.shape[0], bh.dtype)
        bp[: len(bh)] = bh                 # pad to the operator's padded size
        b = jax.device_put(jnp.asarray(bp), NamedSharding(mesh, P(axis)))
    if x0 is None:
        x0 = jnp.zeros_like(b)
    pc_spec = _pc_specs(pc, axis)
    A = place_on_mesh(mesh, A, operator_specs(A, axis))
    pc = place_on_mesh(mesh, pc, pc_spec)
    run = _compiled_par(cfg.ksp_type, cfg, axis, _MeshKey(mesh), pc_spec)
    return run(A, b, x0, pc)


class ParKSP:
    """Stateful distributed KSP (mirrors KSP but over a mesh)."""

    def __init__(self, mesh: Mesh, options=None, prefix: str = ""):
        from petsctpu.core.options import Options
        self.mesh = mesh
        self.opts = (options or Options()).prefixed(prefix)
        self.A: Optional[ShardedAIJ] = None
        self.part: Optional[PartitionedCSR] = None
        self.pc = None

    def set_operators(self, A: ShardedAIJ, part: PartitionedCSR = None):
        self.A = A
        self.part = part
        return self

    def solve(self, b, x0=None) -> SolveResult:
        from petsctpu.ksp.api import config_from_options
        cfg = config_from_options(self.opts)
        if self.pc is None:
            from petsctpu.pc.parallel import make_par_pc
            pc_type = self.opts.get_str("pc_type", "bjacobi")
            self.pc = make_par_pc(pc_type, self.A, self.part,
                                  options=self.opts)
        return par_ksp_solve(self.mesh, self.A, b, x0=x0, pc=self.pc,
                             cfg=cfg)


def audit_par_ksp(nshards: int, A: ShardedAIJ, b, x0=None, pc=None,
                  cfg: KSPConfig = None, **kw):
    """Collective audit of a distributed KSP program WITHOUT devices:
    traces the shard_map program over an AbstractMesh (no execution),
    so a 1-chip box can still report the per-iteration collective
    counts/bytes an n-shard solve would issue (core/commaudit; the
    reference's -log_summary Mess columns, plog.c:1264)."""
    from dataclasses import replace

    from petsctpu.core.commaudit import audit_collectives

    cfg = replace(cfg or KSPConfig(), **kw) if (kw or cfg is None) else cfg
    axis = A.axis
    mesh = jax.sharding.AbstractMesh((nshards,), (axis,))
    fn = KSP_REGISTRY[cfg.ksp_type]

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), _pc_specs(pc, axis)),
        out_specs=SolveResult(P(axis), P(), P(), P(), P()),
        check_vma=False)
    def run_inner(A_st, b_loc, x0_loc, pc_st):
        Al = A_st.local()
        pcl = _local(pc_st)
        return fn(Al, b_loc, x0_loc, pcl, cfg, axis)

    if x0 is None:
        x0 = jnp.zeros_like(b)
    return audit_collectives(run_inner, A, b, x0, pc)
