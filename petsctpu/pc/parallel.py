"""Distributed preconditioners (stacked per-shard pytrees).

Reference: the default parallel PC of the reference is block Jacobi
with one ILU(0) block per rank (PCSetUp_BJacobi src/ksp/pc/impls/
bjacobi/bjacobi.c:14). Here a "block" is a shard's diagonal block; the
sub-solve is a level-scheduled ILU(0)/LU apply — embarrassingly
parallel inside shard_map (SURVEY §2.10 P6). The returned pytrees have
a leading shard axis; `shard_map` splits them and `_local()` strips it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from petsctpu.core.options import Options
from petsctpu.mat.factor import ilu0, lu_factor, make_sptrsv_plan
from petsctpu.pc.factor import ILUPC, LUPC
from petsctpu.pc.simple import JacobiPC
from petsctpu.parallel.plan import PartitionedCSR


def stack_pytrees(trees):
    """Stack a list of identically-structured pytrees along axis 0."""
    return jax.tree.map(lambda *ls: jnp.stack(ls), *trees)


def _stacked_tri_plans(tris, lower, unit_diag, dtype):
    """Build per-shard SpTRSV plans with uniform static shapes, stacked."""
    import scipy.sparse as sp

    from petsctpu.mat.factor import _levels
    nlev = rmax = K = 1
    infos = []
    for T in tris:
        T = sp.csr_matrix(T)
        lev = _levels(T, lower)
        nl = int(lev.max()) + 1 if T.shape[0] else 1
        counts = np.bincount(lev, minlength=nl)
        rm = max(int(counts.max()), 1)
        offk = max(int((np.diff(T.indptr) - (0 if unit_diag else 1)).max())
                   if T.nnz else 0, 1)
        nlev, rmax, K = max(nlev, nl), max(rmax, rm), max(K, offk + 1)
    plans = [make_sptrsv_plan(T, lower=lower, unit_diag=unit_diag,
                              dtype=dtype, pad_to=(nlev, rmax, K))
             for T in tris]
    return stack_pytrees(plans)


def _stacked_band_hier_plans(tris, lower, unit_diag, dtype, tile=128):
    """Build per-block two-phase banded plans with uniform static
    shapes (common nt and window W), stacked for vmap — the fast
    MatSolve route for bjacobi/ASM subdomain factors
    (mat/factor.BandTRSVHierPlan; the reference's default MatSolve is
    its fast path, aijfact.c:603)."""
    from petsctpu.mat.factor import band_dims, make_band_trsv_hier_plan
    nt = W = 1
    for T in tris:
        nti, Wi = band_dims(T, lower, tile)
        nt, W = max(nt, nti), max(W, Wi)
    plans = [make_band_trsv_hier_plan(T, lower=lower, unit_diag=unit_diag,
                                      dtype=dtype, tile=tile,
                                      pad_to=(nt, W))
             for T in tris]
    return stack_pytrees(plans)


def band_solve_viable(tris_lower, tris_upper, dtype,
                      mem_cap_bytes: int = 2 * 1024 * 1024 * 1024,
                      tile: int = 128) -> bool:
    """Auto triangular-solve strategy probe: the banded two-phase plan
    is selected when (a) the value dtype is fp32 (fp64 factors take
    the gather-based level-scheduled solve) and (b) the dense band storage
    (off + prefix tables, ~2·nt·T·W floats per triangle) fits the cap.
    RCM-ordered stencil factors pass; SuperLU fill patterns with
    near-n bandwidth fail back to level scheduling."""
    from petsctpu.mat.factor import band_dims
    if np.dtype(dtype or np.float64) != np.float32:
        return False
    total = 0
    for tris, lower in ((tris_lower, True), (tris_upper, False)):
        for T in tris:
            nt, W = band_dims(T, lower, tile)
            L = max(int(np.ceil(np.sqrt(nt))), 1)
            G = -(-nt // L)
            total += (2 * L * G * tile * W + G * W * W
                      + L * G * tile * tile) * 4
    return total <= mem_cap_bytes


def make_bjacobi(part: PartitionedCSR, sub_pc: str = "ilu", dtype=None):
    """Block Jacobi over shard diagonal blocks; sub_pc: ilu | lu."""
    if sub_pc == "ilu":
        Ls, Us = [], []
        for D in part.diag_blocks:
            L, U = ilu0(D)
            Ls.append(L)
            Us.append(U)
        return ILUPC(_stacked_tri_plans(Ls, True, True, dtype),
                     _stacked_tri_plans(Us, False, False, dtype))
    if sub_pc == "lu":
        Ls, Us, prs, pcs = [], [], [], []
        for D in part.diag_blocks:
            L, U, pr, pcm = lu_factor(D)
            Ls.append(L)
            Us.append(U)
            prs.append(pr)
            pcs.append(pcm)
        return LUPC(_stacked_tri_plans(Ls, True, False, dtype),
                    _stacked_tri_plans(Us, False, False, dtype),
                    jnp.asarray(np.stack(prs), jnp.int32),
                    jnp.asarray(np.stack(pcs), jnp.int32))
    raise ValueError(f"bjacobi sub_pc {sub_pc!r} not supported")


def make_par_jacobi(part: PartitionedCSR, dtype=None) -> JacobiPC:
    dinvs = []
    for D in part.diag_blocks:
        d = D.diagonal()
        d = np.where(d != 0, d, 1.0)
        dinvs.append(jnp.asarray((1.0 / d).astype(dtype or d.dtype)))
    return JacobiPC(jnp.stack(dinvs))


def make_par_pc(pc_type: str, A, part: PartitionedCSR = None,
                options: Options = None):
    """Factory for stacked distributed PCs (PCSetUp analog, parallel)."""
    opts = options or Options()
    dtype = getattr(A, "dtype", None)
    dtype = np.dtype(str(dtype)) if dtype is not None else None
    if pc_type == "none":
        return None
    if pc_type == "jacobi":
        _need_part(part, "jacobi")
        return make_par_jacobi(part, dtype)
    if pc_type == "bjacobi":
        _need_part(part, "bjacobi")
        return make_bjacobi(part, sub_pc=opts.get_str("sub_pc_type", "ilu"),
                            dtype=dtype)
    raise ValueError(f"unknown parallel pc_type {pc_type!r}")


def _need_part(part, name):
    if part is None:
        raise ValueError(f"parallel pc {name} needs the PartitionedCSR "
                         "(returned by sharded_aij_from_scipy)")


# ---------------------------------------------------------------------------
# Block Jacobi with per-block inner KSPs (PCBJacobiGetSubKSP)
# ---------------------------------------------------------------------------

class BJacobiKSPPC:
    """Block Jacobi whose sub-blocks are solved by their OWN inner KSP,
    each with its own solver type, preconditioner, and tolerances —
    the PCBJacobiGetSubKSP customization surface the reference
    demonstrates in ksp ex7.c:136-160 (per-block PCSetType/KSPSetType/
    KSPSetTolerances). Each application nests the inner while_loop
    solves; blocks are a static Python tuple so XLA sees straight-line
    code."""

    def __init__(self, blocks, pcs, cfgs, offsets):
        self.blocks = tuple(blocks)     # device diag-block operators
        self.pcs = tuple(pcs)           # per-block inner PC (or None)
        self.cfgs = tuple(cfgs)         # per-block KSPConfig (static)
        self.offsets = tuple(offsets)   # row ranges [(s,e), ...]

    def apply(self, x):
        from petsctpu.ksp.api import KSP_REGISTRY
        outs = []
        for Ab, pc, cfg, (s, e) in zip(self.blocks, self.pcs, self.cfgs,
                                       self.offsets):
            seg = x[s:e]
            r = KSP_REGISTRY[cfg.ksp_type](Ab, seg, jnp.zeros_like(seg),
                                           pc, cfg, None)
            outs.append(r.x)
        return jnp.concatenate(outs)


def _bjk_flatten(p):
    return (p.blocks, p.pcs), (p.cfgs, p.offsets)


def _bjk_unflatten(aux, children):
    obj = object.__new__(BJacobiKSPPC)
    obj.blocks, obj.pcs = children
    obj.cfgs, obj.offsets = aux
    return obj


jax.tree_util.register_pytree_node(
    BJacobiKSPPC, _bjk_flatten, _bjk_unflatten)


def make_bjacobi_ksp(A_host, blocks, cfgs, sub_pcs, dtype=None):
    """blocks: list of (start, end) row ranges; cfgs: per-block
    KSPConfig; sub_pcs: per-block pc_type string ("none"/"jacobi"/
    "ilu"/"lu")."""
    import scipy.sparse as sp

    from petsctpu.mat.ell import aij_from_scipy
    from petsctpu.pc.api import make_pc

    A = sp.csr_matrix(A_host)
    ops, pcs = [], []
    for (s, e), pct in zip(blocks, sub_pcs):
        D = A[s:e][:, s:e].tocsr()
        Dd = aij_from_scipy(D, dtype=dtype)
        ops.append(Dd)
        pcs.append(None if pct == "none"
                   else make_pc(pct, A=Dd, A_host=D))
    return BJacobiKSPPC(ops, pcs, cfgs, blocks)


# ---------------------------------------------------------------------------
# Distributed overlapping ASM (VERDICT r5: overlap distribution)
# ---------------------------------------------------------------------------
class DistASMPC:
    """Restricted additive Schwarz over DISTRIBUTED overlapping
    subdomains: per-shard overlap-k row sets grown by matrix
    connectivity (MatIncreaseOverlap, mpiov.c:17), ghost residual
    values fetched with a dedicated halo plan (the DMPlexDistribute
    overlap ghost layer, plex.c:3085-3126), a stacked sparse LU on
    each padded overlapped submatrix, and RESTRICTED prolongation
    (owned rows only — asm.c PC_ASM_RESTRICT default)."""

    def __init__(self, Lup, send_idx, ghost_src, s, nshards, axis):
        object.__setattr__(self, "Lup", Lup)
        object.__setattr__(self, "send_idx", send_idx)
        object.__setattr__(self, "ghost_src", ghost_src)
        object.__setattr__(self, "s", s)
        object.__setattr__(self, "nshards", nshards)
        object.__setattr__(self, "axis", axis)

    def apply(self, r):
        from jax import lax
        send = r[self.send_idx]                    # [P, smax]
        recv = lax.all_to_all(send, self.axis, split_axis=0,
                              concat_axis=0)
        g = recv.reshape(-1)[self.ghost_src]       # [gmax]
        v = jnp.concatenate([r, g])
        z = self.Lup.apply(v)
        return z[: self.s]


def _distasm_flatten(p):
    return ((p.Lup, p.send_idx, p.ghost_src),
            (p.s, p.nshards, p.axis))


def _distasm_unflatten(aux, children):
    return DistASMPC(children[0], children[1], children[2], *aux)


jax.tree_util.register_pytree_node(DistASMPC, _distasm_flatten,
                                   _distasm_unflatten)


def make_dist_asm(A_host, part: PartitionedCSR, overlap: int = 1,
                  dtype=None, axis: str = "rows") -> DistASMPC:
    """Distributed restricted ASM with overlap-k subdomains.

    Matches the serial pc/asm.make_asm with the same explicit
    (blocks, outer) subdomains — iteration-count parity between the
    1-process and distributed solves (tests/test_dist_asm.py)."""
    import scipy.sparse as sp

    lay = part.layout
    P, s = lay.nshards, lay.shard_size
    n = sp.csr_matrix(A_host).shape[0]
    npad = lay.n_padded
    A = sp.csr_matrix(A_host)
    # identity-pad to the layout size
    if npad > n:
        A = sp.bmat([[A, None],
                     [None, sp.eye(npad - n, format="csr")]],
                    format="csr")
    A.sort_indices()

    garrays, locals_, subs = [], [], []
    for p in range(P):
        own = np.arange(p * s, (p + 1) * s)
        idx = own
        for _ in range(overlap):
            cols = A[idx].indices
            idx = np.union1d(idx, cols)
        remote = np.setdiff1d(idx, own)
        garrays.append(remote.astype(np.int64))
        locals_.append((own, remote))

    from petsctpu.parallel.plan import _build_halo
    halo = _build_halo(lay, garrays, P)
    gmax = halo.gmax
    nsub = s + gmax

    Ls, Us, prs, pcs = [], [], [], []
    for p in range(P):
        own, remote = locals_[p]
        rows = np.concatenate([own, remote])
        Sub = A[rows][:, rows].tocsr()
        k = Sub.shape[0]
        if k < nsub:                       # pad ghost slots -> identity
            Sub = sp.bmat([[Sub, None],
                           [None, sp.eye(nsub - k, format="csr")]],
                          format="csr")
        L, U, pr, pcm = lu_factor(Sub)
        Ls.append(L)
        Us.append(U)
        prs.append(pr)
        pcs.append(pcm)
    lup = LUPC(_stacked_tri_plans(Ls, True, False, dtype),
               _stacked_tri_plans(Us, False, False, dtype),
               jnp.asarray(np.stack(prs), jnp.int32),
               jnp.asarray(np.stack(pcs), jnp.int32))
    return DistASMPC(lup, jnp.asarray(halo.send_idx),
                     jnp.asarray(halo.ghost_src), s, P, axis)


# ---------------------------------------------------------------------------
# PCHMPI — outer-sequential user, inner-parallel solve (P8)
# ---------------------------------------------------------------------------
@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class HMPIPC:
    """PCHMPI analog (src/ksp/pc/impls/openmp): the OUTER solver runs
    as ordinary single-stream code; each preconditioner application
    solves M z = r with an INNER distributed KSP over a device mesh.
    The inner shard_map composes under the outer jit, so the outer
    Krylov loop stays one compiled program — the reference's
    "sequential user, parallel PC" split becomes a nested-mesh
    region instead of a second MPI communicator."""

    Ash: Any                     # ShardedAIJ over the inner mesh
    pc_inner: Any
    n: int = field(metadata=dict(static=True))
    cfg: Any = field(metadata=dict(static=True), default=None)
    mesh: Any = field(metadata=dict(static=True), default=None)

    def apply(self, b):
        import functools

        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        from petsctpu.ksp.api import KSP_REGISTRY
        from petsctpu.ksp.common import SolveResult

        axis = self.Ash.axis
        npad = self.Ash.shape[0]
        bp = jnp.zeros(npad, b.dtype).at[: self.n].set(b)
        pc_spec = jax.tree.map(lambda _: P(axis), self.pc_inner)
        fn = KSP_REGISTRY[self.cfg.ksp_type]

        @functools.partial(
            shard_map, mesh=self.mesh,
            in_specs=(P(axis), P(axis), pc_spec),
            out_specs=SolveResult(P(axis), P(), P(), P(), P()),
            check_vma=False)
        def inner(A_st, b_loc, pc_st):
            from petsctpu.parallel.api import _local
            return fn(A_st.local(), b_loc, jnp.zeros_like(b_loc),
                      _local(pc_st), self.cfg, axis)

        res = inner(self.Ash, bp, self.pc_inner)
        return res.x.reshape(-1)[: self.n]


def make_hmpi(A_host, mesh=None, options=None, dtype=None):
    """Build the PCHMPI analog: partition A over `mesh` (or all
    devices), inner bjacobi(ILU)+KSP with the reference's `-hmpi_`
    option prefix (ksp_type/rtol/max_it)."""
    import scipy.sparse as sp
    from jax.sharding import Mesh

    from petsctpu.core.options import Options
    from petsctpu.ksp.common import KSPConfig
    from petsctpu.parallel.pmat import sharded_aij_from_scipy

    opts = (options or Options()).prefixed("hmpi_")
    if mesh is None:
        mesh = Mesh(np.array(jax.devices()), ("rows",))
    nsh = int(np.prod(mesh.devices.shape))
    A = sp.csr_matrix(A_host)
    # alltoall halo style: the inner while trip count is data-dependent
    # and ppermute's XLA:CPU rendezvous is global (see subcomm.py)
    Ash, part = sharded_aij_from_scipy(A, nsh, dtype=dtype,
                                       style="alltoall")
    pc_inner = make_bjacobi(part, sub_pc=opts.get_str("sub_pc_type",
                                                      "ilu"),
                            dtype=dtype)
    cfg = KSPConfig(ksp_type=opts.get_str("ksp_type", "gmres"),
                    rtol=opts.get_real("ksp_rtol", 1e-8),
                    maxits=opts.get_int("ksp_max_it", 200))
    return HMPIPC(Ash, pc_inner, A.shape[0], cfg, mesh)
