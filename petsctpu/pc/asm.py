"""PCASM — (restricted) additive Schwarz with overlap.

Reference: src/ksp/pc/impls/asm/asm.c (PCSetUp_ASM :175, PCApply_ASM
:424) with overlap growth via MatIncreaseOverlap
(src/mat/impls/aij/mpi/mpiov.c:17). Setup (host): partition rows into
nb contiguous blocks, grow each block `overlap` times through matrix
connectivity, factor each subdomain with ILU(0) or LU. Apply (device):
gather per-block slices, vmapped level-scheduled triangular solves
over the block axis, scatter with either full addition (basic ASM) or
owner-only writes (restricted ASM — the reference default, which
needs no interpolation communication).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from petsctpu.core.options import Options
from petsctpu.mat.factor import ilu0, lu_factor
from petsctpu.pc.parallel import _stacked_tri_plans


def increase_overlap(A: sp.csr_matrix, idx: np.ndarray,
                     overlap: int) -> np.ndarray:
    """Grow an index set by matrix connectivity `overlap` times
    (MatIncreaseOverlap analog)."""
    idx = np.asarray(idx)
    for _ in range(overlap):
        cols = A[idx].indices
        idx = np.unique(np.concatenate([idx, cols]))
    return idx


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ASMPC:
    idx: jax.Array        # int32 [nb, bmax] subdomain row indices (pad n)
    own: jax.Array        # bool  [nb, bmax] owner mask (restricted writes)
    valid: jax.Array      # bool  [nb, bmax] non-padding mask
    Lplans: Any           # stacked SpTRSVPlan pytree (leading axis nb)
    Uplans: Any
    perm_r: jax.Array     # int32 [nb, bmax] (LU only; identity for ILU)
    perm_c: jax.Array
    n: int = field(metadata=dict(static=True))
    restricted: bool = field(metadata=dict(static=True), default=True)
    use_perm: bool = field(metadata=dict(static=True), default=False)
    # zero-overlap equal contiguous blocks (the bjacobi shape): the
    # subdomain gather/scatter is a pure reshape — skips two n-sized
    # arbitrary gathers per apply
    contiguous: bool = field(metadata=dict(static=True), default=False)

    def apply(self, x):
        nb, bmax = self.idx.shape
        if self.contiguous:
            xs = jnp.zeros((nb * bmax,), x.dtype).at[: self.n].set(x)
            xs = xs.reshape(nb, bmax)
        else:
            xp = jnp.concatenate([x, jnp.zeros(1, x.dtype)])
            xs = xp[self.idx]                       # [nb, bmax]

        def sub_solve(Lp, Up, pr, pcm, b):
            if self.use_perm:
                b = jnp.zeros_like(b).at[pr].set(b)
            z = Up.solve(Lp.solve(b))
            if self.use_perm:
                z = z[pcm]
            return z

        ys = jax.vmap(sub_solve)(self.Lplans, self.Uplans, self.perm_r,
                                 self.perm_c, xs)
        if self.contiguous:
            return ys.reshape(-1)[: self.n]
        mask = self.valid & (self.own if self.restricted else True)
        tgt = jnp.where(mask, self.idx, self.n)
        y = jnp.zeros(self.n + 1, x.dtype).at[tgt.ravel()].add(
            jnp.where(mask, ys, 0).ravel())
        return y[: self.n]


def make_asm(A_host, nblocks: int = 4, overlap: int = 1,
             restricted: bool = True, sub_pc: str = "ilu",
             dtype=None, options: Options = None, blocks=None,
             outer=None, sub_ordering: str = "natural",
             tri: str = "auto") -> ASMPC:
    """blocks: optional explicit non-overlapping subdomains — a list of
    either (start, end) ranges or index arrays (PCASMSetLocalSubdomains
    analog; the default is the reference's one-per-rank equal split).

    outer: optional explicit OVERLAPPING subdomains paired with blocks
    (the PCGASMSetSubdomains iis/ois pair, gasm.c) — when given, the
    matrix-connectivity overlap growth is skipped and these index sets
    define the subdomain solves; `blocks` still defines the restricted
    prolongation ownership.

    sub_ordering ("sub_pc_factor_mat_ordering_type"): per-subdomain
    fill/bandwidth-reducing ordering for the ILU factors (the
    reference's -sub_pc_factor_mat_ordering_type rcm). tri
    ("sub_pc_factor_tri_solve"): 'level' | 'band2' | 'auto' — auto
    picks the two-phase dense-tile banded solve when the factors are fp32 and
    band-viable (pc/parallel.band_solve_viable), else level-scheduled
    gathers; the reference's default MatSolve is its fast path
    (aijfact.c:603), so ours auto-selects too."""
    opts = options or Options()
    nblocks = opts.get_int("pc_asm_blocks", nblocks)
    overlap = opts.get_int("pc_asm_overlap", overlap)
    if opts.get_str("pc_asm_type", "restrict") == "basic":
        restricted = False
    sub_pc = opts.get_str("sub_pc_type", sub_pc)
    sub_ordering = opts.get_str("sub_pc_factor_mat_ordering_type",
                                sub_ordering)
    tri = opts.get_str("sub_pc_factor_tri_solve", tri)

    A = sp.csr_matrix(A_host)
    n = A.shape[0]
    if blocks is not None:
        bases = [np.arange(b[0], b[1]) if isinstance(b, tuple)
                 else np.asarray(b) for b in blocks]
    else:
        bs = -(-n // nblocks)
        bases = [np.arange(k * bs, min((k + 1) * bs, n))
                 for k in range(nblocks)]
    blocks = []
    for k, base in enumerate(bases):
        if len(base) == 0:
            continue
        if outer is not None:
            ext = np.sort(np.asarray(outer[k]))
        else:
            ext = increase_overlap(A, base, overlap)
        blocks.append((base, ext))

    nb = len(blocks)
    bmax = max(len(e) for _, e in blocks)
    idx = np.full((nb, bmax), n, np.int32)
    own = np.zeros((nb, bmax), bool)
    valid = np.zeros((nb, bmax), bool)
    subs = []
    for k, (base, ext) in enumerate(blocks):
        idx[k, :len(ext)] = ext
        valid[k, :len(ext)] = True
        own[k, :len(ext)] = np.isin(ext, base)
        # subdomain matrix padded to bmax with identity tail
        from petsctpu.mat.base import csr_submatrix_keep_zeros
        Sub = csr_submatrix_keep_zeros(A, ext, ext)   # keeps stored 0s
        if len(ext) < bmax:
            pad = bmax - len(ext)
            Sub = sp.block_diag([Sub, sp.eye(pad)]).tocsr()
        subs.append(Sub)

    if sub_pc == "lu":
        Ls, Us, prs, pcs = [], [], [], []
        for S in subs:
            L, U, pr, pcm = lu_factor(S)
            Ls.append(L)
            Us.append(U)
            prs.append(pr)
            pcs.append(pcm)
        Lp = _stacked_tri_plans(Ls, True, False, dtype)
        Up = _stacked_tri_plans(Us, False, False, dtype)
        pr = jnp.asarray(np.stack(prs), jnp.int32)
        pcm = jnp.asarray(np.stack(pcs), jnp.int32)
        use_perm = True
    else:
        Ls, Us, iperms = [], [], []
        for S in subs:
            if sub_ordering not in ("natural", ""):
                from petsctpu.mat.order import get_ordering
                perm = get_ordering(S, sub_ordering)
                S = S[perm][:, perm].tocsr()
                iperms.append(np.argsort(perm))
            else:
                iperms.append(np.arange(S.shape[0]))
            L, U = ilu0(S)
            Ls.append(L)
            Us.append(U)
        if tri == "auto":
            from petsctpu.pc.parallel import band_solve_viable
            tri = "band2" if band_solve_viable(Ls, Us, dtype) else "level"
        if tri == "band2":
            from petsctpu.pc.parallel import _stacked_band_hier_plans
            Lp = _stacked_band_hier_plans(Ls, True, True, dtype)
            Up = _stacked_band_hier_plans(Us, False, False, dtype)
        else:
            Lp = _stacked_tri_plans(Ls, True, True, dtype)
            Up = _stacked_tri_plans(Us, False, False, dtype)
        # symmetric-permutation solves reuse the LU perm slots:
        # pb[iperm[i]] = b[i] permutes in, z[iperm] permutes back
        pr = jnp.asarray(np.stack(iperms), jnp.int32)
        pcm = pr
        use_perm = sub_ordering not in ("natural", "")

    # bjacobi shape: padded-flat [nb, bmax] layout IS the vector layout
    expected = np.arange(nb * bmax).reshape(nb, bmax)
    contiguous = bool(
        np.array_equal(np.where(valid, idx, -1),
                       np.where(valid, expected, -1))
        and valid.ravel()[:n].all() and not valid.ravel()[n:].any())
    return ASMPC(jnp.asarray(idx), jnp.asarray(own), jnp.asarray(valid),
                 Lp, Up, pr, pcm, n, restricted, use_perm, contiguous)
