"""Sharded sparse matrix: the MPIAIJ analog.

Reference: MPIAIJ (src/mat/impls/aij/mpi/mpiaij.c — struct mpiaij.h:77,
MatMult_MPIAIJ :1102). Each shard holds a diagonal block A (local
columns) and an off-diagonal block B with compressed ghost columns
(garray), plus a halo plan. The reference's scatter-begin / local-mult
/ scatter-end / offdiag-multadd overlap (mpiaij.c:1111-1114) maps to:
issue the collective, compute the diag SpMV, then consume the ghosts —
XLA schedules the collective asynchronously.

Leaves carry a leading shard axis [P, ...] so `shard_map(in_specs=
P(axis))` splits them; methods run INSIDE shard_map on the [1, ...]
local slices.

Two halo styles:
  * "alltoall": pack per-destination send buffers, one lax.all_to_all,
    gather ghost slots (O(P·smax) per shard — tight for stencils).
  * "allgather": all_gather the whole vector and gather ghosts by
    global index (O(N) — robust fallback, best for small P or dense
    coupling).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from petsctpu.core.layout import Layout
from petsctpu.parallel.plan import partition_csr, ell_pack


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ShardedAIJ:
    """Row-partitioned ELL matrix (leading axis = shard)."""

    diag_cols: jax.Array    # int32 [P, nloc, K1] local col indices
    diag_vals: jax.Array    # [P, nloc, K1]
    off_cols: jax.Array     # int32 [P, nloc, K2] ghost slot indices
    off_vals: jax.Array     # [P, nloc, K2]
    send_idx: jax.Array     # int32 [P, P, smax]
    ghost_src: jax.Array    # int32 [P, gmax]
    ghost_gidx: jax.Array   # int32 [P, gmax]
    shape: tuple = field(metadata=dict(static=True))        # global (padded)
    nshards: int = field(metadata=dict(static=True), default=1)
    axis: str = field(metadata=dict(static=True), default="rows")
    style: str = field(metadata=dict(static=True), default="alltoall")
    nnz: int = field(metadata=dict(static=True), default=0)
    # ring offsets with traffic (plan.HaloPlan.offsets) — drives the
    # "ppermute" style's unrolled neighbor shifts
    offsets: tuple = field(metadata=dict(static=True), default=())
    # optional stacked SellMat over the diag blocks (fmt="sell"): the
    # local SpMV of every distributed solve then runs SellMat instead
    # of the ELL gather — the MatMult_SeqAIJ-inside-MatMult_MPIAIJ
    # path (mpiaij.c:1102)
    diag_sell: Any = None

    # ---- local (inside shard_map) view --------------------------------
    def local(self) -> "ShardedAIJ":
        """Strip the leading length-1 shard axis after shard_map split."""
        return jax.tree.map(lambda a: a[0], self)

    @property
    def nloc(self):
        return self.diag_cols.shape[-2]

    @property
    def dtype(self):
        return self.diag_vals.dtype

    def ghosts(self, x_local: jax.Array) -> jax.Array:
        """Halo exchange: fetch remote x values for my ghost slots."""
        if self.style == "allgather":
            xg = lax.all_gather(x_local, self.axis, tiled=True)   # [n_padded]
            return xg[self.ghost_gidx]
        if self.style == "ppermute":
            # one lax.ppermute ring-shift per plan offset: payload is
            # O(neighbors)*smax per shard, independent of P (the
            # weak-scalable route; the reference's neighbor Isend/Irecv
            # vpscat.c engine rather than MPI_Alltoallv)
            P, smax = self.send_idx.shape
            i = lax.axis_index(self.axis)
            rbuf = jnp.zeros((P, smax), x_local.dtype)
            for d in self.offsets:
                dst = (i + d) % P
                send = x_local[jnp.take(self.send_idx, dst, axis=0)]
                recv = lax.ppermute(
                    send, self.axis,
                    [(p, (p + d) % P) for p in range(self.nshards)])
                src = ((i - d) % P).astype(jnp.int32)
                rbuf = jax.lax.dynamic_update_slice(
                    rbuf, recv[None], (src, jnp.int32(0)))
            return rbuf.reshape(-1)[self.ghost_src]
        send = x_local[self.send_idx]                # [P, smax]
        recv = lax.all_to_all(send, self.axis, split_axis=0, concat_axis=0)
        return recv.reshape(-1)[self.ghost_src]      # [gmax]

    def _diag_mult(self, x_local: jax.Array) -> jax.Array:
        if self.diag_sell is not None:
            return self.diag_sell.mult(x_local).astype(x_local.dtype)
        return jnp.sum(self.diag_vals * x_local[self.diag_cols], axis=1)

    def mult(self, x_local: jax.Array) -> jax.Array:
        """y_local = (A x)_local with overlapped halo exchange."""
        if self.nshards == 1:
            return self._diag_mult(x_local)
        g = self.ghosts(x_local)                     # collective issued first
        y = self._diag_mult(x_local)
        y = y + jnp.sum(self.off_vals * g[self.off_cols], axis=1)
        return y

    def multT(self, x_local: jax.Array) -> jax.Array:
        """y_local = (Aᵀ x)_local — MatMultTranspose_MPIAIJ analog.

        The diag block transposes locally (scatter-add over ELL slots);
        the off-diag block's contributions land on GHOST slots and ride
        the halo plan in REVERSE (the reference's scatter-reverse,
        VecScatterBegin(...,SCATTER_REVERSE) in mpiaij.c MatMultTranspose):
        alltoall style inverts the pack/exchange/gather pipeline,
        allgather style scatters into global positions and psums."""
        dt = x_local.dtype
        xw = (self.diag_vals * x_local[:, None]).reshape(-1)
        y = jnp.zeros(self.nloc, dt).at[self.diag_cols.reshape(-1)].add(xw)
        if self.nshards == 1:
            return y
        gmax = self.ghost_src.shape[-1]
        gbuf = jnp.zeros(gmax + 1, dt)          # +1 = sentinel pad slot
        ow = (self.off_vals * x_local[:, None]).reshape(-1)
        gbuf = gbuf.at[self.off_cols.reshape(-1)].add(ow)
        gbuf = gbuf[:gmax]
        if self.style == "allgather":
            contrib = jnp.zeros(self.shape[0], dt).at[self.ghost_gidx].add(
                gbuf)
            tot = lax.psum(contrib, self.axis)
            i = lax.axis_index(self.axis)
            return y + lax.dynamic_slice(tot, (i * self.nloc,), (self.nloc,))
        P, smax = self.send_idx.shape
        rbuf = jnp.zeros(P * smax, dt).at[self.ghost_src].add(gbuf)
        if self.style == "ppermute":
            # scatter-reverse: return each owner's contributions along
            # the inverse ring shifts
            rb = rbuf.reshape(P, smax)
            i = lax.axis_index(self.axis)
            for d in self.offsets:
                src = (i - d) % P
                back = lax.ppermute(
                    jnp.take(rb, src, axis=0), self.axis,
                    [(p, (p - d) % P) for p in range(self.nshards)])
                dst = (i + d) % P
                y = y.at[jnp.take(self.send_idx, dst, axis=0)].add(back)
            return y
        back = lax.all_to_all(rbuf.reshape(P, smax), self.axis,
                              split_axis=0, concat_axis=0)
        return y.at[self.send_idx.reshape(-1)].add(back.reshape(-1))

    def diagonal(self) -> jax.Array:
        rows = jnp.arange(self.nloc, dtype=self.diag_cols.dtype)[:, None]
        return jnp.sum(jnp.where(self.diag_cols == rows, self.diag_vals, 0),
                       axis=1)

    def flops_per_mult(self) -> float:
        return 2.0 * self.nnz - self.shape[0]


def sharded_aij_from_scipy(A, nshards: int, dtype=None,
                           style: str = "auto",
                           axis: str = "rows", perm=None,
                           fmt: str = "ell") -> tuple:
    """Build a ShardedAIJ (stacked host arrays → device) + PartitionedCSR.

    Returns (mat, part) — `part` keeps the host-side per-shard scipy
    blocks for PC setup (bjacobi/ILU need them).

    perm: optional row/column permutation applied BEFORE the contiguous
    row split — the MatPartitioning→distribution hook (SURVEY P12):
    pass np.argsort(partition_rcm(A, nshards), kind="stable") so each
    contiguous shard holds one graph partition (small halo), or a
    partitioner NAME ("kway" — the multilevel ParMetis analog — or
    "rcm") to compute it here. Vectors must be permuted consistently
    (x_perm = x[perm]); pass the used perm back via the second return's
    .perm attribute when a name was given."""
    import scipy.sparse as sp
    if isinstance(perm, str):
        from petsctpu.mat.partition import (partition_kway, partition_rcm)
        pfun = {"kway": partition_kway, "rcm": partition_rcm}[perm]
        perm = np.argsort(pfun(sp.csr_matrix(A), nshards), kind="stable")
    if perm is not None:
        perm = np.asarray(perm)
        A = sp.csr_matrix(A)[perm][:, perm]
    part = partition_csr(A, nshards)
    part.perm = perm
    lay = part.layout
    P, s = nshards, lay.shard_size
    dtype = dtype or np.asarray(A.data[:1]).dtype

    K1 = max(max(int(np.diff(D.indptr).max()) if D.nnz else 0
                 for D in part.diag_blocks), 1)
    K2 = max(max(int(np.diff(O.indptr).max()) if O.nnz else 0
                 for O in part.off_blocks), 1)
    gmax = part.halo.gmax

    dc = np.zeros((P, s, K1), np.int32)
    dv = np.zeros((P, s, K1), dtype)
    oc = np.full((P, s, K2), gmax, np.int32)   # pad → sentinel ghost slot
    ov = np.zeros((P, s, K2), dtype)
    for p in range(P):
        c, v = ell_pack(part.diag_blocks[p], K1)
        dc[p], dv[p] = c, v.astype(dtype)
        c, v = ell_pack(part.off_blocks[p], K2)
        # pad entries (val 0) keep col 0 — harmless; real ghost slots < gmax
        oc[p, :, :], ov[p] = c, v.astype(dtype)

    # fmt="sell": local diag blocks through SellMat (stacked per-shard
    # plans with common static dims so the leading shard axis splits
    # under shard_map); every block must be viable
    diag_sell = None
    if fmt == "sell" and np.dtype(dtype) != np.float32:
        raise ValueError("fmt='sell' needs dtype=float32 (SellMat's "
                         "dtype)")
    if fmt == "sell":
        from petsctpu.mat.sell import (sell_from_scipy, sell_plan_stats,
                                       sell_viable)
        import scipy.sparse as sp2
        blocks = [sp2.csr_matrix(D).astype(np.float32)
                  for D in part.diag_blocks]
        for D in blocks:
            D.sum_duplicates()
        if all(sell_viable(D) for D in blocks):
            npass = S = Lp = 1
            for D in blocks:
                Pp, _, Ss, _ = sell_plan_stats(D)
                npass, S = max(npass, Pp), max(S, Ss)
            mats = [sell_from_scipy(D, force=(npass, S, 1))
                    for D in blocks]
            Lp = max(M.Lp for M in mats)
            if Lp != min(M.Lp for M in mats):
                mats = [sell_from_scipy(D, force=(npass, S, Lp))
                        for D in blocks]
            import dataclasses
            # uniform static metadata (nnz differs per block) so the
            # pytree treedefs match for stacking
            nz = max(int(D.nnz) for D in blocks)
            mats = [dataclasses.replace(M, nnz=nz) for M in mats]
            diag_sell = jax.tree.map(lambda *ls: jnp.stack(ls), *mats)
        else:
            raise ValueError("fmt='sell': a diag block is not "
                             "SELL-viable; use fmt='ell'")

    if style == "auto":
        # few ring offsets (banded/partitioned-with-locality rows) ->
        # neighbor ppermute shifts; dense coupling -> one all_to_all
        noff = len(part.halo.offsets)
        style = "ppermute" if 0 < noff <= 4 else "alltoall"
    # ghost buffer gets one sentinel slot (gmax) that always reads 0
    mat = ShardedAIJ(
        diag_cols=jnp.asarray(dc), diag_vals=jnp.asarray(dv),
        off_cols=jnp.asarray(oc), off_vals=jnp.asarray(ov),
        send_idx=jnp.asarray(part.halo.send_idx),
        ghost_src=jnp.asarray(part.halo.ghost_src),
        ghost_gidx=jnp.asarray(part.halo.ghost_gidx),
        shape=(lay.n_padded, lay.n_padded), nshards=P, axis=axis,
        style=style, nnz=int(sp_nnz(A)),
        offsets=part.halo.offsets, diag_sell=diag_sell)
    return mat, part


def sp_nnz(A):
    import scipy.sparse as sp
    return sp.csr_matrix(A).nnz


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ShardedRectAIJ:
    """Row-partitioned RECTANGULAR ELL operator — the sharded form of
    a GAMG/AMG prolongator P: coarse → fine. Rows follow the fine
    layout, columns the coarse layout; `mult` halos the COARSE vector
    (garray plan over the column space), `multT` runs the plan in
    reverse with scatter-adds (MatMultTranspose's scatter-reverse).
    Same leaves/conventions as ShardedAIJ; runs inside shard_map."""

    diag_cols: jax.Array    # int32 [P, nrloc, K1] local coarse cols
    diag_vals: jax.Array
    off_cols: jax.Array     # int32 [P, nrloc, K2] ghost slots (pad=gmax)
    off_vals: jax.Array
    send_idx: jax.Array     # int32 [P, P, smax] into local coarse vec
    ghost_src: jax.Array    # int32 [P, gmax]
    shape: tuple = field(metadata=dict(static=True))   # padded (nf, nc)
    ncloc: int = field(metadata=dict(static=True), default=1)
    nshards: int = field(metadata=dict(static=True), default=1)
    axis: str = field(metadata=dict(static=True), default="rows")
    nnz: int = field(metadata=dict(static=True), default=0)

    def local(self) -> "ShardedRectAIJ":
        return jax.tree.map(lambda a: a[0], self)

    @property
    def nrloc(self):
        return self.diag_cols.shape[-2]

    def _ghosts(self, xc_local):
        send = xc_local[self.send_idx]               # [P, smax]
        recv = lax.all_to_all(send, self.axis, split_axis=0,
                              concat_axis=0)
        return recv.reshape(-1)[self.ghost_src]      # [gmax]

    def mult(self, xc_local: jax.Array) -> jax.Array:
        """Prolongate: local coarse [ncloc] → local fine [nrloc]."""
        if self.nshards == 1:
            return jnp.sum(self.diag_vals * xc_local[self.diag_cols],
                           axis=1)
        g = self._ghosts(xc_local)
        y = jnp.sum(self.diag_vals * xc_local[self.diag_cols], axis=1)
        return y + jnp.sum(self.off_vals * g[self.off_cols], axis=1)

    def multT(self, xf_local: jax.Array) -> jax.Array:
        """Restrict: local fine [nrloc] → local coarse [ncloc]."""
        dt = xf_local.dtype
        dw = (self.diag_vals * xf_local[:, None]).reshape(-1)
        y = jnp.zeros(self.ncloc, dt).at[
            self.diag_cols.reshape(-1)].add(dw)
        if self.nshards == 1:
            return y
        gmax = self.ghost_src.shape[-1]
        gbuf = jnp.zeros(gmax + 1, dt)               # sentinel pad slot
        ow = (self.off_vals * xf_local[:, None]).reshape(-1)
        gbuf = gbuf.at[self.off_cols.reshape(-1)].add(ow)[:gmax]
        P, smax = self.send_idx.shape[-2:]
        rbuf = jnp.zeros(P * smax, dt).at[self.ghost_src].add(gbuf)
        back = lax.all_to_all(rbuf.reshape(P, smax), self.axis,
                              split_axis=0, concat_axis=0)
        return y.at[self.send_idx.reshape(-1)].add(back.reshape(-1))


def sharded_rect_from_scipy(A, nshards: int, dtype=None,
                            axis: str = "rows") -> ShardedRectAIJ:
    """Partition a rectangular scipy matrix (prolongator) over the
    mesh axis; see parallel.plan.partition_rect_csr."""
    import scipy.sparse as sp

    from petsctpu.parallel.plan import partition_rect_csr

    A = sp.csr_matrix(A)
    rlay, clay, Ds, Os, gars, halo = partition_rect_csr(A, nshards)
    P = nshards
    dtype = dtype or A.dtype
    K1 = max(max(int(np.diff(D.indptr).max()) if D.nnz else 0
                 for D in Ds), 1)
    K2 = max(max(int(np.diff(O.indptr).max()) if O.nnz else 0
                 for O in Os), 1)
    gmax = halo.gmax
    sr = rlay.shard_size
    dc = np.zeros((P, sr, K1), np.int32)
    dv = np.zeros((P, sr, K1), dtype)
    oc = np.full((P, sr, K2), gmax, np.int32)
    ov = np.zeros((P, sr, K2), dtype)
    from petsctpu.parallel.plan import ell_pack
    for p in range(P):
        c, v = ell_pack(Ds[p], K1)
        dc[p], dv[p] = c, v.astype(dtype)
        c, v = ell_pack(Os[p], K2)
        oc[p], ov[p] = c, v.astype(dtype)
    return ShardedRectAIJ(
        jnp.asarray(dc), jnp.asarray(dv), jnp.asarray(oc),
        jnp.asarray(ov), jnp.asarray(halo.send_idx),
        jnp.asarray(halo.ghost_src),
        shape=(rlay.n_padded, clay.n_padded), ncloc=clay.shard_size,
        nshards=P, axis=axis, nnz=int(A.nnz))


def sharded_aij_from_decomp(A, dec, dtype=None, style: str = "alltoall",
                            axis: str = "rows") -> tuple:
    """Shard a matrix assembled in NATURAL (application) ordering over
    the ranks of a DADecomp2D — 2-D block domain decomposition.

    The decomposition's rank-major PETSc ordering (dm/decomp.py) makes
    each rank's 2-D patch a CONTIGUOUS row range, so the standard
    equal-shard Layout machinery applies after padding every patch to
    the largest patch size (pad rows are identity, pad rhs 0 — they
    stay exactly 0 through any Krylov iteration). Halo volume per
    shard is O(patch perimeter) instead of the O(grid width) of 1-D
    strip sharding — the win grows as √P (SURVEY §2.10 P2).

    Returns (mat, part, q) with q the natural→padded-slot index map:
    x_padded[q] = x_natural; recover x_natural = x_padded[q].
    """
    import scipy.sparse as sp

    p = dec.natural_to_petsc()
    ranges = dec.petsc_row_ranges()
    P = dec.size
    S = max(e - s for s, e in ranges)
    nt = P * S
    # target slot of each petsc index
    tgt = np.empty(p.size, np.int64)
    for r, (s, e) in enumerate(ranges):
        tgt[s:e] = r * S + np.arange(e - s)
    q = tgt[p]                                  # natural -> padded slot

    A = sp.csr_matrix(A).tocoo()
    used = np.zeros(nt, bool)
    used[q] = True
    pad = np.flatnonzero(~used)
    Ap = sp.coo_matrix(
        (np.concatenate([A.data, np.ones(pad.size, A.data.dtype)]),
         (np.concatenate([q[A.row], pad]),
          np.concatenate([q[A.col], pad]))), shape=(nt, nt)).tocsr()
    mat, part = sharded_aij_from_scipy(Ap, P, dtype=dtype, style=style,
                                       axis=axis)
    return mat, part, q
