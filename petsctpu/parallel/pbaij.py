"""ShardedBAIJ — distributed blocked sparse matrix (MPIBAIJ analog).

Reference: src/mat/impls/baij/mpi/mpibaij.c (row-partitioned BSR with
per-rank diag/offdiag blocks and a block-compressed garray; MatMult
uses the same scatter/local/scatter/offdiag overlap as MPIAIJ but
moves bs-sized value blocks). Here the halo plan works at BLOCK
granularity: each exchanged unit is one bs-vector, so multi-DOF
problems (elasticity bs=3) move their natural quanta and the SpMV
kernels are batched bs×bs einsums.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from jax import lax

from petsctpu.core.layout import Layout


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ShardedBAIJ:
    """Leaves carry a leading shard axis [P, ...] (like ShardedAIJ)."""

    diag_bcols: jax.Array    # int32 [P, sb, K1] local block cols
    diag_bvals: jax.Array    # [P, sb, K1, bs, bs]
    off_bcols: jax.Array     # int32 [P, sb, K2] ghost block slots
    off_bvals: jax.Array     # [P, sb, K2, bs, bs]
    send_idx: jax.Array      # int32 [P, P, smax] local BLOCK indices
    ghost_src: jax.Array     # int32 [P, gmax] position in recv flat
    shape: tuple = field(metadata=dict(static=True))     # global scalar
    bs: int = field(metadata=dict(static=True), default=1)
    nshards: int = field(metadata=dict(static=True), default=1)
    axis: str = field(metadata=dict(static=True), default="rows")
    nnzb: int = field(metadata=dict(static=True), default=0)

    def local(self) -> "ShardedBAIJ":
        return jax.tree.map(lambda a: a[0], self)

    @property
    def nloc_b(self):
        return self.diag_bcols.shape[-2]

    @property
    def dtype(self):
        return self.diag_bvals.dtype

    def ghosts(self, xb: jax.Array) -> jax.Array:
        """Fetch remote x BLOCKS for my ghost slots: [gmax+1, bs]."""
        send = xb[self.send_idx]                 # [P, smax, bs]
        recv = lax.all_to_all(send, self.axis, split_axis=0, concat_axis=0)
        flat = recv.reshape(-1, self.bs)         # [P*smax, bs]
        g = flat[self.ghost_src]                 # [gmax, bs]
        return jnp.concatenate([g, jnp.zeros((1, self.bs), g.dtype)])

    def mult(self, x_local: jax.Array) -> jax.Array:
        xb = x_local.reshape(self.nloc_b, self.bs)
        if self.nshards == 1:
            y = jnp.einsum("rkij,rkj->ri", self.diag_bvals, xb[self.diag_bcols])
            return y.reshape(x_local.shape)
        g = self.ghosts(xb)                      # collective issued first
        y = jnp.einsum("rkij,rkj->ri", self.diag_bvals, xb[self.diag_bcols])
        y = y + jnp.einsum("rkij,rkj->ri", self.off_bvals, g[self.off_bcols])
        return y.reshape(x_local.shape)

    def diagonal(self) -> jax.Array:
        rows = jnp.arange(self.nloc_b)[:, None]
        own = (self.diag_bcols == rows)[..., None, None]
        D = jnp.sum(jnp.where(own, self.diag_bvals, 0.0), axis=1)
        return jax.vmap(jnp.diag)(D).reshape(-1)

    def flops_per_mult(self) -> float:
        return 2.0 * self.nnzb * self.bs * self.bs


def sharded_baij_from_scipy(A, nshards: int, bs: int, dtype=None,
                            axis: str = "rows") -> ShardedBAIJ:
    """Build from a global scipy matrix; block rows are split
    contiguously with block-aligned padding."""
    Ab = sp.bsr_matrix(sp.csr_matrix(A), blocksize=(bs, bs))
    nb = Ab.shape[0] // bs
    lay = Layout(nb, nshards)                    # block-row layout
    P, sb = nshards, lay.shard_size
    dtype = dtype or Ab.data.dtype
    indptr, indices, data = Ab.indptr, Ab.indices, Ab.data

    # per-shard split into diag / offdiag block entries + garray
    rows_of = [[[] for _ in range(sb)] for _ in range(P)]
    gsets = [set() for _ in range(P)]
    for br in range(nb):
        p, rl = divmod(br, sb)
        lo, hi = p * sb, (p + 1) * sb
        for k in range(indptr[br], indptr[br + 1]):
            bc = indices[k]
            if lo <= bc < hi:
                rows_of[p][rl].append(("d", bc - lo, data[k]))
            else:
                rows_of[p][rl].append(("o", bc, data[k]))
                gsets[p].add(bc)
    garrays = [np.array(sorted(g), np.int64) for g in gsets]
    gmax = max(1, max(len(g) for g in garrays))

    K1 = max(1, max(sum(1 for e in r if e[0] == "d")
                    for rs in rows_of for r in rs))
    K2 = max(1, max(sum(1 for e in r if e[0] == "o")
                    for rs in rows_of for r in rs))
    dc = np.zeros((P, sb, K1), np.int32)
    dv = np.zeros((P, sb, K1, bs, bs), dtype)
    oc = np.full((P, sb, K2), gmax, np.int32)    # pad → zero sentinel block
    ov = np.zeros((P, sb, K2, bs, bs), dtype)
    for p in range(P):
        gmap = {g: i for i, g in enumerate(garrays[p])}
        for rl in range(sb):
            i1 = i2 = 0
            for kind, c, blk in rows_of[p][rl]:
                if kind == "d":
                    dc[p, rl, i1] = c
                    dv[p, rl, i1] = blk
                    i1 += 1
                else:
                    oc[p, rl, i2] = gmap[c]
                    ov[p, rl, i2] = blk
                    i2 += 1

    # block-level send plan: shard q needs garrays[q]; owner p sends
    # local block send_idx[p][q] = those of q's ghosts owned by p
    sends = [[[] for _ in range(P)] for _ in range(P)]   # [owner][dest]
    for q in range(P):
        for g in garrays[q]:
            owner = g // sb
            sends[owner][q].append(g - owner * sb)
    smax = max(1, max(len(s) for row in sends for s in row))
    send_idx = np.zeros((P, P, smax), np.int32)
    for p in range(P):
        for q in range(P):
            for j, loc in enumerate(sends[p][q]):
                send_idx[p, q, j] = loc
    # ghost_src: for shard q, ghost i (global block g, owner p) sits in
    # recv flat at p*smax + (index of g among p→q sends)
    ghost_src = np.zeros((P, gmax), np.int32)
    for q in range(P):
        for i, g in enumerate(garrays[q]):
            p = g // sb
            j = sends[p][q].index(g - p * sb)
            ghost_src[q, i] = p * smax + j

    return ShardedBAIJ(
        jnp.asarray(dc), jnp.asarray(dv), jnp.asarray(oc), jnp.asarray(ov),
        jnp.asarray(send_idx), jnp.asarray(ghost_src),
        (lay.n_padded * bs, lay.n_padded * bs), bs, P, axis,
        int(Ab.indptr[-1]))
