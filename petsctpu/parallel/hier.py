"""Two-level (DCN-aware) halo plans: hierarchical MPIAIJ for multi-host.

The reference's network model is flat MPI: VecScatter sends one message
per neighbor rank regardless of where it lives (vpscat.c). On a
multi-host cluster the fabric is two-level — a fast link within a host
("ici" axis), a slower network between hosts ("dcn" axis) — and the
efficient shape is the hierarchical plan PETSc approximates with
PCHMPI / GAMG proc-agglomeration (SURVEY §5.7): stage intra-host
traffic first and cross hosts only with aggregated, rail-aligned
messages.

Mesh: ("dcn", "ici") of shape (H, C); global shard p = h·C + c
(row-major, matching PartitionSpec(("dcn","ici")) on a 1-D row axis).

Halo exchange in two phases (owner → requester (h_r, c_r)):
  phase 1 (ici): owner (h_o, c_o) sends the value to the *gateway*
     chip (h_o, c_r) — one all_to_all over "ici" per host, buckets
     keyed by destination chip index.
  phase 2 (dcn): gateway (h_o, c_r) forwards to (h_r, c_r) — one
     rail-aligned all_to_all over "dcn" (only same-chip-index pairs
     talk across hosts; per-chip DCN message count drops from H·C−C
     to H−1).
Intra-host ghosts terminate after phase 1. The reverse plan (for
MatMultTranspose / scatter-reverse) runs the same two all_to_alls
backward with scatter-adds.

Plan-time is host numpy (like plan.partition_csr, which this reuses
for the diag/offdiag/garray split); run-time is pure collectives
inside shard_map.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from petsctpu.parallel.plan import PartitionedCSR, ell_pack, partition_csr


@dataclass
class HierHaloPlan:
    """Stacked (leading axis = shard, p = h·C + c) two-level plan."""

    send1_idx: np.ndarray   # int32 [P, C, s1max] local x idx → dest chip
    send2_src: np.ndarray   # int32 [P, H, s2max] recv1-flat idx → dest host
    ghost_src: np.ndarray   # int32 [P, gmax] into concat(recv1, recv2)
    n_ghost: np.ndarray     # int64 [P]
    s1max: int
    s2max: int
    gmax: int


def build_hier_halo(lay, garrays, H: int, C: int) -> HierHaloPlan:
    P = H * C
    s = lay.shard_size
    send1 = [[[] for _ in range(C)] for _ in range(P)]
    send2 = [[[] for _ in range(H)] for _ in range(P)]
    # ghost routing notes resolved to flat indices once maxima are known
    notes = []                     # per shard: list of tuples
    for p_r in range(P):
        h_r, c_r = divmod(p_r, C)
        rows = []
        for g in garrays[p_r]:
            q = int(g) // s
            h_o, c_o = divmod(q, C)
            lidx = int(g) - q * s
            pos1 = len(send1[q][c_r])
            send1[q][c_r].append(lidx)
            if h_o == h_r:
                rows.append(("intra", c_o, pos1))
            else:
                gw = h_o * C + c_r
                pos2 = len(send2[gw][h_r])
                send2[gw][h_r].append((c_o, pos1))
                rows.append(("inter", h_o, pos2))
        notes.append(rows)

    s1max = max((len(b) for sh in send1 for b in sh), default=1) or 1
    s2max = max((len(b) for sh in send2 for b in sh), default=1) or 1
    gmax = max((len(g) for g in garrays), default=1) or 1

    send1_idx = np.zeros((P, C, s1max), np.int32)
    send2_src = np.zeros((P, H, s2max), np.int32)
    ghost_src = np.zeros((P, gmax), np.int32)
    n_ghost = np.zeros(P, np.int64)
    for p in range(P):
        for c in range(C):
            b = send1[p][c]
            send1_idx[p, c, :len(b)] = b
        for h in range(H):
            for j, (c_o, pos1) in enumerate(send2[p][h]):
                send2_src[p, h, j] = c_o * s1max + pos1
        n_ghost[p] = len(notes[p])
        for k, note in enumerate(notes[p]):
            if note[0] == "intra":
                _, c_o, pos1 = note
                ghost_src[p, k] = c_o * s1max + pos1
            else:
                _, h_o, pos2 = note
                ghost_src[p, k] = C * s1max + h_o * s2max + pos2
    return HierHaloPlan(send1_idx, send2_src, ghost_src, n_ghost,
                        s1max, s2max, gmax)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ShardedAIJHier:
    """Row-partitioned ELL matrix with a two-level halo.

    Same diag/offdiag decomposition as ShardedAIJ (parallel/pmat.py —
    the MPIAIJ analog, mpiaij.h:77); only the exchange differs.
    Methods run INSIDE shard_map over a ("dcn","ici") mesh.
    """

    diag_cols: jax.Array    # int32 [P, nloc, K1]
    diag_vals: jax.Array    # [P, nloc, K1]
    off_cols: jax.Array     # int32 [P, nloc, K2] ghost-slot indices
    off_vals: jax.Array     # [P, nloc, K2]
    send1_idx: jax.Array    # int32 [P, C, s1max]
    send2_src: jax.Array    # int32 [P, H, s2max]
    ghost_src: jax.Array    # int32 [P, gmax]
    shape: tuple = field(metadata=dict(static=True))
    H: int = field(metadata=dict(static=True), default=1)
    C: int = field(metadata=dict(static=True), default=1)
    axes: tuple = field(metadata=dict(static=True), default=("dcn", "ici"))
    nnz: int = field(metadata=dict(static=True), default=0)

    # interface parity with ShardedAIJ ---------------------------------
    @property
    def nshards(self):
        return self.H * self.C

    @property
    def axis(self):
        return self.axes                       # psum over both axes

    def local(self) -> "ShardedAIJHier":
        return jax.tree.map(lambda a: a[0], self)

    @property
    def nloc(self):
        return self.diag_cols.shape[-2]

    @property
    def dtype(self):
        return self.diag_vals.dtype

    def _bufs(self, x_local):
        dcn, ici = self.axes
        send1 = x_local[self.send1_idx]                      # [C, s1max]
        recv1 = lax.all_to_all(send1, ici, split_axis=0, concat_axis=0)
        r1 = recv1.reshape(-1)
        send2 = r1[self.send2_src]                           # [H, s2max]
        recv2 = lax.all_to_all(send2, dcn, split_axis=0, concat_axis=0)
        return r1, recv2.reshape(-1)

    def ghosts(self, x_local: jax.Array) -> jax.Array:
        r1, r2 = self._bufs(x_local)
        return jnp.concatenate([r1, r2])[self.ghost_src]

    def mult(self, x_local: jax.Array) -> jax.Array:
        if self.nshards == 1:
            return jnp.sum(self.diag_vals * x_local[self.diag_cols], axis=1)
        g = self.ghosts(x_local)             # collectives issued first
        y = jnp.sum(self.diag_vals * x_local[self.diag_cols], axis=1)
        return y + jnp.sum(self.off_vals * g[self.off_cols], axis=1)

    def multT(self, x_local: jax.Array) -> jax.Array:
        """Scatter-reverse: both all_to_alls run backward with adds."""
        dt = x_local.dtype
        xw = (self.diag_vals * x_local[:, None]).reshape(-1)
        y = jnp.zeros(self.nloc, dt).at[self.diag_cols.reshape(-1)].add(xw)
        if self.nshards == 1:
            return y
        dcn, ici = self.axes
        gmax = self.ghost_src.shape[-1]
        gbuf = jnp.zeros(gmax + 1, dt)       # sentinel pad slot
        ow = (self.off_vals * x_local[:, None]).reshape(-1)
        gbuf = gbuf.at[self.off_cols.reshape(-1)].add(ow)[:gmax]
        C, s1max = self.send1_idx.shape[-2:]
        H, s2max = self.send2_src.shape[-2:]
        buf = jnp.zeros(C * s1max + H * s2max, dt)
        buf = buf.at[self.ghost_src].add(gbuf)
        back2 = lax.all_to_all(buf[C * s1max:].reshape(H, s2max), dcn,
                               split_axis=0, concat_axis=0)
        buf1 = buf[:C * s1max].at[self.send2_src.reshape(-1)].add(
            back2.reshape(-1))
        back1 = lax.all_to_all(buf1.reshape(C, s1max), ici,
                               split_axis=0, concat_axis=0)
        return y.at[self.send1_idx.reshape(-1)].add(back1.reshape(-1))

    def diagonal(self) -> jax.Array:
        rows = jnp.arange(self.nloc, dtype=self.diag_cols.dtype)[:, None]
        return jnp.sum(jnp.where(self.diag_cols == rows, self.diag_vals, 0),
                       axis=1)

    def flops_per_mult(self) -> float:
        return 2.0 * self.nnz - self.shape[0]


def sharded_aij_hier_from_scipy(A, H: int, C: int, dtype=None):
    """Partition a scipy matrix over an (H hosts × C chips) mesh.

    Returns (ShardedAIJHier, PartitionedCSR) — the PartitionedCSR
    carries the same diag/off/garray split as the flat path so
    existing per-shard PC setups (bjacobi/ILU …) work unchanged."""
    P = H * C
    part = partition_csr(A, P)
    lay = part.layout
    plan = build_hier_halo(lay, part.garrays, H, C)
    K1 = max(max((int(np.diff(D.indptr).max()) if D.nnz else 1)
                 for D in part.diag_blocks), 1)
    K2 = max(max((int(np.diff(O.indptr).max()) if O.nnz else 1)
                 for O in part.off_blocks), 1)
    dt = dtype or A.dtype
    dcols = np.zeros((P, lay.shard_size, K1), np.int32)
    dvals = np.zeros((P, lay.shard_size, K1), dt)
    ocols = np.zeros((P, lay.shard_size, K2), np.int32)
    ovals = np.zeros((P, lay.shard_size, K2), dt)
    for p in range(P):
        c, v = ell_pack(part.diag_blocks[p], K1)
        dcols[p], dvals[p] = c, v.astype(dt)
        c, v = ell_pack(part.off_blocks[p], K2, pad_col=plan.gmax)
        ocols[p], ovals[p] = c, v.astype(dt)
    M = ShardedAIJHier(
        jnp.asarray(dcols), jnp.asarray(dvals),
        jnp.asarray(ocols), jnp.asarray(ovals),
        jnp.asarray(plan.send1_idx), jnp.asarray(plan.send2_src),
        jnp.asarray(plan.ghost_src),
        shape=(lay.shard_size * P, lay.shard_size * P),
        H=H, C=C, nnz=int(sp_nnz(A)))
    return M, part


def sp_nnz(A):
    import scipy.sparse as sp
    return sp.csr_matrix(A).nnz
