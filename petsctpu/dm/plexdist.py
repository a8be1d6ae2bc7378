"""Distributed Plex — partitioned unstructured FEM assembly.

Reference: DMPlexDistribute (src/dm/impls/plex/plexdistribute.c? in
this tree the distribution machinery lives in plex.c + the Sieve
distribution; conceptually: partition cells, ship closures, build the
PetscSF for ghost points) and MatSetValues stashing for off-process
rows (src/mat/utils/matstash.c).

Device shape of the same flow, all symbolic work at PLAN time:

  plan (host):  partition cells (multilevel k-way on the cell dual
                graph), assign vertex owners, renumber vertices by
                owner, assemble the pattern ONCE, freeze
                  * per-shard padded cell lists + coords,
                  * a static entry ROUTE: every element-matrix entry
                    knows its destination shard and its slot in that
                    shard's ELL storage (the MatStash, precomputed),
                  * the ShardedAIJ template + halo plan for the solve.
  device (jit): vmapped element kernels per shard -> one all_to_all
                (the stash flush) -> segment-sum into ELL slots.
                `assemble(kappa)` rebuilds the operator for new cell
                coefficients without ANY host work.

Fields with >1 dof/vertex go through the same route with Section
closures (dm/section.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from jax import lax

from petsctpu.dm.plex import cell_measures, element_kernel_for, \
    fem_assemble_poisson
from petsctpu.dm.section import vertex_section


@dataclass(frozen=True)
class DistPlex:
    """Frozen distributed-assembly plan + sharded operator template.
    A host-side PLAN object (not a pytree): its arrays enter jit as
    explicit shard_map operands in assembled()."""

    # element computation (leading axis = shard)
    cell_coords: jax.Array   # [P, ncmax, npc, dim]
    cell_mask: jax.Array     # [P, ncmax] 1.0 real / 0.0 padding
    # entry routing (the precomputed MatStash)
    send_idx: jax.Array      # int32 [P, P, emax] local entry -> dest order
    recv_slot: jax.Array     # int32 [P, P*emax] ELL flat slot (F = drop)
    base_flat: jax.Array     # [P, F+1] non-element values (BC/pad identity)
    # the operator template (cols/halo filled; vals rebuilt per assemble)
    template: object         # ShardedAIJ
    b: jax.Array             # [P, s] sharded load vector
    perm: np.ndarray = None
    nparts: int = 1
    npc: int = 3
    axis: str = "rows"

    @property
    def K1(self):
        return self.template.diag_cols.shape[2]

    @property
    def K2(self):
        return self.template.off_cols.shape[2]

    @property
    def s(self):
        return self.template.diag_cols.shape[1]

    def assemble_local(self, kappa_loc, coords_loc, mask_loc, send_loc,
                       slot_loc, base_loc):
        """Inside shard_map: local slices (no leading P axis except the
        routing tables' dest axis). Returns (diag_vals, off_vals)."""
        ker = _KERNELS[(self.npc, coords_loc.shape[-1])]
        Ke = jax.vmap(ker)(coords_loc)                 # [ncmax, npc, npc]
        ent = (Ke * (kappa_loc * mask_loc)[:, None, None]).reshape(-1)
        ent = jnp.concatenate([ent, jnp.zeros((1,), ent.dtype)])
        send = ent[send_loc]                           # [P, emax]
        recv = lax.all_to_all(send, self.axis, split_axis=0,
                              concat_axis=0)           # [P, emax]
        F = self.s * (self.K1 + self.K2)
        flat = base_loc.at[slot_loc].add(recv.reshape(-1))[:F]
        dv = flat[: self.s * self.K1].reshape(self.s, self.K1)
        ov = flat[self.s * self.K1:].reshape(self.s, self.K2)
        return dv, ov

    def assembled(self, mesh, kappa=None):
        """One jitted shard_map assembly -> a filled ShardedAIJ.
        kappa: [nc] per-cell coefficients in ORIGINAL cell order."""
        from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as Pn

        ncmax = self.cell_coords.shape[1]
        if kappa is None:
            kap = jnp.ones((self.nparts, ncmax), self.cell_coords.dtype)
        else:
            kap = jnp.asarray(
                np.asarray(kappa)[self._cell_order()].reshape(
                    self.nparts, ncmax))

        def run(kap, coords, mask, send, slot, base):
            dv, ov = self.assemble_local(kap[0], coords[0], mask[0],
                                         send[0], slot[0], base[0])
            return dv[None], ov[None]

        p = Pn(self.axis)
        dv, ov = jax.jit(shard_map(
            run, mesh=mesh, in_specs=(p, p, p, p, p, p),
            out_specs=(p, p)))(
            kap, self.cell_coords, self.cell_mask, self.send_idx,
            self.recv_slot, self.base_flat)
        import dataclasses as _dc
        return _dc.replace(self.template, diag_vals=dv, off_vals=ov)

    def _cell_order(self):
        return self._cell_order_arr

    # populated by distribute_plex (host-side ordering array)
    _cell_order_arr: np.ndarray = None


# static kernel table (npc, dim) — avoids closing over callables in the
# pytree
from petsctpu.dm.plex import (p1_element_stiffness,              # noqa: E402
                              p1_element_stiffness_3d,
                              q1_element_stiffness,
                              q1_element_stiffness_3d)

_KERNELS = {(3, 2): p1_element_stiffness, (4, 3): p1_element_stiffness_3d,
            (4, 2): q1_element_stiffness, (8, 3): q1_element_stiffness_3d}


def _renumber_by_owner(plex, nparts: int, cell_part: np.ndarray):
    """Vertex owner = min cell part touching it; renumber vertices
    grouped by owner. Returns (perm old->position, vperm new id of old
    vertex)."""
    nv = plex.num_vertices
    owner = np.full(nv, nparts, np.int64)
    for p in range(nparts):
        vs = np.unique(plex.cells[cell_part == p])
        owner[vs] = np.minimum(owner[vs], p)
    owner[owner == nparts] = 0          # isolated vertices -> shard 0
    order = np.argsort(owner, kind="stable")   # old ids grouped by owner
    vnew = np.empty(nv, np.int64)
    vnew[order] = np.arange(nv)
    return order, vnew, owner


def distribute_plex(plex, nparts: int, dtype=np.float64,
                    axis: str = "rows", f=None,
                    bc_label=None) -> DistPlex:
    """Build the DistPlex plan for −Δu = f, Dirichlet boundary.

    The serial fem_assemble_poisson on the renumbered mesh provides
    the pattern oracle; the returned plan re-produces its values on
    device, sharded (verified in tests/test_plexdist.py).

    bc_label: optional (name, values) — Dirichlet dofs from the mesh's
    labels (dm/label, e.g. Gmsh physical groups) instead of the whole
    topological boundary; DMPlexDistribute carries labels with the
    mesh (plex.c:3097), here they are remapped through the owner
    renumbering."""
    from petsctpu.mat.partition import partition_kway
    from petsctpu.parallel.pmat import sharded_aij_from_scipy

    cells = plex.cells
    nc, npc = cells.shape
    nv = plex.num_vertices
    dim = plex.coords.shape[1]

    # 1. cell partition on the cell dual graph (shared-vertex adjacency)
    B = sp.coo_matrix((np.ones(nc * npc), (np.repeat(np.arange(nc), npc),
                                           cells.reshape(-1))),
                      shape=(nc, nv)).tocsr()
    dual = (B @ B.T).tocsr()
    cell_part = (partition_kway(dual, nparts) if nparts > 1
                 else np.zeros(nc, np.int32))

    # 2. vertex renumbering by owner
    order, vnew, owner = _renumber_by_owner(plex, nparts, cell_part)
    plex_perm = type(plex)(vnew[cells].astype(cells.dtype),
                           plex.coords[order])

    # 3. pattern + BC oracle (serial assembly on the renumbered mesh)
    section = None
    if bc_label is not None:
        from petsctpu.dm.label import get_label, label_vertices
        from petsctpu.dm.section import vertex_section
        name, vals = bc_label
        lab = get_label(plex, name)
        if lab is None:
            raise ValueError(f"no label {name!r} on this Plex")
        bnd = np.sort(vnew[label_vertices(plex, lab, vals)])
        section = vertex_section(nv, dof=1, constrained=bnd)
    Adev, Ah, b_host = fem_assemble_poisson(plex_perm, f=f, dtype=dtype,
                                            section=section)
    mat, part = sharded_aij_from_scipy(Ah, nparts, dtype=dtype)
    lay = part.layout
    s = lay.shard_size

    if bc_label is None:
        bnd = plex_perm.boundary_vertices()
    con = np.zeros(nv, bool)
    con[bnd] = True

    # 4. per-shard padded cell arrays (renumbered vertex ids)
    cells_new = vnew[cells]
    by_part = [np.flatnonzero(cell_part == p) for p in range(nparts)]
    ncmax = max(max(len(ix) for ix in by_part), 1)
    cell_coords = np.zeros((nparts, ncmax, npc, dim), dtype)
    cell_mask = np.zeros((nparts, ncmax), dtype)
    cell_order = np.zeros(nparts * ncmax, np.int64)
    cells_sh = np.zeros((nparts, ncmax, npc), np.int64)
    pad_cell = plex_perm.coords[cells_new[0]]   # any valid geometry —
    for p, ix in enumerate(by_part):            # padding Ke must not
        k = len(ix)                             # produce inf/nan (the
        cell_coords[p, k:] = pad_cell           # mask zeroes it later)
        if k:
            cell_coords[p, :k] = plex_perm.coords[cells_new[ix]]
            cell_mask[p, :k] = 1.0
            cells_sh[p, :k] = cells_new[ix]
            cell_order[p * ncmax: p * ncmax + k] = ix
            cell_order[p * ncmax + k: (p + 1) * ncmax] = ix[0]

    # 5. entry routing: (shard p, cell slot c, i, j) -> dest shard +
    # ELL flat slot. Constrained rows/cols are dropped (BC identity is
    # in base_flat).
    F = s * (mat.diag_cols.shape[2] + mat.off_cols.shape[2])
    K1 = mat.diag_cols.shape[2]
    K2 = mat.off_cols.shape[2]
    nent = ncmax * npc * npc

    # per-dest buckets: entry local flat index + target slot
    send_lists = [[[] for _ in range(nparts)] for _ in range(nparts)]
    slot_lists = [[[] for _ in range(nparts)] for _ in range(nparts)]
    diag_csr = part.diag_blocks
    off_csr = part.off_blocks
    gars = [np.asarray(g) for g in part.garrays]

    def slot_of(t: int, gi: int, gj: int) -> int:
        li = gi - t * s
        D = diag_csr[t]
        if t * s <= gj < (t + 1) * s:
            lj = gj - t * s
            r0, r1 = D.indptr[li], D.indptr[li + 1]
            k = np.searchsorted(D.indices[r0:r1], lj)
            assert r0 + k < r1 and D.indices[r0 + k] == lj, (gi, gj)
            return li * K1 + int(k)
        O = off_csr[t]
        gs = np.searchsorted(gars[t], gj)
        assert gs < len(gars[t]) and gars[t][gs] == gj, (gi, gj)
        r0, r1 = O.indptr[li], O.indptr[li + 1]
        k = np.searchsorted(O.indices[r0:r1], gs)
        assert r0 + k < r1 and O.indices[r0 + k] == gs, (gi, gj)
        return s * K1 + li * K2 + int(k)

    for p in range(nparts):
        vc = cells_sh[p]                       # [ncmax, npc]
        for c in range(len(by_part[p])):
            for a in range(npc):
                gi = int(vc[c, a])
                if con[gi]:
                    continue
                t = gi // s
                for bq in range(npc):
                    gj = int(vc[c, bq])
                    if con[gj]:
                        continue
                    eidx = (c * npc + a) * npc + bq
                    send_lists[p][t].append(eidx)
                    slot_lists[p][t].append(slot_of(t, gi, gj))

    emax = max(max(len(send_lists[p][t]) for t in range(nparts))
               for p in range(nparts))
    emax = max(emax, 1)
    # send_idx[p, t]: entries shard p sends to shard t (pad -> nent =
    # the appended zero slot). recv_slot[t, p*emax + k]: where shard t
    # scatters the k-th value received from p (pad -> F = drop slot).
    send_idx = np.full((nparts, nparts, emax), nent, np.int32)
    recv_slot = np.full((nparts, nparts * emax), F, np.int32)
    for p in range(nparts):
        for t in range(nparts):
            k = len(send_lists[p][t])
            send_idx[p, t, :k] = send_lists[p][t]
            recv_slot[t, p * emax: p * emax + k] = slot_lists[p][t]

    # 6. base values: host-filled template minus every routed slot
    dv = np.zeros((nparts, s, K1), dtype)
    ov = np.zeros((nparts, s, K2), dtype)
    dv[...] = np.asarray(mat.diag_vals)
    ov[...] = np.asarray(mat.off_vals)
    base = np.concatenate([dv.reshape(nparts, -1),
                           ov.reshape(nparts, -1)], axis=1)
    for t in range(nparts):
        sl = recv_slot[t][recv_slot[t] < F]
        base[t][sl] = 0.0
    base = np.concatenate([base, np.zeros((nparts, 1), dtype)], axis=1)

    b_sh = np.zeros(lay.n_padded, dtype)
    b_sh[: nv] = np.asarray(b_host)

    return DistPlex(
        cell_coords=jnp.asarray(cell_coords),
        cell_mask=jnp.asarray(cell_mask),
        send_idx=jnp.asarray(send_idx),
        recv_slot=jnp.asarray(recv_slot),
        base_flat=jnp.asarray(base),
        template=mat,
        b=jnp.asarray(b_sh.reshape(nparts, s)),
        perm=vnew, nparts=nparts, npc=npc, axis=axis,
        _cell_order_arr=cell_order)
