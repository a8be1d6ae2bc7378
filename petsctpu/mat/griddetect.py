"""Structured-grid recovery: detect that a sparse pattern is a scrambled
d-D box-grid stencil and return the lexicographic (natural) ordering.

Why: the SELL irregular-SpMV kernel (mat/sell.py) is pass-structure
bound — its cost is the plan's pass count P = per-tile sum of q-chunk
bucket multiplicities, and P collapses (133 -> 36 on the 64^3 27-point
probe, round-4 PARITY.md) exactly when the ordering restores the
stencil's translation invariance: chunk(col) - chunk(row) constant per
offset family.  No generic bandwidth/profile ordering (RCM, Sloan, ND)
achieves that — they bound |col - row| but scramble the alignment
WITHIN the band.  For operators that actually came from a structured
grid, the right locality transform is to recover the grid itself.

This is the device analog of the reference's silent layout upgrades on
AIJ matrices (Inode detection aij.c: MatMult_SeqAIJ_Inode, AIJPERM /
AIJCRL groupings — src/mat/impls/aij/seq/{inode.c,csrperm,crl}): the
user hands over a generic CSR matrix, plan-time analysis discovers the
hidden structure, and the fast kernel runs with identical values.

Algorithm (pattern-only, host-side numpy/scipy):
  1. classify the stencil family by max degree of the pattern graph
     (diagonal dropped): 2d -> star (5/7-point), 3^d - 1 -> box
     (9/27-point), d in {2, 3};
  2. box stencils: build the interior "face graph" (axis +-1 edges
     only) by common-neighbour counts — an interior face pair has
     exactly 2*3^(d-1) - 2 common neighbours, edge/corner pairs fewer
     (counts are exact for interior-interior edges since the shared
     neighbourhood box is never truncated); star stencils use the
     interior-induced subgraph directly;
  3. the interior face graph is a (m1-2)x...x(md-2) grid with
     Manhattan BFS metric: find a corner (min face-degree), BFS from
     it and from each axis corner w (corners whose c000-geodesic set
     is a LINE: |{v : d0[v]+dw[v] = d0[w]}| = d0[w]+1); coordinates
     follow exactly from x_k = (d0 - dw_k + m_k - 1)/2;
  4. peel boundary shells: place each unplaced vertex at the unique
     in-domain cell consistent with ALL its already-placed neighbours
     (candidate generation from one placed neighbour's stencil box,
     acceptance = exact neighbour-count + containment checks),
     iterating rounds until fixpoint;
  5. verify: the recovered ordering must give <= 3^d distinct
     (col - row) offsets — else return None (caller falls back to
     RCM/natural; mat/factory._auto_format compares candidates by the
     SELL plan's predicted pass count either way).

Returns None quickly for anything that is not a scrambled box grid.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _pattern_graph(A: sp.csr_matrix):
    """0/1 pattern with the diagonal removed; None if unsymmetric."""
    B = sp.csr_matrix(A, copy=True)
    B.data = np.ones_like(B.data, dtype=np.int32)
    B.setdiag(0)
    B.eliminate_zeros()
    B.sort_indices()
    Bt = B.T.tocsr()                 # canonical-form array compare is
    Bt.sort_indices()                # ~3x cheaper than (B != B.T)
    if not (np.array_equal(B.indptr, Bt.indptr)
            and np.array_equal(B.indices, Bt.indices)):
        return None
    return B


def _classify(maxdeg: int):
    """-> (dim, kind) or None; kind in {'star', 'box'}."""
    return {4: (2, "star"), 6: (3, "star"),
            8: (2, "box"), 26: (3, "box")}.get(int(maxdeg))


def _bfs_dist(F: sp.csr_matrix, src: int) -> np.ndarray:
    """Unweighted BFS distances by vectorized frontier expansion —
    O(E) total vs dijkstra's O(E log V) heap traffic (this runs up to
    2^dim times; it was ~2/3 of the 64³ probe's plan time)."""
    n = F.shape[0]
    indptr, indices = F.indptr, F.indices
    out = np.full(n, -1, np.int64)
    out[src] = 0
    frontier = np.asarray([src], np.int64)
    d = 0
    while len(frontier):
        d += 1
        # all neighbours of the frontier (duplicates fine)
        counts = indptr[frontier + 1] - indptr[frontier]
        nbr = indices[_ranges(indptr[frontier], counts)]
        new = nbr[out[nbr] < 0]
        if not len(new):
            break
        out[new] = d                    # duplicate writes agree
        frontier = np.unique(new)
    return out


def _ranges(starts, counts):
    """Concatenated arange(s, s+c) per (s, c) — vectorized."""
    nz = counts > 0                 # zero-count rows corrupt the
    starts, counts = starts[nz], counts[nz]   # cumsum trick below
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    out = np.ones(total, np.int64)
    ends = np.cumsum(counts)
    out[0] = starts[0]
    out[ends[:-1]] = starts[1:] - (starts[:-1] + counts[:-1] - 1)
    return np.cumsum(out)


def _recover_interior_coords(F: sp.csr_matrix, dim: int):
    """Coordinates of every vertex of an (assumed) box-grid face graph.
    Returns (coords [nF, dim], dims) or None."""
    nF = F.shape[0]
    deg = np.diff(F.indptr)
    if nF == 0 or deg.min() != dim:
        return None
    corners = np.flatnonzero(deg == dim)
    if len(corners) != 2 ** dim:
        return None
    c000 = int(corners[0])
    d0 = _bfs_dist(F, c000)
    if d0.min() < 0:                      # disconnected
        return None
    axes = []                             # (m_k, dw)
    for w in corners[1:][np.argsort(d0[corners[1:]])]:
        dw = _bfs_dist(F, int(w))
        L = int(d0[w])
        if int(np.sum(d0 + dw == L)) == L + 1:      # geodesic is a line
            axes.append((L + 1, dw))
        if len(axes) == dim:
            break
    if len(axes) != dim:
        return None
    dims = [m for m, _ in axes]
    coords = np.empty((nF, dim), np.int64)
    for k, (m, dw) in enumerate(axes):
        num = d0 - dw + (m - 1)
        if np.any(num & 1):
            return None
        coords[:, k] = num >> 1
        if coords[:, k].min() < 0 or coords[:, k].max() >= m:
            return None
    if int(np.prod(dims)) != nF:
        return None
    # bijectivity
    flat = np.ravel_multi_index(coords.T, dims)
    if len(np.unique(flat)) != nF:
        return None
    return coords, dims


def _expected_deg(c, M, kind):
    if kind == "box":
        p = 1
        for ck, Mk in zip(c, M):
            p *= int(min(ck + 1, Mk - 1)) - int(max(ck - 1, 0)) + 1
        return p - 1
    # note int(): np.bool_ + np.bool_ is logical OR, not addition
    return sum(int(ck > 0) + int(ck < Mk - 1) for ck, Mk in zip(c, M))


def _in_stencil(a, b, kind):
    d = [abs(x - y) for x, y in zip(a, b)]
    if kind == "box":
        return max(d) == 1
    return sum(d) == 1


def _expected_deg_vec(c, Ma, kind):
    """_expected_deg over rows of c [n, dim] (vectorized)."""
    if kind == "box":
        span = (np.minimum(c + 1, Ma - 1) - np.maximum(c - 1, 0) + 1)
        return span.prod(axis=1) - 1
    return ((c > 0).astype(np.int64)
            + (c < Ma - 1).astype(np.int64)).sum(axis=1)


def grid_recover_ordering(A, max_nnz: int = 4e7, return_dims=False):
    """Return perm (new->old int64 array: lexicographic grid order) or
    None when A is not a scrambled box-grid stencil pattern. With
    return_dims, returns (perm, dims) / (None, None) — the recovered
    box dimensions let the caller build stencil coefficient streams
    (mat/stencil.py) directly."""
    res = _grid_recover_impl(A, max_nnz)
    if return_dims:
        return res if res is not None else (None, None)
    return res[0] if res is not None else None


def _grid_recover_impl(A, max_nnz):
    A = sp.csr_matrix(A)
    n = A.shape[0]
    if n != A.shape[1] or A.nnz > max_nnz or n < 4096:
        return None
    B = _pattern_graph(A)
    if B is None:
        return None
    deg = np.diff(B.indptr)
    cls = _classify(deg.max())
    if cls is None:
        return None
    dim, kind = cls
    interior = np.flatnonzero(deg == deg.max())
    # interior fraction sanity: (1 - 2/M)^dim with M >= 6 -> >= 3.7% 2D
    if len(interior) < max(0.03 * n, 8):
        return None

    # ---- interior face graph ------------------------------------------------
    is_int = np.zeros(n, bool)
    is_int[interior] = True
    ridx = np.full(n, -1, np.int64)
    ridx[interior] = np.arange(len(interior))
    if kind == "box":
        # counts are only consumed on interior-row edges: restrict the
        # spgemm to those rows (the full-graph COLUMN side keeps the
        # counts exact — shared neighbourhood boxes of interior pairs
        # include boundary nodes)
        Bi = B[interior]
        Wb = Bi.multiply(Bi @ B).tocoo()  # common-nbr count per edge
        face_count = 2 * 3 ** (dim - 1) - 2
        keep = (Wb.data == face_count) & is_int[Wb.col]
        r, c = Wb.row[keep], ridx[Wb.col[keep]]
    else:
        coo = B.tocoo()
        keep = is_int[coo.row] & is_int[coo.col]
        r, c = ridx[coo.row[keep]], ridx[coo.col[keep]]
    F = sp.csr_matrix((np.ones(len(r), np.int8), (r, c)),
                      shape=(len(interior), len(interior)))

    rec = _recover_interior_coords(F, dim)
    if rec is None:
        return None
    icoords, idims = rec
    M = [m + 2 for m in idims]
    if int(np.prod(M)) != n:
        return None

    # ---- peel boundary shells ----------------------------------------------
    coords = np.full((n, dim), -1, np.int64)
    coords[interior] = icoords + 1
    occupied = np.zeros(M, bool)
    occupied[tuple((icoords + 1).T)] = True
    placed = is_int.copy()
    unplaced = np.flatnonzero(~placed)
    indptr, indices = B.indptr, B.indices
    offs = np.stack(_stencil_offsets(dim, kind))        # [noff, dim]
    Ma = np.asarray(M)
    deg_all = np.diff(indptr)
    for _ in range(3 * dim):
        if not len(unplaced):
            break
        # vectorized round: every unplaced v with >=1 placed neighbour
        # tests all stencil offsets of its FIRST placed neighbour's
        # cell at once; acceptance needs a UNIQUE candidate cell that
        # is free, has the right boundary degree, and is in-stencil of
        # ALL placed neighbours (same predicate as the old per-vertex
        # loop — this ran 2-3 ms/kvertex in Python, ~6 s on the 64³
        # probe's 24k boundary shell)
        counts = indptr[unplaced + 1] - indptr[unplaced]
        nbr = indices[_ranges(indptr[unplaced], counts)]
        vof = np.repeat(np.arange(len(unplaced)), counts)   # pair -> u
        pmask = placed[nbr]
        pv, pn = vof[pmask], nbr[pmask]                 # placed pairs
        has = np.zeros(len(unplaced), bool)
        # first placed neighbour per u (pairs are in pv-ascending order)
        first = np.full(len(unplaced), -1, np.int64)
        first[pv[::-1]] = pn[::-1]
        has[pv] = True
        ui = np.flatnonzero(has)                        # active rows
        if not len(ui):
            return None
        base = coords[first[ui]]                        # [na, dim]
        # remap placed pairs to active-row ids
        rmap = np.full(len(unplaced), -1, np.int64)
        rmap[ui] = np.arange(len(ui))
        ppv = rmap[pv]                                  # pair -> active
        pco = coords[pn]                                # pair coords
        nok = np.zeros(len(ui), np.int64)               # candidates/row
        csel = np.zeros((len(ui), dim), np.int64)
        for off in offs:
            c = base + off                              # [na, dim]
            ok = ((c >= 0) & (c < Ma)).all(axis=1)
            cc = np.clip(c, 0, Ma - 1)
            ok &= ~occupied[tuple(cc.T)]
            ok &= _expected_deg_vec(cc, Ma, kind) == deg_all[
                unplaced[ui]]
            # all placed neighbours in-stencil of c: count violations
            dpp = np.abs(cc[ppv] - pco)
            viol = (dpp.max(axis=1) != 1) if kind == "box" \
                else (dpp.sum(axis=1) != 1)
            ok &= np.bincount(ppv, viol, len(ui)) == 0
            nok += ok
            csel[ok] = c[ok]
        win = nok == 1                                  # unambiguous
        if not win.any():
            return None
        # two rows claiming one cell: keep such cells for next round
        wflat = np.ravel_multi_index(csel[win].T, M)
        uniq, cnt = np.unique(wflat, return_counts=True)
        dup = set(uniq[cnt > 1].tolist())
        if dup:
            win[np.flatnonzero(win)[
                np.isin(wflat, list(dup))]] = False
            if not win.any():
                return None
        vwin = unplaced[ui[win]]
        coords[vwin] = csel[win]
        occupied[tuple(csel[win].T)] = True
        placed[vwin] = True
        unplaced = np.flatnonzero(~placed)
    if len(unplaced):
        return None

    # ---- lexicographic permutation + verification ---------------------------
    flat = np.ravel_multi_index(coords.T, M)
    perm = np.argsort(flat, kind="stable").astype(np.int64)  # new -> old
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    co = A.tocoo()
    offsets = np.unique(inv[co.col] - inv[co.row])
    if len(offsets) > 3 ** dim:
        return None
    return perm, tuple(int(m) for m in M)


def _stencil_offsets(dim, kind):
    from itertools import product
    if kind == "box":
        return [np.array(o) for o in product((-1, 0, 1), repeat=dim)]
    offs = [np.zeros(dim, np.int64)]
    for k in range(dim):
        for s in (-1, 1):
            o = np.zeros(dim, np.int64)
            o[k] = s
            offs.append(o)
    return offs
