"""Plex — minimal unstructured simplicial mesh (DMPlex-lite).

Reference: src/dm/impls/plex/plex.c (DMPlex: cells/faces/edges/vertices
as "points" in a Hasse DAG with cone/support; PetscSection DOF layout;
the successor of the C++ Sieve/DMMesh in §2.9 of SURVEY.md). Scope
here (per SURVEY §2.9: "a minimal unstructured-mesh module, pure
Python/JAX"): 2-D triangle meshes with

  * cone/support connectivity (cells→vertices, plus constructed edges —
    the DMPlexInterpolate analog),
  * boundary detection (DMPlexMarkBoundaryFaces analog),
  * regular refinement (each triangle → 4; DMRefine analog),
  * P1 FEM assembly done the device way: ONE vmapped element-matrix
    kernel over all cells (batched 3×3 geometry algebra)
    + COO segment-sum assembly into the frozen AIJ layout — the
    reference's MatSetValues loop (plex.c DMPlexMatSetClosure)
    becomes a single gather/scatter program.

Plan-time (host, numpy): connectivity, edges, boundary, sparsity.
Device (jit): element kernels + assembly + solves.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


@dataclass(frozen=True)
class Plex:
    """cells: [nc, 3] vertex ids; coords: [nv, 2]."""

    cells: np.ndarray
    coords: np.ndarray

    # ---- sizes ----
    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.coords.shape[0]

    # ---- topology (cone / support / edges) ----
    def cone(self, c: int) -> np.ndarray:
        """DMPlexGetCone: vertices of cell c."""
        return self.cells[c]

    def support(self, v: int) -> np.ndarray:
        """DMPlexGetSupport: cells touching vertex v."""
        return np.where((self.cells == v).any(axis=1))[0]

    def edges(self) -> np.ndarray:
        """Unique edges [ne, 2] (DMPlexInterpolate's edge construction)."""
        e = np.concatenate([self.cells[:, [0, 1]], self.cells[:, [1, 2]],
                            self.cells[:, [2, 0]]])
        e = np.sort(e, axis=1)
        return np.unique(e, axis=0)

    def boundary_vertices(self) -> np.ndarray:
        """Vertices on edges owned by exactly one cell
        (DMPlexMarkBoundaryFaces analog)."""
        e = np.concatenate([self.cells[:, [0, 1]], self.cells[:, [1, 2]],
                            self.cells[:, [2, 0]]])
        e = np.sort(e, axis=1)
        uniq, counts = np.unique(e, axis=0, return_counts=True)
        bedges = uniq[counts == 1]
        return np.unique(bedges.reshape(-1))

    # ---- refinement ----
    def refine(self) -> "Plex":
        """Regular refinement: each triangle into 4 via edge midpoints."""
        edges = self.edges()
        ne = edges.shape[0]
        nv = self.num_vertices
        emap = {tuple(e): nv + i for i, e in enumerate(edges)}
        mid_coords = 0.5 * (self.coords[edges[:, 0]]
                            + self.coords[edges[:, 1]])
        coords = np.concatenate([self.coords, mid_coords])

        def mid(a, b):
            return emap[tuple(sorted((a, b)))]

        new_cells = []
        for a, b, c in self.cells:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_cells += [[a, ab, ca], [ab, b, bc], [ca, bc, c],
                          [ab, bc, ca]]
        return Plex(np.asarray(new_cells, self.cells.dtype), coords)

    # ---- construction ----
    @classmethod
    def create_box_mesh(cls, nx: int, ny: int) -> "Plex":
        """Structured triangulation of the unit square (2 triangles per
        quad; DMPlexCreateBoxMesh analog)."""
        xs = np.linspace(0.0, 1.0, nx + 1)
        ys = np.linspace(0.0, 1.0, ny + 1)
        X, Y = np.meshgrid(xs, ys, indexing="ij")
        coords = np.stack([X.ravel(), Y.ravel()], axis=1)

        def vid(i, j):
            return i * (ny + 1) + j

        cells = []
        for i in range(nx):
            for j in range(ny):
                v00, v10 = vid(i, j), vid(i + 1, j)
                v01, v11 = vid(i, j + 1), vid(i + 1, j + 1)
                cells.append([v00, v10, v11])
                cells.append([v00, v11, v01])
        return cls(np.asarray(cells, np.int32), coords)


@dataclass(frozen=True)
class Plex3D:
    """3-D tetrahedral Plex: cells [nc, 4] vertex ids; coords [nv, 3]
    (DMPlex is dimension-general — plex.c handles any cell dim; this
    is the tet instantiation)."""

    cells: np.ndarray
    coords: np.ndarray

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.coords.shape[0]

    def cone(self, c: int) -> np.ndarray:
        return self.cells[c]

    def support(self, v: int) -> np.ndarray:
        return np.where((self.cells == v).any(axis=1))[0]

    _EDGE_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
    _FACE_TRIPLES = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))

    def edges(self) -> np.ndarray:
        e = np.concatenate([self.cells[:, list(p)] for p in self._EDGE_PAIRS])
        return np.unique(np.sort(e, axis=1), axis=0)

    def faces(self) -> np.ndarray:
        """Unique triangular faces [nf, 3] (the height-1 stratum)."""
        f = np.concatenate([self.cells[:, list(t)]
                            for t in self._FACE_TRIPLES])
        return np.unique(np.sort(f, axis=1), axis=0)

    def boundary_vertices(self) -> np.ndarray:
        """Vertices of faces owned by exactly one tet."""
        f = np.concatenate([self.cells[:, list(t)]
                            for t in self._FACE_TRIPLES])
        uniq, counts = np.unique(np.sort(f, axis=1), axis=0,
                                 return_counts=True)
        return np.unique(uniq[counts == 1].reshape(-1))

    def refine(self) -> "Plex3D":
        """Regular 1:8 refinement: 4 corner tets + octahedron split
        along the (m01, m23) diagonal (Bey's red refinement)."""
        edges = self.edges()
        nv = self.num_vertices
        emap = {tuple(e): nv + i for i, e in enumerate(edges)}
        coords = np.concatenate([self.coords,
                                 0.5 * (self.coords[edges[:, 0]]
                                        + self.coords[edges[:, 1]])])

        def m(a, b):
            return emap[tuple(sorted((int(a), int(b))))]

        out = []
        for a, b, c, d in self.cells:
            ab, ac, ad = m(a, b), m(a, c), m(a, d)
            bc, bd, cd = m(b, c), m(b, d), m(c, d)
            out += [[a, ab, ac, ad], [ab, b, bc, bd],
                    [ac, bc, c, cd], [ad, bd, cd, d],
                    # octahedron {ab,ac,ad,bc,bd,cd} split on (ab, cd)
                    [ab, ac, ad, cd], [ab, ac, bc, cd],
                    [ab, ad, bd, cd], [ab, bc, bd, cd]]
        return Plex3D(np.asarray(out, self.cells.dtype), coords)

    @classmethod
    def create_box_mesh(cls, nx: int, ny: int, nz: int) -> "Plex3D":
        """Kuhn triangulation of the unit cube grid: 6 tets per cube
        (DMPlexCreateBoxMesh dim=3 analog)."""
        xs = [np.linspace(0.0, 1.0, k + 1) for k in (nx, ny, nz)]
        X, Y, Z = np.meshgrid(*xs, indexing="ij")
        coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

        def vid(i, j, k):
            return (i * (ny + 1) + j) * (nz + 1) + k

        # Kuhn: tets follow the 6 permutations of the unit-cube path
        corner_paths = [
            (0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7),
            (0, 2, 6, 7), (0, 4, 5, 7), (0, 4, 6, 7),
        ]
        cells = []
        for i in range(nx):
            for j in range(ny):
                for k in range(nz):
                    v = [vid(i + (s & 1), j + ((s >> 1) & 1),
                             k + ((s >> 2) & 1)) for s in range(8)]
                    for p in corner_paths:
                        cells.append([v[p[0]], v[p[1]], v[p[2]], v[p[3]]])
        return cls(np.asarray(cells, np.int32), coords)


@dataclass(frozen=True)
class PlexQuad:
    """2-D quadrilateral Plex: cells [nc, 4] CCW vertex ids; coords
    [nv, 2]. DMPlex handles arbitrary cell shapes (plex.c is
    polytopal); this is the tensor-cell instantiation with Q1."""

    cells: np.ndarray
    coords: np.ndarray

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.coords.shape[0]

    def cone(self, c: int) -> np.ndarray:
        return self.cells[c]

    def support(self, v: int) -> np.ndarray:
        return np.where((self.cells == v).any(axis=1))[0]

    _EDGE_PAIRS = ((0, 1), (1, 2), (2, 3), (3, 0))

    def edges(self) -> np.ndarray:
        e = np.concatenate([self.cells[:, list(p)]
                            for p in self._EDGE_PAIRS])
        return np.unique(np.sort(e, axis=1), axis=0)

    def boundary_vertices(self) -> np.ndarray:
        e = np.concatenate([self.cells[:, list(p)]
                            for p in self._EDGE_PAIRS])
        uniq, counts = np.unique(np.sort(e, axis=1), axis=0,
                                 return_counts=True)
        return np.unique(uniq[counts == 1].reshape(-1))

    def refine(self) -> "PlexQuad":
        """1:4 refinement: edge midpoints + a center point per quad."""
        edges = self.edges()
        nv = self.num_vertices
        emap = {tuple(e): nv + i for i, e in enumerate(edges)}
        nc = self.num_cells
        centers = self.coords[self.cells].mean(axis=1)
        coords = np.concatenate([
            self.coords,
            0.5 * (self.coords[edges[:, 0]] + self.coords[edges[:, 1]]),
            centers])
        c0 = nv + edges.shape[0]

        def m(a, b):
            return emap[tuple(sorted((int(a), int(b))))]

        out = []
        for ci, (a, b, c, d) in enumerate(self.cells):
            ab, bc, cd, da = m(a, b), m(b, c), m(c, d), m(d, a)
            ce = c0 + ci
            out += [[a, ab, ce, da], [ab, b, bc, ce],
                    [ce, bc, c, cd], [da, ce, cd, d]]
        return PlexQuad(np.asarray(out, self.cells.dtype), coords)

    @classmethod
    def create_box_mesh(cls, nx: int, ny: int) -> "PlexQuad":
        xs = np.linspace(0.0, 1.0, nx + 1)
        ys = np.linspace(0.0, 1.0, ny + 1)
        X, Y = np.meshgrid(xs, ys, indexing="ij")
        coords = np.stack([X.ravel(), Y.ravel()], axis=1)

        def vid(i, j):
            return i * (ny + 1) + j

        cells = [[vid(i, j), vid(i + 1, j), vid(i + 1, j + 1),
                  vid(i, j + 1)]
                 for i in range(nx) for j in range(ny)]
        return cls(np.asarray(cells, np.int32), coords)


@dataclass(frozen=True)
class PlexHex:
    """3-D hexahedral Plex: cells [nc, 8] vertex ids in VTK order
    (bottom quad CCW then top quad CCW); coords [nv, 3]."""

    cells: np.ndarray
    coords: np.ndarray

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.coords.shape[0]

    def cone(self, c: int) -> np.ndarray:
        return self.cells[c]

    def support(self, v: int) -> np.ndarray:
        return np.where((self.cells == v).any(axis=1))[0]

    _EDGE_PAIRS = ((0, 1), (1, 2), (2, 3), (3, 0),
                   (4, 5), (5, 6), (6, 7), (7, 4),
                   (0, 4), (1, 5), (2, 6), (3, 7))
    _FACE_QUADS = ((0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4),
                   (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7))

    def edges(self) -> np.ndarray:
        e = np.concatenate([self.cells[:, list(p)]
                            for p in self._EDGE_PAIRS])
        return np.unique(np.sort(e, axis=1), axis=0)

    def faces(self) -> np.ndarray:
        f = np.concatenate([self.cells[:, list(q)]
                            for q in self._FACE_QUADS])
        return np.unique(np.sort(f, axis=1), axis=0)

    def boundary_vertices(self) -> np.ndarray:
        f = np.concatenate([self.cells[:, list(q)]
                            for q in self._FACE_QUADS])
        uniq, counts = np.unique(np.sort(f, axis=1), axis=0,
                                 return_counts=True)
        return np.unique(uniq[counts == 1].reshape(-1))

    @classmethod
    def create_box_mesh(cls, nx: int, ny: int, nz: int) -> "PlexHex":
        xs = [np.linspace(0.0, 1.0, k + 1) for k in (nx, ny, nz)]
        X, Y, Z = np.meshgrid(*xs, indexing="ij")
        coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

        def vid(i, j, k):
            return (i * (ny + 1) + j) * (nz + 1) + k

        cells = []
        for i in range(nx):
            for j in range(ny):
                for k in range(nz):
                    cells.append([
                        vid(i, j, k), vid(i + 1, j, k),
                        vid(i + 1, j + 1, k), vid(i, j + 1, k),
                        vid(i, j, k + 1), vid(i + 1, j, k + 1),
                        vid(i + 1, j + 1, k + 1), vid(i, j + 1, k + 1)])
        return cls(np.asarray(cells, np.int32), coords)


# ---------------------------------------------------------------------------
# P1 FEM on a Plex — batched element kernels + segment-sum assembly
# ---------------------------------------------------------------------------

def p1_element_stiffness(coords_cell: jax.Array) -> jax.Array:
    """3×3 P1 stiffness for one triangle from its vertex coords [3,2]."""
    p0, p1, p2 = coords_cell[0], coords_cell[1], coords_cell[2]
    J = jnp.stack([p1 - p0, p2 - p0], axis=1)          # [2,2]
    detJ = J[0, 0] * J[1, 1] - J[0, 1] * J[1, 0]
    area = 0.5 * jnp.abs(detJ)
    Jinv = jnp.array([[J[1, 1], -J[0, 1]], [-J[1, 0], J[0, 0]]]) / detJ
    # reference gradients of the P1 basis
    gref = jnp.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    g = gref @ Jinv                                    # [3,2] physical grads
    return area * (g @ g.T)


def p1_element_stiffness_3d(coords_cell: jax.Array) -> jax.Array:
    """4×4 P1 stiffness for one tetrahedron from its coords [4,3]."""
    p0 = coords_cell[0]
    J = (coords_cell[1:] - p0).T                       # [3,3]
    detJ = jnp.linalg.det(J)
    vol = jnp.abs(detJ) / 6.0
    Jinv = jnp.linalg.inv(J)
    gref = jnp.array([[-1.0, -1.0, -1.0],
                      [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    g = gref @ Jinv                                    # [4,3]
    return vol * (g @ g.T)


# Q1 tensor-product elements (2x2 / 2x2x2 Gauss). Corner signs follow
# the cell vertex order (CCW quad; VTK hex).
_Q1_SIGNS_2D = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64)
_Q1_SIGNS_3D = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1],
                         [-1, 1, -1], [-1, -1, 1], [1, -1, 1],
                         [1, 1, 1], [-1, 1, 1]], np.float64)


def _q1_gauss(dim: int):
    g = 1.0 / np.sqrt(3.0)
    if dim == 2:
        pts = np.array([(sx * g, sy * g)
                        for sx in (-1, 1) for sy in (-1, 1)])
    else:
        pts = np.array([(sx * g, sy * g, sz * g)
                        for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)])
    return pts, np.ones(len(pts))


def _q1_grad_ref(signs: np.ndarray, xi: np.ndarray) -> np.ndarray:
    """[npc, dim] reference gradients of the Q1 basis at point xi."""
    npc, dim = signs.shape
    G = np.empty((npc, dim))
    for i in range(npc):
        for d in range(dim):
            v = signs[i, d]
            for e in range(dim):
                if e != d:
                    v = v * (1.0 + signs[i, e] * xi[e])
            G[i, d] = v / (2.0 ** dim)
    return G


def q1_element_stiffness(coords_cell: jax.Array) -> jax.Array:
    """4x4 Q1 stiffness for one quad from its CCW coords [4,2]."""
    return _q1_stiffness(coords_cell, _Q1_SIGNS_2D)


def q1_element_stiffness_3d(coords_cell: jax.Array) -> jax.Array:
    """8x8 Q1 stiffness for one hex from its VTK-order coords [8,3]."""
    return _q1_stiffness(coords_cell, _Q1_SIGNS_3D)


def _q1_stiffness(coords_cell: jax.Array, signs: np.ndarray) -> jax.Array:
    dim = signs.shape[1]
    pts, wts = _q1_gauss(dim)
    K = jnp.zeros((signs.shape[0], signs.shape[0]), coords_cell.dtype)
    for q, w in zip(pts, wts):
        Gref = jnp.asarray(_q1_grad_ref(signs, q), coords_cell.dtype)
        J = coords_cell.T @ Gref                       # [dim, dim]
        detJ = jnp.linalg.det(J)
        g = Gref @ jnp.linalg.inv(J)                   # physical grads
        K = K + w * jnp.abs(detJ) * (g @ g.T)
    return K


def _q1_measures(coords: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """Per-cell area/volume by the same Gauss rule."""
    dim = coords.shape[1]
    signs = _Q1_SIGNS_2D if dim == 2 else _Q1_SIGNS_3D
    pts, wts = _q1_gauss(dim)
    out = np.zeros(cells.shape[0])
    xc = coords[cells]                                 # [nc, npc, dim]
    for q, w in zip(pts, wts):
        Gref = _q1_grad_ref(signs, q)                  # [npc, dim]
        J = np.einsum("cpd,pe->cde", xc, Gref)
        out += w * np.abs(np.linalg.det(J))
    return out


def element_kernel_for(plex):
    """The vmappable stiffness kernel for this Plex's cell type."""
    npc = plex.cells.shape[1]
    dim = plex.coords.shape[1]
    if (npc, dim) == (3, 2):
        return p1_element_stiffness
    if (npc, dim) == (4, 3):
        return p1_element_stiffness_3d
    if (npc, dim) == (4, 2):
        return q1_element_stiffness
    if (npc, dim) == (8, 3):
        return q1_element_stiffness_3d
    raise ValueError(f"no element for npc={npc}, dim={dim}")


def cell_measures(plex) -> np.ndarray:
    npc = plex.cells.shape[1]
    dim = plex.coords.shape[1]
    if (npc, dim) in ((3, 2), (4, 3)):
        return _simplex_measures(plex.coords, plex.cells)
    return _q1_measures(plex.coords, plex.cells)


def _simplex_measures(coords: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """Per-cell area (tri) / volume (tet)."""
    p0 = coords[cells[:, 0]]
    E = np.stack([coords[cells[:, k]] - p0
                  for k in range(1, cells.shape[1])], axis=2)
    if cells.shape[1] == 3:
        return 0.5 * np.abs(E[:, 0, 0] * E[:, 1, 1]
                            - E[:, 0, 1] * E[:, 1, 0])
    return np.abs(np.linalg.det(E)) / 6.0


def fem_assemble_poisson(plex, f: Callable = None, dtype=np.float64,
                         section=None, bc_label=None, neumann=None,
                         robin=None):
    """Assemble A, b for −Δu = f with homogeneous Dirichlet boundary,
    on any Plex cell type (tri/quad P1/Q1 in 2-D, tet/hex in 3-D).

    Returns (A_device AIJ, A_host scipy CSR, b_device). The element
    loop is vmapped (all cells at once); the dof scatter goes through
    a Section (closure_indices — the vectorized DMPlexMatSetClosure,
    plex.c); assembly is host-side COO→CSR for the frozen sparsity
    plus identity boundary rows (the ex12-style path).

    bc_label: optional (label_name, values) pair or DMLabel —
    Dirichlet dofs come from the named point sets instead of the
    whole topological boundary (the DMAddBoundary-over-DMLabel
    pattern the reference uses for marker-driven BCs).

    neumann: optional (label|name, values, g) — facet-integral
    natural BC over FIRST-CLASS facet points (dm/interp): adds
    int_Gamma g v ds to the load (one-point facet rule), the
    DMAddBoundary NATURAL analog. g: callable(centroid)->value or a
    constant.

    robin: optional (label|name, values, alpha) — adds the lumped
    facet mass alpha int_Gamma u v ds to the operator."""
    from petsctpu.dm.section import vertex_section
    from petsctpu.mat.ell import aij_from_scipy

    # canonicalize: fp64 requests under a non-x64 runtime become fp32
    # explicitly (otherwise every jnp.asarray emits a truncation
    # warning — the dryrun/bench environment runs fp32)
    if (np.dtype(dtype) == np.float64
            and not jax.config.jax_enable_x64):
        dtype = np.float32
    npc = plex.cells.shape[1]                          # nodes per cell
    cells = jnp.asarray(plex.cells)
    coords = jnp.asarray(plex.coords, dtype)
    ker = element_kernel_for(plex)
    Ke_np = np.asarray(jax.vmap(lambda c: ker(coords[c]))(cells))

    nc = plex.num_cells
    nv = plex.num_vertices
    if bc_label is not None:
        from petsctpu.dm.label import (DMLabel, get_label,
                                       label_vertices)
        if isinstance(bc_label, DMLabel):
            lab, vals = bc_label, bc_label.values()
        else:
            name, vals = bc_label
            lab = get_label(plex, name)
            if lab is None:
                raise ValueError(f"no label {name!r} on this Plex")
        bnd = label_vertices(plex, lab, vals)
    else:
        bnd = plex.boundary_vertices()
    if section is None:
        section = vertex_section(nv, dof=1, constrained=bnd)
    ndof = section.total_dofs
    ci = section.closure_indices(plex.cells)           # [nc, npc]
    rows = np.repeat(ci, npc, axis=1).reshape(-1)      # i index
    cols = np.tile(ci, (1, npc)).reshape(-1)           # j index
    vals = Ke_np.reshape(-1)
    # STRUCTURAL pattern (closure pairs), then accumulate — a plain
    # COO->CSR would silently prune entries whose element sums cancel
    # to exactly 0 (e.g. the diagonal edge of right-angle triangles),
    # breaking frozen-pattern plans downstream
    keys = rows.astype(np.int64) * ndof + cols
    ukeys, slot = np.unique(keys, return_inverse=True)
    data = np.zeros(len(ukeys), dtype)
    np.add.at(data, slot, vals)
    indptr = np.searchsorted(ukeys // ndof, np.arange(ndof + 1))
    A = sp.csr_matrix((data, (ukeys % ndof).astype(np.int32),
                       indptr), shape=(ndof, ndof))

    # load vector: one-point rule (measure/npc per vertex)
    p = plex.coords
    centroids = p[plex.cells].mean(axis=1)
    measures = cell_measures(plex)
    fc = (np.ones(nc) if f is None
          else np.asarray([f(c) for c in centroids], float))
    b = np.zeros(ndof)
    np.add.at(b, ci.reshape(-1), np.repeat(measures * fc / npc, npc))

    def _resolve(spec):
        from petsctpu.dm.label import DMLabel, get_label
        lab_or_name, vals, gfun = spec
        if isinstance(lab_or_name, DMLabel):
            lab2 = lab_or_name
        else:
            lab2 = get_label(plex, lab_or_name)
            if lab2 is None:
                raise ValueError(f"no label {lab_or_name!r}")
        return lab2, vals, gfun

    if neumann is not None:
        from petsctpu.dm.interp import (face_centroids, face_measures,
                                        interpolate, label_faces)
        lab2, vals2, g = _resolve(neumann)
        fids = label_faces(plex, lab2, vals2)
        if len(fids):
            it = interpolate(plex)
            meas = face_measures(plex, fids)
            cen = face_centroids(plex, fids)
            gv = (np.asarray([g(c) for c in cen], float)
                  if callable(g) else float(g) * np.ones(len(fids)))
            fverts = it.faces[fids]                  # [nf, fnodes]
            fnodes = fverts.shape[1]
            contrib = np.repeat(meas * gv / fnodes, fnodes)
            np.add.at(b, section.closure_indices(fverts).reshape(-1),
                      contrib)

    if robin is not None:
        from petsctpu.dm.interp import (face_centroids, face_measures,
                                        interpolate, label_faces)
        lab2, vals2, alpha = _resolve(robin)
        fids = label_faces(plex, lab2, vals2)
        if len(fids):
            it = interpolate(plex)
            meas = face_measures(plex, fids)
            cen = face_centroids(plex, fids)
            av = (np.asarray([alpha(c) for c in cen], float)
                  if callable(alpha) else float(alpha)
                  * np.ones(len(fids)))
            fverts = it.faces[fids]
            fnodes = fverts.shape[1]
            dd = np.repeat(av * meas / fnodes, fnodes)
            di = section.closure_indices(fverts).reshape(-1)
            # lumped facet mass onto the diagonal (pattern has it)
            Ad_ = A.diagonal()
            np.add.at(Ad_, di, dd)
            A.setdiag(Ad_)

    # Dirichlet boundary (the Section's constrained dofs): zero
    # rows/cols IN the pattern (MatZeroRows keeps the pattern), unit
    # diagonal, zero rhs
    con = section.constrained
    rr = np.repeat(np.arange(ndof), np.diff(A.indptr))
    A.data[con[rr] | con[A.indices]] = 0.0
    A.data[(A.indices == rr) & con[rr]] = 1.0
    b[con] = 0.0
    return aij_from_scipy(A, dtype=dtype), A, jnp.asarray(b, dtype)


def p1_assemble_poisson(plex, f: Callable = None, dtype=np.float64):
    """Back-compat alias (rounds 1-2 name)."""
    return fem_assemble_poisson(plex, f=f, dtype=dtype)


# ---------------------------------------------------------------------------
# P2 (quadratic) triangles through the Section — dofs on vertices AND
# edge midpoints (the PetscSection multi-stratum layout, plex.c's
# DMPlexGetDepthStratum over vertices + edges)
# ---------------------------------------------------------------------------

def p2_element_stiffness(coords_cell: jax.Array) -> jax.Array:
    """6×6 P2 stiffness for a straight triangle (coords [3,2]).

    Local ordering: vertices 0,1,2 then midpoints of edges (0,1),
    (1,2), (2,0). Barycentric shapes N_i = λ_i(2λ_i−1),
    N_{3+k} = 4λ_aλ_b; the 3-midpoint rule integrates the quadratic
    gradient products exactly."""
    p0, p1, p2 = coords_cell[0], coords_cell[1], coords_cell[2]
    J = jnp.stack([p1 - p0, p2 - p0], axis=1)
    detJ = J[0, 0] * J[1, 1] - J[0, 1] * J[1, 0]
    area = 0.5 * jnp.abs(detJ)
    Jinv = jnp.array([[J[1, 1], -J[0, 1]], [-J[1, 0], J[0, 0]]]) / detJ
    # ∇λ (constant): λ = [1-ξ-η, ξ, η] in reference coords
    glam = jnp.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]]) @ Jinv
    # midpoint quadrature: barycentric (1/2,1/2,0),(0,1/2,1/2),(1/2,0,1/2)
    qpts = np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]])
    edges = ((0, 1), (1, 2), (2, 0))
    K = jnp.zeros((6, 6), coords_cell.dtype)
    for lam in qpts:
        G = []
        for i in range(3):                   # vertex shapes
            G.append((4.0 * lam[i] - 1.0) * glam[i])
        for (a, b) in edges:                 # edge bubbles
            G.append(4.0 * (lam[a] * glam[b] + lam[b] * glam[a]))
        G = jnp.stack(G)                     # [6, 2]
        K = K + (area / 3.0) * (G @ G.T)
    return K


def p2_closure(plex):
    """[nc, 6] closure point ids (vertices then edge points offset by
    nv) and the edge table used for the numbering."""
    edges = plex.edges()
    emap = {tuple(e): k for k, e in enumerate(edges)}
    nv = plex.num_vertices
    cl = np.empty((plex.num_cells, 6), np.int64)
    for c, (a, b, d) in enumerate(plex.cells):
        cl[c, :3] = (a, b, d)
        cl[c, 3] = nv + emap[tuple(sorted((int(a), int(b))))]
        cl[c, 4] = nv + emap[tuple(sorted((int(b), int(d))))]
        cl[c, 5] = nv + emap[tuple(sorted((int(d), int(a))))]
    return cl, edges


def p2_assemble_poisson(plex, f: Callable = None, dtype=np.float64):
    """Assemble −Δu = f with P2 triangles, homogeneous Dirichlet.

    Returns (A_device, A_host, b_device, node_coords) where
    node_coords [nv+ne, 2] includes the edge midpoints (for evaluating
    exact solutions at every dof)."""
    from petsctpu.dm.section import Section
    from petsctpu.mat.ell import aij_from_scipy

    cl, edges = p2_closure(plex)
    nv = plex.num_vertices
    ne = edges.shape[0]
    npts = nv + ne
    mids = 0.5 * (plex.coords[edges[:, 0]] + plex.coords[edges[:, 1]])
    node_coords = np.concatenate([plex.coords, mids])

    # boundary: vertices on boundary + midpoints of boundary edges
    e_all = np.concatenate([plex.cells[:, [0, 1]], plex.cells[:, [1, 2]],
                            plex.cells[:, [2, 0]]])
    e_all = np.sort(e_all, axis=1)
    uniq, counts = np.unique(e_all, axis=0, return_counts=True)
    bedges = uniq[counts == 1]
    bnd_v = np.unique(bedges.reshape(-1))
    emap = {tuple(e): k for k, e in enumerate(edges)}
    bnd_e = np.asarray([nv + emap[tuple(e)] for e in bedges], np.int64)
    con_pts = np.concatenate([bnd_v, bnd_e])

    sec = Section(npts).set_dof(np.arange(npts), 1)
    sec.set_constrained(con_pts)
    sec.setup()

    coords = jnp.asarray(plex.coords, dtype)
    Ke = np.asarray(jax.vmap(
        lambda c: p2_element_stiffness(coords[c]))(
        jnp.asarray(plex.cells)))

    ci = sec.closure_indices(cl)                      # [nc, 6]
    rows = np.repeat(ci, 6, axis=1).reshape(-1)
    cols = np.tile(ci, (1, 6)).reshape(-1)
    vals = Ke.reshape(-1)
    ndof = sec.total_dofs
    keys = rows.astype(np.int64) * ndof + cols
    ukeys, slot = np.unique(keys, return_inverse=True)
    data = np.zeros(len(ukeys), dtype)
    np.add.at(data, slot, vals)
    indptr = np.searchsorted(ukeys // ndof, np.arange(ndof + 1))
    A = sp.csr_matrix((data, (ukeys % ndof).astype(np.int32), indptr),
                      shape=(ndof, ndof))

    # load: midpoint rule — only edge dofs receive load (vertex P2
    # shapes vanish at midpoints)
    measures = _simplex_measures(plex.coords, plex.cells)
    b = np.zeros(ndof)
    for k in range(3, 6):
        pts = node_coords[cl[:, k]]
        fv = (np.ones(len(pts)) if f is None
              else np.asarray([f(p) for p in pts], float))
        # ∫ N_edge = area/3; midpoint-rule weight area/3 × N=1 at its
        # own midpoint (other shapes vanish there)
        np.add.at(b, ci[:, k], measures / 3.0 * fv)

    con = sec.constrained
    rr = np.repeat(np.arange(ndof), np.diff(A.indptr))
    A.data[con[rr] | con[A.indices]] = 0.0
    A.data[(A.indices == rr) & con[rr]] = 1.0
    b[con] = 0.0
    return aij_from_scipy(A, dtype=dtype), A, jnp.asarray(b, dtype), \
        node_coords
