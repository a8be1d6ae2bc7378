"""Sparse matrix-matrix products: SpGEMM and PtAP (Galerkin).

Reference: MatMatMult symbolic/numeric split (src/mat/impls/aij/seq/
matmatmult.c:29 — symbolic estimates fill once, numeric re-runs cheaply
when values change) and MatPtAP (src/mat/impls/aij/seq/matptap.c:19,44)
powering GAMG's coarse operators (gamg.c:156).

Device design: the same symbolic/numeric split, but sharper — the
SYMBOLIC phase runs on host (scipy computes the product pattern and a
flat contribution plan), and the NUMERIC phase is a pure jit-safe
segment-sum over device value arrays. That makes Galerkin coarse
operators re-assemblable INSIDE a jitted Newton/time loop when only
coefficients change (something the reference's host-only PtAP cannot
do without leaving the solver).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from petsctpu.mat.ell import AIJ, aij_from_scipy


# ---------------------------------------------------------------------------
# host-only products (plan-time)
# ---------------------------------------------------------------------------
def matmatmult(A, B):
    """C = A·B on host (MatMatMult analog)."""
    return (sp.csr_matrix(A) @ sp.csr_matrix(B)).tocsr()


def ptap(A, P):
    """Galerkin triple product Pᵀ·A·P on host (MatPtAP analog)."""
    P = sp.csr_matrix(P)
    return (P.T @ sp.csr_matrix(A) @ P).tocsr()


def rart(A, R):
    """R·A·Rᵀ (MatRARt analog)."""
    R = sp.csr_matrix(R)
    return (R @ sp.csr_matrix(A) @ R.T).tocsr()


# ---------------------------------------------------------------------------
# device numeric with frozen symbolic pattern
# ---------------------------------------------------------------------------
def _csr_entry_index(M: sp.csr_matrix):
    """Map (row, col) -> flat data index for a sorted CSR."""
    M = sp.csr_matrix(M)
    M.sort_indices()
    return M


def _lookup(M: sp.csr_matrix, rows, cols):
    """Flat data indices of entries (rows[k], cols[k]) — must exist.

    Vectorized: a sorted CSR's data order is the sort order of the key
    (row·ncols + col), so one global searchsorted resolves every query
    (the scalar-loop version was the GAMG-setup bottleneck at scale)."""
    ncols = M.shape[1]
    m_rows = np.repeat(np.arange(M.shape[0], dtype=np.int64),
                       np.diff(M.indptr))
    keys = m_rows * ncols + M.indices
    return np.searchsorted(keys, np.asarray(rows, np.int64) * ncols
                           + np.asarray(cols, np.int64))


def _segment_arange(starts, lengths):
    """Concatenate [starts[i], starts[i]+lengths[i]) ranges, vectorized."""
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    seg = np.repeat(np.arange(len(lengths)), lengths)
    first = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=first[1:])
    local = np.arange(total, dtype=np.int64) - first[seg]
    return np.asarray(starts, np.int64)[seg] + local


def _size_class_tables(c_idx, c_nnz, *index_streams):
    """Group contributions by output slot into pow2-width dense
    tables, so the numeric product is a scatter-free
    gather → [n_cls, W] multiply → sum(axis=1) →
    one inverse-permutation gather. Returns
    (classes=[(W, padded index arrays per stream)], inv)."""
    order = np.argsort(c_idx, kind="stable")
    cs = np.asarray(c_idx)[order]
    streams = [np.asarray(s)[order] for s in index_streams]
    starts = np.searchsorted(cs, np.arange(c_nnz + 1))
    counts = np.diff(starts)
    W = np.maximum(1, 1 << np.ceil(np.log2(np.maximum(counts, 1)))
                   .astype(np.int64))
    classes = []
    slot_concat = []
    for w in np.unique(W):
        slots = np.flatnonzero(W == w)
        idx2d = starts[slots][:, None] + np.arange(w)[None, :]
        valid = np.arange(w)[None, :] < counts[slots][:, None]
        tables = []
        for s in streams:
            t = np.where(valid, s[np.minimum(idx2d, len(cs) - 1)],
                         -1).astype(np.int64)
            tables.append(t)
        classes.append((int(w), tables))
        slot_concat.append(slots)
    slot_concat = np.concatenate(slot_concat) if slot_concat else \
        np.zeros(0, np.int64)
    inv = np.zeros(c_nnz, np.int64)
    inv[slot_concat] = np.arange(len(slot_concat))
    return classes, inv


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SpGEMMPlan:
    """Numeric C = A·B with frozen patterns.

    Contributions are grouped by output slot into pow2-width dense
    tables at plan time (see _size_class_tables) so the numeric phase
    is pure gathers + dense reductions — no scatter.
    `template` holds C's ELL structure; `ell_pos` maps CSR data order
    to flat ELL slots. Padded slots index a_nnz/b_nnz (an appended
    zero)."""

    cls_ai: tuple           # per class: int32 [n_cls, W] into a_data
    cls_bi: tuple           # per class: int32 [n_cls, W] into b_data
    inv: jax.Array          # output slot -> position in class-concat
    ell_pos: jax.Array
    template: AIJ
    c_nnz: int = field(metadata=dict(static=True))
    a_nnz: int = field(metadata=dict(static=True), default=0)
    b_nnz: int = field(metadata=dict(static=True), default=0)

    @classmethod
    def plan(cls, A_host, B_host, dtype=None) -> "SpGEMMPlan":
        A = _csr_entry_index(A_host)
        B = _csr_entry_index(B_host)
        C = _csr_entry_index((A @ B).tocsr())
        a_rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
        # contributions: for each A entry (i,k) x each B entry (k,j)
        reps = np.diff(B.indptr)[A.indices]
        a_idx = np.repeat(np.arange(A.nnz), reps)
        b_idx = _segment_arange(B.indptr[A.indices], reps)
        ci = np.repeat(a_rows, reps)
        cj = B.indices[b_idx]
        c_idx = _lookup(C, ci, cj)
        classes, inv = _size_class_tables(c_idx, int(C.nnz),
                                          a_idx, b_idx)
        cls_ai = tuple(jnp.asarray(np.where(t[0] < 0, A.nnz, t[0]),
                                   jnp.int32) for _, t in classes)
        cls_bi = tuple(jnp.asarray(np.where(t[1] < 0, B.nnz, t[1]),
                                   jnp.int32) for _, t in classes)
        tmpl = aij_from_scipy(C, dtype=dtype)
        ell_pos = _ell_positions(C, tmpl)
        return cls(cls_ai, cls_bi, jnp.asarray(inv, jnp.int32),
                   jnp.asarray(ell_pos, jnp.int32),
                   tmpl, int(C.nnz), int(A.nnz), int(B.nnz))

    def numeric_data(self, a_data: jax.Array, b_data: jax.Array):
        """C's sorted-CSR data array (for chaining into further plans)."""
        zp = jnp.zeros((1,), a_data.dtype)
        ap = jnp.concatenate([a_data, zp])
        bp = jnp.concatenate([b_data.astype(a_data.dtype), zp])
        parts = [jnp.sum(ap[ai] * bp[bi], axis=1)
                 for ai, bi in zip(self.cls_ai, self.cls_bi)]
        sums = jnp.concatenate(parts) if parts else \
            jnp.zeros((0,), a_data.dtype)
        return sums[self.inv]

    def numeric(self, a_data: jax.Array, b_data: jax.Array) -> AIJ:
        return _fill_template(self.template, self.ell_pos,
                              self.numeric_data(a_data, b_data))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PtAPPlan:
    """Numeric Ac = Pᵀ·A·P with frozen patterns (P values also frozen —
    the common Galerkin case where only A's coefficients change).
    Same scatter-free size-classed layout as SpGEMMPlan."""

    cls_ai: tuple         # per class: int32 [n_cls, W] into a_data
    cls_w: tuple          # per class: [n_cls, W] P-weight products
    inv: jax.Array
    ell_pos: jax.Array
    template: AIJ
    c_nnz: int = field(metadata=dict(static=True))
    a_nnz: int = field(metadata=dict(static=True), default=0)

    @classmethod
    def plan(cls, A_host, P_host, dtype=None) -> "PtAPPlan":
        A = _csr_entry_index(A_host)
        P = _csr_entry_index(P_host)
        C = _csr_entry_index((P.T @ A @ P).tocsr())
        # contributions: A entry (k,l); P row k entries (k,i); P row l (l,j)
        a_rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
        ks, ls = a_rows, A.indices
        cnt_k = np.diff(P.indptr)[ks]
        cnt_l = np.diff(P.indptr)[ls]
        reps = cnt_k * cnt_l
        a_idx = np.repeat(np.arange(A.nnz), reps)
        # vectorized outer products: contribution q under A-entry t maps
        # to P-row-k slot (local // cnt_l) and P-row-l slot (local % cnt_l)
        total = int(reps.sum())
        t_of = np.repeat(np.arange(A.nnz), reps)
        first = np.zeros(A.nnz + 1, np.int64)
        np.cumsum(reps, out=first[1:])
        local = np.arange(total, dtype=np.int64) - first[t_of]
        denom = np.maximum(cnt_l[t_of], 1)
        pk_idx = P.indptr[ks[t_of]] + local // denom
        pl_idx = P.indptr[ls[t_of]] + local % denom
        ci = P.indices[pk_idx].astype(np.int64)
        cj = P.indices[pl_idx].astype(np.int64)
        w = P.data[pk_idx] * P.data[pl_idx]
        c_idx = _lookup(C, ci, cj)
        tmpl = aij_from_scipy(C, dtype=dtype)
        ell_pos = _ell_positions(C, tmpl)
        wi = np.arange(len(w))
        classes, inv = _size_class_tables(c_idx, int(C.nnz), a_idx, wi)
        cls_ai = tuple(jnp.asarray(np.where(t[0] < 0, A.nnz, t[0]),
                                   jnp.int32) for _, t in classes)
        wpad = np.concatenate([w, [0.0]])
        cls_w = tuple(jnp.asarray(wpad[t[1]], tmpl.dtype)
                      for _, t in classes)
        return cls(cls_ai, cls_w, jnp.asarray(inv, jnp.int32),
                   jnp.asarray(ell_pos, jnp.int32), tmpl,
                   int(C.nnz), int(A.nnz))

    def numeric(self, a_data: jax.Array) -> AIJ:
        ap = jnp.concatenate([a_data, jnp.zeros((1,), a_data.dtype)])
        parts = [jnp.sum(ap[ai] * w, axis=1)
                 for ai, w in zip(self.cls_ai, self.cls_w)]
        cdata = jnp.concatenate(parts)[self.inv] if parts else \
            jnp.zeros((0,), a_data.dtype)
        return _fill_template(self.template, self.ell_pos, cdata)


def _ell_positions(C: sp.csr_matrix, tmpl: AIJ) -> np.ndarray:
    """Flat ELL slot of each CSR data entry (row-major slot order)."""
    K = tmpl.ell_width
    row_nnz = np.diff(C.indptr)
    rows = np.repeat(np.arange(C.shape[0]), row_nnz)
    slot = np.arange(C.nnz) - np.repeat(C.indptr[:-1], row_nnz)
    return rows.astype(np.int64) * K + slot


def _fill_template(tmpl: AIJ, ell_pos, cdata) -> AIJ:
    flat = jnp.zeros((tmpl.cols.shape[0] * tmpl.ell_width,), cdata.dtype)
    flat = flat.at[ell_pos].set(cdata)
    return AIJ(tmpl.cols, flat.reshape(tmpl.vals.shape), tmpl.shape,
               tmpl.nnz)


def csr_data_of(A_host) -> np.ndarray:
    """Sorted-CSR data array matching plan index conventions."""
    M = _csr_entry_index(A_host)
    return M.data
