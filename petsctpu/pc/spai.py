"""PCSPAI — sparse approximate inverse preconditioner (native).

The reference wraps the external SPAI 3.0 library
(src/ksp/pc/impls/spai/ispai.c, PCSPAISetEpsilon etc.); here the
Frobenius-norm SPAI is implemented natively, because an approximate
inverse suits an accelerator: the apply is one SpMV (no sequential
triangular solves, no collectives beyond the SpMV's own halo).

Construction (host, plan-time, batched numpy):
  minimize ||A M - I||_F  column-by-column over a fixed sparsity
  pattern S = pattern(A^p) (p = pc_spai_nbsteps pattern power).
  Column j solves the small dense least-squares
      min_m || A(I_j, J_j) m - e_j(I_j) ||_2,
  J_j = pattern column, I_j = rows touched by those columns. Columns
  are grouped by (|I|,|J|) padding class and solved with one batched
  pinv per class (zero row/col padding is exact for least squares).

Apply (device): x -> M x, a single AIJ SpMV.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def spai_host(A_host, pattern_power: int = 1, max_pattern: int = 64):
    """Compute the SPAI matrix M (scipy CSR) minimizing ||AM - I||_F
    over the pattern of A**pattern_power (column-capped at
    max_pattern entries, largest-|A| kept)."""
    A = sp.csr_matrix(A_host).astype(np.float64)
    n = A.shape[0]
    # pattern S: columns of A^p (structural)
    S = A.copy()
    S.data[:] = 1.0
    P = S
    for _ in range(pattern_power - 1):
        P = (P @ S).tocsr()
        P.data[:] = 1.0
    Pc = P.tocsc()
    Ac = A.tocsc()
    Acsr = A

    # per-column index sets
    cols_J = []
    for j in range(n):
        J = Pc.indices[Pc.indptr[j]:Pc.indptr[j + 1]]
        if J.size > max_pattern:
            # keep entries with largest |A[:, j]|-coupling: rank by |A[J, j]|
            w = np.abs(np.asarray(Ac[J, j].todense())).ravel()
            J = J[np.argsort(-w)[:max_pattern]]
            J.sort()
        cols_J.append(J)

    # rows touched: union of rows of A[:, J]
    cols_I = []
    for j in range(n):
        J = cols_J[j]
        I = np.unique(np.concatenate(
            [Ac.indices[Ac.indptr[k]:Ac.indptr[k + 1]] for k in J]))
        cols_I.append(I)

    # batch by padded class sizes (quantized to limit class count)
    def q(x):
        return int(2 ** np.ceil(np.log2(max(x, 1))))

    classes = {}
    for j in range(n):
        key = (q(cols_I[j].size), q(cols_J[j].size))
        classes.setdefault(key, []).append(j)

    rows_out, cols_out, vals_out = [], [], []
    for (mi, mj), js in classes.items():
        B = np.zeros((len(js), mi, mj))
        e = np.zeros((len(js), mi))
        for t, j in enumerate(js):
            I, J = cols_I[j], cols_J[j]
            # dense block A[I, J]
            sub = Acsr[I][:, J].toarray()
            B[t, :I.size, :J.size] = sub
            pos = np.searchsorted(I, j)
            if pos < I.size and I[pos] == j:
                e[t, pos] = 1.0
        # batched least squares via pinv (zero padding rows/cols exact)
        Bp = np.linalg.pinv(B)            # (b, mj, mi)
        m = np.einsum("bji,bi->bj", Bp, e)
        for t, j in enumerate(js):
            J = cols_J[j]
            rows_out.append(J)
            cols_out.append(np.full(J.size, j))
            vals_out.append(m[t, :J.size])

    M = sp.coo_matrix((np.concatenate(vals_out),
                       (np.concatenate(rows_out), np.concatenate(cols_out))),
                      shape=(n, n)).tocsr()
    return M


def make_spai(A_host, dtype=None, pattern_power: int = 1,
              max_pattern: int = 64):
    """Build the SPAI PC: host least-squares construction, device AIJ
    apply (one SpMV)."""
    from petsctpu.mat.ell import aij_from_scipy
    from petsctpu.pc.composite import MatPC

    M = spai_host(A_host, pattern_power=pattern_power,
                  max_pattern=max_pattern)
    return MatPC(aij_from_scipy(M, dtype=dtype))
