"""Factorization preconditioners: ILU(0), LU, Cholesky/ICC.

Reference: src/ksp/pc/impls/factor/{ilu,lu,cholesky,icc}. Numeric
factorization happens host-side at setup (PCSetUp time, like the
reference); the apply is two level-scheduled SpTRSVs on device
(mat/factor.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from petsctpu.mat.factor import (
    BandTRSVPlan, SpTRSVPlan, ilu0, lu_factor, make_band_trsv_plan,
    make_sptrsv_plan,
)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ILUPC:
    """x = U⁻¹ L⁻¹ b with L unit-lower, U upper (pattern of A)."""

    Lplan: SpTRSVPlan
    Uplan: SpTRSVPlan

    def apply(self, b):
        return self.Uplan.solve(self.Lplan.solve(b))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PermutedPC:
    """Apply an inner PC in a symmetric permutation: M⁻¹ = Pᵀ M̃⁻¹ P
    (-pc_factor_mat_ordering_type rcm analog)."""

    inner: object
    perm: jax.Array      # new → old

    def apply(self, b):
        z = self.inner.apply(b[self.perm])
        return jnp.zeros_like(b).at[self.perm].set(z)

    @property
    def has_transpose(self):
        return getattr(self.inner, "has_transpose",
                       hasattr(self.inner, "apply_transpose"))

    def apply_transpose(self, b):
        # (Pᵀ M̃⁻¹ P)ᵀ = Pᵀ M̃⁻ᵀ P for a symmetric permutation
        z = self.inner.apply_transpose(b[self.perm])
        return jnp.zeros_like(b).at[self.perm].set(z)


def make_ilu(A_host, dtype=None, levels: int = 0,
             ordering: str = "natural", tri: str = "auto",
             drop_tol: float = 0.0, fill_factor: float = 10.0,
             transpose_solves: bool = False):
    """tri: 'level' (level-scheduled SpTRSV) or 'band' (dense-tile
    blocked back-substitution for banded/RCM-ordered factors; see
    mat/factor.BandTRSVPlan).

    drop_tol > 0 selects drop-tolerance ILU (ILUTP via SuperLU, the
    -pc_factor_drop_tolerance / MATSOLVERSUPERLU ILUT path of the
    reference's factor PCs): threshold-based fill instead of ILU(k)
    pattern powers."""
    if drop_tol > 0.0:
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla
        ilu = spla.spilu(sp.csc_matrix(A_host).astype(np.float64),
                         drop_tol=drop_tol, fill_factor=fill_factor)
        L = sp.csr_matrix(ilu.L)         # unit lower with stored diag 1
        U = sp.csr_matrix(ilu.U)
        Lstrict = sp.tril(L, k=-1, format="csr")
        if tri == "auto":
            # same auto policy as the ILU(k) path: band-viable fp32
            # factors take the banded route; band-inviable SMALL
            # factors go dense (SuperLU ILUT fill reaches ~n bandwidth
            # AND ~1000 dependency levels — the level-scheduled loop
            # then runs ~1e9 scalar gathers in one program); only large
            # band-inviable factors keep level scheduling
            from petsctpu.pc.parallel import band_solve_viable
            if band_solve_viable([Lstrict], [U], dtype):
                tri = "band2"
            elif L.shape[0] <= 4096:
                tri = "dense"
            else:
                tri = "level"
        if tri == "dense":
            from petsctpu.mat.factor import make_dense_trsv_plan
            inner = ILUPC(
                make_dense_trsv_plan(Lstrict + sp.eye(L.shape[0]),
                                     lower=True, unit_diag=True,
                                     dtype=dtype),
                make_dense_trsv_plan(U, lower=False, unit_diag=False,
                                     dtype=dtype))
        elif tri == "band2":
            from petsctpu.mat.factor import make_band_trsv_hier_plan
            inner = ILUPC(
                make_band_trsv_hier_plan(Lstrict, lower=True,
                                         unit_diag=True, dtype=dtype),
                make_band_trsv_hier_plan(U, lower=False, unit_diag=False,
                                         dtype=dtype))
        else:
            mk = (make_band_trsv_plan if tri == "band"
                  else make_sptrsv_plan)
            inner = ILUPC(
                mk(Lstrict, lower=True, unit_diag=True, dtype=dtype),
                mk(U, lower=False, unit_diag=False, dtype=dtype))
        # spilu permutes rows/cols: x = Pc U⁻¹ L⁻¹ Pr b (LUPC convention)
        return LUPC(inner.Lplan, inner.Uplan,
                    jnp.asarray(ilu.perm_r, jnp.int32),
                    jnp.asarray(ilu.perm_c, jnp.int32))
    if ordering not in ("natural", ""):
        from petsctpu.mat.order import get_ordering, permute_symmetric
        perm = get_ordering(A_host, ordering)
        inner = make_ilu(permute_symmetric(A_host, perm), dtype=dtype,
                         levels=levels, tri=tri,
                         transpose_solves=transpose_solves)
        return PermutedPC(inner, jnp.asarray(perm, jnp.int32))
    return _make_ilu_natural(A_host, dtype, levels, tri,
                             transpose_solves)


def _iluk_pattern(A, k: int):
    """Symbolic ILU(k) pattern (Saad §10.3.3; the reference's
    MatILUFactorSymbolic level rule, aijfact.c:122): per row, start
    with the matrix's own entries at level 0; eliminating column kk<i
    introduces fills at row kk's upper entries with
    level = lev(i,kk) + lev(kk,j) + 1, kept when ≤ k. Returns a list
    of sorted column-index arrays (one per row)."""
    import bisect

    n = A.shape[0]
    A.sort_indices()
    from petsctpu import native
    if native.available():
        res = native.iluk_pattern(A.indptr, A.indices, k)
        if res is not None:
            indptr, cols = res
            return np.split(cols, indptr[1:-1])
    rowpat = []                    # per row: list of (col, level), sorted
    out = []
    for i in range(n):
        lev = {int(j): 0 for j in A.indices[A.indptr[i]:A.indptr[i + 1]]}
        wl = sorted(c for c in lev if c < i)
        idx = 0
        while idx < len(wl):
            kk = wl[idx]
            idx += 1
            lk = lev[kk]
            if lk >= k:            # fills from this pivot exceed k
                continue
            for jc, lj in rowpat[kk]:
                if jc <= kk:
                    continue
                nl = lk + lj + 1
                if nl <= k:
                    cur = lev.get(jc)
                    if cur is None:
                        lev[jc] = nl
                        if jc < i:
                            bisect.insort(wl, jc)
                    elif nl < cur:
                        lev[jc] = nl
        row = sorted(lev.items())
        rowpat.append(row)
        out.append(np.asarray([c for c, _ in row], np.int64))
    return out


def _make_ilu_natural(A_host, dtype=None, levels: int = 0,
                      tri: str = "auto",
                      transpose_solves: bool = False) -> ILUPC:
    if levels != 0:
        import scipy.sparse as sp
        # symbolic ILU(k): Saad's level-of-fill rule —
        # lev(fill i,j) = min over eliminations of
        # lev(i,k)+lev(k,j)+1, kept when ≤ k. This is the reference's
        # MatILUFactorSymbolic/MatICCFactorSymbolic pattern
        # (aijfact.c:122+); numeric = ILU(0) on the widened pattern.
        patt_rows = _iluk_pattern(sp.csr_matrix(A_host), levels)
        n = A_host.shape[0]
        indptr = np.zeros(n + 1, np.int64)
        for i, cols_ in enumerate(patt_rows):
            indptr[i + 1] = indptr[i] + len(cols_)
        indices = (np.concatenate(patt_rows) if n
                   else np.zeros(0, np.int64))
        data = np.zeros(indices.shape[0])
        A_c = sp.csr_matrix(A_host)
        A_c.sort_indices()
        for i in range(n):
            s, e = indptr[i], indptr[i + 1]
            asl = slice(A_c.indptr[i], A_c.indptr[i + 1])
            pos = np.searchsorted(indices[s:e], A_c.indices[asl])
            data[s + pos] = A_c.data[asl]
        Awide = sp.csr_matrix((data, indices, indptr), shape=(n, n))
        L, U = ilu0(Awide)
    else:
        L, U = ilu0(A_host)
    if transpose_solves:
        # the transpose plans are level-scheduled; keep the forward
        # solves on the same route so apply/apply_transpose use one
        # factorization representation (PCApplyTranspose parity)
        tri = "level"
    if tri == "auto":
        # the reference's default MatSolve is its fast path
        # (aijfact.c:603); auto picks the banded solve when the
        # factors are fp32 + band-viable, else level scheduling
        from petsctpu.pc.parallel import band_solve_viable
        tri = "band2" if band_solve_viable([L], [U], dtype) else "level"
    if tri == "band2":
        from petsctpu.mat.factor import make_band_trsv_hier_plan
        return ILUPC(
            make_band_trsv_hier_plan(L, lower=True, unit_diag=True,
                                     dtype=dtype),
            make_band_trsv_hier_plan(U, lower=False, unit_diag=False,
                                     dtype=dtype))
    if tri == "band":
        return ILUPC(
            make_band_trsv_plan(L, lower=True, unit_diag=True, dtype=dtype),
            make_band_trsv_plan(U, lower=False, unit_diag=False,
                                dtype=dtype))
    if transpose_solves:
        import scipy.sparse as sp
        return ILUPCT(
            make_sptrsv_plan(L, lower=True, unit_diag=True, dtype=dtype),
            make_sptrsv_plan(U, lower=False, unit_diag=False,
                             dtype=dtype),
            make_sptrsv_plan(sp.csr_matrix(L.T), lower=False,
                             unit_diag=True, dtype=dtype),
            make_sptrsv_plan(sp.csr_matrix(U.T), lower=True,
                             unit_diag=False, dtype=dtype))
    return ILUPC(make_sptrsv_plan(L, lower=True, unit_diag=True, dtype=dtype),
                 make_sptrsv_plan(U, lower=False, unit_diag=False, dtype=dtype))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ICCPC:
    """Incomplete Cholesky apply: x = U⁻¹ D⁻¹ U⁻ᵀ b with U unit upper
    (A ≈ UᵀDU from mat/factor.icc_factor — the reference's SBAIJ-form
    factor storage, MatSolve_SeqSBAIJ_1_NaturalOrdering)."""

    Lplan: object                  # solves Uᵀ y = b (unit lower)
    Uplan: object                  # solves U x = z (unit upper)
    dinv: jax.Array

    def apply(self, b):
        y = self.Lplan.solve(b)
        return self.Uplan.solve(self.dinv * y)


def make_icc(A_host, dtype=None, levels: int = 0,
             ordering: str = "natural", tri: str = "auto",
             shift_type: str = "positive_definite",
             shift_amount: float = None, zeropivot: float = None):
    """True ICC(k): symbolic level pattern (the same Saad/aijfact.c
    rule as ILU(k), restricted to the upper triangle) + the reference's
    UᵀDU numeric incomplete Cholesky with Manteuffel shift
    (MatCholeskyFactorNumeric_SeqAIJ aijfact.c:2076; PCICC defaults
    icc.c:198). Reproduces ksp ex32 testset5 icc monitor streams
    digit-exact (natural ordering)."""
    import scipy.sparse as sp

    from petsctpu.mat.factor import icc_factor, icc_pattern

    if ordering not in ("natural", ""):
        from petsctpu.mat.order import get_ordering, permute_symmetric
        perm = get_ordering(A_host, ordering)
        inner = make_icc(permute_symmetric(A_host, perm), dtype=dtype,
                         levels=levels, tri=tri, shift_type=shift_type,
                         shift_amount=shift_amount, zeropivot=zeropivot)
        return PermutedPC(inner, jnp.asarray(perm, jnp.int32))
    pattern = (None if levels == 0
               else icc_pattern(sp.csr_matrix(A_host), levels))
    Ustrict, d, _, _ = icc_factor(A_host, pattern_rows=pattern,
                                  shift_type=shift_type,
                                  zeropivot=zeropivot,
                                  shift_amount=shift_amount)
    L = sp.csr_matrix(Ustrict.T)
    if tri == "auto":
        # same policy as ILU: fp32 band-viable factors take the
        # two-phase banded solve, else level scheduling
        from petsctpu.pc.parallel import band_solve_viable
        tri = "band2" if band_solve_viable([L], [Ustrict], dtype) \
            else "level"
    if tri == "band2":
        from petsctpu.mat.factor import make_band_trsv_hier_plan
        mk = make_band_trsv_hier_plan
    else:
        mk = (make_band_trsv_plan if tri == "band"
              else make_sptrsv_plan)
    dt = dtype or np.float64
    return ICCPC(mk(L, lower=True, unit_diag=True, dtype=dtype),
                 mk(Ustrict, lower=False, unit_diag=True, dtype=dtype),
                 jnp.asarray(1.0 / d, dt))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class LUPC:
    """Exact sparse LU (SuperLU factors, device triangular solves):
    x = Pc U⁻¹ L⁻¹ Pr b."""

    Lplan: SpTRSVPlan
    Uplan: SpTRSVPlan
    perm_r: jax.Array
    perm_c: jax.Array

    def apply(self, b):
        # scipy splu convention: x = Pc U⁻¹ L⁻¹ Pr b with
        # (Pr b)[perm_r[i]] = b[i] (scatter) and (Pc z)[i] = z[perm_c[i]]
        # (gather) — matches scipy.sparse.linalg.SuperLU docs.
        pb = jnp.zeros_like(b).at[self.perm_r].set(b)
        z = self.Uplan.solve(self.Lplan.solve(pb))
        return z[self.perm_c]


def make_lu(A_host, dtype=None, transpose: bool = False) -> LUPC:
    """transpose=True builds the PCApplyTranspose operator from the
    SAME factorization (precon.c PCApplyTranspose → MatSolveTranspose):
    apply(b) = A⁻ᵀ b = Prᵀ L⁻ᵀ U⁻ᵀ Pcᵀ b — the permutations swap
    scatter/gather roles and the triangular factors swap order."""
    import scipy.sparse as sp

    L, U, perm_r, perm_c = lu_factor(A_host)
    if transpose:
        Ut = sp.csr_matrix(U.T)
        Lt = sp.csr_matrix(L.T)
        return LUPC(
            make_sptrsv_plan(Ut, lower=True, unit_diag=False, dtype=dtype),
            make_sptrsv_plan(Lt, lower=False, unit_diag=False, dtype=dtype),
            jnp.asarray(perm_c, jnp.int32), jnp.asarray(perm_r, jnp.int32))
    return LUPC(make_sptrsv_plan(L, lower=True, unit_diag=False, dtype=dtype),
                make_sptrsv_plan(U, lower=False, unit_diag=False, dtype=dtype),
                jnp.asarray(perm_r, jnp.int32), jnp.asarray(perm_c, jnp.int32))


def iludt_factor_host(A, dt: float = 0.005, dtcount: int = None,
                      shift: float = 0.0):
    """The reference's NATIVE drop-tolerance ILU, MatILUDTFactor_SeqAIJ
    (aijfact.c:3230), replicated exactly on host numpy — including the
    PetscLLAddSortedLU incremental fill scan (the persistent im[] scan
    limits), the multiplier-magnitude update-dropping rule
    (|m| > dt applies the pivot-row update; m is KEPT in L either
    way), the (nzi_l + dtcount)-largest-magnitude row cut selected by
    the PetscSortSplit quickselect VERBATIM (its tie-handling decides
    which equal-magnitude entries survive), and the zero-pivot
    dt+shift substitution. Returns (L_strict, U) scipy CSR with U
    carrying the TRUE (non-inverted) diagonal.

    Defaults follow the reference: dt=0.005, dtcount=1.5·max row nnz.
    """
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    A.sort_indices()
    n = A.shape[0]
    rmax = int(np.diff(A.indptr).max())
    if dtcount is None:
        dtcount = int(1.5 * rmax)
    dtcount = min(dtcount, n - 1)

    def sort_split(ncut, v, idx):
        """PetscSortSplit verbatim (sorti.c quickselect partition)."""
        first, last = 0, len(v) - 1
        if ncut < first or ncut > last:
            return
        while True:
            mid = first
            abskey = abs(v[mid])
            for j in range(first + 1, last + 1):
                if abs(v[j]) >= abskey:
                    mid += 1
                    v[mid], v[j] = v[j], v[mid]
                    idx[mid], idx[j] = idx[j], idx[mid]
            v[mid], v[first] = v[first], v[mid]
            idx[mid], idx[first] = idx[first], idx[mid]
            if mid == ncut:
                return
            if mid > ncut:
                last = mid - 1
            else:
                first = mid + 1

    Lrows = [None] * n              # per row: (cols list, vals list)
    Urows = [None] * n              # per row: (cols list incl diag first,
    #                                 vals list; diag NOT inverted here)
    im = np.zeros(n, np.int64)
    ai, aj, aa = A.indptr, A.indices, A.data
    adiag = np.zeros(n, np.int64)
    for i in range(n):
        s, e = ai[i], ai[i + 1]
        d = np.searchsorted(aj[s:e], i)
        assert aj[s + d] == i, f"missing diagonal in row {i}"
        adiag[i] = s + d

    rtmp = np.zeros(n, np.float64)          # PERSISTENT dense work row:
    # the reference only zeroes the jtmp positions after each row, so
    # values written by pivot updates at columns OUTSIDE the kept
    # pattern LEAK into later rows' fill positions — replicated.
    import bisect
    for i in range(n):
        s, e = ai[i], ai[i + 1]
        cols0 = [int(c) for c in aj[s:e]]
        nzi_al = int(adiag[i] - s)
        nzi_au = int(e - adiag[i] - 1)
        jset = sorted(cols0)
        inset = set(jset)
        for c, v in zip(cols0, aa[s:e]):
            rtmp[c] = v                      # overwrite (load)
        # symbolic: walk pivot rows in (dynamic) sorted order
        pos = 0
        while pos < len(jset) and jset[pos] < i:
            row = jset[pos]
            nzbd = len(Lrows[row][0]) + 1
            nidx = int(im[row]) - nzbd
            ucols = Urows[row][0][1:]        # exclude diagonal
            for k in range(nidx):
                entry = ucols[k]
                nzbd += 1
                if entry == i:
                    im[row] = nzbd
                if entry not in inset:
                    inset.add(entry)
                    bisect.insort(jset, entry)
            pos += 1
        jtmp = jset
        # numeric elimination
        for row in jtmp:
            if row >= i:
                break
            multiplier = rtmp[row] * Urows[row][1][0]   # inverted diag
            rtmp[row] = multiplier
            if abs(multiplier) > dt:
                for uc, uv in zip(Urows[row][0][1:], Urows[row][1][1:]):
                    rtmp[uc] -= multiplier * uv
        diag_tmp = rtmp[i]
        vtmp = [rtmp[c] for c in jtmp]
        for c in jtmp:
            rtmp[c] = 0.0
        nzi_bl = sum(1 for c in jtmp if c < i)
        nzi_bu = len(jtmp) - nzi_bl - 1
        jl = list(jtmp[:nzi_bl])
        vl = vtmp[:nzi_bl]
        ncut = nzi_al + dtcount
        if ncut < nzi_bl:
            sort_split(ncut, vl, jl)
            pair = sorted(zip(jl[:ncut], vl[:ncut]))
            jl = [p[0] for p in pair]
            vl = [p[1] for p in pair]
        else:
            ncut = nzi_bl
        Lrows[i] = (jl[:ncut], vl[:ncut])
        nzi = ncut + 1
        ju = list(jtmp[nzi_bl + 1:])
        vu = vtmp[nzi_bl + 1:]
        ncut = nzi_au + dtcount
        if ncut < nzi_bu:
            sort_split(ncut, vu, ju)
            pair = sorted(zip(ju[:ncut], vu[:ncut]))
            ju = [p[0] for p in pair]
            vu = [p[1] for p in pair]
        else:
            ncut = nzi_bu
        nzi += ncut
        if diag_tmp == 0.0:
            diag_tmp = dt + shift
        Urows[i] = ([i] + ju[:ncut], [1.0 / diag_tmp] + vu[:ncut])
        im[i] = nzi

    import scipy.sparse as sp
    Lr, Lc, Lv, Ur, Uc, Uv = [], [], [], [], [], []
    for i in range(n):
        for c, v in zip(*Lrows[i]):
            Lr.append(i)
            Lc.append(c)
            Lv.append(v)
        cols, vals = Urows[i]
        Ur.append(i)
        Uc.append(i)
        Uv.append(1.0 / vals[0])             # back to the true diagonal
        for c, v in zip(cols[1:], vals[1:]):
            Ur.append(i)
            Uc.append(c)
            Uv.append(v)
    L = sp.csr_matrix((Lv, (Lr, Lc)), shape=(n, n))
    U = sp.csr_matrix((Uv, (Ur, Uc)), shape=(n, n))
    return L, U


def make_iludt(A_host, dt: float = 0.005, dtcount: int = None,
               dtype=None, tri: str = "level"):
    """PCILU with the reference's NATIVE drop-tolerance factorization
    (-pc_factor_drop_tolerance dt,dtcol,maxrowcount -> MatILUDTFactor;
    ksp ex2_7). Apply = the usual level-scheduled L/U solves."""
    import scipy.sparse as sp

    L, U = iludt_factor_host(A_host, dt=dt, dtcount=dtcount)
    return ILUPC(
        make_sptrsv_plan(sp.csr_matrix(L), lower=True, unit_diag=True,
                         dtype=dtype),
        make_sptrsv_plan(sp.csr_matrix(U), lower=False, unit_diag=False,
                         dtype=dtype))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ILUPCT:
    """ILU with TRUE transpose application: apply = U⁻¹L⁻¹b,
    apply_transpose = L⁻ᵀU⁻ᵀb through dedicated plans for Uᵀ (lower)
    and Lᵀ (upper) — what the reference's PCApplyTranspose →
    MatSolveTranspose does for the adjoint chains of BiCG
    (bicg.c KSP_PCApplyTranspose). Built by
    make_ilu(transpose_solves=True) / -pc_factor_transpose_solves."""

    Lplan: SpTRSVPlan
    Uplan: SpTRSVPlan
    LTplan: SpTRSVPlan
    UTplan: SpTRSVPlan
    has_transpose = True

    def apply(self, b):
        return self.Uplan.solve(self.Lplan.solve(b))

    def apply_transpose(self, b):
        return self.LTplan.solve(self.UTplan.solve(b))
