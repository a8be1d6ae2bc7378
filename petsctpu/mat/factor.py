"""Incomplete/complete factorizations + level-scheduled triangular solves.

Reference: MatILUFactorSymbolic/MatLUFactorNumeric_SeqAIJ
(src/mat/impls/aij/seq/aijfact.c:122,285,461) and MatSolve_SeqAIJ
(aijfact.c:603). The reference's row-by-row sequential solve is the
wrong shape for a data-parallel device, so the design splits:

  * NUMERIC factorization on host (numpy over CSR) at PCSetUp time —
    setup is plan-time work, exactly where the reference also does it.
  * TRIANGULAR SOLVES on device via LEVEL SCHEDULING: rows are grouped
    into dependency levels (wavefronts); all rows in a level solve in
    parallel as an ELL gather + fused multiply-add, and a `fori_loop`
    walks levels. This is the standard GPU SpTRSV decomposition —
    the sequential depth drops from n to nlevels (≈ grid diameter for
    stencil ILU(0)).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


# ---------------------------------------------------------------------------
# numeric factorizations (host, numpy over CSR)
# ---------------------------------------------------------------------------
def ilu0(A) -> tuple:
    """ILU(0): LU restricted to the sparsity pattern of A.

    Returns (L, U) scipy CSR with L unit-lower (diag not stored) and U
    upper including diagonal. IKJ algorithm; the numeric loop runs in
    the native C++ kernel when available (native/petsctpu_native.cpp),
    mirroring the reference's C MatLUFactorNumeric_SeqAIJ."""
    A = sp.csr_matrix(A, copy=True)
    A.sort_indices()
    n = A.shape[0]
    ai, aj, av = A.indptr, A.indices, A.data

    from petsctpu import native
    if native.available():
        av64 = np.ascontiguousarray(av, np.float64)
        native.ilu0_csr_inplace(ai, aj, av64)
        F = sp.csr_matrix((av64.astype(av.dtype), aj, ai), shape=A.shape)
        return (sp.tril(F, k=-1, format="csr"),
                sp.triu(F, k=0, format="csr"))
    diag_ptr = np.zeros(n, dtype=np.int64)
    for i in range(n):
        row = aj[ai[i]:ai[i + 1]]
        d = np.searchsorted(row, i)
        if d >= len(row) or row[d] != i:
            raise ValueError(f"ILU(0): missing diagonal in row {i}")
        diag_ptr[i] = ai[i] + d
    for i in range(n):
        for p in range(ai[i], diag_ptr[i]):
            k = aj[p]
            av[p] /= av[diag_ptr[k]]
            lik = av[p]
            # update row i entries j > k that exist in BOTH rows
            krow = slice(diag_ptr[k] + 1, ai[k + 1])
            kj = aj[krow]
            kv = av[krow]
            irow = slice(p + 1, ai[i + 1])
            ij = aj[irow]
            pos = np.searchsorted(ij, kj)
            ok = (pos < len(ij))
            okp = pos[ok]
            hit = ij[okp] == kj[ok]
            av[irow][0]  # noop to keep slice live
            tgt = np.arange(irow.start, irow.stop)[okp[hit]]
            av[tgt] -= lik * kv[ok][hit]
    L = sp.tril(sp.csr_matrix((av, aj, ai), shape=A.shape), k=-1, format="csr")
    U = sp.triu(sp.csr_matrix((av, aj, ai), shape=A.shape), k=0, format="csr")
    return L, U


def icc0(A) -> sp.csr_matrix:
    """IC(0) via ILU(0) on the symmetric matrix: returns U with
    A ≈ UᵀDU folded as A ≈ LLᵀ-style (we reuse L,U from ilu0; for SPD A
    the ILU(0) pair is the standard substitute the reference's icc
    covers)."""
    L, U = ilu0(A)
    return L, U


def icc_pattern(A, levels: int):
    """Symbolic IC(k) pattern (MatICCFactorSymbolic_SeqAIJ,
    aijfact.c:2405): column-driven level rule over the UPPER triangle
    only. Row k starts from A's upper entries at level 0; every prior
    row `prow` with a pattern entry (prow,k) merges its columns j>k at
    level lev(prow,j) + lev(prow,k) + 1, kept when ≤ `levels`
    (PetscICCLLAddSorted, matimpl.h:1069). This differs from the
    upper triangle of the ILU(k) pattern: levels here propagate only
    through stored upper rows.

    Returns per-row sorted strict-upper column arrays.
    """
    A = sp.csr_matrix(A)
    A.sort_indices()
    n = A.shape[0]
    ai, aj = A.indptr, A.indices
    from petsctpu import native
    if native.available():
        res = native.icck_pattern(ai, aj, levels)
        if res is not None:
            indptr, cols = res
            return np.split(cols, indptr[1:-1])
    out_cols = []                    # per row: np array strict-upper cols
    out_lvls = []                    # matching levels
    il = np.zeros(n, np.int64)       # next-unconsumed index into out_cols
    bucket = [[] for _ in range(n)]  # jl: rows keyed by active column
    for k in range(n):
        row = aj[ai[k]:ai[k + 1]]
        lnk = {int(j): 0 for j in row[row >= k]}
        lnk.setdefault(k, 0)         # diagonal always present
        for prow in bucket[k]:
            p0 = il[prow]
            cols_p = out_cols[prow]
            lvls_p = out_lvls[prow]
            lev_pk = int(lvls_p[p0])
            for t in range(p0 + 1, len(cols_p)):
                inc = int(lvls_p[t]) + lev_pk + 1
                if inc > levels:
                    continue
                j = int(cols_p[t])
                if j not in lnk or lnk[j] > inc:
                    lnk[j] = inc
            nxt = p0 + 1
            if nxt < len(cols_p):
                il[prow] = nxt
                bucket[int(cols_p[nxt])].append(prow)
        bucket[k] = []
        items = sorted((j, l) for j, l in lnk.items() if j > k)
        cols_k = np.asarray([j for j, _ in items], np.int64)
        lvls_k = np.asarray([l for _, l in items], np.int64)
        out_cols.append(cols_k)
        out_lvls.append(lvls_k)
        if len(cols_k):
            il[k] = 0
            bucket[int(cols_k[0])].append(k)
    return out_cols


def icc_factor(A, pattern_rows=None, shift_type: str = "positive_definite",
               zeropivot: float = None, shift_amount: float = None):
    """Incomplete Cholesky A ≈ UᵀDU restricted to an upper-triangular
    pattern, with the reference's Manteuffel/zero-pivot shift loop.

    This is the algorithm of MatCholeskyFactorNumeric_SeqAIJ
    (src/mat/impls/aij/seq/aijfact.c:2076-2230): row-by-row elimination
    over the pattern (fills outside the pattern dropped), a
    column-bucketed walk of prior rows (the c2r/il linked lists), and
    MatPivotCheck (include/petsc-private/matimpl.h:511-585) restarting
    the whole factorization with a larger diagonal shift when a pivot
    fails:

      * positive_definite (Manteuffel; the PCICC default, icc.c:198):
        shift_top = 1.1·max_i(Σ_j|a_ij| − |a_ii| − a_ii); on failure
        bisect shift_fraction upward in [0,1] (max 5 tries, then 1.0)
        and restart with shift = fraction·shift_top.
      * nonzero: start at `shift_amount` (default 100·eps), double on
        each failure (matimpl.h:512-529).
      * inblocks: add `shift_amount` to the failing pivot in place, no
        restart (matimpl.h:557-569).
      * none: raise on |pivot| ≤ zeropivot (matimpl.h:572-585).

    pattern_rows: per-row sorted arrays of upper-triangle columns
    (including the diagonal), e.g. from the ILU(k) symbolic level rule;
    None means IC(0) = pattern of triu(A).

    Returns (Ustrict, d, nshift, shift_used): Ustrict the strictly
    upper CSR of the UNIT-upper factor U, d the pivot vector, so
    A + shift·I ≈ (I+Ustrict)ᵀ · diag(d) · (I+Ustrict).
    """
    A = sp.csr_matrix(A)
    A.sort_indices()
    n = A.shape[0]
    eps = float(np.finfo(np.float64).eps)
    if zeropivot is None:
        zeropivot = 100.0 * eps
    if shift_amount is None:
        shift_amount = 100.0 * eps
    ai, aj, aa = A.indptr, A.indices, np.asarray(A.data, np.float64)

    # --- pattern (strict upper per row, sorted) ---
    if pattern_rows is None:
        strict = [aj[ai[i]:ai[i + 1]][aj[ai[i]:ai[i + 1]] > i]
                  for i in range(n)]
    else:
        strict = [np.asarray(r)[np.asarray(r) > i]
                  for i, r in enumerate(pattern_rows)]
    ui = np.zeros(n + 1, np.int64)
    for i, r in enumerate(strict):
        ui[i + 1] = ui[i] + len(r)
    uj = (np.concatenate(strict).astype(np.int64) if n and ui[-1]
          else np.zeros(0, np.int64))
    uv = np.zeros(ui[-1], np.float64)
    d = np.zeros(n, np.float64)

    from petsctpu import native
    if native.available():
        res = native.icc_numeric(ai, aj, aa, ui, uj, shift_type,
                                 zeropivot, shift_amount)
        if res is not None:
            uvn, dn, nshift, cur_shift = res
            # native uv is already the unit-upper factor (negated once)
            return (sp.csr_matrix((uvn, uj, ui), shape=(n, n)), dn,
                    nshift, cur_shift)

    # --- shift_top for the Manteuffel (positive_definite) strategy ---
    shift_top = 0.0
    if shift_type == "positive_definite":
        shift_top = zeropivot
        for i in range(n):
            row = aa[ai[i]:ai[i + 1]]
            cols = aj[ai[i]:ai[i + 1]]
            dpos = np.searchsorted(cols, i)
            dval = row[dpos] if dpos < len(cols) and cols[dpos] == i else 0.0
            rs = float(np.abs(row).sum()) - abs(dval) - dval
            shift_top = max(shift_top, rs)
        shift_top *= 1.1

    nshift = 0
    nshift_max = 5
    shift_lo, shift_hi, shift_fraction = 0.0, 1.0, 0.0
    cur_shift = 0.0
    rtmp = np.zeros(n, np.float64)

    while True:                                  # the reference's do-while
        newshift = False
        il = np.zeros(n, np.int64)
        bucket = [[] for _ in range(n)]          # c2r: rows keyed by column
        for k in range(n):
            cols_k = uj[ui[k]:ui[k + 1]]
            rtmp[cols_k] = 0.0
            # load unfactored upper row of A
            arow = slice(ai[k], ai[k + 1])
            upper = aj[arow] >= k
            acols = aj[arow][upper]
            avals = aa[arow][upper]
            dk = cur_shift
            sd = np.searchsorted(acols, k)
            if sd < len(acols) and acols[sd] == k:
                dk += avals[sd]
            off = acols != k
            rtmp[acols[off]] = avals[off]

            # eliminate with prior rows whose active column is k
            for i in bucket[k]:
                ili = il[i]
                stored = uv[ili]                 # = d_i · u_ik
                uikdi = -stored / d[i]           # = −u_ik
                dk += uikdi * stored
                uv[ili] = uikdi
                nxt = ili + 1
                if nxt < ui[i + 1]:
                    sl = slice(nxt, ui[i + 1])
                    rtmp[uj[sl]] += uikdi * uv[sl]
                    il[i] = nxt
                    bucket[uj[nxt]].append(i)
            bucket[k] = []

            # copy into U(k,:) and compute the active row sum
            sl = slice(ui[k], ui[k + 1])
            uv[sl] = rtmp[cols_k]
            rs = float(np.abs(uv[sl]).sum())
            if len(cols_k):
                il[k] = ui[k]
                bucket[cols_k[0]].append(k)

            # MatPivotCheck
            if shift_type == "positive_definite":
                if dk <= zeropivot * rs:
                    if nshift == nshift_max:
                        shift_fraction = shift_hi
                    else:
                        shift_lo = shift_fraction
                        shift_fraction = (shift_hi + shift_lo) / 2.0
                    cur_shift = shift_fraction * shift_top
                    nshift += 1
                    newshift = True
                    break
            elif shift_type == "nonzero":
                if abs(dk) <= zeropivot * rs:
                    cur_shift = (shift_amount if nshift == 0
                                 else cur_shift * 2.0)
                    nshift += 1
                    newshift = True
                    break
            elif shift_type == "inblocks":
                if abs(dk) <= zeropivot:
                    dk += shift_amount
                    nshift += 1
            else:                                # none
                if abs(dk) <= zeropivot:
                    raise ZeroDivisionError(
                        f"icc: zero pivot row {k} value {abs(dk):g} "
                        f"tolerance {zeropivot:g}")
            d[k] = dk
        if not newshift:
            break

    # stored strict entries are −u_ij once consumed; entries of the last
    # rows are consumed too (every column < n gets its bucket turn), so
    # recover the unit-upper factor directly.
    Ustrict = sp.csr_matrix((-uv, uj, ui), shape=(n, n))
    return Ustrict, d, nshift, cur_shift


def lu_factor(A):
    """Complete sparse LU via SuperLU (scipy splu) with permutations,
    exposed as (L, U, perm_r, perm_c) for level-scheduled device solves.
    The reference's MatLUFactorNumeric + MatSolve pair."""
    A = sp.csc_matrix(A)
    lu = sp.linalg.splu(A, permc_spec="COLAMD",
                        options=dict(Equil=False, IterRefine="NOREFINE"))
    # x = Pc ( U⁻¹ ( L⁻¹ ( Pr b ) ) )
    L = sp.csr_matrix(lu.L)          # unit lower (diag stored = 1)
    U = sp.csr_matrix(lu.U)
    return L, U, lu.perm_r, lu.perm_c


def cholesky_factor(A):
    """Sparse Cholesky via LU of SPD matrix (no pivoting requirement)."""
    return lu_factor(A)


# ---------------------------------------------------------------------------
# level-scheduled SpTRSV plan (device)
# ---------------------------------------------------------------------------
def _levels(T: sp.csr_matrix, lower: bool) -> np.ndarray:
    """Dependency level of each row for a triangular solve."""
    from petsctpu import native
    if native.available():
        return native.tri_levels(T.indptr, T.indices, lower)
    n = T.shape[0]
    lev = np.zeros(n, dtype=np.int64)
    ai, aj = T.indptr, T.indices
    order = range(n) if lower else range(n - 1, -1, -1)
    for i in order:
        deps = aj[ai[i]:ai[i + 1]]
        deps = deps[deps < i] if lower else deps[deps > i]
        if len(deps):
            lev[i] = lev[deps].max() + 1
    return lev


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SpTRSVPlan:
    """Level-scheduled triangular solve: x = T⁻¹ b.

    level_rows: int32 [nlev, rmax] rows per level (padding = n sentinel)
    cols/vals : ELL off-diagonal entries per row [n, K] (padding col = n)
    dinv      : 1/diag per row [n] (1 for unit diagonal)
    """

    level_rows: jax.Array
    cols: jax.Array
    vals: jax.Array
    dinv: jax.Array
    n: int = field(metadata=dict(static=True))
    nlev: int = field(metadata=dict(static=True))

    def solve(self, b: jax.Array) -> jax.Array:
        n = self.n
        x = jnp.zeros(n + 1, b.dtype)
        bp = jnp.concatenate([b, jnp.zeros(1, b.dtype)])
        dinv = jnp.concatenate([self.dinv, jnp.ones(1, b.dtype)])

        def level(l, x):
            rows = self.level_rows[l]                       # [rmax]
            c = self.cols[rows]                             # [rmax, K]
            v = self.vals[rows]
            acc = jnp.sum(v * x[c], axis=1)
            xr = (bp[rows] - acc) * dinv[rows]
            return x.at[rows].set(xr)

        x = jax.lax.fori_loop(0, self.nlev, level, x)
        return x[:n]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DenseTRSVPlan:
    """Dense triangular solve as matmuls — the robustness fallback for
    small-n factors whose fill pattern is neither band-viable nor
    level-schedulable in reasonable depth (SuperLU ILUT factors reach
    ~n bandwidth and ~1000 dependency levels; the level-scheduled
    fori_loop then issues ~1e9 scalar gathers in one program). n <= 4096
    keeps the [n, n] operand <= 64 MB fp32."""

    T: jax.Array                   # [n, n] dense triangle
    lower: bool = field(metadata=dict(static=True), default=True)
    unit: bool = field(metadata=dict(static=True), default=False)

    def solve(self, b: jax.Array) -> jax.Array:
        import jax.scipy.linalg as jsla
        return jsla.solve_triangular(self.T, b, lower=self.lower,
                                     unit_diagonal=self.unit)


def make_dense_trsv_plan(T, lower: bool, unit_diag: bool, dtype=None):
    import scipy.sparse as sp
    D = np.asarray(sp.csr_matrix(T).toarray(),
                   np.dtype(dtype or T.dtype))
    if unit_diag:
        np.fill_diagonal(D, 1.0)
    return DenseTRSVPlan(jnp.asarray(D), lower, unit_diag)


def make_sptrsv_plan(T, lower: bool, unit_diag: bool, dtype=None,
                     pad_to: tuple = None) -> SpTRSVPlan:
    """Build a device plan from a scipy triangular matrix.

    pad_to=(nlev, rmax, K) forces uniform static shapes so plans from
    different local blocks can be stacked for shard_map (bjacobi)."""
    T = sp.csr_matrix(T)
    T.sort_indices()
    n = T.shape[0]
    lev = _levels(T, lower)
    nlev = int(lev.max()) + 1 if n > 0 else 1
    dtype = dtype or T.dtype

    # group rows by level, padded with sentinel n
    counts = np.bincount(lev, minlength=nlev)
    rmax = max(int(counts.max()), 1)
    if pad_to is not None:
        nlev = max(nlev, pad_to[0])
        rmax = max(rmax, pad_to[1])
        counts = np.bincount(lev, minlength=nlev)
    # group rows by level (vectorized: stable argsort by level gives
    # each level's rows in ascending row order, same as the original
    # fill loop)
    level_rows = np.full((nlev, rmax), n, dtype=np.int32)
    order = np.argsort(lev, kind="stable") if n else np.zeros(0, np.int64)
    starts = np.zeros(nlev + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    pos = np.arange(n) - starts[lev[order]] if n else order
    level_rows[lev[order], pos] = order.astype(np.int32)

    # off-diagonal ELL (padding col = n → reads the scratch slot, val 0)
    ai, aj, av = T.indptr, T.indices, T.data
    diag = np.ones(n, dtype=dtype)
    rows_all = np.repeat(np.arange(n), np.diff(ai))
    is_diag = aj == rows_all
    if not unit_diag and is_diag.any():
        diag[rows_all[is_diag]] = av[is_diag]
    keep = ~is_diag
    rk = rows_all[keep]
    off_counts = np.bincount(rk, minlength=n)
    K = max(int(off_counts.max()) if n else 0, 1)
    if pad_to is not None:
        K = max(K, pad_to[2])
    cols = np.full((n, K), n, dtype=np.int32)
    vals = np.zeros((n, K), dtype=dtype)
    # position of each kept entry within its row
    row_start = np.zeros(n + 1, np.int64)
    row_start[1:] = np.cumsum(off_counts)
    slot = np.arange(len(rk)) - row_start[rk] if len(rk) else rk
    cols[rk, slot] = aj[keep]
    vals[rk, slot] = av[keep]
    # extra sentinel row (level_rows padding reads row n): point at scratch
    cols = np.vstack([cols, np.full((1, K), n, dtype=np.int32)])
    vals = np.vstack([vals, np.zeros((1, K), dtype=dtype)])
    dinv = (1.0 / diag).astype(dtype)
    return SpTRSVPlan(jnp.asarray(level_rows), jnp.asarray(cols),
                      jnp.asarray(vals), jnp.asarray(dinv), n, nlev)


# ---------------------------------------------------------------------------
# Banded triangular solve — dense-tile back-substitution
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BandTRSVPlan:
    """Blocked banded back-substitution: x = T⁻¹ b.

    Level-scheduled SpTRSV (above) issues one gather round per
    dependency level — fine on CPUs, latency-dominated on an
    accelerator (the reference's MatSolve event is the one place the
    1996 numbers were competitive). For BANDED triangles (natural
    after RCM), this plan instead inverts each [T,T] diagonal tile
    densely at setup and runs ONE `lax.scan` over the band:

        x_t = Dinv_t (b_t − Off_t @ x_window)

    — two small matmuls per tile, no gathers, ~nt sequential steps
    instead of nlev. Off_t covers the W = ceil(B/T)·T columns left of
    (lower) / right of (upper) the tile; the scan carries that window.
    """

    dinv_tiles: jax.Array            # [nt, T, T] inverted diagonal tiles
    off_tiles: jax.Array             # [nt, T, W]
    lower: bool = field(metadata=dict(static=True), default=True)
    tile: int = field(metadata=dict(static=True), default=128)
    n: int = field(metadata=dict(static=True), default=0)

    def solve(self, b: jax.Array) -> jax.Array:
        T = self.tile
        nt, _, W = self.off_tiles.shape
        bt = jnp.zeros((nt * T,), b.dtype).at[:self.n].set(b).reshape(nt, T)
        tiles = (self.dinv_tiles, self.off_tiles, bt)
        if not self.lower:
            tiles = jax.tree.map(lambda a: a[::-1], tiles)

        def step(win, t):
            dinv, off, bb = t
            acc = jnp.matmul(off, win, precision="highest")
            xt = jnp.matmul(dinv, bb - acc, precision="highest")
            if self.lower:
                win = jnp.concatenate([win[T:], xt])
            else:
                win = jnp.concatenate([xt, win[:W - T]])
            return win, xt

        _, xs = jax.lax.scan(step, jnp.zeros((W,), b.dtype), tiles)
        if not self.lower:
            xs = xs[::-1]
        return xs.reshape(-1)[:self.n]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BandTRSVHierPlan:
    """Two-phase blocked banded solve: sequential depth O(L+G) instead
    of O(nt).

    The banded back-substitution is the linear window recurrence
        w_t = A_t w_{t-1} + c_t,   A_t = shift − E·(Dinv_t Off_t),
        c_t = E·(Dinv_t b_t),
    whose propagators A_t are CONSTANT per factorization — so group
    products P_g = Π A and within-group prefixes Q_t are precomputed at
    plan time. Runtime: (1) particular solutions per group with zero
    inflow, batched over all G groups (L sequential steps of [G,·]
    work); (2) boundary recurrence over G groups ([W,W] matvecs);
    (3) one batched correction x_t += Q_t[last T rows] · v_g. This is
    the latency-optimal shape: ~L+G launches instead of nt.
    """

    dinv_tiles: jax.Array            # [L, G, T, T]
    off_tiles: jax.Array             # [L, G, T, W]
    Pg: jax.Array                    # [G, W, W] group propagators
    R: jax.Array                     # [L, G, T, W] prefix last-T rows
    lower: bool = field(metadata=dict(static=True), default=True)
    tile: int = field(metadata=dict(static=True), default=128)
    n: int = field(metadata=dict(static=True), default=0)
    nt: int = field(metadata=dict(static=True), default=0)  # true tiles

    def solve(self, b: jax.Array) -> jax.Array:
        L, G, T, W = self.off_tiles.shape
        # b in natural tile order → processed order (upper runs the
        # baked-reversed chain), identity padding tiles get zeros
        bt = jnp.zeros((self.nt * T,), b.dtype).at[:self.n].set(b)
        bt = bt.reshape(self.nt, T)
        if not self.lower:
            bt = bt[::-1]
        bb = jnp.concatenate(
            [bt, jnp.zeros((L * G - self.nt, T), b.dtype)])
        bb = bb.reshape(G, L, T).transpose(1, 0, 2)      # [L, G, T]

        # phase 1: particular solutions, all groups in parallel
        def step(win, t):
            dinv, off, bv = t                            # [G,T,T],[G,T,W],[G,T]
            xt = jnp.einsum(
                "gij,gj->gi", dinv,
                bv - jnp.einsum("giw,gw->gi", off, win,
                                precision="highest"),
                precision="highest")
            win = jnp.concatenate([win[:, T:], xt], axis=1)
            return win, xt

        w0 = jnp.zeros((G, W), b.dtype)
        wend, x0 = jax.lax.scan(
            step, w0, (self.dinv_tiles, self.off_tiles, bb))

        # phase 2: boundary windows v_g (entry window of each group)
        def bstep(v, t):
            P, pe = t
            vn = jnp.matmul(P, v, precision="highest") + pe
            return vn, v

        _, vs = jax.lax.scan(bstep, jnp.zeros((W,), b.dtype),
                             (self.Pg, wend))            # vs: [G, W]

        # phase 3: batched correction
        x = x0 + jnp.einsum("lgtw,gw->lgt", self.R, vs,
                            precision="highest")
        x = x.transpose(1, 0, 2).reshape(-1)[:self.nt * T]  # processed order
        if not self.lower:
            x = x.reshape(self.nt, T)[::-1].reshape(-1)
        return x[:self.n]


@jax.jit
def _hier_propagators(dinv_gl, off_gl):
    """Group propagators Pg and within-group prefix rows R, on device.

    The window recurrence w_t = A_t w_{t-1} + c_t has propagator
    A_t = [[shift], [M_t]] with M_t = −Dinv_t Off_t, so the product
    update only needs M_t @ Q (the other rows are a copy):
        Q ← [Q[T:], M_t Q],  R_t = last T rows = M_t Q.
    Scanned over the L within-group steps, vmapped over groups."""
    G, L, T, W = off_gl.shape
    M = -jnp.einsum("glij,gljw->gliw", dinv_gl, off_gl,
                    precision="highest")

    def step(Q, Ml):                      # Q [G, W, W]; Ml [G, T, W]
        Rl = jnp.einsum("gtw,gwv->gtv", Ml, Q, precision="highest")
        Qn = jnp.concatenate([Q[:, T:, :], Rl], axis=1)
        return Qn, Rl

    Q0 = jnp.broadcast_to(jnp.eye(W, dtype=off_gl.dtype), (G, W, W))
    Pg, R = jax.lax.scan(step, Q0, M.transpose(1, 0, 2, 3))
    return Pg, R                          # R [L, G, T, W]


def make_band_trsv_hier_plan(Tmat, lower: bool, unit_diag: bool, dtype=None,
                             tile: int = None, group_len: int = None,
                             pad_to: tuple = None) -> BandTRSVHierPlan:
    """Build the two-phase plan from a scipy triangle. Reuses the flat
    plan's tiling, then precomputes propagator products on device
    (one jitted scan — the host triple loop took seconds per plan).

    tile default is 128: the batched phase-1/3 ops amortize launches,
    so smaller tiles suit the two-phase shape.

    pad_to=(nt, W) forces uniform static shapes so plans from
    different local blocks can be stacked for vmap (bjacobi/ASM)."""
    base = make_band_trsv_plan(Tmat, lower, unit_diag, dtype=dtype,
                               tile=tile or 128,
                               pad_to=pad_to)
    dinv = np.asarray(base.dinv_tiles)
    off = np.asarray(base.off_tiles)
    nt, T, W = off.shape
    if not lower:
        # the flat plan reverses tiles at runtime; bake the reversal in
        # so the hier recurrence is always "lower-style". The window of
        # the baked chain holds the previously produced tiles in
        # REVERSED tile order relative to the flat-upper window, so the
        # T-blocks of the off columns must be flipped too (W == T made
        # the flip a no-op, which is how the W > T upper bug survived
        # the original tests).
        dinv = dinv[::-1].copy()
        off = off[::-1].reshape(nt, T, W // T, T)[:, :, ::-1, :] \
            .reshape(nt, T, W).copy()
    L = group_len or max(int(np.ceil(np.sqrt(nt))), 1)
    G = -(-nt // L)
    pad = L * G - nt
    if pad:
        # identity steps producing x=0: dinv=I, off=0 (appended at end)
        dinv = np.concatenate([dinv, np.tile(np.eye(T, dtype=dinv.dtype),
                                             (pad, 1, 1))])
        off = np.concatenate([off, np.zeros((pad, T, W), off.dtype)])
    dinv_gl = jnp.asarray(dinv.reshape(G, L, T, T))
    off_gl = jnp.asarray(off.reshape(G, L, T, W))
    Pg, R = _hier_propagators(dinv_gl, off_gl)
    return BandTRSVHierPlan(dinv_gl.transpose(1, 0, 2, 3),
                            off_gl.transpose(1, 0, 2, 3),
                            Pg, R, lower, T, base.n, nt)


def band_dims(Tmat, lower: bool, tile: int = 128) -> tuple:
    """(nt, W) the banded plans would use — the cheap viability probe
    for the auto triangular-solve strategy (storage ~ nt·T·W·2 floats
    per triangle for the hier plan's off + prefix tables)."""
    Tmat = sp.csr_matrix(Tmat)
    n = Tmat.shape[0]
    T = tile
    nt = max(-(-n // T), 1)
    coo = Tmat.tocoo()
    toff = coo.col - (coo.row // T) * T
    outside = (toff < 0) if lower else (toff >= T)
    B = int(np.abs(toff[outside] - (0 if lower else T - 1)).max()) \
        if outside.any() else 1
    return nt, max(-(-B // T), 1) * T


def make_band_trsv_plan(Tmat, lower: bool, unit_diag: bool, dtype=None,
                        tile: int = None,
                        pad_to: tuple = None) -> BandTRSVPlan:
    """Build a banded back-substitution plan from a scipy triangle.

    tile=None auto-selects: each scan step is launch-latency-bound, so
    fewer/larger tiles win until per-step matvec work overtakes the
    latency — 256 for all but tiny systems.

    pad_to=(nt, W) forces at-least dimensions (identity diagonal tiles
    / zero off columns) so plans of different blocks stack for vmap.
    Padding columns go on the far side of the window (left for lower,
    right for upper) so real data keeps its window alignment."""
    Tmat = sp.csr_matrix(Tmat)
    n = Tmat.shape[0]
    coo = Tmat.tocoo()
    T = tile if tile is not None else (256 if n > 1536 else 128)
    nt, W = band_dims(Tmat, lower, T)      # single source of the sizes
    if pad_to is not None:
        nt = max(nt, pad_to[0])
        W = max(W, pad_to[1])
    dtiles = np.zeros((nt, T, T), dtype or Tmat.dtype)
    otiles = np.zeros((nt, T, W), dtype or Tmat.dtype)
    t_of = coo.row // T
    i_of = coo.row % T
    base = t_of * T
    in_diag = (coo.col >= base) & (coo.col < base + T)
    dtiles[t_of[in_diag], i_of[in_diag],
           (coo.col - base)[in_diag]] = coo.data[in_diag]
    off = ~in_diag
    ocol = (coo.col - (base - W)) if lower else (coo.col - (base + T))
    otiles[t_of[off], i_of[off], ocol[off]] = coo.data[off]
    diag_view = np.einsum("tkk->tk", dtiles)     # writable diagonal view
    if unit_diag:
        diag_view[:] = 1.0
    else:
        # pad rows beyond n with identity so the tile is invertible
        diag_view[diag_view == 0] = 1.0
    eye = np.broadcast_to(np.eye(T, dtype=dtiles.dtype), dtiles.shape)
    dtiles = np.linalg.solve(dtiles, eye)        # one batched inversion
    return BandTRSVPlan(jnp.asarray(dtiles), jnp.asarray(otiles),
                        lower, T, n)
