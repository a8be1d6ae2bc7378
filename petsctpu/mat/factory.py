"""Runtime matrix-format selection (-mat_type, MatSetFromOptions).

Reference: MatSetType/MatSetFromOptions + the registry in
src/mat/interface/matregis.c — `-mat_type aij|baij|sbaij|...` selects
the storage format at runtime. Device formats here:

  aij      ELL-packed general sparse (gather SpMV — robust default)
  baij     block ELL (needs -mat_block_size)
  sbaij    symmetric block upper-triangle storage
  dense    dense matrix
  dia      diagonal-offset streams (few-diagonal matrices)
  band     dense-tiled band (RCM-ordered irregular, for file-driven
           ex10-style workloads)
  sell     sliced-ELL with window-grouped rows (mat/sell.py, fp32
           only)
  auto     band if the band (natural or RCM) holds at most twice the
           nonzeros, a stencil if grid recovery succeeds, else aij

band/dia/sell solve in the permuted space: the returned `perm` (or
None) must be applied to b and inverted on x.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def mat_from_options(A, opts=None, mat_type: str = None, dtype=None):
    """Build a device matrix per options. Returns (mat, perm|None)."""
    from petsctpu.mat import (aij_from_scipy, baij_from_scipy_bsr,
                              band_from_scipy, dia_from_scipy,
                              sbaij_from_scipy)
    from petsctpu.mat.dense import Dense
    from petsctpu.mat.order import get_ordering

    if opts is not None:
        mat_type = mat_type or opts.get_str("mat_type", "aij")
        bs = opts.get_int("mat_block_size", 1)
        ordering = opts.get_str("mat_ordering_type", "rcm")
        if opts.get_bool("info", False):
            from petsctpu.core.logging import info_on
            info_on()
    else:
        mat_type = mat_type or "aij"
        bs = 1
        ordering = "rcm"
    A = sp.csr_matrix(A)

    if mat_type == "aij":
        return aij_from_scipy(A, dtype=dtype), None
    if mat_type == "baij":
        return baij_from_scipy_bsr(A, bs=bs, dtype=dtype), None
    if mat_type == "sbaij":
        return sbaij_from_scipy(A, bs=bs, dtype=dtype), None
    if mat_type == "dense":
        import jax.numpy as jnp
        return Dense(jnp.asarray(A.toarray(), dtype)), None
    if mat_type in ("band", "dia"):
        perm = get_ordering(A, ordering)
        if mat_type == "band":
            return band_from_scipy(A, dtype=dtype, perm=perm), perm
        return dia_from_scipy(A, dtype=dtype, perm=perm), perm
    if mat_type == "sell":
        from petsctpu.mat.sell import sell_from_scipy
        perm = get_ordering(A, ordering)
        Ap = A[perm][:, perm].tocsr()
        Ap.sum_duplicates()
        return sell_from_scipy(Ap), perm
    if mat_type == "auto":
        M, perm = _auto_format(A, ordering, dtype)
        from petsctpu.core.logging import petsc_info
        petsc_info("MatFromOptions",
                   f"-mat_type auto: n={A.shape[0]} nnz={A.nnz} -> "
                   f"{type(M).__name__}"
                   + ("" if perm is None else " (permuted)"))
        return M, perm
    raise ValueError(f"unknown -mat_type {mat_type!r} "
                     "(aij|baij|sbaij|dense|band|dia|sell|auto)")


def _auto_format(A: sp.csr_matrix, ordering: str, dtype):
    """Default format: a band (natural or RCM) dense enough that its
    storage stays within twice the nonzeros -> BandMat; a recovered
    structured grid -> StencilMat; else the aij/ELL gather path.

    Ordering policy (the reference's default kernel is its fast
    kernel, aij.c:1173, and its Inode/CRL detection upgrades the
    layout silently): the NATURAL ordering is tried first — when the
    matrix is already banded as given, no permutation is applied at
    all (parity-safe: values, ordering, and iteration counts are
    untouched). Only when natural fails does the plan evaluate
    permutations."""
    from petsctpu.mat import aij_from_scipy, band_from_scipy
    from petsctpu.mat.band import band_slots
    from petsctpu.mat.order import bandwidth, get_ordering

    n = A.shape[0]

    def band_ok(M):
        # the band stores n·(T+2B) values and reads each once; ELL
        # reads a value and a column index per nonzero. Past twice the
        # nonzeros the band moves more bytes than ELL, and its storage
        # grows with B (n·2B: 10.7 GB fp32 for a 5-point 1024² grid)
        return band_slots(n, bandwidth(M)) <= 2 * A.nnz

    # 1) natural band (identity perm — fastest AND parity-exact)
    if band_ok(A):
        return band_from_scipy(A, dtype=dtype), None

    # 2) structured-grid recovery (mat/griddetect): a recovered grid
    #    becomes coefficient streams with no index arrays at all
    from petsctpu.mat.griddetect import grid_recover_ordering
    gperm, gdims = grid_recover_ordering(A, return_dims=True)
    if gperm is not None:
        # a recovered grid is a <= 3^d-offset stencil with ~zero band
        # fill: build stencil coefficient STREAMS directly
        # (mat/stencil.py)
        Ag = A[gperm][:, gperm].tocsr()
        Ag.sum_duplicates()
        cog = Ag.tocoo()
        rcs = np.unravel_index(cog.row, gdims)
        ccs = np.unravel_index(cog.col, gdims)
        # stencil offsets are in {-1,0,1}^d (verified by the recovery)
        # — encode each as one base-3 int so the dedup is a plain
        # integer unique, not a lexsort over rows
        key = np.zeros(cog.row.shape, np.int64)
        for rk, ck in zip(rcs, ccs):
            key = key * 3 + (ck.astype(np.int64) - rk + 1)
        okeys, oinv = np.unique(key, return_inverse=True)
        K = len(okeys)
        if K * n <= 2.0 * max(Ag.nnz, 1):   # boundary-pad guard
            import jax.numpy as jnp

            from petsctpu.mat.stencil import StencilMat
            offs = []
            for ok in okeys:
                o, ds = [], int(ok)
                for _ in gdims:
                    o.append(ds % 3 - 1)
                    ds //= 3
                offs.append(tuple(reversed(o)))
            C = np.zeros((K,) + tuple(gdims), np.dtype(dtype or A.dtype))
            C[(oinv,) + rcs] = cog.data
            return (StencilMat(jnp.asarray(C), tuple(offs),
                               tuple(gdims)), gperm)
        if band_ok(Ag):
            return band_from_scipy(A, dtype=dtype, perm=gperm), gperm

    # 3) profile (RCM) candidate. The band test only needs an
    #    RCM-shaped profile, not SPARSPAK-exact tie-breaks
    #    (-pc_factor_mat_ordering_type parity keeps genrcm): scipy's
    #    RCM is much faster on large operators.
    perm = get_ordering(A, "rcm_fast" if ordering == "rcm" else ordering)
    Ap = A[perm][:, perm].tocsr()
    if band_ok(Ap):
        return band_from_scipy(A, dtype=dtype, perm=perm), perm
    return aij_from_scipy(A, dtype=dtype), None

