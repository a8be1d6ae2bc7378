"""Device-side COO assembly.

The reference assembles matrices incrementally with MatSetValues +
MatStash rendezvous communication for off-owner entries
(src/mat/impls/aij/mpi/mpiaij.c:476, src/mat/utils/matstash.c:435).
Mutable insertion is anti-XLA; the JAX-native pattern (SURVEY §2.10 P5)
is: generate ALL (row, col, val) triples batched (e.g. per-element FEM
contributions), then sort + segment-merge on device into a frozen ELL
layout. Duplicate (row, col) entries are summed — ADD_VALUES semantics,
which is what assembly loops use.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from petsctpu.mat.ell import AIJ


def ell_from_coo(rows: jax.Array, cols: jax.Array, vals: jax.Array,
                 shape: tuple, ell_width: int) -> AIJ:
    """Assemble COO triples into an ELL-packed AIJ entirely on device.

    rows/cols: int32 [nnz]; vals: [nnz]. Entries with row < 0 or
    row >= shape[0] are dropped (handy for masked stencil generation).
    `ell_width` must bound the max merged nonzeros per row; overflow
    entries are dropped silently (callers derive the bound statically
    from the stencil/element structure, as the reference derives
    preallocation).
    """
    m, n = shape
    nnz = rows.shape[0]
    rows = rows.astype(jnp.int32)
    cols = cols.astype(jnp.int32)

    valid = (rows >= 0) & (rows < m) & (cols >= 0) & (cols < n)
    # route invalid entries to a sentinel row m (sorted last, then dropped)
    rows = jnp.where(valid, rows, m)
    vals = jnp.where(valid, vals, 0)

    # lexicographic sort by (row, col)
    rows_s, cols_s, vals_s = lax.sort((rows, cols, vals), num_keys=2)

    # merge duplicates: new-group mask
    idx = jnp.arange(nnz)
    newgrp = (idx == 0) | (rows_s != jnp.roll(rows_s, 1)) | (cols_s != jnp.roll(cols_s, 1))
    gid = jnp.cumsum(newgrp) - 1  # group id per entry

    # compacted unique triples at positions gid (rows beyond the last
    # group stay at sentinel row m)
    u_rows = jnp.full((nnz,), m, dtype=jnp.int32).at[gid].set(rows_s, mode="drop")
    u_cols = jnp.zeros((nnz,), dtype=jnp.int32).at[gid].set(cols_s, mode="drop")
    u_vals = jnp.zeros((nnz,), vals.dtype).at[gid].add(vals_s, mode="drop")

    # slot within row: position minus first index of this row
    first_of_row = (jnp.arange(nnz) == 0) | (u_rows != jnp.roll(u_rows, 1))
    row_start = lax.associative_scan(jnp.maximum,
                                     jnp.where(first_of_row, jnp.arange(nnz), 0))
    slot = jnp.arange(nnz) - row_start

    ok = (u_rows < m) & (slot < ell_width)
    flat = jnp.where(ok, u_rows * ell_width + slot, m * ell_width)
    ell_cols = jnp.zeros((m * ell_width + 1,), jnp.int32).at[flat].set(u_cols)[:-1]
    ell_vals = jnp.zeros((m * ell_width + 1,), vals.dtype).at[flat].add(u_vals)[:-1]
    return AIJ(ell_cols.reshape(m, ell_width), ell_vals.reshape(m, ell_width),
               (m, n), nnz=0)
