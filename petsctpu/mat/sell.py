"""SellMat — sliced-ELL sparse format with plan-chosen source slices.

The reference's universal SpMV is CSR MatMult_SeqAIJ
(src/mat/impls/aij/seq/aij.c:1173): one indirect load per nonzero.
SellMat is a SELL-C-sigma descendant whose rows are grouped by the
x-window they read instead of by row length:

  * rows are tiled in blocks of C = G*128 (g = sub-row, l = lane);
    each tile owns a contiguous x-window whose span RCM bounds
    (plan-time `mat/order` — the same locality lever the reference
    pulls for bandwidth reduction);
  * a nonzero (row = (g, l), col = X) needs x[X], which lives in
    window row q + g for the UNIQUE q = row_of(X) - winstart - g;
    nonzeros are bucketed by q;
  * a PASS = (one bucket q, at most one slot per row) holds G*128
    slots whose operands all come from window rows q .. q+G-1;
  * y[g, l] = sum over passes of vals * x[slot column].

`mult` is plain jax.numpy over this layout: each slot's column is
rebuilt from winstart, qs, g and the int8 in-chunk position, x is
gathered once per slot and the pass sum is one reduction, which XLA
fuses into a single gather-multiply-reduce. `multT` scatter-adds
vals * r onto the same columns.

Storage per pass slot: 4B val + 1B idx (position within a 128-wide
chunk); pass count P = sum over buckets of the max per-row count
("slop"; >= the ELL width K, near K for banded/clustered sparsity —
the plan reports it). Matrices whose window span exceeds the cap or
whose slop explodes (adversarially random) stay on the ELL path —
`sell_viable` checks this.

fp32 only; fp64 callers use ELL/Band formats.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SellMat:
    """vals [nt, P, G, 128] f32; idx [nt, P, G, 128] int8 (position in
    a 128 chunk); qs [nt, P] int32 (window-slice row per pass);
    winstart [nt] int32 (window start row into the G-row-padded x);
    diag [n] f32."""

    vals: jax.Array
    idx: jax.Array
    qs: jax.Array
    winstart: jax.Array
    diag: jax.Array
    shape: tuple = field(metadata=dict(static=True))
    nnz: int = field(metadata=dict(static=True), default=0)
    G: int = field(metadata=dict(static=True), default=16)
    S: int = field(metadata=dict(static=True), default=512)  # window rows
    Lp: int = field(metadata=dict(static=True), default=0)   # padded x rows
    # addressing mode: "diag" buckets nonzeros by q = chunk(col) - g
    # (translation-aligned square operators — every pass serves G
    # sub-rows from G consecutive window rows); "chunk" buckets by the
    # absolute chunk(col) and broadcasts ONE window row to all G
    # sub-rows — the right shape for rectangular operators (MG
    # transfers) whose column rate differs from the row rate.
    mode: str = field(metadata=dict(static=True), default="diag")

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nt(self):
        return self.vals.shape[0]

    @property
    def npass(self):
        return self.vals.shape[1]

    def _slot_cols(self) -> jax.Array:
        """Flat index of every slot's operand in the padded x buffer
        (x sits at offset G*128): window start + pass slice row (+ the
        sub-row g in diag mode), times 128, plus the in-chunk position."""
        row = self.winstart[:, None, None, None] + self.qs[:, :, None, None]
        if self.mode == "diag":
            row = row + jnp.arange(self.G, dtype=jnp.int32)[:, None]
        return row * 128 + self.idx.astype(jnp.int32)

    def mult(self, x: jax.Array) -> jax.Array:
        n = self.shape[0]
        xp = jnp.zeros((self.Lp * 128,), self.dtype)
        xp = jax.lax.dynamic_update_slice(
            xp, x.reshape(-1).astype(self.dtype), (self.G * 128,))
        y = jnp.sum(self.vals * xp[self._slot_cols()], axis=1)
        return y.reshape(-1)[:n]

    def mult_add(self, x, y):
        return y + self.mult(x)

    def multT(self, r: jax.Array) -> jax.Array:
        """y = Aᵀ r for chunk-mode operators (the MG restriction
        R = Pᵀ run through P's OWN layout — MatMultTranspose on the
        stored prolongator, mg.c): a scatter-add of vals * r onto the
        same slot columns `mult` gathers from."""
        if self.mode != "chunk":
            raise NotImplementedError("SellMat.multT: chunk mode only")
        n, m = self.shape
        rp = jnp.zeros((self.nt * self.G * 128,), self.dtype)
        rp = jax.lax.dynamic_update_slice(
            rp, r.reshape(-1).astype(self.dtype), (0,))
        contrib = self.vals * rp.reshape(self.nt, 1, self.G, 128)
        y = jnp.zeros((self.Lp * 128,), self.dtype)
        y = y.at[self._slot_cols().reshape(-1)].add(contrib.reshape(-1))
        return y[self.G * 128: self.G * 128 + m]

    def diagonal(self) -> jax.Array:
        return self.diag

    def flops_per_mult(self) -> float:
        return 2.0 * self.nnz - self.shape[0]


def _plan(A: sp.csr_matrix, G: int, mode: str = "diag"):
    """Host plan: bucket nonzeros by window-slice row, lay out passes.
    mode="chunk" buckets by the absolute chunk (see SellMat.mode)."""
    C = G * 128
    n = A.shape[0]
    nt = -(-n // C)
    coo = A.tocoo()
    rows = coo.row.astype(np.int64)
    cols = coo.col.astype(np.int64)
    data = coo.data
    t = rows // C
    g = (rows % C) // 128
    lane = rows % 128

    # per-tile window start, aligned down to 8 chunks (1024 columns)
    wmin = np.full(nt, 2**62, np.int64)
    if len(cols):
        np.minimum.at(wmin, t, cols)
    wmin[wmin == 2**62] = 0
    wmin = (wmin // 1024) * 1024

    q = (cols - wmin[t]) // 128                # window-relative chunk
    if mode == "diag":
        q = q - g                              # in [-(G-1), ...]
    pos = (cols - wmin[t]) % 128

    # order by (tile, bucket q, row) and rank within each row's bucket
    order = np.lexsort((cols, rows, q, t))
    ts, qs_, rs = t[order], q[order], rows[order]
    new_run = np.ones(len(order), bool)
    new_run[1:] = (ts[1:] != ts[:-1]) | (qs_[1:] != qs_[:-1]) \
        | (rs[1:] != rs[:-1])
    run_id = np.cumsum(new_run) - 1
    first_idx = np.flatnonzero(new_run)
    rank = np.arange(len(order)) - first_idx[run_id]

    # per (tile, q) bucket: passes = max rank + 1
    new_bucket = np.ones(len(order), bool)
    new_bucket[1:] = (ts[1:] != ts[:-1]) | (qs_[1:] != qs_[:-1])
    b_id = np.cumsum(new_bucket) - 1
    nb = int(b_id[-1]) + 1 if len(b_id) else 0
    b_t = ts[new_bucket] if nb else np.zeros(0, np.int64)
    b_q = qs_[new_bucket] if nb else np.zeros(0, np.int64)
    b_m = np.zeros(nb, np.int64)
    if nb:
        np.maximum.at(b_m, b_id, rank)
        b_m += 1

    # within-tile pass offsets: buckets are already tile-ordered
    # (b_t is non-decreasing), so a running cumsum reset per tile works
    bucket_pass0 = np.zeros(nb, np.int64)
    P_t = np.zeros(nt, np.int64)
    if nb:
        cum = np.cumsum(b_m) - b_m
        first_of_tile = np.ones(nb, bool)
        first_of_tile[1:] = b_t[1:] != b_t[:-1]
        tile_base = np.zeros(nt, np.int64)
        tile_base[b_t[first_of_tile]] = cum[first_of_tile]
        bucket_pass0 = cum - tile_base[b_t]
        np.add.at(P_t, b_t, b_m)
    P = max(int(P_t.max()) if nt else 1, 1)
    pass_of = (bucket_pass0[b_id] + rank) if nb else np.zeros(0, np.int64)

    # window rows: diag reads reach q + g, chunk reads reach q;
    # slices need qs_pass + G <= S, rounded up to a multiple of 8.
    qg_max = int((qs_ + (g[order] if mode == "diag" else 0)).max()) \
        if len(order) else 0
    q_max = int(qs_.max()) if len(order) else 0
    S = max(qg_max + G + 1, q_max + 2 * G, 2 * G)
    S = -(-S // 8) * 8

    avg_row = A.nnz / max(n, 1)
    slop = P / max(avg_row, 1e-9) if A.nnz else 1.0
    return dict(C=C, nt=nt, t=ts, g=g[order], lane=lane[order],
                pos=pos[order], data=data[order], q=qs_, pass_of=pass_of,
                P=P, wmin=wmin, S=S,
                K=int(np.diff(A.indptr).max()) if n else 0,
                slop=float(slop))


def sell_plan_stats(A, G: int = 16, mode: str = "diag"):
    """(npass, ell_width, window_rows, slop = npass/avg_row_nnz)."""
    m = _plan(sp.csr_matrix(A), G, mode)
    return m["P"], m["K"], m["S"], m["slop"]


def sell_viable(A, G: int = 16, max_span_rows: int = 8192,
                max_slop: float = 8.0) -> bool:
    A = sp.csr_matrix(A)
    if A.shape[0] < G * 128:
        return False
    P, K, S, slop = sell_plan_stats(A, G)
    return S <= max_span_rows and slop <= max_slop


def sell_pack(A, G: int = 16, max_span_rows: int = 8192,
              force: tuple = None, mode: str = "diag"):
    """Host-side SELL pack (no device transfers): returns
    (arrays dict {vals f32, idx i8, qs i32, winstart i32, diag f32},
    statics dict {shape, nnz, G, S, Lp}) — the single source of the
    layout; sell_from_scipy wraps it with transfers, and
    pc/mg.PackedMGPC ships the arrays inside its two flat buffers.

    force=(npass, S, Lp) pads the static dimensions to at least these
    values so packs of different local blocks can be stacked and
    vmapped/shard_mapped (the MPIAIJ diag-block route)."""
    A = sp.csr_matrix(A).astype(np.float32)
    A.sum_duplicates()
    n = A.shape[0]
    m = _plan(A, G, mode)
    nt, P, S = m["nt"], m["P"], m["S"]
    if S > max_span_rows:
        raise ValueError(f"window span {S} rows exceeds cap "
                         f"{max_span_rows}; RCM-order or use ELL")
    if force is not None:
        P = max(P, force[0])
        S = -(-max(S, force[1]) // 8) * 8
    vals = np.zeros((nt, P, G, 128), np.float32)
    idx = np.zeros((nt, P, G, 128), np.int8)
    qs = np.zeros((nt, P), np.int64)
    vals[m["t"], m["pass_of"], m["g"], m["lane"]] = m["data"]
    idx[m["t"], m["pass_of"], m["g"], m["lane"]] = m["pos"]
    qs[m["t"], m["pass_of"]] = m["q"]
    # padded-x coordinates: x sits at row G of the padded buffer, so
    # buffer row 0 of a window = original row wmin/128 - G maps to
    # padded row wmin/128; slice rows get the same +G offset
    qs = (qs + G).astype(np.int32)
    winstart = (m["wmin"] // 128).astype(np.int32)
    # Lp must cover the padded OPERAND x (shape[1] entries at offset
    # G*128) — rectangular operators (MG transfers) have ncols != n
    Lp = int(max(winstart.max() + S if nt else S,
                 -(-A.shape[1] // 128) + G + 1))
    if force is not None:
        Lp = max(Lp, force[2])
    dg = A.diagonal().astype(np.float32)
    if dg.shape[0] < n:                       # rectangular operator
        dg = np.pad(dg, (0, n - dg.shape[0]))
    return (dict(vals=vals, idx=idx, qs=qs, winstart=winstart,
                 diag=dg),
            dict(shape=(n, A.shape[1]), nnz=int(A.nnz), G=G, S=S,
                 Lp=Lp, mode=mode))


def sell_from_scipy(A, G: int = 16, max_span_rows: int = 8192,
                    force: tuple = None, mode: str = "diag") -> SellMat:
    """Build a SellMat (fp32). Raises ValueError when the window span
    exceeds the cap — callers should RCM-order first and fall back to
    ELL when not viable. See sell_pack for `force`."""
    arrs, st = sell_pack(A, G=G, max_span_rows=max_span_rows,
                         force=force, mode=mode)
    return SellMat(jnp.asarray(arrs["vals"]), jnp.asarray(arrs["idx"]),
                   jnp.asarray(arrs["qs"]),
                   jnp.asarray(arrs["winstart"]),
                   jnp.asarray(arrs["diag"]), st["shape"], st["nnz"],
                   st["G"], st["S"], st["Lp"], mode)


# ---------------------------------------------------------------------------
# frozen-pattern templates: jit-safe numeric refill
# ---------------------------------------------------------------------------
def sell_template(A, G: int = 16, max_span_rows: int = 8192):
    """(template SellMat, pos, diag_idx): the symbolic side of the
    format, built once from a PATTERN — `sell_fill(tmpl, pos, diag_idx,
    data)` then rebuilds the numeric matrix INSIDE jit from a
    CSR-ordered data vector (the MatAssembly symbolic/numeric split the
    GAMG device refresh needs; reference: PCSetUp_GAMG re-runs host
    assembly per refresh, gamg.c:533 — here it is one device scatter).

    pos: int32 [nnz] flat slot of each sorted-CSR entry in the
    [nt, P, G, 128] value array. diag_idx: int32 [n] sorted-CSR data
    index of each diagonal entry (missing diagonals hit an appended
    zero slot)."""
    A = sp.csr_matrix(A).astype(np.float32)
    A.sum_duplicates()
    A.sort_indices()
    n = A.shape[0]
    tmpl = sell_from_scipy(A, G=G, max_span_rows=max_span_rows)
    m = _plan(A, G)
    nt, P = m["nt"], m["P"]
    # invert the plan's (t, q, row, col) lexsort: order[k] = CSR entry
    # index of plan slot k, so pos maps CSR data order -> flat slots
    coo = A.tocoo()
    rows = coo.row.astype(np.int64)
    cols = coo.col.astype(np.int64)
    C = G * 128
    t = rows // C
    g = (rows % C) // 128
    wmin = m["wmin"]
    q = (cols - wmin[t]) // 128 - g
    order = np.lexsort((cols, rows, q, t))
    flat = ((m["t"] * P + m["pass_of"]) * G + m["g"]) * 128 + m["lane"]
    pos = np.empty(A.nnz, np.int64)
    pos[order] = flat
    d = A.diagonal()
    diag_idx = np.full(n, A.nnz, np.int64)      # sentinel -> appended 0
    rr = np.repeat(np.arange(n), np.diff(A.indptr))
    isd = rr == A.indices
    diag_idx[rr[isd]] = np.flatnonzero(isd)
    return (tmpl, jnp.asarray(pos, jnp.int32),
            jnp.asarray(diag_idx, jnp.int32))


def sell_fill(tmpl: SellMat, pos, diag_idx, data) -> SellMat:
    """Numeric refill of a SELL template from sorted-CSR data (jit-safe)."""
    nt, P, G, _ = tmpl.vals.shape
    flat = jnp.zeros((nt * P * G * 128,), jnp.float32)
    flat = flat.at[pos].set(data.astype(jnp.float32))
    dpad = jnp.concatenate([data.astype(jnp.float32),
                            jnp.zeros((1,), jnp.float32)])
    return dataclasses.replace(tmpl, vals=flat.reshape(tmpl.vals.shape),
                               diag=dpad[diag_idx])
