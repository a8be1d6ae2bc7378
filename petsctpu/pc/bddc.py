"""PCBDDC — balancing domain decomposition by constraints over MATIS.

Reference: src/ksp/pc/impls/bddc/bddc.c (5,589 LoC): primal
vertex/edge/face constraint spaces, local saddle-point solves, the
coarse operator assembled from subdomain harmonic basis functions.
pc/nn.py realizes only BDDC's MINIMAL coarse space (subdomain
constants = the NN balancing step); this module builds the proper
constraint space:

  * interface classification by subdomain signature (PCBDDCAnalyzeInterface):
    dofs shared by >= 3 subdomains (or singleton classes) are VERTICES
    (point constraints); classes shared by exactly 2 are EDGES
    (average constraints); in 3-D, classes with |sig| >= 3 and size > 1
    additionally get an average (edge-of-3-subdomains).
  * per-subdomain constraint matrices C_i and dense saddle solves
      [A_i C_iᵀ; C_i 0]⁻¹  →  H_i (constrained correction) and
      Ψ_i (coarse basis: harmonic w.r.t. C_i Ψ = I)
    (PCBDDCSetUpLocalSolvers / CorrectionOperator).
  * coarse matrix K_c = Σ_i Ψ_iᵀ A_i Ψ_i over global primal dofs.
  * apply (additive):  M⁻¹r = Rᴰᵀ (H + Ψ K_c⁻¹ Ψᵀ) Rᴰ r
    with Rᴰ the multiplicity-scaled restrictions.

All per-subdomain solves are frozen dense operators — batched dense
matmuls at apply time; no host work after setup.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from petsctpu.mat.matis import MatIS


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BDDCPC:
    A: MatIS
    weights: tuple                  # per-subdomain D_i
    H: tuple                        # per-subdomain [ni, ni] correction ops
    Psi: tuple                      # per-subdomain [ni, nc_i] coarse basis
    cmaps: tuple                    # per-subdomain global primal dof ids
    Kc_inv: jax.Array               # [NC, NC] dense coarse inverse
    nprimal: int = field(metadata=dict(static=True), default=0)

    def apply(self, r):
        y = jnp.zeros_like(r)
        rc = jnp.zeros((self.nprimal,), r.dtype)
        locs = []
        for Wi, Hi, Pi, ci, gi in zip(self.weights, self.H, self.Psi,
                                      self.cmaps, self.A.l2g):
            ri = Wi * r[gi]
            locs.append(ri)
            rc = rc.at[ci].add(Pi.T @ ri)
        xc = self.Kc_inv @ rc
        for Wi, Hi, Pi, ci, gi, ri in zip(self.weights, self.H, self.Psi,
                                          self.cmaps, self.A.l2g, locs):
            y = y.at[gi].add(Wi * (Hi @ ri + Pi @ xc[ci]))
        return y


def _interface_classes(l2g_np, n):
    """Group dofs by their subdomain signature
    (PCBDDCAnalyzeInterface)."""
    sig = [[] for _ in range(n)]
    for i, g in enumerate(l2g_np):
        for k in g:
            sig[k].append(i)
    classes = {}
    for k in range(n):
        if len(sig[k]) >= 2:
            classes.setdefault(tuple(sig[k]), []).append(k)
    return classes


def make_bddc(A: MatIS, dtype=None, rtol: float = 1e-10,
              vertices: bool = True, edges: bool = True) -> BDDCPC:
    """Build the BDDC preconditioner from a MATIS operator."""
    from petsctpu.mat.ell import aij_to_scipy

    dt = dtype or np.float64
    n = A.shape[0]
    l2g_np = [np.asarray(g) for g in A.l2g]
    nsub = len(l2g_np)

    mult = np.zeros(n)
    for g in l2g_np:
        mult[g] += 1.0
    weights = tuple(jnp.asarray(1.0 / mult[g], dt) for g in l2g_np)

    classes = _interface_classes(l2g_np, n)

    # global primal dofs: (kind, payload) — vertex: single dof id;
    # edge: list of dof ids averaged
    primal = []
    for sg, dofs in sorted(classes.items()):
        if len(sg) >= 3 or len(dofs) == 1:
            if vertices:
                primal.extend(("v", d) for d in sorted(dofs))
            if len(sg) >= 3 and len(dofs) > 1 and edges:
                primal.append(("e", tuple(sorted(dofs))))
        elif edges:
            primal.append(("e", tuple(sorted(dofs))))
    if not primal:                       # degenerate: fall back to NN
        primal = [("e", tuple(sorted(d for ds in classes.values()
                                     for d in ds)))]
    NC = len(primal)

    # per-subdomain constraint rows + global coarse ids
    g2l = [dict((int(g), i) for i, g in enumerate(gi)) for gi in l2g_np]
    Hs, Psis, cmaps = [], [], []
    Kc = np.zeros((NC, NC))
    for i in range(nsub):
        gi = l2g_np[i]
        ni = len(gi)
        Ai = aij_to_scipy(A.locals_[i]).toarray().astype(np.float64)
        rows, cids = [], []
        for cj, (kind, payload) in enumerate(primal):
            if kind == "v":
                if payload in g2l[i]:
                    row = np.zeros(ni)
                    row[g2l[i][payload]] = 1.0
                    rows.append(row)
                    cids.append(cj)
            else:
                dofs = [g2l[i][d] for d in payload if d in g2l[i]]
                if len(dofs) == len(payload):   # whole class in subdomain
                    row = np.zeros(ni)
                    row[dofs] = 1.0 / len(dofs)
                    rows.append(row)
                    cids.append(cj)
        nc = len(rows)
        if nc == 0:
            # no constraints touch this subdomain: plain regularized
            # local solve, no coarse contribution
            Hs.append(jnp.asarray(np.linalg.pinv(Ai, rcond=rtol), dt))
            Psis.append(jnp.zeros((ni, 1), dt))
            cmaps.append(jnp.zeros((1,), jnp.int32))
            continue
        C = np.stack(rows)
        K = np.zeros((ni + nc, ni + nc))
        K[:ni, :ni] = Ai
        K[:ni, ni:] = C.T
        K[ni:, :ni] = C
        Kinv = np.linalg.pinv(K, rcond=rtol)
        Hi = Kinv[:ni, :ni]
        Psi = Kinv[:ni, ni:]                    # [ni, nc]
        Hs.append(jnp.asarray(Hi, dt))
        Psis.append(jnp.asarray(Psi, dt))
        cmaps.append(jnp.asarray(np.asarray(cids, np.int32)))
        Kci = Psi.T @ Ai @ Psi
        Kc[np.ix_(cids, cids)] += Kci

    Kc_inv = np.linalg.pinv(Kc, rcond=rtol)
    return BDDCPC(A, weights, tuple(Hs), tuple(Psis), tuple(cmaps),
                  jnp.asarray(Kc_inv, dt), NC)
