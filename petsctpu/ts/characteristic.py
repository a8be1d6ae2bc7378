"""Method of characteristics — semi-Lagrangian advection on DA grids.

Reference: src/ts/characteristic (CharacteristicSolve: for
u_t + v·∇u = g, trace characteristics back half/full steps and
interpolate the field at the departure points; the reference's
bilinear interpolation + VecScatter of off-process departure values).

Device mapping: departure-point interpolation over the WHOLE grid is one
batched `map_coordinates` gather (order-1 = the reference's bilinear),
so a semi-Lagrangian step is two elementwise kernels + one gather —
no scatter, no per-point loop.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.ndimage import map_coordinates

from petsctpu.ts.steppers import TSConfig, TSResult, _monitor


def characteristic_step(u: jax.Array, vx: jax.Array, vy: jax.Array,
                        dt, hx: float, hy: float,
                        bc: str = "clamp") -> jax.Array:
    """One semi-Lagrangian step for u_t + v·∇u = 0 on a uniform grid.

    u, vx, vy: [m, n] grid fields; departure points x − dt·v are
    evaluated by bilinear interpolation (map_coordinates order=1)."""
    m, n = u.shape
    ii = jnp.arange(m, dtype=u.dtype)[:, None]
    jj = jnp.arange(n, dtype=u.dtype)[None, :]
    di = ii - dt * vx / hx                       # departure index coords
    dj = jj - dt * vy / hy
    if bc == "periodic":
        mode = "wrap"
    else:
        mode = "nearest"
        di = jnp.clip(di, 0.0, m - 1.0)
        dj = jnp.clip(dj, 0.0, n - 1.0)
    return map_coordinates(u, [di, dj], order=1, mode=mode)


def ts_characteristic(velocity: Callable, u0: jax.Array, grid: tuple,
                      cfg: TSConfig = None, source: Callable = None,
                      bc: str = "clamp", axis: Optional[str] = None,
                      **kw) -> TSResult:
    """Integrate u_t + v·∇u = g by characteristics (TSSolve shape).

    velocity: (t, u_grid) -> (vx, vy) grid fields
    source:   optional (t, u_grid) -> g grid field (explicit update)
    u0 flat or grid-shaped; grid = (m, n); spacing assumes the unit
    square with vertex grids (the DA convention)."""
    cfg = replace(cfg or TSConfig(), **kw) if kw else (cfg or TSConfig())
    m, n = grid
    hx = 1.0 / max(m - 1, 1)
    hy = 1.0 / max(n - 1, 1)
    dtype = u0.dtype
    shape_in = u0.shape

    def cond(c):
        t, u, dt, step = c
        return (step < cfg.max_steps) & (t < cfg.max_time - 1e-14)

    def body(c):
        t, u, dt, step = c
        dt_eff = jnp.minimum(dt, cfg.max_time - t)
        ug = u.reshape(grid)
        vx, vy = velocity(t, ug)
        un = characteristic_step(ug, vx, vy, dt_eff, hx, hy, bc)
        if source is not None:
            un = un + dt_eff * source(t + dt_eff, un)
        t = t + dt_eff
        step = step + 1
        _monitor(cfg, step, t, un)
        return (t, un.reshape(shape_in), dt, step)

    t, u, dt, step = lax.while_loop(
        cond, body, (jnp.asarray(cfg.t0, dtype), u0,
                     jnp.asarray(cfg.dt, dtype), jnp.int32(0)))
    return TSResult(u, t, step, dt)
