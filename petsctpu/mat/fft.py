"""MATFFT analog + FFT-based fast Poisson solver.

Reference: src/mat/impls/fft wraps FFTW/CUFFT as a Mat whose MatMult
is the (multi-dimensional) DFT. Here the DFT is jnp.fft (XLA-native);
no external library. On top of it, a DST-I spectral
solver gives an *exact* O(N log N) solve of the constant-coefficient
Dirichlet Laplacian — usable standalone or as a PC for
variable-coefficient problems (shifted-Laplacian preconditioning).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class FFTMat:
    """y = DFT_nd(x): MatMult is the n-dimensional DFT over `dims`
    (MatCreateFFT, src/mat/impls/fft/fft.c). The DFT matrix F is
    symmetric, so multT == mult; F^H = N·F^{-1} gives mult_hermitian;
    solve() is the inverse transform."""

    dims: Tuple[int, ...] = field(metadata=dict(static=True))

    @property
    def shape(self):
        n = int(np.prod(self.dims))
        return (n, n)

    def _grid(self, x):
        return x.reshape(self.dims)

    def mult(self, x):
        return jnp.fft.fftn(self._grid(x.astype(jnp.complex64)
                                       if not jnp.iscomplexobj(x)
                                       else x)).reshape(-1)

    multT = mult  # DFT matrix is symmetric

    def mult_hermitian(self, x):
        n = int(np.prod(self.dims))
        return n * jnp.fft.ifftn(self._grid(x)).reshape(-1)

    def solve(self, b):
        return jnp.fft.ifftn(self._grid(b)).reshape(-1)


def dst1(x, axis=-1):
    """DST-I along `axis` via the odd-extension FFT:
    y_k = Σ_{j=1..n} x_j sin(π j k / (n+1)), k = 1..n.
    Self-inverse up to the factor (n+1)/2."""
    n = x.shape[axis]
    x = jnp.moveaxis(x, axis, -1)
    z = jnp.zeros(x.shape[:-1] + (1,), x.dtype)
    ext = jnp.concatenate([z, x, z, -x[..., ::-1]], axis=-1)  # len 2n+2
    F = jnp.fft.rfft(ext)
    y = (-0.5) * F[..., 1:n + 1].imag
    return jnp.moveaxis(y.astype(x.dtype), -1, axis)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PoissonFFTPC:
    """Exact fast solver for the 5/7-point Dirichlet Laplacian with
    uniform coefficients: diagonalize with DST-I along every axis,
    divide by the eigenvalue sum, transform back. apply() is jit-safe
    device code (all FFTs).

    Eigenvalues per axis: λ_k = 2 − 2cos(kπ/(n+1)) of the [-1,2,-1]
    stencil; `scale` multiplies the operator (h-scalings)."""

    inv_eig: jax.Array                      # (dims) precomputed 1/Σλ
    dims: Tuple[int, ...] = field(metadata=dict(static=True))

    def apply(self, b):
        v = b.reshape(self.dims)
        for ax in range(len(self.dims)):
            v = dst1(v, axis=ax)
        v = v * self.inv_eig
        for ax in range(len(self.dims)):
            v = dst1(v, axis=ax)
        norm = float(np.prod([(n + 1) / 2.0 for n in self.dims]))
        return (v / norm).reshape(b.shape)


def make_poisson_fft(dims, dtype=None, scale: float = 1.0,
                     shift: float = 0.0):
    """Fast solver for scale·(−Δ_h) + shift·I on a dims Dirichlet grid
    (the ex2/ex45 operator with scale=1)."""
    dt = np.dtype(dtype or np.float32)
    eig = np.zeros(dims, np.float64)
    for ax, n in enumerate(dims):
        k = np.arange(1, n + 1)
        lam = 2.0 - 2.0 * np.cos(k * np.pi / (n + 1))
        shape = [1] * len(dims)
        shape[ax] = n
        eig = eig + lam.reshape(shape)
    inv = 1.0 / (scale * eig + shift)
    return PoissonFFTPC(jnp.asarray(inv.astype(dt)), tuple(dims))
