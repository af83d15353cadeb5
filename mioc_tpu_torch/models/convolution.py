"""Signal-reconstruction (convolution) problem.

Counterpart of ``mioc_tpu.models.convolution`` (the reference's
``example_convolution.jl``, Section 6.2 of Marko & Wachsmuth, ESAIM:COCV
2023): a single 5-level integer control and no differential equation; the
objective is the quadratic

    f(u) = ½ (K u − f̂)ᵀ M (K u − f̂)

with the Toeplitz kernel-integral matrix ``K`` (analytic antiderivative,
``example_convolution.jl:60-63,104-125``) and the hat-function mass matrix
``M`` (``:85-100``), applied as a tridiagonal stencil.  Its default,
nt=2048 (L=5, B=128 at the preset), is the DP stress configuration of the
bundled problems: the longest time axis, and evaluations that cost less
than the DP build and chases between them.

``K u`` is a dense matrix product (``torch.matmul``; the JAX package leaves
it to XLA outside any kernel).  Rows of a batch must have the bits of the
single evaluation — the speculative trial wave decides on them — and a
library product picks its algorithm (and its split of the sum) by shape.  So
every product here has ONE shape: the rows go through in chunks of
:data:`ROWS`, the last chunk padded with zeros, and a single evaluation is a
padded chunk (:func:`~mioc_tpu_torch.ops.rows.chunked`).  The sum of f is
:func:`~mioc_tpu_torch.ops.tv.fold_sum`.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device, resolve_dtype
from ..objectives.base import LazyObjective, sweep_span
from ..ops.levels import product_levels
from ..ops.rows import ROWS, chunked
from ..ops.tv import fold_sum

__all__ = ["ConvObj", "gauss_legendre5", "ROWS"]


def gauss_legendre5(f, a, b):
    """5-point Gauss-Legendre quadrature of ``f`` over ``(a, b)``
    (``GaußLegendre5``, ``example_convolution.jl:144-154``): the fallback
    for building ``K`` when the kernel's antiderivative is unknown."""
    w = np.array([0.236926885056189, 0.478628670499366, 0.568888888888889,
                  0.478628670499366, 0.236926885056189])
    x = np.array([-0.906179845938664, -0.538469310105683, 0.0,
                  0.538469310105683, 0.906179845938664])
    y = (b - a) / 2 * x + (a + b) / 2
    return (b - a) / 2 * np.dot(w, np.vectorize(f)(y))


def _toeplitz(nt, tau, int_k):
    """Kernel-integral Toeplitz matrix, ``example_convolution.jl:104-125``:
    ``K[r, c] = ∫ k`` over one grid cell at lag ``d = r − c ≥ 1`` (0-based),
    ``(nt+1, nt)``."""
    d = np.arange(nt + 1)[:, None] - np.arange(nt)[None, :]
    vals = np.zeros(nt + 2)
    lags = np.arange(1, nt + 2)
    vals[1:] = int_k(lags * tau) - int_k((lags - 1) * tau)
    return np.where(d >= 1, vals[np.clip(d, 0, nt + 1)], 0.0)


def _mass_rows(mdiag, moff, v):
    """The tridiagonal mass stencil on the last axis of ``v``, in the JAX
    package's order: ``mdiag·v``, then the upper, then the lower
    off-diagonal added."""
    out = mdiag * v
    out[..., :-1] += moff * v[..., 1:]
    out[..., 1:] += moff * v[..., :-1]
    return out


class ConvObj(LazyObjective):
    """The convolution problem on ``nt`` cells of ``[-1, 1]``.

    ``matmul_precision`` is accepted for the JAX package's signature (there
    it sets the TPU matrix unit's pass count); here every product is a full
    product in the objective's dtype whatever its value, as long as the
    process keeps PyTorch's default of TF32 off (the port never turns it
    on).  ``device=None`` means ``"cuda"``; ``dtype=None`` means float64.
    """

    # Every row of a batch has the bits of the single evaluation (fixed-shape
    # chunks, fold sums), so the speculative wave is exact and on by default.
    _batched_sweeps_bitexact = True
    _sweep_layer = "conv_sweep"

    def __init__(self, nt: int = 2048, *, omega0=np.pi, device=None, dtype=None,
                 matmul_precision: str = "float32"):
        super().__init__()
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        self.matmul_precision = str(matmul_precision)
        self.T0, self.T1 = -1.0, 1.0
        self.nt = int(nt)
        self.tau = (self.T1 - self.T0) / self.nt
        self.omega0 = float(omega0)
        self.V = [[-2, -1, 0, 1, 2]]
        self.admissible = product_levels(self.V)
        self.nu, self.nv = 0, 1

        tau, T0 = self.tau, self.T0
        # Target samples target(T0 + τ·i), i = 1 … nt+1
        # (example_convolution.jl:73-81): shifted one grid cell right.
        i = np.arange(1, self.nt + 2)
        fvec = 0.4 * np.cos(2 * np.pi * (T0 + tau * i))

        # Antiderivative of the kernel (example_convolution.jl:60-63).
        w0 = self.omega0

        def int_k(t):
            a = w0 * (t - 1.0) / np.sqrt(2.0)
            return 0.1 * np.exp(-a) * (np.sin(a) + np.cos(a))

        # Tridiagonal mass-matrix stencil (example_convolution.jl:85-100):
        # diagonal τ/3 at both ends, 2τ/3 inside; off-diagonals τ/6.
        diag = np.full(self.nt + 1, 2.0 * tau / 3.0)
        diag[0] = diag[-1] = tau / 3.0
        self.set_operators(_toeplitz(self.nt, tau, int_k), fvec, diag, tau / 6.0)
        self.x = torch.zeros((self.nt, 1), dtype=self.dtype, device=self.device)

    def set_operators(self, K, fvec, Mdiag, Moff):
        """Install the operators ``K (nt+1, nt)``, ``fvec (nt+1,)``,
        ``Mdiag (nt+1,)`` and the off-diagonal ``Moff`` (numpy arrays or
        numbers), converted to the objective's dtype on its device."""
        def dev(a):
            return torch.as_tensor(np.array(a), device=self.device).to(self.dtype)

        self.K, self.fvec, self._Mdiag, self._Moff = (dev(a) for a in (K, fvec, Mdiag, Moff))
        if self.K.shape != (self.nt + 1, self.nt):
            raise ValueError(f"K must be ({self.nt + 1}, {self.nt}), got {tuple(self.K.shape)}")
        self._KT = self.K.T.contiguous()  # (nt, nt+1): the rows' product X @ Kᵀ

    def _residual(self, X):
        return X @ self._KT - self.fvec  # (ROWS, nt+1)

    def _f_chunk(self, X):
        v = self._residual(X)
        return 0.5 * fold_sum(v * _mass_rows(self._Mdiag, self._Moff, v))

    def _df_chunk(self, X):
        return _mass_rows(self._Mdiag, self._Moff, self._residual(X)) @ self.K

    # Batched evaluation: the hooks of the device TRM (solvers/trm_device.py).
    # There is no state, so the auxiliary output is None.
    @sweep_span("f")
    def _forward_batch(self, xs):
        """``xs (S, nt, 1) → (f (S,), None)``."""
        return chunked(self._f_chunk, xs[..., 0]), None

    @sweep_span("df")
    def _adjoint_batch(self, xs, aux):
        """``(xs (S, nt, 1), None) → (df (S, nt, 1), None)``."""
        return chunked(self._df_chunk, xs[..., 0])[..., None], None

    def _rows_swept(self, rows: int) -> int:
        return rows + (-rows % ROWS)

    def _sweep_steps(self, rows: int) -> int:
        return -(-rows // ROWS)  # one product per chunk of ROWS rows, no recursion

    def _forward(self, x):
        f, _ = self._forward_batch(x[None])
        return f[0], None

    def _adjoint(self, x, aux):
        df, _ = self._adjoint_batch(x[None], None)
        return df[0], None

    def eval_f_impl(self, x, cache: bool):
        return self._forward(x)

    def eval_df_impl(self):
        return self._adjoint(self.x, None)[0]
