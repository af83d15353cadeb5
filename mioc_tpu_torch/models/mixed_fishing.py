"""Mixed continuous + integer fishing problem.

Counterpart of ``mioc_tpu.models.mixed_fishing``: the Lotka-Volterra
multimode fishing problem (:class:`~.fishing.LVMObj`) with ONE bounded
continuous control, a supplementary prey-harvesting rate ``c(t) ∈ [0, cmax]``
with a quadratic effort cost,

    ẏ₁ = y₁(α − βy₂ − c₁·(v·w₁) − c(t)),
    ẏ₂ = y₂(−γ + δy₁ − c₂·(v·w₂)),
    G   = ½(y₁−1)² + ½(y₂−1)² + ρ c(t)²,

with the SOS1 integer mode selection ``v`` unchanged.  Control layout is
``x = [c, v₁, v₂, v₃]`` (continuous block first, ``nu = 1``).

The JAX package takes ``Fu`` and ``Gu`` by ``jacfwd``; here they are written
out (the ``c`` column is ∂F₁/∂c = −y₁ and ∂G/∂c = 2ρc), on the last axis like
every bundled model, so batched rows have the single sweep's bits.

The mixed solver's projected-gradient steps amplify rounding (a one-ulp
difference in f or ∇f becomes a different iterate within a few rounds), so
the sweeps here round as the JAX package's compiled CPU sweeps do
(:mod:`~mioc_tpu_torch.ops.xla_order`), at the default parameters, where
the products with α, β, γ, δ, c₁ and c₂ are exact:

* the Euler step is ``fma(τ, F, y)``;
* the running cost is ``fma(c², ρ, ½·fma(d₀, d₀, d₁²))`` with ``d = y − 1``
  (XLA factors the two halves), and the trapezoid sum is
  :func:`~mioc_tpu_torch.ops.xla_order.window_sum`;
* the adjoint step is ``fma(τ, Fyᵀλ − (y − 1), λ)``; ``Fyᵀλ`` rounds both
  products, except at the last step of each unrolled body of the JAX scan
  (every ``sweep_unroll``-th step, and the last step of the scan; the
  table ``_ADJ``, read through
  :func:`~mioc_tpu_torch.objectives.ode.scan_rules`), where its two sums
  are ``fma(λ₀, S₀, y₁λ₁)`` and ``fma(−y₀, λ₀, λ₁S₁)``;
* the gradient's ``c`` column is ``fma(2ρ, c, fma(−0, λ₁, y₀λ₀))`` (XLA's
  dot of −F_u with λ keeps the zero's product: NaN where λ₁ overflows) and
  a ``v`` column ``fma(y₁c₂w₂, λ₁, y₀c₁w₁·λ₀)``.

So f, ∇f and the states equal the JAX package's bit for bit on the CPU, and
the card gives the same bits.  The rules hold on grids with ``nt ≥ 32``
(below, the JAX sweeps' trapezoid sum is one fused reduction that rounds
otherwise); the tests hold nt = 32, 48, 57, 240 and 1024 at unroll 8
(``tests/test_torch_mixed.py``) and 1, 2, 4, and nt = 33 … 40 at 1, 2, 4
and 8 (``tests/test_torch_ode_bits.py``).  Where the scan's remainder has 3
steps (unroll 8 at nt = 36, 100; unroll 4 at nt = 40) its last step can
round otherwise, so there the adjoint at the first step agrees to rounding
only.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_dtype
from ..objectives.base import sweep_span
from ..objectives.ode import RowwiseODEObjective, _numpy_dtype, const_dot
from ..ops.levels import bounded_sum_levels
from ..ops.xla_order import fma, window_sum

# Per adjoint step in scan order: "L" the last-step form of Fyᵀλ (one
# product of each sum fused), "R" both products rounded (scan_rules; read off
# the JAX sweeps at nt = 32 … 1024).
_ADJ = {u: {"body": "R" * (u - 1) + "L", **{r: "R" * (r - 1) + "L" for r in range(1, u)},
            "rest": "R"} for u in (1, 2, 4, 8)}
_ADJ["straight"] = {"rest": "R", "last": "L"}

__all__ = ["LVMMixedObj"]


class LVMMixedObj(RowwiseODEObjective):
    _adjoint_rules = _ADJ

    def __init__(self, nt: int = 600, *, cmax=0.3, rho=0.05,
                 alpha=1.0, beta=1.0, gamma=1.0, delta=1.0,
                 c1=1.0, c2=1.0, v1=(0.2, 0.4, 0.01), v2=(0.1, 0.2, 0.1),
                 state0=(0.5, 0.7), device=None, dtype=None):
        self.alpha, self.beta = float(alpha), float(beta)
        self.gamma, self.delta = float(gamma), float(delta)
        self.c1, self.c2 = float(c1), float(c2)
        self.rho, self.cmax = float(rho), float(cmax)
        npdt = _numpy_dtype(resolve_dtype(dtype))
        self.v1 = np.asarray(v1, dtype=npdt)
        self.v2 = np.asarray(v2, dtype=npdt)
        V = [[0, 1], [0, 1], [0, 1]]
        adm = bounded_sum_levels(V, 1, 1)
        super().__init__(T0=0.0, T1=12.0, nt=nt, state0=state0, nu=1, V=V,
                         admissible=adm, device=device, dtype=dtype)
        # Pointwise bounds of the continuous block (rand_func_cont contract).
        self.umin = np.zeros((1,))
        self.umax = np.full((1,), self.cmax)
        self._v1 = torch.as_tensor(self.v1, device=self.device)
        self._v2 = torch.as_tensor(self.v2, device=self.device)
        self._cv1 = torch.as_tensor(self.c1 * self.v1, device=self.device)
        self._cv2 = torch.as_tensor(self.c2 * self.v2, device=self.device)
        self._tau_t = torch.tensor(self.tau, dtype=self.dtype, device=self.device)

    # The control-only terms: the two mode couplings and the harvest rate c.
    def _coupling(self, x):
        v = x[..., 1:]
        return (self.c1 * const_dot(v, self.v1), self.c2 * const_dot(v, self.v2),
                x[..., 0])

    def _rhs(self, y, terms):
        a, b, c = terms
        y0, y1 = y[..., 0], y[..., 1]
        return torch.stack([
            y0 * (self.alpha - self.beta * y1 - a - c),
            y1 * (-self.gamma + self.delta * y0 - b),
        ], dim=-1)

    def _rhsT_lam(self, y, lam, terms):
        a, b, c = terms
        y0, y1 = y[..., 0], y[..., 1]
        l0, l1 = lam[..., 0], lam[..., 1]
        return torch.stack([
            (self.alpha - self.beta * y1 - a - c) * l0 + self.delta * y1 * l1,
            -self.beta * y0 * l0 + (-self.gamma + self.delta * y0 - b) * l1,
        ], dim=-1)

    def Fy(self, y, x, i):
        a, b, c = self._coupling(x)
        y0, y1 = y[..., 0], y[..., 1]
        return torch.stack([
            torch.stack([self.alpha - self.beta * y1 - a - c, -self.beta * y0], dim=-1),
            torch.stack([self.delta * y1, -self.gamma + self.delta * y0 - b], dim=-1),
        ], dim=-2)

    def Fu(self, y, x, i):
        y0, y1 = y[..., 0:1], y[..., 1:2]
        return torch.stack([
            torch.cat([-y0, (-self.c1 * y0) * self._v1], dim=-1),
            torch.cat([torch.zeros_like(y1), (-self.c2 * y1) * self._v2], dim=-1),
        ], dim=-2)

    def G(self, y, x, i):
        return (0.5 * (y[..., 0] - 1.0) ** 2 + 0.5 * (y[..., 1] - 1.0) ** 2
                + self.rho * x[..., 0] ** 2)

    def Gy(self, y, x, i):
        return y - 1.0

    def Gu(self, y, x, i):
        return torch.cat([(2.0 * self.rho) * x[..., 0:1],
                          torch.zeros_like(x[..., 1:])], dim=-1)

    # -- sweeps in the JAX package's CPU rounding (module docstring) -----------
    # The state is an (S, 2) tensor and both components step together:
    # S_i = fma(K1, y_swapped, K0) − A1 − A2 with K0 = (α, −γ), K1 = (−β, δ),
    # A1 = (c₁v·w₁, c₂v·w₂), A2 = (c, 0), which is S₀ = (α − βy₁ − a) − c and
    # S₁ = (−γ + δy₀ − b) − 0: the same roundings as F, in 6 small ops a
    # forward step and 11 an adjoint step.
    def _step_consts(self, xs):
        a, b, c = self.step_terms(xs)  # (S, nt) each
        A1 = torch.stack([a, b], dim=-1).transpose(0, 1).contiguous()  # (nt, S, 2)
        A2 = torch.stack([c, torch.zeros_like(c)], dim=-1).transpose(0, 1).contiguous()
        K0 = torch.tensor([self.alpha, -self.gamma], dtype=xs.dtype, device=xs.device)
        K1 = torch.tensor([-self.beta, self.delta], dtype=xs.dtype, device=xs.device)
        return A1, A2, K0, K1

    @staticmethod
    def _S(y, A1, A2, K0, K1):
        return fma(K1, y.flip(-1), K0) - A1 - A2

    @sweep_span("f")
    def _forward_batch(self, xs):
        tau, nt = self.tau, self.nt
        S = xs.shape[0]
        A1, A2, K0, K1 = self._step_consts(xs)
        y0 = self.state0.expand(S, self.ny)
        y = y0
        ys = []
        for k in range(nt):
            y = fma(y * self._S(y, A1[k], A2[k], K0, K1), self._tau_t, y)
            ys.append(y)
        ys = torch.stack(ys)  # (nt, S, ny)
        yall = torch.cat([y0[None], ys]).transpose(0, 1)  # (S, nt+1, ny)
        cc = xs[:, self._g_idx, 0]
        d0, d1 = yall[..., 0] - 1.0, yall[..., 1] - 1.0
        g = fma(cc * cc, torch.tensor(self.rho, dtype=xs.dtype, device=xs.device),
                0.5 * fma(d0, d0, d1 * d1))
        return tau * window_sum(self._trap_w * g), ys

    @sweep_span("df")
    def _adjoint_batch(self, xs, ys):
        tau, nt = self.tau, self.nt
        S = xs.shape[0]
        A1, A2, K0, K1 = self._step_consts(xs)
        sign = torch.tensor([1.0, -1.0], dtype=xs.dtype, device=xs.device)
        lam = -0.5 * tau * (ys[-1] - 1.0)  # ODEObjective.jl:165-166
        lams = [lam]
        rules = self.adjoint_rules()
        for i, rule in enumerate(rules):
            k = nt - 2 - i  # uses (y_{k+1}, u_{k+1}) = (ys[k], x[k+1])
            y = ys[k]
            s = self._S(y, A1[k + 1], A2[k + 1], K0, K1)
            if rule == "L":
                y0, y1, l0, l1 = y[:, 0], y[:, 1], lam[:, 0], lam[:, 1]
                ft = torch.stack([fma(l0, s[:, 0], y1 * l1),
                                  fma(-y0, l0, l1 * s[:, 1])], dim=-1)
            else:  # (λ₀S₀ + y₁λ₁, λ₁S₁ − y₀λ₀)
                ft = fma(sign, (y * lam).flip(-1), lam * s)
            lam = fma(ft - (y - 1.0), self._tau_t, lam)
            lams.append(lam)
        lam = torch.stack(lams[::-1], dim=1)  # (S, nt, ny), 0-based k
        ys0 = torch.cat([self.state0.expand(1, S, self.ny), ys[:-1]]).transpose(0, 1)
        return self.df_rows(ys0, xs, lam), lam

    def df_rows(self, ys0, x, lam):
        y0, y1 = ys0[..., 0:1], ys0[..., 1:2]
        l0, l1 = lam[..., 0:1], lam[..., 1:2]
        # −F_u's c column is (y₀, −0): XLA's dot keeps the zero's product,
        # which is NaN where λ₁ is infinite.
        dc = fma(torch.tensor(2.0 * self.rho, dtype=x.dtype, device=x.device),
                 x[..., 0:1], fma(torch.full_like(l1, -0.0), l1, y0 * l0))
        dv = fma(y1 * self._cv2, l1, (y0 * self._cv1) * l0)
        return torch.cat([dc, dv], dim=-1)
