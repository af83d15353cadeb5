"""ODE-constrained objectives: forward-Euler state sweep + discrete adjoint.

Counterpart of ``mioc_tpu.objectives.ode`` (the reference's
``ODEObjective.jl``).  The problem is

    min  ∫_{T0}^{T1} G(y, u) dt      s.t.  y' = F(y, u),  y(T0) = state0

discretized by explicit Euler on an equidistant grid with trapezoidal
objective quadrature.  The gradient is the reference's discrete adjoint
recursion, index for index (0-based, time-major)::

    y_{k+1} = y_k + τ F(y_k, u_k)                          k = 0 … nt-1
    f = τ·( ½ G(y_0,u_0) + Σ_{k=1}^{nt-1} G(y_k,u_k) + ½ G(y_nt,u_{nt-1}) )

    λ_{nt-1} = −½ τ G_y(y_nt, u_{nt-1})
    λ_k = λ_{k+1} + τ( F_y(y_{k+1},u_{k+1})ᵀ λ_{k+1} − G_y(y_{k+1},u_{k+1}) )
    df_k = −F_u(y_k, u_k)ᵀ λ_k + G_u(y_k, u_k)

Both sweeps are Python loops of small tensor ops on the objective's device
(on the card they are bound by kernel-launch latency; a CUDA graph or a sweep
kernel is later work).  The per-step quadrature and gradient terms are
evaluated for all steps at once with ``torch.func.vmap``, which computes
each step with the same arithmetic as a single call.

Users implement ``F(y, u, i)`` and ``G(y, u, i)`` only; the Jacobians default
to ``torch.func`` (``jacfwd``, ``vjp``, ``grad``) of those.  A model may also
precompute control-only terms for all steps at once (:meth:`step_terms`) and
consume them in :meth:`F_step` / :meth:`FyT_lam_step`, provided it keeps the
per-step order of operations, so that f stays bit-comparable.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, jacfwd, vjp, vmap

from .._device import resolve_device, resolve_dtype
from .base import LazyObjective

__all__ = ["ODEObjective", "const_dot"]


def const_dot(u, v):
    """Dot of ``u``'s last axis with a small constant vector ``v``, unrolled
    as ``0 + v_0·u_0 + v_1·u_1 + …`` with Python-float coefficients — the
    order of ``mioc_tpu.objectives.ode.const_dot``.  ``u`` may be one control
    row ``(M,)`` or a whole time-major control ``(nt, M)``: the elementwise
    arithmetic per step is the same."""
    v = np.asarray(v)
    return sum(float(c) * u[..., m] for m, c in enumerate(v.ravel()))


def _numpy_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


class ODEObjective(LazyObjective):
    """Abstract ODE objective.  Subclasses set dimensions and implement
    ``F(self, y, u, i)`` (rhs, shape ``(ny,)``) and ``G(self, y, u, i)``
    (running cost, scalar); optionally ``Fy``, ``FyT_lam``, ``Fu``, ``Gy``,
    ``Gu`` and the sweep hooks ``step_terms``/``F_step``/``FyT_lam_step``.

    ``device=None`` means ``"cuda"`` (raises without CUDA; pass ``"cpu"``);
    ``dtype=None`` means float64.
    """

    def __init__(self, *, T0, T1, nt, state0, nu=0, V=None, admissible=None,
                 device=None, dtype=None):
        super().__init__()
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        self.T0 = float(T0)
        self.T1 = float(T1)
        self.nt = int(nt)
        self.tau = (self.T1 - self.T0) / self.nt
        self.V = V
        self.admissible = admissible
        self.nu = int(nu)
        self.nv = len(V) if V is not None else 0
        self.state0 = torch.as_tensor(
            np.asarray(state0, dtype=_numpy_dtype(self.dtype)), device=self.device)
        self.ny = self.state0.shape[0]
        self.x = torch.zeros((self.nt, self.nx), dtype=self.dtype, device=self.device)
        self.state = None    # (nt, ny): y_1 … y_nt  (reference obj.state)
        self.adjoint = None  # (nt, ny): λ_1 … λ_nt  (reference obj.adjoint)

    # -- user dynamics ---------------------------------------------------------
    def F(self, y, u, i):
        raise NotImplementedError

    def G(self, y, u, i):
        raise NotImplementedError

    # Default Jacobians via torch.func; override for hand-written versions.
    def Fy(self, y, u, i):
        return jacfwd(lambda yy: self.F(yy, u, i))(y)

    def FyT_lam(self, y, u, lam, i):
        """Adjoint-mode product ``Fyᵀλ``, the only dynamics derivative the
        backward sweep consumes (default: ``torch.func.vjp`` of ``F``)."""
        _, pullback = vjp(lambda yy: self.F(yy, u, i), y)
        return pullback(lam)[0]

    def Fu(self, y, u, i):
        return jacfwd(lambda uu: self.F(y, uu, i))(u)

    def Gy(self, y, u, i):
        return grad(lambda yy: self.G(yy, u, i))(y)

    def Gu(self, y, u, i):
        return grad(lambda uu: self.G(y, uu, i))(u)

    # -- sweep hooks -----------------------------------------------------------
    def step_terms(self, x):
        """Control-only terms of ``F`` for all steps at once (default none)."""
        return None

    def F_step(self, y, x, k, terms):
        """``F(y, x[k], k)``; ``terms`` is :meth:`step_terms` of ``x``."""
        return self.F(y, x[k], k)

    def FyT_lam_step(self, y, x, lam, k, terms):
        """``FyT_lam(y, x[k], lam, k)``; ``terms`` is :meth:`step_terms` of ``x``."""
        return self.FyT_lam(y, x[k], lam, k)

    # -- sweeps ----------------------------------------------------------------
    def _forward(self, x):
        """``x (nt, nx) → (f, ys)``: 0-d ``f`` and ``ys[k] = y_{k+1}``, ``(nt, ny)``."""
        tau, nt = self.tau, self.nt
        terms = self.step_terms(x)
        y = self.state0
        ys = []
        for k in range(nt):
            y = y + tau * self.F_step(y, x, k, terms)
            ys.append(y)
        ys = torch.stack(ys)
        ys_all = torch.cat([self.state0[None], ys])  # y_0 … y_nt
        # G arguments per the reference: k=0: G(0, y_0, u_0); 1≤k≤nt-1:
        # G(k, y_k, u_k); k=nt: G(nt-1, y_nt, u_{nt-1}).
        ar = torch.arange(nt + 1, device=x.device)
        u_idx = torch.clamp(ar, max=nt - 1)
        gvals = vmap(self.G)(ys_all, x[u_idx], u_idx)
        w = torch.ones(nt + 1, dtype=x.dtype, device=x.device)
        w[0] = 0.5
        w[nt] = 0.5
        return tau * torch.sum(w * gvals), ys

    def _adjoint(self, x, ys):
        """``(x, ys) → (df (nt, nx), lam (nt, ny))``."""
        tau, nt = self.tau, self.nt
        terms = self.step_terms(x)
        lamT = -0.5 * tau * self.Gy(ys[-1], x[-1], nt)  # ODEObjective.jl:165-166
        lam = lamT
        lams = [lamT]
        # k = nt-2 … 0 uses (y_{k+1}, u_{k+1}) = (ys[k], x[k+1]).
        for k in range(nt - 2, -1, -1):
            y = ys[k]
            lam = lam + tau * (self.FyT_lam_step(y, x, lam, k + 1, terms)
                               - self.Gy(y, x[k + 1], k + 1))
            lams.append(lam)
        lam = torch.stack(lams[::-1])  # λ, 0-based k
        ys0 = torch.cat([self.state0[None], ys[:-1]])  # y_0 … y_{nt-1}

        def dfk(y, u, lk, i):
            return -self.Fu(y, u, i).T @ lk + self.Gu(y, u, i)

        df = vmap(dfk)(ys0, x, lam, torch.arange(nt, device=x.device))
        return df, lam

    def _forward_batch_with(self, xs):
        """K-row batched forward ``xs (K, nt, nx) → (fvals (K,), ys (nt, K, ny))``.
        ``ys`` is TIME-major with the batch axis second, the JAX package's
        layout; each row is :meth:`_forward` of that row, bit for bit."""
        outs = [self._forward(x) for x in xs]
        return (torch.stack([f for f, _ in outs]),
                torch.stack([ys for _, ys in outs], dim=1))

    # -- protocol hooks --------------------------------------------------------
    def eval_f_impl(self, x, cache: bool):
        return self._forward(x)

    def eval_f_(self):
        f = super().eval_f_()
        self.state = self._aux
        return f

    def eval_df_impl(self):
        df, lam = self._adjoint(self.x, self._aux)
        self.adjoint = lam
        return df
