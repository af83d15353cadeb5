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

Both sweeps run over a batch of S controls at once (:meth:`_forward_batch`,
:meth:`_adjoint_batch`): each time step is one set of tensor ops on ``(S, ·)``
tensors, so a batch costs the launches of one sweep.  A single evaluation is
the batch of one row, so every row of a batch has the bits of the single
sweep of that row, whatever S is: the per-step arithmetic is elementwise and
the trapezoid sum is :func:`~mioc_tpu_torch.ops.tv.fold_sum`.  On the card
these generic sweeps are bound by kernel-launch latency.  The bundled
fishing model (:class:`~mioc_tpu_torch.models.fishing.LVMObj`) runs each
sweep on the card, in float64 or float32, as one launch of ``csrc/ode_lvm.cu``
(:mod:`~mioc_tpu_torch.ops.ode_cuda`), with the same bits as its PyTorch
sweeps; the Van der Pol model
(:class:`~mioc_tpu_torch.models.vanderpol.VPOObj`) replays its per-step ops
on the card from CUDA graphs (:mod:`~mioc_tpu_torch.ops.graphs`); the other
bundled models still step op by op.

Users implement ``F(y, u, i)`` and ``G(y, u, i)`` for one row only; the
Jacobians default to ``torch.func`` (``jacfwd``, ``vjp``, ``grad``) of those,
and the batched hooks (:meth:`F_step`, :meth:`FyT_lam_step`, :meth:`G_rows`,
:meth:`Gy_rows`, :meth:`df_rows`) default to ``torch.func.vmap`` of the
per-row functions, so any model gets the batched sweeps.  The bundled
models (:class:`RowwiseODEObjective`) write their own sweeps instead, in the
rounding of the JAX package's compiled CPU sweeps.

:meth:`ODEObjective.test_Fy` and :meth:`ODEObjective.test_Fu` check a
model's Jacobians against forward differences of ``F`` (the reference's
``test_Fy!``/``test_Fu!``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, jacfwd, vjp, vmap

from .._device import resolve_device, resolve_dtype
from ..ops.tv import fold_sum
from .base import LazyObjective, sweep_span

__all__ = ["ODEObjective", "RowwiseODEObjective", "const_dot"]


def const_dot(u, v):
    """Dot of ``u``'s last axis with a small constant vector ``v``, unrolled
    as ``0 + v_0·u_0 + v_1·u_1 + …`` with Python-float coefficients — the
    order of ``mioc_tpu.objectives.ode.const_dot``.  ``u`` may be one control
    row ``(M,)`` or any batch ``(..., M)``: the elementwise arithmetic per
    row is the same."""
    v = np.asarray(v)
    return sum(float(c) * u[..., m] for m, c in enumerate(v.ravel()))


def _numpy_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def scan_rules(rules: dict, n: int, unroll: int) -> str:
    """One rule letter per step of a ``lax.scan`` of ``n`` steps unrolled
    ``unroll`` times, in scan order.  JAX runs ``n // unroll`` trips of a
    loop whose body holds ``unroll`` steps, then the ``n % unroll`` steps
    left as straight code after the loop; when one trip would hold them all
    (``unroll ≥ n``, ``unroll ≠ 1``) there is no loop and all ``n`` steps are
    straight code, the same program for every such unroll
    (``jax._src.lax.control_flow.loops._scan_impl``).  XLA's CPU code
    contracts a step's products into fused multiply-adds by its place there.
    ``rules[unroll]`` maps ``"body"`` to the letters of one trip and a
    remainder length to the letters of that remainder; a remainder it lacks
    takes ``rules[unroll]["rest"]`` (a default letter).  ``rules["straight"]``
    maps a length ``n`` to the letters of a scan that is straight code
    throughout; a length it lacks takes its ``"rest"``, but its ``"last"``
    (where given) at the scan's last step.  An unroll without rules raises
    ``KeyError``."""
    trips, rem = divmod(n, unroll)
    if unroll != 1 and trips <= 1 and (trips == 0 or rem == 0):
        table = rules["straight"]
        if n in table or n == 0:
            return table.get(n, "")
        return table["rest"] * (n - 1) + table.get("last", table["rest"])
    table = rules[unroll]
    return table["body"] * trips + table.get(rem, table["rest"] * rem)


class ODEObjective(LazyObjective):
    """Abstract ODE objective.  Subclasses set dimensions and implement
    ``F(self, y, u, i)`` (rhs, shape ``(ny,)``) and ``G(self, y, u, i)``
    (running cost, scalar); optionally ``Fy``, ``FyT_lam``, ``Fu``, ``Gy``,
    ``Gu`` and the batched sweep hooks.

    ``device=None`` means ``"cuda"`` (raises without CUDA; pass ``"cpu"``);
    ``dtype=None`` means float64.

    ``sweep_unroll`` is the JAX package's ``lax.scan`` unroll of both sweeps,
    stored as given and clamped to ``1 … nt`` where it is read, as there
    (:meth:`scan_unroll`).  It changes no value of the generic sweeps here;
    the bundled models, whose sweeps round as the JAX package's compiled CPU
    sweeps do, read it at every evaluation (the rounding of an adjoint step
    depends on its place in the unrolled scan: :attr:`_adjoint_rules`,
    :func:`scan_rules`) and refuse an unroll they have no rules for with a
    ``ValueError``.  ``obj.sweep_unroll = u; obj._build()`` changes it, as
    in the JAX package.  Below nt = 32 the bundled models claim no bits: the
    JAX trapezoid sum is one fused reduction there, and on the shortest
    grids XLA fuses the straight-code steps of the scans otherwise; the
    sweeps agree to rounding.
    """

    # A model's per-step rules of the adjoint scan (scan_rules); None: no
    # step's rounding depends on its place, so any unroll is reproduced.
    _adjoint_rules = None
    _sweep_layer = "ode_sweep"

    def __init__(self, *, T0, T1, nt, state0, nu=0, V=None, admissible=None,
                 device=None, dtype=None, sweep_unroll=8):
        super().__init__()
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        self.T0 = float(T0)
        self.T1 = float(T1)
        self.nt = int(nt)
        self.sweep_unroll = int(sweep_unroll)
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
        # G arguments per the reference: k=0: G(0, y_0, u_0); 1≤k≤nt-1:
        # G(k, y_k, u_k); k=nt: G(nt-1, y_nt, u_{nt-1}).  Trapezoid weights.
        self._g_idx = torch.clamp(torch.arange(self.nt + 1, device=self.device),
                                  max=self.nt - 1)
        w = np.ones(self.nt + 1)
        w[0] = w[-1] = 0.5
        self._trap_w = torch.as_tensor(w, dtype=self.dtype, device=self.device)
        self._build()

    def _build(self):
        """Check that the sweeps reproduce the JAX package's rounding at
        ``sweep_unroll``.  The JAX package recompiles its sweeps here; these
        read the attribute at every evaluation."""
        self.adjoint_rules()

    def scan_unroll(self) -> int:
        """``sweep_unroll`` clamped to ``1 … nt``, the unroll the JAX sweeps'
        scans run with (``mioc_tpu/objectives/ode.py:277``)."""
        return max(1, min(int(self.sweep_unroll), self.nt))

    def adjoint_rules(self):
        """The letters of :attr:`_adjoint_rules` for the adjoint scan's
        ``nt − 1`` steps, in scan order (None without rules); a
        ``ValueError`` naming ``sweep_unroll`` where the model has none."""
        if self._adjoint_rules is None:
            return None
        try:
            return scan_rules(self._adjoint_rules, self.nt - 1, self.scan_unroll())
        except KeyError:
            unrolls = tuple(k for k in self._adjoint_rules if k != "straight")
            raise ValueError(
                f"sweep_unroll={self.sweep_unroll}: {type(self).__name__} reproduces the "
                f"JAX package's rounding at sweep_unroll in {unrolls}, or where it is "
                f"at least nt - 1, only") from None

    # -- user dynamics (one row) -----------------------------------------------
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

    # -- user-facing FD Jacobian checkers --------------------------------------
    # The reference's test_Fy!/test_Fu! (ODEObjective.jl:186-241), as in the
    # JAX package: the Jacobian at a random admissible point against forward
    # differences of F over a sweep of step sizes.  Returns the per-step
    # relative errors; the minimum shows the FD V-shape (≈ sqrt(eps)).

    def sample_point(self, rng):
        """Random ``(y, u, i)`` for the FD checks, from the numpy generator
        ``rng`` (the JAX package's draws).  Override for dynamics with
        restricted domains (``example_doubletank.jl:116-179``)."""
        y = self._on_device(rng.standard_normal(self.ny))
        if self.admissible is not None and self.admissible.L:
            u = self._on_device(self.admissible.levels[rng.integers(self.admissible.L)])
        else:
            u = self._on_device(rng.standard_normal(self.nx))
        return y, u, int(rng.integers(self.nt))

    def _on_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=_numpy_dtype(self.dtype)),
                               device=self.device)

    def _test_jac(self, wrt, seed, steps, verbose):
        rng = np.random.default_rng(seed)
        y, u, i = self.sample_point(rng)
        if steps is None:
            steps = np.logspace(-10, 0, 11)
        h = rng.standard_normal(self.ny if wrt == "y" else self.nx)
        h = self._on_device(h / np.linalg.norm(h))
        if wrt == "y":
            J = self.Fy(y, u, i)
            fd_of = lambda t: (self.F(y + t * h, u, i) - self.F(y, u, i)) / t
        else:
            J = self.Fu(y, u, i)
            fd_of = lambda t: (self.F(y, u + t * h, i) - self.F(y, u, i)) / t
        Jh = J.cpu().numpy() @ h.cpu().numpy()
        scale = max(float(np.linalg.norm(Jh)), 1.0)
        errs = np.array([float(np.linalg.norm(fd_of(t).cpu().numpy() - Jh)) / scale
                         for t in steps])
        if verbose:
            name = "Fy" if wrt == "y" else "Fu"
            for t, e in zip(steps, errs):
                print(f"{name}: t = {t:9.3e}   rel err = {e:9.3e}")
        return errs

    def test_Fy(self, seed=None, steps=None, verbose=False):
        """FD-check the state Jacobian ``Fy`` (ODEObjective.jl:186-213)."""
        return self._test_jac("y", seed, steps, verbose)

    def test_Fu(self, seed=None, steps=None, verbose=False):
        """FD-check the control Jacobian ``Fu`` (ODEObjective.jl:215-241)."""
        return self._test_jac("u", seed, steps, verbose)

    # -- batched sweep hooks (S rows) --------------------------------------------
    def step_terms(self, x):
        """Control-only terms of ``F`` for all rows and steps of ``x (S, nt,
        nx)`` at once (default none)."""
        return None

    def F_step(self, y, x, k, terms):
        """``F(y[s], x[s, k], k)`` for every row: ``y (S, ny)`` → ``(S, ny)``;
        ``terms`` is :meth:`step_terms` of ``x``."""
        return vmap(lambda yy, uu: self.F(yy, uu, k))(y, x[:, k])

    def FyT_lam_step(self, y, x, lam, k, terms):
        """``FyT_lam(y[s], x[s, k], lam[s], k)`` for every row."""
        return vmap(lambda yy, uu, ll: self.FyT_lam(yy, uu, ll, k))(y, x[:, k], lam)

    def G_rows(self, ys, us, idx):
        """Running cost at every row and step: ``ys (S, n, ny)``, ``us (S, n,
        nx)`` and time indices ``idx (n,)`` give ``(S, n)``."""
        return vmap(vmap(self.G), in_dims=(0, 0, None))(ys, us, idx)

    def Gy_rows(self, y, u, i):
        """``Gy(y[s], u[s], i)`` for every row: ``(S, ny)`` → ``(S, ny)``."""
        return vmap(lambda yy, uu: self.Gy(yy, uu, i))(y, u)

    def df_rows(self, ys0, x, lam):
        """The gradient term ``−F_uᵀλ + G_u`` at every row and step:
        ``ys0 (S, nt, ny)``, ``x (S, nt, nx)``, ``lam (S, nt, ny)`` give
        ``(S, nt, nx)``."""
        def dfk(y, u, lk, i):
            return -self.Fu(y, u, i).T @ lk + self.Gu(y, u, i)

        idx = torch.arange(self.nt, device=x.device)
        return vmap(vmap(dfk), in_dims=(0, 0, 0, None))(ys0, x, lam, idx)

    # -- sweeps ----------------------------------------------------------------
    @sweep_span("f")
    def _forward_batch(self, xs):
        """``xs (S, nt, nx) → (f (S,), ys (nt, S, ny))`` with ``ys[k, s] =
        y_{k+1}`` of row ``s``: TIME-major with the batch on axis 1, the JAX
        package's layout (select ``ys[:, s]``)."""
        tau, nt = self.tau, self.nt
        S = xs.shape[0]
        terms = self.step_terms(xs)
        y0 = self.state0.expand(S, self.ny)
        y = y0
        ys = []
        for k in range(nt):
            y = y + tau * self.F_step(y, xs, k, terms)
            ys.append(y)
        ys = torch.stack(ys)  # (nt, S, ny)
        ys_all = torch.cat([y0[None], ys]).transpose(0, 1)  # (S, nt+1, ny)
        gvals = self.G_rows(ys_all, xs[:, self._g_idx], self._g_idx)
        return tau * fold_sum(self._trap_w * gvals), ys

    @sweep_span("df")
    def _adjoint_batch(self, xs, ys):
        """``(xs (S, nt, nx), ys (nt, S, ny)) → (df (S, nt, nx), lam (S, nt,
        ny))``."""
        tau, nt = self.tau, self.nt
        S = xs.shape[0]
        terms = self.step_terms(xs)
        lam = -0.5 * tau * self.Gy_rows(ys[-1], xs[:, -1], nt)  # ODEObjective.jl:165-166
        lams = [lam]
        # k = nt-2 … 0 uses (y_{k+1}, u_{k+1}) = (ys[k], x[k+1]).
        for k in range(nt - 2, -1, -1):
            y = ys[k]
            lam = lam + tau * (self.FyT_lam_step(y, xs, lam, k + 1, terms)
                               - self.Gy_rows(y, xs[:, k + 1], k + 1))
            lams.append(lam)
        lam = torch.stack(lams[::-1], dim=1)  # (S, nt, ny), 0-based k
        ys0 = torch.cat([self.state0.expand(1, S, self.ny), ys[:-1]])  # y_0 … y_{nt-1}
        return self.df_rows(ys0.transpose(0, 1), xs, lam), lam

    def _forward_batch_with(self, xs):
        """The JAX package's name for :meth:`_forward_batch`."""
        return self._forward_batch(xs)

    def _forward(self, x):
        """``x (nt, nx) → (f, ys)``: 0-d ``f`` and ``ys[k] = y_{k+1}``, ``(nt, ny)``."""
        f, ys = self._forward_batch(x[None])
        return f[0], ys[:, 0]

    def _adjoint(self, x, ys):
        """``(x, ys) → (df (nt, nx), lam (nt, ny))``."""
        df, lam = self._adjoint_batch(x[None], ys[:, None])
        return df[0], lam[0]

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


class RowwiseODEObjective(ODEObjective):
    """An ODE objective written on the last axis: ``F``, ``FyT_lam``, ``Fy``,
    ``Fu``, ``G``, ``Gy`` and ``Gu`` take one row or any batch of rows (the
    per-row API and the FD checks use them).

    A subclass splits its dynamics into the control-only terms
    :meth:`_coupling` (``u (..., M)`` → a tensor or a tuple of tensors of
    ``u``'s leading shape) and :meth:`_rhs` / :meth:`_rhsT_lam`, which take
    those terms, and writes its own sweeps (:meth:`_forward_batch`,
    :meth:`_adjoint_batch`, :meth:`df_rows`) in the rounding of the JAX
    package's compiled CPU sweeps (:mod:`~mioc_tpu_torch.ops.xla_order`),
    with :meth:`step_terms` for all rows and steps at once.  Every step is
    elementwise over the rows, so every batched row has the single sweep's
    bits (``_batched_sweeps_bitexact``)."""

    _batched_sweeps_bitexact = True

    def _coupling(self, u):
        raise NotImplementedError

    def _rhs(self, y, terms):
        raise NotImplementedError

    def _rhsT_lam(self, y, lam, terms):
        raise NotImplementedError

    def F(self, y, u, i):
        return self._rhs(y, self._coupling(u))

    def FyT_lam(self, y, u, lam, i):
        return self._rhsT_lam(y, lam, self._coupling(u))

    def step_terms(self, x):
        return self._coupling(x)
