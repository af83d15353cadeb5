"""Objective protocol: lazy and all-at-once evaluation with caching/counters.

Counterpart of ``mioc_tpu.objectives.base`` (the reference's
``AbstractObjective.jl``).  Two evaluation protocols:

* :class:`LazyObjective` (``AbstractObjectiveLazy``, :70-110): ``f`` and ``df``
  are computed separately; ``eval_f_`` caches forward state for a later
  ``eval_df_`` and invalidates the gradient cache; ``eval_df_`` is a no-op when
  ``df_valid``.
* :class:`AAOObjective` (``AbstractObjectiveAAO``, :15-59): a single
  ``eval_fdf_impl`` computes both at once.

The stateful wrapper keeps the reference's evaluation counters (``f_evals``,
``df_evals``, ``fdf_evals``) and the ``df_valid`` gradient-cache discipline,
which the TRM relies on (one gradient per outer iteration,
``multi-trust.jl:102``).

Conventions: the optimization variable ``x`` is a time-major ``(nt, nx)``
tensor on the objective's ``device``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..utils import trace
from ..utils.checks import check_nan

__all__ = ["Objective", "LazyObjective", "AAOObjective", "sweep_span"]


def sweep_span(tag: str):
    """Decorate a batched sweep ``(self, xs (rows, nt, nx), ...)`` with the
    span ``<self._sweep_layer>.<tag>`` (:mod:`~mioc_tpu_torch.utils.trace`):
    ``rows`` passed, ``rows_swept`` computed (:meth:`Objective._rows_swept`,
    padding included), ``steps`` (:meth:`Objective._sweep_steps`) and
    ``path`` ``"torch"``, which a sweep that hands its recursion to one
    kernel launch sets to ``"kernel"`` (:func:`~mioc_tpu_torch.utils.trace.annotate`)."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(self, xs, *args):
            if not trace.enabled():
                return fn(self, xs, *args)
            rows = xs.shape[0]
            with trace.span(f"{self._sweep_layer}.{tag}", rows=rows,
                            rows_swept=self._rows_swept(rows), steps=self._sweep_steps(rows),
                            path="torch"):
                return fn(self, xs, *args)
        return traced
    return wrap


class Objective:
    """Common base: problem dimensions, admissible set, counters.

    Attributes expected on instances:

    * ``T0``, ``T1``, ``nt``, ``tau`` — time grid.
    * ``nu`` (continuous controls), ``nv`` (integer controls), ``nx = nu+nv``.
    * ``V`` — ragged per-control integer level lists (``𝓥``).
    * ``admissible`` — :class:`~mioc_tpu_torch.ops.levels.AdmissibleSet` or
      ``None``.
    * ``x`` — current control, ``(nt, nx)``.
    * ``device``, ``dtype`` — where and in which precision it is evaluated.
    """

    T0: float
    T1: float
    nt: int
    nu: int = 0
    nv: int = 0
    # True when the batched sweeps compute every row with arithmetic
    # bit-identical to the single sweep of that row (elementwise per-step
    # code, fixed-order sums).  The device TRM's speculative-wave default
    # reads it (solvers/trm_device.py); mioc_tpu.objectives.base:99.
    _batched_sweeps_bitexact = False
    # The layer that names the spans of the batched sweeps (sweep_span).
    _sweep_layer = "sweep"

    def __init__(self):
        self.f: float = 0.0
        self.df: Optional[torch.Tensor] = None
        self.df_valid: bool = False
        self.f_evals: int = 0
        self.df_evals: int = 0
        self.fdf_evals: int = 0
        self.x: Optional[torch.Tensor] = None

    # -- helpers matching ODEObjective.jl:76-122 ------------------------------
    @property
    def nx(self) -> int:
        return self.nu + self.nv

    def i2t(self, i):
        return self.T0 + i * self.tau

    def t2i(self, t):
        return int(round((t - self.T0) / self.tau))

    def trange0(self):
        return np.linspace(self.T0, self.T1, self.nt + 1)

    def trange(self):
        return np.linspace(self.T0 + self.tau, self.T1, self.nt)

    def as_control(self, x) -> torch.Tensor:
        """``x`` as a tensor of this objective's dtype on its device."""
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _rows_swept(self, rows: int) -> int:
        """Rows a batched sweep of ``rows`` rows computes, padding included."""
        return rows

    def _sweep_steps(self, rows: int) -> int:
        """Sequential steps of a batched sweep of ``rows`` rows."""
        return self.nt


class LazyObjective(Objective):
    """f-then-df protocol with gradient-cache invalidation.

    Subclasses implement:
      ``eval_f_impl(x, cache: bool) -> (fval, aux)`` — objective at ``x``;
        when ``cache`` the returned ``aux`` (e.g. the state trajectory) is
        stored for the gradient pass.
      ``eval_df_impl() -> df`` — gradient at the cached ``x``/``aux``.
    """

    def eval_f_impl(self, x, cache: bool):
        raise NotImplementedError

    def eval_df_impl(self):
        raise NotImplementedError

    def eval_f(self, x) -> float:
        """Evaluate at ``x``; counts but does not cache (AbstractObjective.jl:74-78)."""
        self.f_evals += 1
        fval, _ = self.eval_f_impl(self.as_control(x), cache=False)
        return check_nan(float(fval), "f")

    def eval_f_(self) -> float:
        """Evaluate at ``self.x``; caches state and invalidates ``df`` (:81-91)."""
        self.f_evals += 1
        fval, aux = self.eval_f_impl(self.x, cache=True)
        self._aux = aux
        self.f = check_nan(float(fval), "f")
        self.df_valid = False
        return self.f

    def eval_df_(self):
        """Gradient at ``self.x``; assumes ``eval_f_`` ran for this ``x`` (:94-102)."""
        if not self.df_valid:
            self.df_evals += 1
            self.df = check_nan(self.eval_df_impl(), "df")
            self.df_valid = True

    def eval_fdf_(self) -> float:
        f = self.eval_f_()
        self.eval_df_()
        return f


class AAOObjective(Objective):
    """All-at-once protocol: one hook computes value and gradient (:15-59)."""

    def eval_fdf_impl(self, x, want_df: bool):
        raise NotImplementedError

    def eval_f(self, x) -> float:
        self.fdf_evals += 1
        fval, _ = self.eval_fdf_impl(self.as_control(x), want_df=False)
        return check_nan(float(fval), "f")

    def eval_f_(self) -> float:
        fval, _ = self.eval_fdf_impl(self.x, want_df=False)
        self.fdf_evals += 1
        self.f = check_nan(float(fval), "f")
        self.df_valid = False
        return self.f

    def eval_df_(self):
        if not self.df_valid:
            self.fdf_evals += 1
            _, df = self.eval_fdf_impl(self.x, want_df=True)
            self.df = check_nan(df, "df")
            self.df_valid = True

    def eval_fdf_(self) -> float:
        self.fdf_evals += 1
        fval, df = self.eval_fdf_impl(self.x, want_df=True)
        self.f = check_nan(float(fval), "f")
        self.df = check_nan(df, "df")
        self.df_valid = True
        return self.f
