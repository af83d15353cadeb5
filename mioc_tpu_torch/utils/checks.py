"""Host-side debug checks of the solver hot path (``TRMParameters.debug_checks``)
and the process-wide NaN trap (:func:`enable_nan_checks`).

Counterpart of ``mioc_tpu.utils.checks``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["assert_admissible", "check_budget", "enable_nan_checks", "check_nan"]

_NAN_CHECKS = False


def enable_nan_checks(on: bool = True) -> None:
    """Trap NaNs in the solver hot path, for this process.

    The JAX package's switch sets ``jax_debug_nans``, which traps a NaN in
    every jitted computation.  PyTorch has no such global switch, so this
    flag traps NaNs where the port's solvers read their results.  With it
    set, these raise ``FloatingPointError`` on a NaN they produce:

    * every evaluation of a :class:`~mioc_tpu_torch.objectives.base.LazyObjective`
      or :class:`~mioc_tpu_torch.objectives.base.AAOObjective` through the
      protocol (``eval_f``, ``eval_f_``, ``eval_df_``, ``eval_fdf_``): the
      value ``f`` and every entry of the gradient ``df``;
    * ``trm_solve``'s DP tables after each build (``phi0``, or the temporal
      route's ``phis``);
    * ``mixed_solve``'s objective after each half-step.

    It does not trap a NaN that stays inside a computation and never reaches
    one of those results (an intermediate of a sweep whose f is finite, the
    rows of a batched sweep that the device TRM evaluates without the
    protocol, the discarded entries of a DP table), nor any other PyTorch
    code.  An infinite value is not a NaN: a trial objective that overflows
    to +inf stays a rejected step (a blown-up Van der Pol trial whose f is
    NaN is trapped, as ``jax_debug_nans`` traps it).  Each check
    reads its result back to the host, so the flag costs a synchronisation
    per result on the card."""
    global _NAN_CHECKS
    _NAN_CHECKS = bool(on)


def check_nan(value, what: str):
    """Raise ``FloatingPointError`` if NaN checks are on and ``value`` (a
    number or a tensor) holds a NaN; return ``value``."""
    if _NAN_CHECKS:
        bad = (bool(torch.isnan(value).any()) if isinstance(value, torch.Tensor)
               else value != value)
        if bad:
            raise FloatingPointError(f"NaN in {what}")
    return value


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_admissible(u, admissible, atol=1e-9) -> bool:
    """Check that every row of ``u (nt, M)`` is an admissible level
    combination.  Returns True or raises AssertionError with the first bad row."""
    u = _host(u)
    levels = np.asarray(admissible.levels)
    d = np.abs(u[:, None, :] - levels[None, :, :]).sum(-1)  # (nt, L)
    bad = np.nonzero(d.min(axis=1) > atol)[0]
    if len(bad):
        raise AssertionError(
            f"control row {bad[0]} = {u[bad[0]]} is not an admissible combination"
        )
    return True


def check_budget(u, u_old, B) -> bool:
    """Check the trust-region constraint Σ‖u−u_old‖₁ ≤ B."""
    dev = float(np.abs(_host(u) - _host(u_old)).sum())
    if dev > B + 1e-9:
        raise AssertionError(f"trust-region violated: L1 deviation {dev} > B={B}")
    return True
