"""Host-side debug checks of the solver hot path (``TRMParameters.debug_checks``).

Counterpart of ``mioc_tpu.utils.checks``; its ``enable_nan_checks`` switches a
JAX flag and has no counterpart yet.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["assert_admissible", "check_budget"]


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
