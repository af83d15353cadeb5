"""Total-variation functional for piecewise-constant vector-valued controls.

Reference: ``TV_p`` at ``HelpFunctions.jl:251-273``; counterpart of
``mioc_tpu.ops.tv``.  Controls are time-major: ``u`` has shape ``(nt, M)``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["tv_p"]


def tv_p(u, p) -> torch.Tensor:
    """``TV_p(u) = Σ_i ‖u_i − u_{i−1}‖_p`` over the time axis, as a 0-d tensor
    on ``u``'s device.

    ``p = inf`` uses the honest per-jump max norm (the reference computes this
    correctly here, ``HelpFunctions.jl:255-258``, even though its DP jump cost
    for ``p = inf`` does not).  ``u is None`` (no integer control) returns 0
    like the ``Nothing`` overload (``HelpFunctions.jl:271-273``).
    """
    if u is None:
        return torch.tensor(0.0, dtype=torch.float64)
    p = float(p)
    if not (p > 0) and p != math.inf:
        raise ValueError("Only positive p (or inf) are accepted.")
    d = (u[1:] - u[:-1]).abs()  # (nt-1, M)
    if p == math.inf:
        return d.amax(dim=-1).sum()
    return ((d**p).sum(dim=-1) ** (1.0 / p)).sum()
