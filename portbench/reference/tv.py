"""Total variation of piecewise-constant controls: ``TV_p(u) = Σ_i ‖u_i −
u_{i−1}‖_p`` over the time axis, the max norm for ``p = inf``."""

from __future__ import annotations

import numpy as np


def tv_p(us, p):
    """Row-wise TV of ``us (..., nt, M)``."""
    d = np.abs(np.diff(us, axis=-2))
    if np.isinf(p):
        return d.max(axis=-1).sum(axis=-1)
    return ((d**p).sum(axis=-1) ** (1.0 / p)).sum(axis=-1)
