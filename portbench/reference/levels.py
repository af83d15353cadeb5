"""Admissible level sets and the TV jump costs between them.

The enumeration order is Julia's column-major product order (the first
control's level varies fastest), the order the upstream toolbox and its
ports use, so a level index means the same combination on both sides.
"""

from __future__ import annotations

import itertools

import numpy as np


def admissible_levels(spec: dict) -> np.ndarray:
    """The ``(L, M)`` level combinations a configuration's ``"levels"``
    entry describes: ``{"V": [[...], ...]}`` for the full product, with
    ``"sum": [lo, hi]`` to keep the combinations whose sum lies in
    ``[lo, hi]`` (an SOS1 constraint is ``[1, 1]`` over binary levels)."""
    V = [np.asarray(v, dtype=np.float64) for v in spec["V"]]
    rev = itertools.product(*[range(len(v)) for v in reversed(V)])
    idx = np.asarray(list(rev), dtype=np.int64)[:, ::-1]
    levels = np.stack([V[m][idx[:, m]] for m in range(len(V))], axis=1)
    if "sum" in spec:
        lo, hi = spec["sum"]
        s = levels.sum(axis=1)
        levels = levels[(s >= lo) & (s <= hi)]
    return levels


def jump_costs(levels: np.ndarray, p: float, beta: float) -> np.ndarray:
    """``cost[l, j] = β·‖ν_j − ν_l‖_p`` (the max norm for ``p = inf``)."""
    d = np.abs(levels[None, :, :] - levels[:, None, :])
    if np.isinf(p):
        return beta * d.max(axis=-1)
    return beta * (d**p).sum(axis=-1) ** (1.0 / p)


def max_budget_use(levels: np.ndarray) -> int:
    """The L¹ diameter of the level set: the most budget one step can use."""
    d = np.abs(levels[None, :, :] - levels[:, None, :]).sum(axis=-1)
    return int(round(d.max()))


def level_index(us: np.ndarray, levels: np.ndarray) -> np.ndarray:
    """Index of each row of ``us (..., M)`` in ``levels``, or −1 where the
    row is no admissible combination."""
    eq = np.all(us[..., None, :] == levels, axis=-1)
    return np.where(eq.any(axis=-1), eq.argmax(axis=-1), -1)
