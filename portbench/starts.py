"""Random admissible starting controls: the traffic of a solver.

A frozen copy of the numpy path of ``rand_func``/``rand_func_int`` in
``mioc_tpu_torch/utils/init.py`` at commit 04297e7 (``julia_stream=False``,
integer controls only), so that ``start(levels, nt, seed)`` is the start
that the port's CLI draws for ``--seed seed``.  The benchmark makes its
inputs here and hands the same arrays to the program and the reference.
"""

from __future__ import annotations

import numpy as np


def start(levels: np.ndarray, nt: int, seed: int, jumps: int = None) -> np.ndarray:
    """A random piecewise-constant admissible control ``(nt, M)`` with
    ``jumps`` (default ``nt // 10``) switch times drawn uniformly."""
    if jumps is None:
        jumps = nt // 10
    rng = np.random.default_rng(seed)
    t = np.sort(rng.choice(np.arange(1, nt), size=jumps, replace=False))
    seg_combos = rng.integers(0, len(levels), size=jumps + 1)
    seg_of_step = np.searchsorted(t, np.arange(nt), side="right")
    return np.asarray(levels, dtype=np.float64)[seg_combos[seg_of_step]]
