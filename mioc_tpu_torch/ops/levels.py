"""Admissible-set enumeration: dense level tables for the DP subproblem.

The reference models the admissible set as a ragged array ``𝓥`` of per-control
level lists plus a lazy Julia iterator over admissible index tuples
(``julia_opt/AdmissibleIterators.jl:9-49``).  Here the admissible set is
enumerated *once* at problem-construction time into dense numpy arrays (a
copy of ``mioc_tpu.ops.levels``, numpy only) so that the DP sweep is pure
array math:

* ``levels``     -- float ``(L, M)``: the admissible control-value combinations
  ``ν_l`` (row ``l`` is one combination).
* ``indices``    -- int32 ``(L, M)``: index of each entry into the per-control
  level list (0-based analogue of the Julia iterator tuples).
* ``jump_cost``  -- float ``(L, L)``: ``β·‖ν_j − ν_l‖_p`` transition-cost table.

Enumeration order matches Julia's ``Iterators.product`` (first control index
varies fastest, cf. column-major ``CartesianIndices``) so that argmin
tie-breaking in the backtrack reproduces the reference exactly.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

__all__ = [
    "AdmissibleSet",
    "product_levels",
    "bounded_sum_levels",
    "jump_cost_table",
]


@dataclass(frozen=True)
class AdmissibleSet:
    """Enumerated admissible control-level combinations.

    Attributes:
      V: the ragged per-control level lists (``𝓥`` in the reference).
      indices: int32 ``(L, M)`` index tuples into ``V``.
      levels: float64 ``(L, M)`` admissible value combinations ``ν_l``.
    """

    V: tuple = field(repr=False)
    indices: np.ndarray
    levels: np.ndarray

    @property
    def L(self) -> int:
        return self.levels.shape[0]

    @property
    def M(self) -> int:
        return self.levels.shape[1]

    def __len__(self) -> int:
        return self.L


def _enumerate_indices(sizes: Sequence[int]) -> np.ndarray:
    """All index tuples with the FIRST index varying fastest (Julia order).

    ``Iterators.product`` in Julia is column-major: the first range cycles
    fastest (``AdmissibleIterators.jl:17``).  Python's ``itertools.product``
    cycles the last factor fastest, so enumerate reversed and flip.
    """
    rev = list(itertools.product(*[range(s) for s in reversed(sizes)]))
    arr = np.asarray(rev, dtype=np.int32)
    if arr.size == 0:
        return arr.reshape(0, len(sizes))
    return arr[:, ::-1]


def product_levels(V: Sequence[Sequence[float]]) -> AdmissibleSet:
    """Full Cartesian product of the per-control level lists.

    Mirrors ``product_iterator`` (``AdmissibleIterators.jl:9-18``).
    """
    V = tuple(tuple(v) for v in V)
    sizes = [len(v) for v in V]
    idx = _enumerate_indices(sizes)
    vals = np.empty(idx.shape, dtype=np.float64)
    for m, vm in enumerate(V):
        vals[:, m] = np.asarray(vm, dtype=np.float64)[idx[:, m]]
    return AdmissibleSet(V=V, indices=idx, levels=vals)


def bounded_sum_levels(
    V: Sequence[Sequence[float]], lower_bound: float, upper_bound: float
) -> AdmissibleSet:
    """Product combinations whose value-sum lies in ``[lower_bound, upper_bound]``.

    Mirrors ``bounded_sum_iterator``/``check_sum``
    (``AdmissibleIterators.jl:26-49``); with bounds ``(1, 1)`` over binary
    levels this is the SOS1 constraint used by the fishing/vanderpol/doubletank
    examples (``example_fishing.jl:24``).
    """
    full = product_levels(V)
    sums = full.levels.sum(axis=1)
    keep = (sums >= lower_bound) & (sums <= upper_bound)
    return AdmissibleSet(V=full.V, indices=full.indices[keep], levels=full.levels[keep])


def jump_cost_table(
    levels: np.ndarray,
    p: float,
    beta: float = 1.0,
    compat_pinf: bool = False,
) -> np.ndarray:
    """Pairwise TV jump costs ``cost[l, j] = β·‖ν_j − ν_l‖_p``.

    This is the (l, j)-independent-of-time part of the DP stage cost
    (``HelpFunctions.jl:60-67``).  For ``p = inf`` the reference's expression
    ``(Σ_m|Δ_m|^Inf)^(1/Inf)`` collapses to the constant ``1.0`` for *every*
    transition under IEEE semantics (``0.0^0.0 == Inf^0.0 == 1``) — a uniform
    per-stage offset that cancels in the path argmin.  We implement the honest
    ``max_m |Δ_m|`` by default; pass ``compat_pinf=True`` to reproduce the
    reference's uniform-offset behaviour bit-for-bit.
    """
    diff = np.abs(levels[None, :, :] - levels[:, None, :])  # [l, j, m]
    if np.isinf(p):
        if compat_pinf:
            cost = np.ones(diff.shape[:2], dtype=levels.dtype)
        else:
            cost = diff.max(axis=-1)
    elif p > 0:
        cost = (diff**p).sum(axis=-1) ** (1.0 / p)
    else:
        raise ValueError("Only positive p (or inf) are accepted.")
    return beta * cost
