"""Admissible sets, TV and the Bellman DP (plain PyTorch and CUDA kernels).

The CUDA wrappers (:mod:`.bellman_cuda`, :mod:`.backtrack_cuda`) are imported
by :func:`.bellman.build_tables` and :func:`.bellman.backtrack` only when they
are handed CUDA tensors; the kernels are built at first use.
"""

from .bellman import (
    backtrack,
    build_tables,
    dp_solve,
    max_budget_use,
    stage_tables,
)
from .levels import AdmissibleSet, bounded_sum_levels, jump_cost_table, product_levels
from .tv import tv_p

__all__ = [
    "AdmissibleSet",
    "backtrack",
    "bounded_sum_levels",
    "build_tables",
    "dp_solve",
    "jump_cost_table",
    "max_budget_use",
    "product_levels",
    "stage_tables",
    "tv_p",
]
