"""Batch parallelism over starts and scenarios, and the temporal DP (one
device)."""

from .batch import make_ode_trm_step, multistart_solve
from .temporal import temporal_dp_solve

__all__ = ["make_ode_trm_step", "multistart_solve", "temporal_dp_solve"]
