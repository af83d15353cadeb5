"""Batch parallelism over starts and scenarios (one device)."""

from .batch import make_ode_trm_step, multistart_solve

__all__ = ["make_ode_trm_step", "multistart_solve"]
