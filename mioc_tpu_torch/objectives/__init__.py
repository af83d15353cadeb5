"""Objective protocol and the ODE adapter."""

from .base import AAOObjective, LazyObjective, Objective
from .ode import ODEObjective, const_dot

__all__ = ["AAOObjective", "LazyObjective", "ODEObjective", "Objective", "const_dot"]
