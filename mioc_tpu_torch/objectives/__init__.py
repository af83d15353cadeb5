"""Objective protocol, the ODE adapter and the parabolic PDE objective."""

from .base import AAOObjective, LazyObjective, Objective
from .ode import ODEObjective, const_dot
from .pde import PDEObjective

__all__ = ["AAOObjective", "LazyObjective", "ODEObjective", "Objective", "PDEObjective",
           "const_dot"]
