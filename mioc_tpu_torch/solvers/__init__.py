"""The host-driven TRM, the device-resident TRM with batched multistart, the
mixed continuous+integer solver and (lazily) the continuous optimizers."""

from .trm import TRM, TRMParameters, TRMResult, trm_solve
from .trm_device import (
    DeviceTRMResult,
    make_device_trm,
    multistart_solve_device,
    trm_solve_device,
)
from .mixed import MixedParameters, MixedResult, mixed_solve

__all__ = ["TRM", "TRMParameters", "TRMResult", "trm_solve", "DeviceTRMResult",
           "make_device_trm", "multistart_solve_device", "trm_solve_device",
           "MixedParameters", "MixedResult", "mixed_solve",
           "SteepestDescent", "NonlinCG", "ArmijoLS", "WolfeLS", "opt_optimize"]

_CONTINUOUS = {"SteepestDescent", "NonlinCG", "ArmijoLS", "WolfeLS", "opt_optimize",
               "LSInitialStatic", "LSInitialLastInc"}


def __getattr__(name):
    if name in _CONTINUOUS:
        from . import continuous

        return getattr(continuous, name)
    raise AttributeError(f"module 'mioc_tpu_torch.solvers' has no attribute {name!r}")
