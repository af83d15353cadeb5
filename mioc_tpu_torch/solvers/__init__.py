"""The host-driven TRM and the device-resident TRM with batched multistart."""

from .trm import TRM, TRMParameters, TRMResult, trm_solve
from .trm_device import (
    DeviceTRMResult,
    make_device_trm,
    multistart_solve_device,
    trm_solve_device,
)

__all__ = ["TRM", "TRMParameters", "TRMResult", "trm_solve", "DeviceTRMResult",
           "make_device_trm", "multistart_solve_device", "trm_solve_device"]
