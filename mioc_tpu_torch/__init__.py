"""mioc_tpu_torch — the PyTorch/CUDA port of ``mioc_tpu``.

Mixed-integer optimal control with TV regularization, solved by a
trust-region method whose subproblem is an exact Bellman DP.  The layout
mirrors the JAX package so that each module has an obvious counterpart:

* :mod:`mioc_tpu_torch.ops`        — admissible sets, TV, the DP (plain
  PyTorch version plus hand-written CUDA kernels for Hopper in ``csrc/``).
* :mod:`mioc_tpu_torch.objectives` — objective protocol, ODE sweeps, the
  dense parabolic PDE objective.
* :mod:`mioc_tpu_torch.models`     — fishing, double tank, Van der Pol,
  Fuller, convolution and heat, and the problem registry.
* :mod:`mioc_tpu_torch.fem`        — meshes, elements, quadrature and
  assembly (numpy, at model construction) and the native triangulator.
* :mod:`mioc_tpu_torch.solvers`    — the host-driven and the device TRM.
* :mod:`mioc_tpu_torch.utils`      — starts, Julia RNG, logging, checks, IO.
* :mod:`mioc_tpu_torch.interop`    — builds the port's objects from the JAX
  package's data (numpy arrays), for tests that hold the two together.

Entry points run on the CUDA device unless ``device="cpu"`` is passed; the
default dtype is float64.  The package imports neither JAX nor ``mioc_tpu``.
"""

from ._device import resolve_device, resolve_dtype
from .ops.levels import (
    AdmissibleSet,
    bounded_sum_levels,
    jump_cost_table,
    product_levels,
)

__version__ = "0.1.0"

__all__ = [
    "AdmissibleSet",
    "bounded_sum_levels",
    "jump_cost_table",
    "product_levels",
    "resolve_device",
    "resolve_dtype",
]
