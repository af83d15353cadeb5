"""Problem registry with plugin-style discovery.

Counterpart of ``mioc_tpu.models.registry`` (the reference's example
auto-import, ``multi-trust.jl:15-20``), with the same names and presets:

* built-in problems resolve lazily (name → class + the reference's solver
  preset from ``multi-trust.jl:181-198``);
* :func:`register` adds a problem, called directly or as a class decorator;
* :func:`discover` imports every ``example_*.py`` on the plugin search path
  (``$MIOC_PROBLEMS_PATH`` entries, else the working directory).  A plugin
  calls :func:`register` itself or defines a subclass of the port's
  :class:`~mioc_tpu_torch.objectives.base.Objective`, which is registered
  under the file stem (``example_foo.py`` → ``foo``), with an optional
  module-level ``PRESET`` dict of TRM parameters.

A factory is called as ``factory(nt=..., device=..., dtype=...)``: a plugin's
objective takes ``device`` and ``dtype`` like the bundled ones (``None``
meaning ``"cuda"`` and float64).
"""

from __future__ import annotations

import glob
import importlib
import importlib.util
import os
import sys
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

__all__ = ["ProblemSpec", "register", "get", "build", "available", "discover"]


@dataclass
class ProblemSpec:
    name: str
    factory: Callable            # factory(nt=..., device=..., dtype=...) -> Objective
    preset: dict = field(default_factory=dict)  # TRMParameters overrides


_REGISTRY: dict = {}

# Presets = multi-trust.jl:181-198, as in the JAX package.
_BUILTINS = {
    "fishing": ("fishing", "LVMObj", dict(beta=1e-4, delta0=2.0, p=np.inf)),
    "doubletank": ("doubletank", "DTMObj", dict(beta=1e-5, delta0=2.0, p=np.inf)),
    "vanderpol": ("vanderpol", "VPOObj", dict(beta=0.1, delta0=1.0, p=np.inf)),
    "convolution": ("convolution", "ConvObj", dict(beta=1e-4, delta0=0.125, p=1)),
    "heat": ("heat", "HeatObj", dict(beta=1e-3, delta0=2.0, p=2)),
    "mixed": ("mixed_fishing", "LVMMixedObj", dict(beta=1e-4, delta0=2.0, p=np.inf)),
    # Not in the reference's main(): its .gitignore:7-11 withholds the fuller
    # example; preset chosen so the TRM resolves the chattering arc.
    "fuller": ("fuller", "FullerObj", dict(beta=1e-4, delta0=0.1, p=1)),
}


def register(name: str, factory: Optional[Callable] = None, *,
             preset: Optional[dict] = None):
    """Register ``factory`` under ``name``.  With only ``name`` (and
    ``preset``) given, acts as a class decorator."""
    if factory is None:
        def deco(cls):
            register(name, cls, preset=preset)
            return cls

        return deco
    _REGISTRY[name] = ProblemSpec(name, factory, dict(preset or {}))
    return factory


def get(name: str) -> ProblemSpec:
    spec = _REGISTRY.get(name)
    if spec is None and name in _BUILTINS:
        mod, cls, preset = _BUILTINS[name]
        factory = getattr(importlib.import_module(f".{mod}", __package__), cls)
        spec = ProblemSpec(name, factory, dict(preset))
        _REGISTRY[name] = spec
    if spec is None:
        raise KeyError(
            f'I do not know the problem "{name}". '
            f"Available: {', '.join(available())}."
        )
    return spec


def build(name: str, nt: int, *, device=None, dtype=None):
    """Instantiate the problem's objective at ``nt`` time steps on ``device``
    (``None`` means ``"cuda"``) in ``dtype`` (``None`` means float64)."""
    return get(name).factory(nt=nt, device=device, dtype=dtype)


def available() -> list:
    return sorted(set(_BUILTINS) | set(_REGISTRY))


def _auto_register(module, stem: str) -> bool:
    """Convention fallback: register the module's own Objective subclass
    under the ``example_<stem>`` file stem."""
    from ..objectives.base import Objective

    for val in vars(module).values():
        if (isinstance(val, type) and issubclass(val, Objective)
                and val.__module__ == module.__name__):
            register(stem, val, preset=getattr(module, "PRESET", None))
            return True
    return False


def discover(paths=None) -> list:
    """Import ``example_*.py`` plugin modules and return the newly registered
    problem names.  Default search path: the ``os.pathsep``-separated entries
    of ``$MIOC_PROBLEMS_PATH``, else the current working directory."""
    if paths is None:
        env = os.environ.get("MIOC_PROBLEMS_PATH", "")
        paths = [p for p in env.split(os.pathsep) if p] or [os.getcwd()]
    new = []
    for d in paths:
        for f in sorted(glob.glob(os.path.join(d, "example_*.py"))):
            stem = os.path.splitext(os.path.basename(f))[0][len("example_"):]
            modname = f"mioc_tpu_torch_problem_{stem}"
            if modname in sys.modules:
                continue
            spec = importlib.util.spec_from_file_location(modname, f)
            if spec is None or spec.loader is None:
                continue
            module = importlib.util.module_from_spec(spec)
            sys.modules[modname] = module
            before = set(_REGISTRY)
            try:
                spec.loader.exec_module(module)
            except Exception as exc:  # a broken plugin must not kill the CLI
                del sys.modules[modname]
                print(f"warning: plugin {f} failed to import: {exc}", file=sys.stderr)
                continue
            if set(_REGISTRY) == before:
                _auto_register(module, stem)
            new.extend(sorted(set(_REGISTRY) - before))
    return new
