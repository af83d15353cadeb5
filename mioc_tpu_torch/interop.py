"""Carrying state across from the JAX package.

The functions take ``mioc_tpu``'s data as numpy arrays (or plain numbers) and
build the port's objects, so a test can feed both packages the same problem
and hold their outputs together.  Nothing here imports JAX or ``mioc_tpu``:
the caller converts with ``np.asarray``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ._device import resolve_device
from .models import ConvObj, DTMObj, FullerObj, HeatObj, LVMMixedObj, LVMObj, VPOObj
from .ops.levels import AdmissibleSet

__all__ = ["LVM_PARAMS", "PROBLEM_PARAMS", "CONV_OPERATORS", "HEAT_OPERATORS",
           "HEAT_SPARSE_OPERATORS", "HEAT_ENGINE",
           "admissible_from_arrays",
           "lvm_from_params", "objective_from_params", "tables_from_pallas"]

# The numeric parameters that define a fishing problem (attributes of
# ``mioc_tpu.models.LVMObj``).
LVM_PARAMS = ("alpha", "beta", "gamma", "delta", "c1", "c2", "v1", "v2",
              "state0", "nt", "T0", "T1")

# The numeric parameters of each problem, by registry name (attributes of the
# JAX package's objective of that name).
PROBLEM_PARAMS = {
    "fishing": LVM_PARAMS,
    "doubletank": ("nt", "k1", "k2", "c", "state0"),
    "vanderpol": ("nt", "c", "state0"),
    "fuller": ("nt", "state0", "terminal_weight", "terminal_frac"),
    "convolution": ("nt", "omega0"),
    "heat": ("nt", "gamma", "kappa", "Tout", "temp0", "tempT"),
    "mixed": ("nt", "alpha", "beta", "gamma", "delta", "c1", "c2", "rho", "cmax",
              "v1", "v2", "state0"),
}

# The operators of a convolution problem (attributes of
# ``mioc_tpu.models.ConvObj``); :func:`objective_from_params` installs them
# when given, in place of the port's own build.
CONV_OPERATORS = ("K", "fvec", "_Mdiag", "_Moff")

# The operators of a heat problem (attributes of ``mioc_tpu.models.HeatObj``:
# the dense inverse S⁻¹, M⁻¹F, the dense mass matrix, the target, the initial
# state and the step); :func:`objective_from_params` builds the objective on
# them, with no assembly of its own, when given.
HEAT_OPERATORS = ("Sinv", "M_invF", "_Mj", "yd", "state0", "tau")

# The host operators of a heat problem on the sparse cg/mg engines
# (attributes of a ``mioc_tpu.models.HeatObj`` built with ``solver="cg"`` or
# ``"mg"``: stiffness + Robin, mass, load, initial state — in the banded
# engine's order there, as that package keeps it — and the step), the
# engine's settings, and the optional ``dof_perm`` (the banded engine's
# permutation) and ``prolongations`` (the multigrid levels', finest first:
# ``prolongation(meshes[i - 1], meshes[i], fe)`` for i = len(meshes)−1 … 1).
HEAT_SPARSE_OPERATORS = ("A", "M", "F", "state0", "tau")
HEAT_ENGINE = ("solver_mode", "sparse_format", "cg_iters")


def admissible_from_arrays(V, indices, levels) -> AdmissibleSet:
    """The port's admissible set from the ragged level lists ``V`` and the
    enumerated ``indices (L, M)`` / ``levels (L, M)`` arrays."""
    return AdmissibleSet(
        V=tuple(tuple(v) for v in V),
        indices=np.asarray(indices, dtype=np.int32),
        levels=np.asarray(levels, dtype=np.float64),
    )


def _with_unroll(obj, params: Mapping):
    """``obj`` with the JAX object's ``sweep_unroll`` where ``params`` gives
    it (the JAX idiom ``obj.sweep_unroll = u; obj._build()``)."""
    if "sweep_unroll" in params:
        obj.sweep_unroll = int(np.asarray(params["sweep_unroll"]))
        obj._build()
    return obj


def lvm_from_params(params: Mapping, *, device=None, dtype=None) -> LVMObj:
    """A port :class:`~mioc_tpu_torch.models.LVMObj` with the numeric
    parameters ``params`` (keys :data:`LVM_PARAMS`, values numbers or numpy
    arrays; an optional ``sweep_unroll`` is carried across)."""
    missing = [k for k in LVM_PARAMS if k not in params]
    if missing:
        raise KeyError(f"missing fishing parameters: {missing}")
    p = {k: np.asarray(params[k]) for k in LVM_PARAMS}
    return _with_unroll(LVMObj(
        int(p["nt"]),
        alpha=float(p["alpha"]), beta=float(p["beta"]),
        gamma=float(p["gamma"]), delta=float(p["delta"]),
        c1=float(p["c1"]), c2=float(p["c2"]),
        v1=p["v1"], v2=p["v2"], state0=p["state0"],
        T0=float(p["T0"]), T1=float(p["T1"]),
        device=device, dtype=dtype,
    ), params)


def tables_from_pallas(U, phi0, *, nt: int, L: int, B: int, device=None):
    """DP tables in the Pallas padded layout — ``U (T ≥ nt-1, Lp, Bp)``,
    ``phi0 (Lp, Bp)``, or batched over starts, ``U (S, T, Lp, Bp)``, ``phi0
    (S, Lp, Bp)`` — sliced to the port's exact ``(nt-1, L, B+1)`` / ``(L,
    B+1)`` (with the start axis kept), as contiguous tensors of the same
    element types on ``device`` (``None`` means ``"cuda"``, as for every
    entry point)."""
    U = np.asarray(U)
    phi0 = np.asarray(phi0)
    if U.ndim != phi0.ndim + 1 or phi0.ndim not in (2, 3):
        raise ValueError(f"U {U.shape} and phi0 {phi0.shape} are not one table "
                         "set or a batch of them")
    if U.shape[-3] < nt - 1 or U.shape[-2] < L or U.shape[-1] < B + 1:
        raise ValueError(f"U {U.shape} is smaller than ({nt - 1}, {L}, {B + 1})")
    if phi0.shape[-2] < L or phi0.shape[-1] < B + 1:
        raise ValueError(f"phi0 {phi0.shape} is smaller than ({L}, {B + 1})")
    dev = resolve_device(device)
    U_t = torch.from_numpy(np.ascontiguousarray(U[..., : nt - 1, :L, : B + 1])).to(dev)
    phi_t = torch.from_numpy(np.ascontiguousarray(phi0[..., :L, : B + 1])).to(dev)
    return U_t, phi_t


def objective_from_params(name: str, params: Mapping, *, device=None, dtype=None):
    """The port's objective of problem ``name`` (a key of
    :data:`PROBLEM_PARAMS`) with the numeric parameters ``params`` (numbers
    or numpy arrays).  For ``"convolution"``, any of :data:`CONV_OPERATORS`
    in ``params`` replace the port's own operators (all four, or none); for
    ``"heat"``, :data:`HEAT_OPERATORS` (all six, or none) take the place of
    the port's own mesh and assembly; with ``solver_mode`` ``"cg"`` or
    ``"mg"`` in ``params``, :data:`HEAT_SPARSE_OPERATORS` and
    :data:`HEAT_ENGINE` (plus ``dof_perm`` and ``prolongations`` where
    given) build the port's sparse engine on them instead.  For the ODE
    problems an optional ``sweep_unroll`` (the JAX object's) is carried
    across."""
    if name not in PROBLEM_PARAMS:
        raise KeyError(f"no parameter set for problem {name!r}; "
                       f"known: {sorted(PROBLEM_PARAMS)}")
    if name == "fishing":
        return lvm_from_params(params, device=device, dtype=dtype)
    missing = [k for k in PROBLEM_PARAMS[name] if k not in params]
    if missing:
        raise KeyError(f"missing {name} parameters: {missing}")
    p = {k: np.asarray(params[k]) for k in PROBLEM_PARAMS[name]}
    nt, kw = int(p["nt"]), dict(device=device, dtype=dtype)
    if name == "doubletank":
        return _with_unroll(DTMObj(nt, k1=float(p["k1"]), k2=float(p["k2"]), c=p["c"],
                                   state0=p["state0"], **kw), params)
    if name == "vanderpol":
        return _with_unroll(VPOObj(nt, c=p["c"], state0=p["state0"], **kw), params)
    if name == "mixed":
        return _with_unroll(
            LVMMixedObj(nt, **{k: float(p[k]) for k in PROBLEM_PARAMS[name][1:9]},
                        v1=p["v1"], v2=p["v2"], state0=p["state0"], **kw), params)
    if name == "fuller":
        return _with_unroll(
            FullerObj(nt, state0=p["state0"], terminal_weight=float(p["terminal_weight"]),
                      terminal_frac=float(p["terminal_frac"]), **kw), params)
    if name == "heat":
        scalars = {k: float(p[k]) for k in PROBLEM_PARAMS["heat"][1:]}
        if str(params.get("solver_mode", "dense")) in ("cg", "mg"):
            return _sparse_heat(nt, params, scalars, kw)
        ops = _operators(params, HEAT_OPERATORS)
        if ops is None:
            return HeatObj(nt, **scalars, **kw)
        return HeatObj.from_operators(
            nt, Sinv=ops[0], M_invF=ops[1], M=ops[2], yd=ops[3], state0=ops[4],
            tau=float(ops[5]), **scalars, **kw)
    obj = ConvObj(nt, omega0=float(p["omega0"]), **kw)
    ops = _operators(params, CONV_OPERATORS)
    if ops is not None:
        obj.set_operators(*ops)
    return obj


def _sparse_heat(nt, params, scalars, kw):
    """A heat objective on the port's cg/mg engine from another package's
    host operators (:data:`HEAT_SPARSE_OPERATORS`, :data:`HEAT_ENGINE`)."""
    missing = [k for k in HEAT_SPARSE_OPERATORS + HEAT_ENGINE if k not in params]
    if missing:
        raise KeyError(f"missing sparse heat operators: {missing}")
    A, M, F, state0, tau = (params[k] for k in HEAT_SPARSE_OPERATORS)
    perm = params.get("dof_perm")
    state0 = np.asarray(state0)
    if perm is not None:  # held in the banded engine's order: back to assembly order
        state0 = state0[np.argsort(np.asarray(perm))]
    return HeatObj.from_sparse_operators(
        nt, A=A, M=M, F=np.asarray(F), state0=state0, tau=float(tau),
        solver=str(params["solver_mode"]), cg_iters=int(params["cg_iters"]),
        sparse_format=str(params["sparse_format"]), dof_perm=perm,
        prolongations=params.get("prolongations"), **scalars, **kw)


def _operators(params: Mapping, names):
    """The arrays ``params[name]`` for every name, or ``None`` if none is
    given; raises ``KeyError`` for a partial set."""
    given = [k for k in names if k in params]
    if not given:
        return None
    if len(given) != len(names):
        raise KeyError(f"give all of {names} or none, got {given}")
    return [np.asarray(params[k]) for k in names]
