"""Scenario/multistart batch parallelism.

Counterpart of ``mioc_tpu.parallel.batch``:

* :func:`make_ode_trm_step` — one full TRM inner step for a batch of
  controls at once: a batched forward and adjoint, batched stage tables, the
  batched DP build, the batched chase at ``B`` for every start and a batched
  forward of the candidates (accept/halve logic stays with the caller);
* :func:`multistart_solve` — full host-loop TRM solves from ``n_starts``
  starts, returning the best.

With a :class:`~.device_mesh.Mesh` the step runs SPMD on every rank: each
rank takes its block of the starts along ``"batch"``, and where the mesh's
``"level"`` axis is larger than 1 the DP build inside the block is the
level-sharded :func:`~.shard_dp.dp_body` on the padded stage tables; the
outputs are gathered over ``"batch"``, so every rank returns the whole
batch (the JAX package's sharded outputs, read whole).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.bellman import (
    backtrack_batched,
    build_tables_batched,
    max_budget_use,
    stage_tables,
)
from ..ops.levels import jump_cost_table
from ..ops.tv import fold_sum, tv_rows
from .shard_dp import dp_body, jump_block, pad_level_axis

__all__ = ["make_ode_trm_step", "multistart_solve"]


def make_ode_trm_step(obj, *, beta: float, p, delta0: float, mesh=None,
                      compat_pinf: bool = False):
    """Build ``step(u_batch) -> (u_new, J_new, J_model)`` for an ODE
    objective on ``obj.device``.  ``u_batch`` is ``(S, nt, nx)``;
    ``J_model[s]`` is the DP's model objective ``τ·Σ ∇f·u_new + β·TV``.
    With a ``mesh``, ``S`` must be divisible by its ``"batch"`` size (else
    ``ValueError``) and every rank of the mesh must call the step."""
    adm = obj.admissible
    dev, dtype = obj.device, obj.dtype
    levels = torch.as_tensor(adm.levels, dtype=dtype, device=dev)
    jump = torch.as_tensor(
        jump_cost_table(adm.levels, p, beta=beta, compat_pinf=compat_pinf),
        dtype=dtype, device=dev)
    smax = max_budget_use(adm.levels)
    B = int(np.floor(delta0 / obj.tau))
    tau = obj.tau
    lev = mesh.shape["level"] if mesh is not None else 1
    if lev > 1:
        block = jump_block(jump, mesh)
        # Levels padded by zero rows where the chase gathers them.
        levels = torch.cat([levels, levels.new_zeros(block.shape[0] - adm.L, adm.M)])

    def dp_build(stage, btilde):
        if lev == 1:
            return (*build_tables_batched(stage, btilde, jump, B, smax), btilde)
        stage_p, btilde_p, _, _ = pad_level_axis(stage, btilde, jump, lev, B)
        return (*dp_body(stage_p, btilde_p, block, B, mesh), btilde_p)

    def one(u):
        _, ys = obj._forward_batch(u)
        grad, _ = obj._adjoint_batch(u, ys)
        stage, btilde = stage_tables(grad, u, adm.levels, tau)
        u_new, _ = backtrack_batched(*dp_build(stage, btilde), levels, B)
        f_new, _ = obj._forward_batch(u_new)
        model = tau * fold_sum((grad * u_new).flatten(-2)) + beta * tv_rows(u_new, p)
        return u_new, f_new, model

    def step(u_batch):
        u = torch.as_tensor(u_batch, dtype=dtype, device=dev)
        if mesh is None:
            return one(u)
        nb = mesh.shape["batch"]
        if u.shape[0] % nb:
            raise ValueError(f"{u.shape[0]} scenarios are not divisible by the mesh's "
                             f"batch axis of {nb}")
        Sb = u.shape[0] // nb
        b = mesh.coord("batch")
        return tuple(mesh.all_gather(t, "batch").flatten(0, 1)
                     for t in one(u[b * Sb:(b + 1) * Sb]))

    return step


def multistart_solve(obj_factory, n_starts: int, par=None, seed: int = 0,
                     x0s: Optional[np.ndarray] = None):
    """Run full host-loop TRM solves from ``n_starts`` starts (``x0s`` or
    ``rand_func(obj, seed=seed + s)``); return ``(best_result,
    all_results)``.  ``obj_factory`` is a callable that makes a fresh
    objective, or one objective reused for every start."""
    from ..solvers.trm import TRMParameters, trm_solve
    from ..utils.init import rand_func

    par = par or TRMParameters()
    results = []
    for s in range(n_starts):
        obj = obj_factory() if callable(obj_factory) else obj_factory
        x0 = x0s[s] if x0s is not None else rand_func(obj, seed=seed + s)
        results.append(trm_solve(obj, par, x0=x0))
    best = min(results, key=lambda r: r.J)
    return best, results
