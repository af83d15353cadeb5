"""Trust-region method (TRM) for integer optimal control with TV regularization.

Counterpart of ``mioc_tpu.solvers.trm`` (the reference's outer solver,
``multi-trust.jl:26-170``):

    min_u  f(u) + β·TV_p(u)    s.t.  u_i ∈ admissible level set

Each outer iteration computes ∇f once, builds the Bellman DP tables once
(``B = ⌊Δ⁰/Δt⌋`` fixed — the reference never grows the budget), and runs up to
``kmax`` inner accept/halve steps.  A halved trust region re-extracts the path
from the *same* tables (``multi-trust.jl:108-110``).  Termination: the DP
certifies stationarity of the trust-region linearized model (``pred ≤ 0``,
``multi-trust.jl:130-138``).

The solve runs where the objective lives (``obj.device``).  The accept/halve/
stop control flow stays on the host; on the card every DP build launches the
``dp_build`` kernel and every chase the ``chase`` kernel (through
``ops.bellman.build_tables``/``backtrack``), the ODE sweeps are PyTorch ops.
``dp_backend="temporal"`` builds with the banded temporal DP
(:func:`~mioc_tpu_torch.parallel.temporal.temporal_tables`, tensor code) and
chases with :func:`~mioc_tpu_torch.parallel.temporal.temporal_backtrack`
instead, on either device.  ``dp_backend="sharded"`` builds with the
level-sharded DP (:func:`~mioc_tpu_torch.parallel.shard_dp.build_tables_sharded`,
tensor code and one collective per step, over ``par.mesh`` or every rank of
the world on the ``level`` axis) and chases its padded tables with the
ordinary chase: the ``chase`` kernel on the card.  Every rank of the mesh
runs the same solve.

Documented divergences from the reference (all edge-path only, kept from the
JAX package):
  * non-finite trial objectives (e.g. vanderpol explicit-Euler overflow) are
    treated as rejected steps instead of propagating NaN through comparisons;
  * if an outer iteration exhausts ``kmax`` without an accepted step, the
    iterate is restored to the last accepted control before the next gradient
    (the reference would differentiate at the rejected candidate);
  * ``p = inf`` uses the honest ``max_m |Δ_m|`` jump cost by default — set
    ``compat_pinf=True`` for the reference's uniform-cost behaviour.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..ops.bellman import backtrack, build_tables, max_budget_use, stage_tables
from ..ops.levels import jump_cost_table
from ..ops.tv import tv_p
from ..utils import trace
from ..utils.checks import check_nan
from ..utils.init import rand_func
from ..utils.logging import IterationLog

__all__ = ["TRMParameters", "TRMResult", "trm_solve", "TRM", "dp_route"]


def dp_route(dp_backend: Optional[str], use_pallas: Optional[bool], device) -> str:
    """The DP route of a solve on ``device``, from the JAX package's two
    spellings: ``dp_backend`` where given, else ``use_pallas``.

    * ``"pallas"``, ``True`` or neither: the device's route, the CUDA
      kernels on the card and the plain versions on the CPU; returns
      ``"pallas"``;
    * ``"scan"`` or ``False``: the plain versions, which the CPU runs
      (returns ``"scan"``); on the card they raise ``ValueError``, since no
      solve there runs them;
    * ``"temporal"``: the banded temporal DP on either device (returns
      ``"temporal"``);
    * ``"sharded"``: the level-sharded build over a mesh of ranks on either
      device, its padded tables chased by the device's chase (returns
      ``"sharded"``); any other name: ``ValueError``.

    All routes give the same chases; ``"pallas"`` and ``"scan"`` the same
    tables, bit for bit."""
    name = dp_backend
    if name is None:
        name = "scan" if use_pallas is False else "pallas"
    if name not in ("pallas", "scan", "temporal", "sharded"):
        raise ValueError(f"Unknown dp_backend {name!r}")
    if name == "scan" and torch.device(device).type == "cuda":
        raise ValueError("dp_backend='scan' (use_pallas=False) selects the plain versions, "
                         "which no solve runs on the card; the CUDA kernels are its route")
    return name


@dataclass
class TRMParameters:
    """Algorithmic parameters (``TRM_parameters``, ``multi-trust.jl:26-34``).

    ``use_pallas`` and ``dp_backend`` take the JAX package's values and
    choose the DP route by :func:`dp_route`: ``"pallas"``, ``True`` or
    neither run the CUDA kernels on the card and the plain versions on the
    CPU; ``"scan"`` or ``False`` the plain versions, on the CPU only;
    ``"temporal"`` the banded temporal DP (``parallel.temporal``);
    ``"sharded"`` the level-sharded build (``parallel.shard_dp``) over
    ``mesh``, a :class:`~mioc_tpu_torch.parallel.device_mesh.Mesh` of ranks
    (default: every rank of the world on the ``level`` axis).
    """

    beta: float = 0.001      # weight of the TV_p term (β)
    p: float = 1             # TV norm parameter; inf for the max norm
    delta0: float = 1.0      # initial trust-region radius (Δ⁰)
    sigma: float = 0.5       # required ared/pred ratio (σ)
    kmax: int = 40           # max inner iterations (trust-region halvings)
    maxiter: int = 1000      # max outer iterations
    log: bool = False        # print the iteration table
    compat_pinf: bool = False  # reproduce the reference's p=inf jump cost
    use_pallas: Optional[bool] = None  # the DP route (dp_route): None/True kernels
    dp_backend: Optional[str] = None   # "pallas" | "scan" | "temporal" | "sharded"
    mesh: Optional[object] = None      # mesh of ranks for dp_backend="sharded"
                                       # (default: all ranks on the level axis)
    metrics_path: Optional[str] = None  # jsonl per-iteration metrics
    checkpoint_path: Optional[str] = None  # npz snapshot per outer iteration
    resume_from: Optional[str] = None   # restart from a checkpoint npz
    profile_dir: Optional[str] = None   # torch.profiler chrome trace directory
    debug_checks: bool = False          # assert admissibility + budget per step


@dataclass
class TRMResult:
    """Solve outcome plus observability counters/timers."""

    J: float                 # final f + β·TV (the reference's return value)
    u: np.ndarray            # accepted control, (nt, nx)
    x_final: np.ndarray      # objective's final iterate (reference leaves the
                             # last DP candidate in obj.x; kept for parity)
    converged: bool          # stopped via the pred ≤ 0 certificate
    iterations: int          # outer iterations executed
    inner_steps: int         # total inner accept/halve steps
    f_evals: int
    df_evals: int
    tv: float                # TV_p of the accepted control
    f: float                 # smooth part of the objective at the accepted u
    dp_builds: int
    timings: dict = field(default_factory=dict)  # seconds per phase


def _profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def trm_solve(obj, par: TRMParameters = None, x0=None, seed: Optional[int] = None) -> TRMResult:
    """Run the TRM on ``obj`` (a LazyObjective with an admissible set) on
    ``obj.device``."""
    f0, df0 = obj.f_evals, obj.df_evals
    with trace.span("solve") as sp:
        res = _trm_solve(obj, par or TRMParameters(), x0, seed)
        # This solve's evaluations: the result's counters are the objective's.
        sp.set(f_evals=res.f_evals - f0, df_evals=res.df_evals - df0)
    return res


def _trm_solve(obj, par: TRMParameters, x0, seed) -> TRMResult:
    route = dp_route(par.dp_backend, par.use_pallas, obj.device)
    nt, dt = obj.nt, obj.tau
    adm = obj.admissible
    if adm is None or adm.L == 0:
        raise ValueError("Objective has no admissible integer level combinations.")
    if not np.allclose(adm.levels, np.round(adm.levels)):
        raise ValueError(
            "Admissible levels must be integer-valued: the DP budget axis "
            "tracks the exact L1 deviation (HelpFunctions.jl:37)."
        )
    dev, dtype = obj.device, obj.dtype
    cuda = dev.type == "cuda"
    levels = torch.as_tensor(adm.levels, dtype=dtype, device=dev)
    jump = torch.as_tensor(
        jump_cost_table(adm.levels, par.p, beta=par.beta, compat_pinf=par.compat_pinf),
        dtype=dtype, device=dev,
    )

    if x0 is None and par.resume_from:
        from ..utils.io import load_checkpoint

        x0 = load_checkpoint(par.resume_from)["u"]
    if x0 is None:
        x0 = rand_func(obj, seed=seed)
    else:
        from ..utils.checks import assert_admissible

        assert_admissible(x0, adm)
    obj.x = obj.as_control(x0)
    u_old = obj.x

    B = int(math.floor(par.delta0 / dt))
    smax = max_budget_use(adm.levels)
    if route == "temporal":
        from ..parallel.temporal import temporal_backtrack, temporal_tables

        def dp_build(stage, btilde):
            phis = temporal_tables(stage, btilde, jump, B, smax)
            return (check_nan(phis, "the temporal DP tables"),)

        def dp_backtrack(tables, btilde, B_new):
            return temporal_backtrack(tables[0], btilde, jump, levels, B_new)
    elif route == "sharded":
        # Level-axis tensor parallelism: the DP's min-plus contraction is
        # partitioned over the mesh's ``level`` axis; the chases (halvings
        # included) run on the returned replicated padded tables.
        from ..parallel.device_mesh import default_level_mesh
        from ..parallel.shard_dp import build_tables_sharded, pad_level_axis

        mesh = par.mesh or default_level_mesh(dev.type)
        D = mesh.shape["level"]

        def dp_build(stage, btilde):
            U, phi0 = build_tables_sharded(stage, btilde, jump, B, smax, mesh)
            btilde_p = pad_level_axis(stage, btilde, jump, D, B)[1]
            return U, check_nan(phi0, "the DP table phi0"), btilde_p

        def dp_backtrack(tables, btilde, B_new):
            U, phi0, btilde_p = tables
            return backtrack(U, phi0, btilde_p, levels, B_new)
    else:
        def dp_build(stage, btilde):
            U, phi0 = build_tables(stage, btilde, jump, B, smax)
            return U, check_nan(phi0, "the DP table phi0")

        def dp_backtrack(tables, btilde, B_new):
            return backtrack(*tables, btilde, levels, B_new)

    timers = {"dp": 0.0, "backtrack": 0.0, "f": 0.0, "df": 0.0}
    log = IterationLog(enabled=par.log, metrics_path=par.metrics_path)

    def timed(key, fn, *args):
        """``fn(*args)`` timed into ``timers[key]``; on the card it ends in a
        synchronise, so the timer holds the phase's device time, not its
        enqueue."""
        t0 = time.perf_counter()
        out = fn(*args)
        if cuda:
            torch.cuda.synchronize(dev)
        timers[key] += time.perf_counter() - t0
        return out

    def build(grad, u_old):
        with trace.span("trm.stage"):
            stage, btilde = stage_tables(grad, u_old, levels, dt)
        return dp_build(stage, btilde), btilde

    J = math.inf
    J_old = timed("f", obj.eval_f_)
    TV_old = float(tv_p(u_old, par.p))
    log.header()
    log.row(0, 0, par.delta0, J_old + par.beta * TV_old, 0.0, 0.0, "Initial Value")

    stop = False
    iteration = 1
    inner_total = 0
    dp_builds = 0
    u = u_old

    profiler = _profiler(dev) if par.profile_dir else None
    if profiler is not None:
        profiler.__enter__()

    try:
        while not stop and iteration <= par.maxiter:
            with trace.span("trm.outer"):
                delta_k = par.delta0
                k = 1
                ared, pred = 0.0, 1.0
                halved = False
                TV_old = float(tv_p(u_old, par.p))

                timed("df", obj.eval_df_)
                grad = obj.df

                btilde = tables = None

                while ared < par.sigma * pred and k <= par.kmax:
                    if halved:
                        B_new = int(math.floor(delta_k / dt))
                        u, _ = timed("backtrack", dp_backtrack, tables, btilde, B_new)
                    else:
                        tables, btilde = timed("dp", build, grad, u_old)
                        dp_builds += 1
                        u, _ = timed("backtrack", dp_backtrack, tables, btilde, B)

                    if par.debug_checks:
                        from ..utils.checks import assert_admissible, check_budget

                        assert_admissible(u, adm)
                        check_budget(u, u_old, B if not halved else B_new)

                    # pred / ared (multi-trust.jl:117-127)
                    int_val = dt * float(torch.sum(grad * (u_old - u)))
                    TV_new = float(tv_p(u, par.p))
                    obj.x = u
                    J_new = timed("f", obj.eval_f_)

                    pred = int_val + par.beta * (TV_old - TV_new)
                    ared = J_old - J_new + par.beta * (TV_old - TV_new)
                    if not math.isfinite(J_new):
                        ared = -math.inf  # reject blown-up trials (unstable ODEs)

                    inner_total += 1

                    if pred <= 0:
                        # DP certifies stationarity of the linearized model.
                        J = J_old
                        stop = True
                        log.row(iteration, k, delta_k, J + par.beta * TV_old, pred, ared,
                                "optimal solution found")
                        break
                    elif ared < par.sigma * pred:
                        log.row(iteration, k, delta_k, J_old + par.beta * TV_old, pred, ared,
                                "bad step, halved")
                        delta_k /= 2.0
                        halved = True
                    else:
                        u_old = u
                        J_old = J_new
                        TV_old = TV_new
                        J = J_new
                        log.row(iteration, k, delta_k, J + par.beta * TV_new, pred, ared,
                                "good step")
                    k += 1

                if not stop and bool(torch.any(u != u_old)):
                    # kmax exhausted with a rejected candidate: restore the accepted
                    # iterate before the next gradient (divergence from the reference,
                    # which differentiates at the rejected candidate; see module doc).
                    obj.x = u_old
                    J_old = timed("f", obj.eval_f_)

                log.metrics(
                    iteration=iteration,
                    J=J_old + par.beta * TV_old,
                    f=J_old,
                    tv=TV_old,
                    pred=pred,
                    ared=ared,
                    inner=k - 1,
                    f_evals=obj.f_evals,
                    df_evals=obj.df_evals,
                    dp_s=timers["dp"],
                    f_s=timers["f"],
                    df_s=timers["df"],
                )
                if par.checkpoint_path:
                    from ..utils.io import save_checkpoint

                    save_checkpoint(
                        par.checkpoint_path,
                        u=u_old.cpu().numpy(),
                        delta=delta_k,
                        iteration=iteration,
                        J=J_old,
                        tv=TV_old,
                    )
                iteration += 1
    finally:
        log.close()
        if profiler is not None:
            profiler.__exit__(None, None, None)
    if profiler is not None:
        os.makedirs(par.profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(par.profile_dir, "trm_trace.json"))

    # Final gradient for reporting/plotting (multi-trust.jl:166-167).
    timed("df", obj.eval_df_)

    x_final = obj.x.cpu().numpy()
    return TRMResult(
        J=J + par.beta * float(tv_p(obj.x, par.p)),
        u=u_old.cpu().numpy(),
        x_final=x_final,
        converged=stop,
        iterations=iteration - 1,
        inner_steps=inner_total,
        f_evals=obj.f_evals,
        df_evals=obj.df_evals,
        tv=float(tv_p(u_old, par.p)),
        f=J_old if math.isfinite(J_old) else float("nan"),
        dp_builds=dp_builds,
        timings=dict(timers),
    )


def TRM(obj, par: TRMParameters = None, x0=None, seed: Optional[int] = None) -> float:
    """Reference-style entry point: returns ``f(u) + β·TV_p(u)``
    (``multi-trust.jl:53-170``; note the reference evaluates the TV term at
    the final candidate iterate, reproduced here via ``x_final``)."""
    return trm_solve(obj, par, x0=x0, seed=seed).J
