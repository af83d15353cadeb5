"""Device-resident TRM: the accept/halve loop on the objective's device, with
a start axis for batched multistart.

Counterpart of ``mioc_tpu.solvers.trm_device``.  The JAX package runs the
whole loop as ``lax.while_loop``s inside one ``jit`` and batches starts with
``jax.vmap``.  PyTorch has neither, so here:

* the carry is a set of tensors on the device with an explicit start axis S
  (a single solve is S = 1): ``u_old``, the time-major state cache
  ``ys_old (nt, S, ny)``, ``J_old``, ``TV_old``, the last candidate
  ``u_cand``, ``J_ret``, ``stop`` and the counters;
* every decision is a ``torch.where`` select, so a start that has stopped,
  or whose inner loop has exited, keeps its carry and counters unchanged —
  what ``vmap`` of a ``while_loop`` does;
* the host reads back only the small flag tensor that ends a Python loop:
  once per outer iteration and once per step of the sequential inner loop.
  ``outer_unroll``/``inner_unroll`` run that many guarded steps per read.

Per-start arithmetic does not depend on the batch: the sweeps, ``tv_rows``
and ``iv_rows`` compute every row with elementwise ops, fixed pairwise folds
and fixed-shape product chunks (``ops.rows``), so a start of a multistart,
or a trial of a wave, has the bits of the single evaluation, and the
speculative wave makes the sequential loop's decisions.

DP route: the tables are built and chased where the tensors are
(``use_pallas``/``dp_backend`` as :func:`~.trm.dp_route` reads them).  On
the card a single solve builds with ``dp_build`` and chases its sequential
inner loop with ``chase`` and its trial wave (``wave_chase="vmap"``) with
``chase_batched`` on the tables expanded K-fold (stride 0, no copy); a
multistart builds with ``dp_build_batched``, chases its inner loop with
``chase_batched`` (a cap per start) and its wave with ``chase_trials`` (S
table sets of K caps each, whichever ``wave_chase``).  On the CPU the same
calls take the plain versions.  ``dp_backend="sharded"`` builds with the
level-sharded DP (``parallel.shard_dp``, one collective per step for all
the starts) and chases its padded tables with the same chases.

With a mesh of ranks (``parallel.device_mesh``), every rank runs this loop
on its own tensors: a multistart's starts are split over ``"batch"`` and
the result gathered over it at the end; the ranks of one ``"level"`` group
hold the same starts and, their arithmetic being deterministic, make the
same decisions, so they build, and meet in the build's collectives, the same
number of times.
"""

from __future__ import annotations

import math
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.bellman import (
    backtrack,
    backtrack_batched,
    backtrack_trials,
    build_tables,
    build_tables_batched,
    max_budget_use,
    stage_tables,
)
from ..ops.levels import jump_cost_table
from ..ops.tv import iv_rows, tv_rows
from ..utils import trace
from ..utils.init import rand_func
from .trm import _profiler, dp_route

__all__ = ["DeviceTRMResult", "make_device_trm", "trm_solve_device",
           "multistart_solve_device"]


class DeviceTRMResult(NamedTuple):
    """Solve outcome as numpy arrays (0-d for a single solve, a leading start
    axis for a multistart)."""

    u: np.ndarray          # accepted control (nt, nx)
    x_final: np.ndarray    # last candidate iterate (reference's obj.x)
    J: np.ndarray          # f + β·TV at the reference's return convention
    f: np.ndarray          # smooth objective at the accepted control
    tv: np.ndarray         # TV_p of the accepted control
    converged: np.ndarray
    iterations: np.ndarray
    inner_steps: np.ndarray
    f_evals: np.ndarray
    # One adjoint sweep / one DP build per outer body.  The host loop's
    # df_evals is one higher: it computes a final reporting gradient after
    # the loop (multi-trust.jl:166-167) that the device loop has no use for.
    df_evals: np.ndarray
    dp_builds: np.ndarray


class _Carry(NamedTuple):
    u_old: torch.Tensor        # (S, nt, nx)
    ys_old: torch.Tensor       # (nt, S, ny) (ODE) or (nt+1, S, N) (PDE): the
                               # state cache at u_old, time-major, or None
                               # for an objective without a state
    J_old: torch.Tensor        # (S,)
    TV_old: torch.Tensor       # (S,)
    u_cand: torch.Tensor       # (S, nt, nx)
    J_ret: torch.Tensor        # (S,), +inf until an accept or the certificate
    stop: torch.Tensor         # (S,) bool
    it: torch.Tensor           # (S,) int32, starts at 1
    inner_total: torch.Tensor  # (S,) int32
    f_evals: torch.Tensor      # (S,) int32
    df_evals: torch.Tensor     # (S,) int32
    dp_builds: torch.Tensor    # (S,) int32


class _Inner(NamedTuple):
    k: torch.Tensor            # (S,) int32
    delta: torch.Tensor        # (S,) objective dtype
    ared: torch.Tensor         # (S,)
    pred: torch.Tensor         # (S,)
    done: torch.Tensor         # (S,) bool
    c: _Carry


def _select(mask, new, old):
    """Field-wise ``torch.where(mask, new, old)`` over a carry, with the
    start axis of ``mask (S,)`` on axis 1 of ``ys_old`` and axis 0 elsewhere.
    A select, never a product, so NaNs of masked starts cannot leak."""
    out = []
    for name, n, o in zip(old._fields, new, old):
        if isinstance(o, tuple):
            out.append(_select(mask, n, o))
            continue
        if o is None:  # no state cache (an objective without a state)
            out.append(None)
            continue
        shape = [1] * o.dim()
        shape[1 if name == "ys_old" else 0] = -1
        out.append(torch.where(mask.view(shape), n, o))
    return type(old)(*out)


def _any(flags, what: str) -> bool:
    """The one host read that ends a Python loop (``what``: ``"outer"`` or
    ``"inner"``)."""
    with trace.span("trm.read", what=what):
        return bool(flags.any())


def make_device_trm(obj, par, use_pallas: Optional[bool] = None,
                    outer_chunk=None, speculative: bool = False,
                    dp_backend: Optional[str] = None, mesh=None,
                    wave_chase: str = "vmap", outer_unroll: int = 1,
                    inner_unroll: int = 1):
    """Build ``run(x0s, batched, progress=None, on_segment=None) -> carry``
    for ``obj`` with parameters ``par`` (a :class:`~.trm.TRMParameters`).
    ``x0s`` is ``(S, nt, nx)`` on the objective's device; ``batched=False``
    means a single solve (S = 1), which builds and chases one table set.
    ``run.finalize(carry)`` gives the :class:`DeviceTRMResult` arrays as
    tensors.

    ``outer_chunk`` (``None``, an int or ``"auto"``) sets how often
    ``progress(it, seconds)`` and ``on_segment(carry)`` run, by the probe
    rule of the JAX package; results are identical for every value.

    ``speculative=True`` replaces the sequential inner accept/halve loop with
    one trial wave per outer iteration over the static halving schedule
    ``B_k = ⌊δ₀/2^{k-1}/Δt⌋`` (floored in the objective's dtype, down to 0,
    at most ``kmax`` trials): the K trials are chased from the same tables,
    evaluated in one batched forward sweep, and the first trial that meets
    the sequential loop's exit condition is selected.  The counters are the
    sequential-equivalent ones.  ``wave_chase`` selects a single solve's
    wave chase: ``"vmap"`` (the single-solve default) chases K views of the
    tables with the batched chase; ``"trials"`` (the multistart form) the K
    caps with the trial-wave chase.  A wave of S > 1 starts chases S table
    sets of K caps each with the trial-wave chase under either name, with
    no copy of a table.

    ``outer_unroll``/``inner_unroll`` run that many guarded steps between
    host reads (a guarded step selects the old carry where its condition
    fails, so results are bit-identical to 1).

    ``use_pallas`` and ``dp_backend`` (default: ``par``'s) choose the DP
    route by :func:`~.trm.dp_route`, in the JAX package's argument order.
    ``dp_backend="temporal"`` runs the ordinary route here, as the JAX
    package's ``make_device_trm`` does (it special-cases only
    ``"sharded"``): the kernels on the card, the plain versions on the CPU.
    ``dp_backend="sharded"`` builds every table set with the level-sharded
    DP over ``mesh`` (default: ``par.mesh``, else every rank of the world on
    the ``level`` axis) and chases the padded tables with the levels padded
    by zero rows; every rank of the mesh's ``level`` group must run the same
    solve.  Without ``"sharded"`` the mesh matters only to
    :func:`multistart_solve_device`'s split of the starts."""
    route = dp_route(par.dp_backend if dp_backend is None else dp_backend,
                     par.use_pallas if use_pallas is None else use_pallas, obj.device)
    if wave_chase not in ("vmap", "trials"):
        raise ValueError(f"wave_chase must be 'vmap' or 'trials', got {wave_chase!r}")
    adm = obj.admissible
    if adm is None or adm.L == 0:
        raise ValueError("Objective has no admissible integer level combinations.")
    levels_np = np.asarray(adm.levels)
    if not np.allclose(levels_np, np.round(levels_np)):
        raise ValueError("Admissible levels must be integer-valued.")
    dev, dtype = obj.device, obj.dtype
    dt = obj.tau
    beta, sigma, p = float(par.beta), float(par.sigma), float(par.p)
    kmax, maxiter = int(par.kmax), int(par.maxiter)
    delta0 = float(par.delta0)
    B = int(math.floor(delta0 / dt))
    smax = max_budget_use(levels_np)
    levels = torch.as_tensor(levels_np, dtype=dtype, device=dev)
    jump = torch.as_tensor(
        jump_cost_table(levels_np, p, beta=beta, compat_pinf=par.compat_pinf),
        dtype=dtype, device=dev)
    levels_bt = levels  # the levels the chases gather from
    if route == "sharded":
        from ..parallel.device_mesh import default_level_mesh
        from ..parallel.shard_dp import build_tables_sharded, pad_level_axis

        mesh = mesh if mesh is not None else (par.mesh or default_level_mesh(dev.type))
        D = mesh.shape["level"]
        Lp = -(-len(levels_np) // D) * D
        levels_bt = torch.cat([levels, levels.new_zeros(Lp - len(levels_np), levels.shape[1])])

    # Static speculative halving schedule, computed in the objective dtype's
    # arithmetic: the sequential loop floors a carried δ of that dtype, and a
    # Python-float floor could differ by 1 where δ/Δt is near an integer.
    sdtype = np.float64 if dtype == torch.float64 else np.float32
    sched = []
    d, dt_s = np.asarray(delta0, sdtype), np.asarray(dt, sdtype)
    for _ in range(kmax):
        sched.append(int(np.floor(d / dt_s)))
        if sched[-1] == 0:
            break
        d = (d / sdtype(2.0)).astype(sdtype)
    K = len(sched)
    B_sched = torch.tensor(sched, dtype=torch.int32, device=dev)

    def build(grad, u_old, batched):
        """Stage tables and the DP build; single solves drop the start axis."""
        if not batched:
            grad, u_old = grad[0], u_old[0]
        with trace.span("trm.stage"):
            stage, btilde = stage_tables(grad, u_old, levels, dt)
        if route == "sharded":
            U, phi0 = build_tables_sharded(stage, btilde, jump, B, smax, mesh)
            return U, phi0, pad_level_axis(stage, btilde, jump, D, B)[1]
        if not batched:
            return (*build_tables(stage, btilde, jump, B, smax), btilde)
        return (*build_tables_batched(stage, btilde, jump, B, smax), btilde)

    def chase_seq(U, phi0, btilde, caps, batched):
        """One candidate per start at ``caps (S,)`` → ``(S, nt, nx)``."""
        if not batched:
            return backtrack(U, phi0, btilde, levels_bt, caps[0])[0][None]
        return backtrack_batched(U, phi0, btilde, levels_bt, caps)[0]

    def chase_wave(U, phi0, btilde, S, batched):
        """The K trials of every start → ``(S, K, nt, nx)``."""
        if not batched:
            U, phi0, btilde = U[None], phi0[None], btilde[None]
        if wave_chase == "trials" or S > 1:  # S table sets of K caps each
            return backtrack_trials(U, phi0, btilde, levels_bt, B_sched.expand(S, K))[0]
        # K views of one table set (start stride 0)
        tables = [t[0].expand(K, *t.shape[1:]) for t in (U, phi0, btilde)]
        return backtrack_batched(*tables, levels_bt, B_sched)[0][None]

    def init_carry(x0s):
        S = x0s.shape[0]
        f0, ys0 = obj._forward_batch(x0s)
        with trace.span("trm.tv"):
            tv0 = tv_rows(x0s, p)
        ones = torch.ones(S, dtype=torch.int32, device=dev)
        zeros = torch.zeros(S, dtype=torch.int32, device=dev)
        return _Carry(x0s, ys0, f0, tv0, x0s, torch.full_like(f0, math.inf),
                      torch.zeros(S, dtype=torch.bool, device=dev), ones, zeros,
                      ones, zeros, zeros)

    def decide(pred, ared):
        optimal = pred <= 0  # the DP's stationarity certificate
        good = (~optimal) & (ared >= sigma * pred)
        return optimal, good

    def ared_of(J_old, J_new, TV_old, TV_new):
        return torch.where(torch.isfinite(J_new),
                           J_old - J_new + beta * (TV_old - TV_new), -math.inf)

    def gradient_and_tables(c, batched):
        """One ∇f (adjoint sweep) and one DP build per outer body."""
        grad, _ = obj._adjoint_batch(c.u_old, c.ys_old)
        tables = build(grad, c.u_old, batched)
        return grad, tables, c._replace(df_evals=c.df_evals + 1,
                                        dp_builds=c.dp_builds + 1)

    def accept(c, u, ys_new, J_new, TV_new, optimal, good):
        """Accept ``u`` where good (multi-trust.jl:148-157); stop where the
        certificate fires; the candidate iterate (the reference's obj.x) is
        always ``u``."""
        return c._replace(
            u_old=torch.where(good[:, None, None], u, c.u_old),
            ys_old=(None if ys_new is None
                    else torch.where(good[None, :, None], ys_new, c.ys_old)),
            J_old=torch.where(good, J_new, c.J_old),
            TV_old=torch.where(good, TV_new, c.TV_old),
            u_cand=u,
            J_ret=torch.where(optimal, c.J_old, torch.where(good, J_new, c.J_ret)),
            stop=c.stop | optimal)

    def outer_body_speculative(c, batched):
        S = c.u_old.shape[0]
        grad, (U, phi0, btilde), c = gradient_and_tables(c, batched)
        us = chase_wave(U, phi0, btilde, S, batched)          # (S, K, nt, nx)
        with trace.span("trm.tv"):
            int_vals = dt * iv_rows(grad, c.u_old, us)         # (S, K)
            TV_news = tv_rows(us, p)
        J_news, ys_b = obj._forward_batch(us.reshape(S * K, *us.shape[2:]))
        J_news = J_news.view(S, K)
        pred_k = int_vals + beta * (c.TV_old[:, None] - TV_news)
        ared_k = ared_of(c.J_old[:, None], J_news, c.TV_old[:, None], TV_news)
        optimal_k, good_k = decide(pred_k, ared_k)
        # The sequential loop leaves trial k on optimal|good, or when
        # ared < σ·pred is False — which differs only for NaN, where it
        # exits WITHOUT accepting.
        exit_k = optimal_k | good_k | ~(ared_k < sigma * pred_k)
        has = exit_k.any(1)
        first = torch.argmax(exit_k.to(torch.int32), 1)       # first True
        sel = torch.where(has, first, torch.full_like(first, K - 1))
        rows = torch.arange(S, device=dev)
        # ys is time-major, rows on axis 1: (nt, S·K, ny) for an ODE, (nt+1,
        # S·K, N) for a PDE (rows sliced from a padded buffer: splitting axis
        # 1 keeps its stride, so the view holds).
        ys_new = None if ys_b is None else ys_b.view(ys_b.shape[0], S, K, -1)[:, rows, sel]
        c = accept(c, us[rows, sel], ys_new, J_news[rows, sel], TV_news[rows, sel],
                   has & optimal_k[rows, sel], has & good_k[rows, sel])
        # Sequential-equivalent counters: trials 1 … sel.
        n_trials = sel.to(torch.int32) + 1
        return c._replace(it=c.it + 1, inner_total=c.inner_total + n_trials,
                          f_evals=c.f_evals + n_trials)

    def inner_cond(t):
        return (~t.done) & (t.ared < sigma * t.pred) & (t.k <= kmax)

    def inner_body(t, tables, grad, batched):
        c = t.c
        caps = torch.floor(t.delta / dt).to(torch.int32)
        u = chase_seq(*tables, caps, batched)                  # (S, nt, nx)
        with trace.span("trm.tv"):
            int_val = dt * iv_rows(grad, c.u_old, u[:, None])[:, 0]
            TV_new = tv_rows(u, p)
        J_new, ys_new = obj._forward_batch(u)
        pred = int_val + beta * (c.TV_old - TV_new)
        ared = ared_of(c.J_old, J_new, c.TV_old, TV_new)
        optimal, good = decide(pred, ared)
        c = accept(c, u, ys_new, J_new, TV_new, optimal, good)
        c = c._replace(inner_total=c.inner_total + 1, f_evals=c.f_evals + 1)
        return _Inner(t.k + 1, torch.where(good | optimal, t.delta, t.delta / 2.0),
                      ared, pred, t.done | optimal | good, c)

    def outer_body(c, batched, active):
        S = c.u_old.shape[0]
        grad, tables, c = gradient_and_tables(c, batched)
        # Starts whose outer step is masked out run no inner steps: their
        # result is discarded by the outer select anyway.
        t = _Inner(torch.ones(S, dtype=torch.int32, device=dev),
                   torch.full((S,), delta0, dtype=dtype, device=dev),
                   torch.zeros(S, dtype=dtype, device=dev),
                   torch.ones(S, dtype=dtype, device=dev), ~active, c)
        while _any(inner_cond(t), "inner"):
            for _ in range(inner_unroll):
                t = _select(inner_cond(t), inner_body(t, tables, grad, batched), t)
        return t.c._replace(it=t.c.it + 1)

    def run_outer(c, it_hi, batched):
        def outer_cond(c):
            return (~c.stop) & (c.it <= it_hi)

        while _any(outer_cond(c), "outer"):
            for _ in range(outer_unroll):
                with trace.span("trm.outer"):
                    act = outer_cond(c)
                    cn = (outer_body_speculative(c, batched) if speculative
                          else outer_body(c, batched, act))
                    c = _select(act, cn, c)
        return c

    def finalize(c):
        # Reference return convention: J_accepted + β·TV(final candidate)
        # (multi-trust.jl:169 evaluates TV on obj.x, the last DP candidate).
        with trace.span("trm.tv"):
            tv_cand = tv_rows(c.u_cand, p)
        return DeviceTRMResult(
            u=c.u_old, x_final=c.u_cand, J=c.J_ret + beta * tv_cand,
            f=c.J_old, tv=c.TV_old, converged=c.stop, iterations=c.it - 1,
            inner_steps=c.inner_total, f_evals=c.f_evals, df_evals=c.df_evals,
            dp_builds=c.dp_builds)

    def run(x0s, batched, progress=None, on_segment=None):
        x0s = torch.as_tensor(x0s, dtype=dtype, device=dev)
        if not batched and x0s.shape[0] != 1:
            raise ValueError("a single solve takes one start, x0s (1, nt, nx)")
        c = init_carry(x0s)
        if not outer_chunk:
            return run_outer(c, maxiter, batched)
        return _segmented_loop(
            lambda c, it_hi: run_outer(c, it_hi, batched), c, outer_chunk,
            maxiter, progress=progress, on_segment=on_segment)

    run.finalize = finalize
    run.K = K
    return run


_PROBE, _TARGET_S = 2, 30.0


def _segmented_loop(outer, c, outer_chunk, maxiter, progress=None, on_segment=None):
    """Drive ``outer(carry, it_hi) -> carry`` in segments until every start
    has stopped or ``maxiter`` is passed.  A segment ends at iteration
    ``it_hi``; the host then reads the stop flags and the iteration front
    (the maximum over starts).  ``outer_chunk="auto"`` probes two 2-iteration
    segments for the per-iteration time (a running MAX), then sizes segments
    to ~30 s, growing at most 4× per segment.  ``progress(it, seconds)`` and
    ``on_segment(carry)`` run after every segment."""
    auto = outer_chunk == "auto"
    it = 1
    per_iter = None
    last_done = None
    while True:
        if not auto:
            chunk = int(outer_chunk)
        elif per_iter is None:
            chunk = _PROBE
        else:
            chunk = max(1, int(_TARGET_S / per_iter))
            if last_done:
                chunk = min(chunk, 4 * last_done)
        t0 = time.perf_counter()
        c = outer(c, min(it + chunk - 1, maxiter))
        with trace.span("trm.read", what="segment"):
            stop, new_it = bool(c.stop.all()), int(c.it.max())
        elapsed = time.perf_counter() - t0
        if auto and new_it > it and it > 1:
            # The first segment is skipped: early iterations are cheaper.
            per_iter = max(per_iter or 0.0, elapsed / (new_it - it))
            last_done = new_it - it
        it = new_it
        if progress is not None:
            progress(it - 1, elapsed)
        if on_segment is not None:
            on_segment(c)
        if stop or it > maxiter:
            return c


def _to_numpy(res: DeviceTRMResult, single: bool) -> DeviceTRMResult:
    """The one copy back from the device at the end of a solve."""
    with trace.span("trm.read", what="result"):
        host = [t.cpu().numpy() for t in res]
    if single:
        host = [h[0] for h in host]
    return DeviceTRMResult(*host)


def _profiled(par, device, fn):
    profiler = _profiler(device) if par.profile_dir else None
    if profiler is None:
        return fn()
    with profiler:
        out = fn()
    os.makedirs(par.profile_dir, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(par.profile_dir, "trm_device_trace.json"))
    return out


def _solve(par, device, fn):
    """``_profiled(par, device, fn)`` inside the request's ``solve`` span,
    which closes with the result's evaluation counts summed over its starts,
    read from its host copy."""
    with trace.span("solve") as sp:
        res = _profiled(par, device, fn)
        sp.set(f_evals=int(np.sum(res.f_evals)), df_evals=int(np.sum(res.df_evals)))
    return res


def trm_solve_device(obj, par=None, x0=None, seed: Optional[int] = None,
                     use_pallas: Optional[bool] = None,
                     outer_chunk="auto", progress=None,
                     speculative: Optional[bool] = None,
                     dp_backend: Optional[str] = None, mesh=None,
                     outer_unroll: int = 1, inner_unroll: int = 1) -> DeviceTRMResult:
    """One device-resident TRM solve on ``obj.device``; returns a
    :class:`DeviceTRMResult` of numpy scalars and arrays (one copy back at
    the end).

    ``outer_chunk`` defaults to ``"auto"``; ``None`` runs one segment, an int
    fixes the segment length (see :func:`make_device_trm`).  Segmented solves
    honour ``par.checkpoint_path`` (an npz of the accepted control after
    every segment, the host loop's format) and ``par.resume_from``.

    ``speculative=None`` enables the trial wave when the objective declares
    its batched sweeps bit-exact per row (``_speculative_default``, else
    ``_batched_sweeps_bitexact``); the wave chases with the objective's
    ``_wave_chase_default`` (``"vmap"``).  ``use_pallas``, ``dp_backend``
    and ``mesh`` as in :func:`make_device_trm`, at the JAX package's
    positions."""
    from .trm import TRMParameters

    par = par or TRMParameters()
    if x0 is None and par.resume_from:
        from ..utils.io import load_checkpoint

        x0 = load_checkpoint(par.resume_from)["u"]
    if x0 is None:
        x0 = rand_func(obj, seed=seed)
    if speculative is None:
        speculative = bool(getattr(obj, "_speculative_default",
                                   getattr(obj, "_batched_sweeps_bitexact", False)))
    run = make_device_trm(obj, par, use_pallas=use_pallas, outer_chunk=outer_chunk,
                          speculative=speculative, dp_backend=dp_backend, mesh=mesh,
                          wave_chase=getattr(obj, "_wave_chase_default", "vmap"),
                          outer_unroll=outer_unroll, inner_unroll=inner_unroll)
    on_segment = None
    if par.checkpoint_path and outer_chunk:
        from ..utils.io import save_checkpoint

        def on_segment(c):
            save_checkpoint(par.checkpoint_path, u=c.u_old[0].cpu().numpy(),
                            delta=float(par.delta0), iteration=int(c.it[0]) - 1,
                            J=float(c.J_old[0]), tv=float(c.TV_old[0]))

    x0s = torch.as_tensor(np.asarray(x0), dtype=obj.dtype, device=obj.device)[None]
    return _solve(par, obj.device, lambda: _to_numpy(
        run.finalize(run(x0s, False, progress=progress, on_segment=on_segment)),
        single=True))


def multistart_solve_device(obj, par, x0s, mesh=None, use_pallas: Optional[bool] = None,
                            outer_chunk=None, progress=None,
                            speculative: Optional[bool] = None,
                            dp_backend: Optional[str] = None,
                            outer_unroll: Optional[int] = None,
                            inner_unroll: Optional[int] = None) -> DeviceTRMResult:
    """Batched multistart: the device TRM over ``x0s (S, nt, nx)`` with a
    start axis; every start runs its own accept/halve schedule, masked in
    lockstep.  Returns a :class:`DeviceTRMResult` with a leading start axis.

    ``speculative=None`` follows ``_speculative_multistart`` (False for ODE
    objectives: the start axis already fills the batch).  The wave always
    chases with the trial-wave chase (``wave_chase="trials"``).
    ``outer_chunk`` (``None``, an int or ``"auto"``) segments like
    :func:`make_device_trm`; a segment ends when ALL starts have stopped.
    ``use_pallas`` and ``dp_backend`` as in :func:`make_device_trm`, at the
    JAX package's positions.

    With a ``mesh`` (a :class:`~mioc_tpu_torch.parallel.device_mesh.Mesh`
    of ranks, every one of which must call this) the starts are split over
    its ``"batch"`` axis (``S`` must be divisible by its size, else
    ``ValueError``): each rank runs its block batched, segmented by
    ``outer_chunk`` on its own, and the result's leaves are gathered over
    ``"batch"``, so every rank returns all S starts.  ``dp_backend="sharded"``
    also partitions each build of a block over the mesh's ``"level"`` axis."""
    if speculative is None:
        speculative = bool(getattr(obj, "_speculative_multistart", False))
    run = make_device_trm(obj, par, use_pallas=use_pallas, outer_chunk=outer_chunk,
                          speculative=speculative, dp_backend=dp_backend, mesh=mesh,
                          wave_chase="trials",
                          outer_unroll=outer_unroll or 1,
                          inner_unroll=inner_unroll or 1)
    x0s = torch.as_tensor(np.asarray(x0s), dtype=obj.dtype, device=obj.device)
    if mesh is not None:
        nb = mesh.shape["batch"]
        if len(x0s) % nb:
            raise ValueError(f"{len(x0s)} starts are not divisible by the mesh's batch "
                             f"axis of {nb}")
        Sb = len(x0s) // nb
        x0s = x0s[mesh.coord("batch") * Sb:][:Sb]

    def solve():
        res = run.finalize(run(x0s, True, progress=progress))
        if mesh is not None:
            res = DeviceTRMResult(*[mesh.all_gather(t, "batch").flatten(0, 1) for t in res])
        return _to_numpy(res, single=False)

    return _solve(par, obj.device, solve)
