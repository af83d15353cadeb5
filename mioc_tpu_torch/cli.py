"""Command-line entry point: solve a registered problem with the TRM.

Counterpart of ``mioc_tpu.cli`` (the reference's ``main``,
``multi-trust.jl:179-206``, with its per-problem presets), with the same
flags and the same JSON result line, plus ``--device`` (default ``cuda``;
without CUDA the run raises, pass ``--device cpu``).  Usage::

    python -m mioc_tpu_torch.cli fishing --n 1024 --no-plot
    python -m mioc_tpu_torch.cli convolution --n 2048 --seed 0 --no-plot --device-loop
    python -m mioc_tpu_torch.cli heat --n 500 --no-plot

Differences from the JAX CLI:

* there is no backend fallback: the run is on ``--device`` or raises;
* ``--dp-backend``: ``pallas`` means the port's CUDA kernels, the default
  anyway (the plain versions on the CPU); ``scan`` means the plain versions
  and is refused on the card, where no solve runs them; ``temporal`` runs
  the host loop on the banded temporal DP (``--device-loop`` takes the
  ordinary route, as the JAX package's does); ``sharded`` is not ported and
  raises ``NotImplementedError`` (``solvers.trm.dp_route``, the rule the
  solvers apply too);
* plotting is not ported (ROADMAP.md queue A item 7), nor the animation of
  a PDE state that the JAX CLI adds for ``heat``: a run that the JAX CLI
  would plot — a single host-loop solve, any ``--device-loop`` run, or
  ``mixed`` — without ``--no-plot`` raises ``NotImplementedError`` before
  it solves; the host-loop ``--multistart N`` (N > 1), which the JAX CLI
  does not plot, runs;
* ``--multistart`` with ``--device-loop`` runs the batched multistart on one
  device (no mesh).

``mixed`` runs the mixed continuous+integer solver (``solvers.mixed``) and
prints the JAX CLI's lines and JSON keys (``problem``, ``n``, ``J``,
``rounds``, ``converged``, ``wall_s``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .models import registry

_PLOT = "ROADMAP.md queue A item 7 (utils/plotting.py, utils/vtk.py)"


def build_objective(problem: str, n: int, device=None):
    """Instantiate a registered problem (built-in or plugin-discovered)."""
    try:
        return registry.build(problem, nt=n, device=device)
    except KeyError as exc:
        raise SystemExit(str(exc.args[0]))


def main(argv=None):
    # Plugin-style problem discovery (multi-trust.jl:15-20): import every
    # example_*.py on $MIOC_PROBLEMS_PATH (default: the working directory).
    registry.discover()
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("problem", nargs="?", default="fishing",
                    choices=registry.available())
    ap.add_argument("--n", type=int, default=1024, help="number of time steps")
    ap.add_argument("--seed", type=int, default=None, help="x0 RNG seed")
    ap.add_argument("--julia-start", action="store_true",
                    help="generate x0 from a bit-exact replica of the "
                         "reference's seeded MersenneTwister stream "
                         "(requires --seed)")
    ap.add_argument("--beta", type=float, default=None)
    ap.add_argument("--delta0", type=float, default=None)
    ap.add_argument("--p", type=float, default=None)
    ap.add_argument("--maxiter", type=int, default=1000)
    ap.add_argument("--no-plot", action="store_true",
                    help="required where the run would plot (a single solve, or "
                         "--device-loop): plotting is not ported yet")
    ap.add_argument("--no-log", action="store_true")
    ap.add_argument("--metrics", default=None, help="jsonl metrics path")
    ap.add_argument("--checkpoint", default=None, help="npz checkpoint path")
    ap.add_argument("--multistart", type=int, default=1,
                    help="number of random restarts (best result kept)")
    ap.add_argument("--device-loop", action="store_true",
                    help="run the device-resident TRM (one flag read per outer "
                         "iteration; batches the multistart over a start axis)")
    ap.add_argument("--dp-backend", default=None,
                    choices=["scan", "pallas", "temporal", "sharded"],
                    help="DP engine: 'pallas' = the CUDA kernels (the default on "
                         "the card), 'scan' = the plain versions (CPU only), "
                         "'temporal' = the banded temporal DP (host loop); "
                         "'sharded' is not ported")
    ap.add_argument("--speculative", dest="speculative", default=None,
                    action="store_true",
                    help="device loop: evaluate the whole trust-region halving "
                         "schedule as one batched trial wave per outer "
                         "iteration (default: on where the objective's batched "
                         "rows are bit-exact; trajectories equal the "
                         "sequential loop's)")
    ap.add_argument("--no-speculative", dest="speculative", action="store_false")
    ap.add_argument("--device-chunk", type=int, default=None,
                    help="device loop: read the stop flags every N outer "
                         "iterations (exact; default: adaptive; 0: once)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solve (default: cuda; no fallback)")
    args = ap.parse_args(argv)

    # The JAX CLI plots where it holds an objective: after a mixed solve, a
    # single solve or any device-loop run, not after the host-loop multistart.
    if not args.no_plot and (args.problem == "mixed" or args.device_loop
                             or args.multistart <= 1):
        raise NotImplementedError(f"plotting is not ported yet: {_PLOT}; pass --no-plot")

    from ._device import resolve_device
    from .solvers.trm import TRMParameters, TRMResult, dp_route, trm_solve

    device = resolve_device(args.device)
    dp_route(args.dp_backend, None, device)
    preset = dict(registry.get(args.problem).preset)
    for key in ("beta", "delta0", "p"):
        if getattr(args, key) is not None:
            preset[key] = getattr(args, key)
    par = TRMParameters(
        **preset,
        maxiter=args.maxiter,
        log=not args.no_log,
        metrics_path=args.metrics,
        checkpoint_path=args.checkpoint,
        dp_backend=args.dp_backend,
    )

    def _julia_x0(obj, start: int = 0):
        """x0 from the reference's seeded MersenneTwister stream (or None
        when --julia-start is off; per-start seeds offset like the numpy
        multistart path)."""
        if not args.julia_start:
            return None
        if args.seed is None:
            ap.error("--julia-start requires --seed")
        from .utils.init import rand_func

        return rand_func(obj, seed=args.seed + start, julia_stream=True)

    t0 = time.time()
    obj = build_objective(args.problem, args.n, device)
    if args.problem == "mixed":
        from .solvers.mixed import MixedParameters, mixed_solve

        mres = mixed_solve(obj, MixedParameters(trm=par), x0=_julia_x0(obj),
                           seed=args.seed)
        wall = time.time() - t0
        print(f"{wall:.3f} seconds")
        print(f"Objective Value: J = {mres.J}")
        print(json.dumps({
            "problem": "mixed", "n": args.n, "J": mres.J,
            "rounds": mres.rounds, "converged": mres.converged,
            "wall_s": round(wall, 3),
        }))
        return 0
    if args.device_loop:
        from .solvers.trm_device import (DeviceTRMResult, multistart_solve_device,
                                         trm_solve_device)
        from .utils.init import rand_func

        if args.multistart > 1:
            x0s = np.stack([_julia_x0(obj, s) if args.julia_start
                            else rand_func(obj, seed=(args.seed or 0) + s)
                            for s in range(args.multistart)])
            batch = multistart_solve_device(obj, par, x0s, speculative=args.speculative)
            best = int(np.argmin(batch.J))
            dev = DeviceTRMResult(*[leaf[best] for leaf in batch])
        else:
            # --device-chunk: absent → adaptive, 0 → one segment, N → fixed.
            chunk = "auto" if args.device_chunk is None else args.device_chunk or None
            prog = None
            if not args.no_log:
                def prog(it, s):
                    print(f"  device loop: {it} outer iterations ({s:.1f} s segment)")
            dev = trm_solve_device(obj, par, x0=_julia_x0(obj), seed=args.seed,
                                   outer_chunk=chunk, progress=prog,
                                   speculative=args.speculative)
        res = TRMResult(
            J=float(dev.J), u=np.asarray(dev.u), x_final=np.asarray(dev.x_final),
            converged=bool(dev.converged), iterations=int(dev.iterations),
            inner_steps=int(dev.inner_steps), f_evals=int(dev.f_evals),
            df_evals=int(dev.df_evals), tv=float(dev.tv), f=float(dev.f),
            dp_builds=int(dev.dp_builds), timings={},
        )
    elif args.multistart > 1:
        from .parallel import multistart_solve

        x0s = None
        if args.julia_start:
            x0s = np.stack([_julia_x0(obj, s) for s in range(args.multistart)])
        res, _ = multistart_solve(lambda: build_objective(args.problem, args.n, device),
                                  args.multistart, par, seed=args.seed or 0, x0s=x0s)
    else:
        res = trm_solve(obj, par, x0=_julia_x0(obj), seed=args.seed)
    wall = time.time() - t0

    print(f"{wall:.3f} seconds")
    print(f"Objective Value: J = {res.J}")
    print(json.dumps({
        "problem": args.problem, "n": args.n, "J": res.J,
        "iterations": res.iterations, "f_evals": res.f_evals,
        "df_evals": res.df_evals, "converged": res.converged,
        "wall_s": round(wall, 3),
        "timings": {k: round(v, 3) for k, v in res.timings.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
