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
  ordinary route, as the JAX package's does); ``sharded`` builds with the
  level-sharded DP over every rank of the world (``solvers.trm.dp_route``,
  the rule the solvers apply too);
* several processes come from ``torchrun`` (``WORLD_SIZE`` > 1 in the
  environment), where the JAX CLI sees several devices in one process: the
  CLI then calls ``init_multihost()``, ``--device-loop --multistart N``
  splits the starts over a ``(batch=world)`` mesh when ``N`` is divisible by
  the world size, and only rank 0 prints and writes files::

      torchrun --standalone --nproc-per-node 4 -m mioc_tpu_torch.cli fishing \
          --device-loop --multistart 32 --seed 0 --no-plot --no-log

``mixed`` runs the mixed continuous+integer solver (``solvers.mixed``) and
prints the JAX CLI's lines and JSON keys (``problem``, ``n``, ``J``,
``rounds``, ``converged``, ``wall_s``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .models import registry


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
    ap.add_argument("--no-plot", action="store_true")
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
                         "'temporal' = the banded temporal DP (host loop), "
                         "'sharded' = the contraction partitioned over the ranks' "
                         "level axis")
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

    from ._device import resolve_device
    from .solvers.trm import TRMParameters, TRMResult, dp_route, trm_solve

    rank, world = 0, 1
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:  # under torchrun
        from .parallel import init_multihost

        rank, world = init_multihost()
    lead = rank == 0  # prints and writes files
    device = resolve_device(args.device)
    dp_route(args.dp_backend, None, device)
    preset = dict(registry.get(args.problem).preset)
    for key in ("beta", "delta0", "p"):
        if getattr(args, key) is not None:
            preset[key] = getattr(args, key)
    par = TRMParameters(
        **preset,
        maxiter=args.maxiter,
        log=lead and not args.no_log,
        metrics_path=args.metrics if lead else None,
        checkpoint_path=args.checkpoint if lead else None,
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
        if not lead:
            return 0
        print(f"{wall:.3f} seconds")
        print(f"Objective Value: J = {mres.J}")
        print(json.dumps({
            "problem": "mixed", "n": args.n, "J": mres.J,
            "rounds": mres.rounds, "converged": mres.converged,
            "wall_s": round(wall, 3),
        }))
        if not args.no_plot:
            from .utils.plotting import plot_results

            print(f"plot saved to {plot_results(obj)}")
        return 0
    if args.device_loop:
        from .solvers.trm_device import (DeviceTRMResult, multistart_solve_device,
                                         trm_solve_device)
        from .utils.init import rand_func

        if args.multistart > 1:
            x0s = np.stack([_julia_x0(obj, s) if args.julia_start
                            else rand_func(obj, seed=(args.seed or 0) + s)
                            for s in range(args.multistart)])
            mesh = None
            if world > 1 and args.multistart % world == 0:
                from .parallel import make_device_mesh

                mesh = make_device_mesh(batch=world, device_type=device.type)
            batch = multistart_solve_device(obj, par, x0s, mesh=mesh,
                                            speculative=args.speculative)
            best = int(np.argmin(batch.J))
            dev = DeviceTRMResult(*[leaf[best] for leaf in batch])
        else:
            # --device-chunk: absent → adaptive, 0 → one segment, N → fixed.
            chunk = "auto" if args.device_chunk is None else args.device_chunk or None
            prog = None
            if lead and not args.no_log:
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
        obj.x = obj.as_control(dev.x_final)  # for plotting parity with the reference
        obj.eval_fdf_()
    elif args.multistart > 1:
        from .parallel import multistart_solve

        x0s = None
        if args.julia_start:
            x0s = np.stack([_julia_x0(obj, s) for s in range(args.multistart)])
        res, _ = multistart_solve(lambda: build_objective(args.problem, args.n, device),
                                  args.multistart, par, seed=args.seed or 0, x0s=x0s)
        obj = None  # the JAX CLI plots nothing after the host-loop multistart
    else:
        res = trm_solve(obj, par, x0=_julia_x0(obj), seed=args.seed)
    wall = time.time() - t0
    if not lead:
        return 0

    print(f"{wall:.3f} seconds")
    print(f"Objective Value: J = {res.J}")
    print(json.dumps({
        "problem": args.problem, "n": args.n, "J": res.J,
        "iterations": res.iterations, "f_evals": res.f_evals,
        "df_evals": res.df_evals, "converged": res.converged,
        "wall_s": round(wall, 3),
        "timings": {k: round(v, 3) for k, v in res.timings.items()},
    }))

    if not args.no_plot and obj is not None:
        from .utils.plotting import plot_results

        print(f"plot saved to {plot_results(obj)}")
        from .objectives.pde import PDEObjective

        if isinstance(obj, PDEObjective):
            from .utils.plotting import animate_solution

            print("Animating solution, this could take a few seconds")
            out = animate_solution(obj.mesh, obj.state.detach().cpu().numpy().T, obj.tau,
                                   v=np.asarray(res.u))
            print(f"animation saved to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
