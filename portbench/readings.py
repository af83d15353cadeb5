"""Readings of a cell's compared numbers over many start sets, for setting
its limits (not part of a benchmark run).

    python3 portbench/readings.py --workload <cell> --seeds 1 2 ... [--dtype float32]

For every seed it solves one call of the cell's traffic at the cell's size,
on the starts drawn from ``first_seed = seed · 1000`` (start sets the
cell's pool does not hold), judges the answers as a run does, and prints a
JSON line of readings; then a line with the largest reading of each number.
``--dtype float32`` runs the program in float32 where the configuration
states float64: the control, which has to fail a limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import run as _run  # noqa: E402,F401  (sets the cache directories)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", default=None, choices=("float32", "float64"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from portbench import harness
    from portbench.reference.levels import admissible_levels

    cell, cfg, traffic = harness.load_cell(args.workload)
    dtype = getattr(torch, args.dtype) if args.dtype else None
    prog = harness.Program(cfg, traffic, device=args.device, dtype=dtype)
    ref = harness.reference_model(cfg)
    levels = admissible_levels(cfg["levels"])
    worst = {}
    for seed in args.seeds:
        x0s = harness.pool_starts(levels, int(cfg["nt"]), dict(traffic, pool=1),
                                  first_seed=seed * 1000)[0]
        t0 = time.perf_counter()
        try:
            answers, failed = [(0, a) for a in prog.solve(x0s)], 0
        except Exception as exc:  # a control that crashes has failed
            print(json.dumps({"seed": seed, "raised": f"{type(exc).__name__}: {exc}"}), flush=True)
            continue
        wall = time.perf_counter() - t0
        r = harness.judge_answers(prog, ref, answers, failed)
        r.update(seed=seed, wall_s=wall,
                 iterations=[a["iterations"] for _, a in answers][:8])
        print(json.dumps(r), flush=True)
        for k, v in r.items():
            if k in cell["limits"]:
                worst[k] = max(worst.get(k, v), v)
    print(json.dumps({"workload": args.workload, "dtype": str(prog.dtype), "max": worst,
                      "limits": cell["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
