"""The port's benchmark: one cell, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

prints one JSON line as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
``breakdown`` (traced runs) and, last, ``checks``: every compared number
beside its limit, which also end standard error.  The run measures
``mioc_tpu_torch`` on one CUDA card and exits non-zero, with no result,
where there is none, or where the process holds JAX or the JAX package once
the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Every build and kernel cache of the program lives at a fixed path inside
# the checkout, so only a checkout's first run builds.
CACHE = os.path.join(ROOT, ".portbench_cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

WARMUP_ITERATIONS = 2


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        overrides: dict = None, t_start: float = None):
    """One run of a cell; returns the result dict (the printed line).
    ``overrides`` replaces entries of the cell's configuration or traffic
    (``{"config": {...}, "traffic": {...}}``): the tests' small sizes."""
    import numpy as np

    from portbench import harness, peaks
    from portbench import trace as tracing
    from portbench.spans import Recorder

    t_start = T_PROCESS if t_start is None else t_start
    cell, cfg, traffic = harness.load_cell(cell_name)
    for part, d in (overrides or {}).items():
        {"config": cfg, "traffic": traffic}[part].update(d)
    import torch

    from portbench.reference.levels import admissible_levels

    torch.set_num_threads(1)  # one process, one thread of CPU work
    prog = harness.Program(cfg, traffic, device=device)
    pool = harness.pool_starts(admissible_levels(cfg["levels"]), int(cfg["nt"]), traffic)
    # Warm-up at the cell's own shapes: one call capped at a few iterations.
    prog.solve(pool[0], par=harness.trm_parameters(cfg["preset"], maxiter=WARMUP_ITERATIONS))
    recorder = dev_trace = None
    if trace:
        dev_trace = tracing.DeviceTrace(torch)
        with dev_trace:   # the profiler's own first start is set-up too
            prog.sync()
        dev_trace = tracing.DeviceTrace(torch)
        from mioc_tpu_torch.ops import backtrack_cuda, bellman_cuda

        recorder = Recorder(prog.sync)
        recorder.wrap_sweeps(prog.obj, cfg["sweeps"])
        recorder.wrap_dp({"bellman_cuda": bellman_cuda, "backtrack_cuda": backtrack_cuda})
    prog.sync()
    setup_s = time.perf_counter() - t_start

    if dev_trace is not None:
        # A traced run traces one whole call: at ~10⁶ launches a solve, the
        # profiler's records of a longer window take minutes to read.
        with dev_trace:
            t0, t1, calls, answers, failed = harness.window(prog, pool, seed, seconds, log,
                                                            max_calls=1)
    else:
        t0, t1, calls, answers, failed = harness.window(prog, pool, seed, seconds, log)
    log(f"set-up {setup_s:.3f} s, window {t1 - t0:.3f} s, {calls} calls")
    if recorder is not None:
        recorder.restore()
    memory_peak = int(torch.cuda.max_memory_allocated()) if prog.device.type == "cuda" else 0
    bad = harness.loaded_forbidden()
    if bad:
        raise SystemExit(f"the process holds {', '.join(bad)} after the window")

    window_s = t1 - t0
    attempted = len(answers) + failed
    converged = sum(a["converged"] for _, a in answers)
    result = {"correct": False, "attempted": attempted, "failed": 0, "metrics": {}}
    if device == "cuda":
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                            "count": 1, "memory_peak_bytes": memory_peak}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": memory_peak}
    metric = traffic["metric"]
    if not trace:
        value = (window_s / max(calls, 1) if metric == "solve_s"
                 else converged / window_s)
        unit = {"solve_s": "s", "starts_per_s": "starts/s"}[metric]
        result["metrics"] = {metric: {"value": value, "unit": unit},
                             "setup_s": {"value": setup_s, "unit": "s"}}
    else:
        names, ks, ke = dev_trace.kernels()
        log(dev_trace.summary)
        w0, w1 = t0 * 1e9, t1 * 1e9
        busy = tracing.union_seconds(ks, ke, w0, w1) / 1e9
        dur = (ke - ks) / 1e9
        is_dp = np.array([any(s in n for s in peaks.DP_KERNEL_SYMBOLS) for n in names], bool)
        bound = 0.0
        for name, args in recorder.dp_calls:
            nbytes, ops, dt = peaks.call_work(name, args)
            bound += peaks.bound_s(nbytes, ops, dt)
        recorder.dp_calls.clear()
        ctx = {"e2e": metric, "spans": recorder.spans, "window_s": window_s,
               "busy_s": busy, "dp_device_s": float(dur[is_dp].sum()), "dp_bound_s": bound}
        for name, read in harness.readers().items():
            v = read(ctx)
            if v is not None:
                result["metrics"][name] = {"value": v, "unit": "ms" if "_ms" in name else "%"}
        result["device"].update(busy_s=busy, window_s=window_s)
        per_op = {}
        for n, d in zip(names, dur.tolist()):
            per_op[n] = per_op.get(n, 0.0) + d
        gaps = tracing.idle_gaps(ks, ke, w0, w1)
        idle = {k: v / 1e9 for k, v in tracing.label_gaps(gaps, recorder.spans).items()}
        result["breakdown"] = {"device_ops": [[n[:160], v] for n, v in tracing.top(per_op)],
                               "idle_gaps": tracing.top(idle)}
        del names, ks, ke, dur, per_op, gaps
        log(f"trace read in {time.perf_counter() - t1:.3f} s")
    del dev_trace

    # Judge what the window produced: the program's gradients at its answers
    # first, then the program is freed and the reference runs.
    ref = harness.reference_model(cfg)
    readings = harness.judge_answers(prog, ref, answers, failed)
    del prog
    log(f"judged in {time.perf_counter() - t1:.3f} s after the window")
    limits = cell["limits"]
    chk = harness.checks(readings, limits)
    result["failed"] = int(readings["failed"] + readings["admissible"])
    result["correct"] = harness.passed(chk) and calls > 0
    result["checks"] = chk
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from portbench import harness

    need = int(harness.load_json("workloads", f"{args.workload}.json").get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"no result: the cell needs {need} CUDA card(s), "
            f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    for k, v in result["checks"].items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
