"""The program's own spans (``mioc_tpu_torch/utils/trace.py``) in a cell.

    python3 portbench/program_trace.py --workload <cell> --seed <n> [--untraced 2]

``run.py`` does not read the program's spans yet; this measures what they
give, on one pool item of the cell (the first of ``--seed``'s order), after
``run.py``'s set-up and warm-up:

* **call 1**, traced as ``run.py --trace 1`` traces it (the benchmark's
  synchronised wrappers, ``portbench/spans.py``, and ``torch.profiler``),
  with the program's recorder on as well: the per-layer metrics of
  ``BENCHMARK.json`` from ``run.py``'s inputs, the device launches per sweep
  step, and the idle gaps labelled by the innermost span of both kinds;
* **call 2**, the same item with the program's recorder on and neither the
  profiler nor the wrappers, so no synchronise of the benchmark's hides the
  host's waits: the share of swept rows the solve uses, the loop's own ms
  per outer iteration and the host's wait share;
* **calls 3 …**, the same item untraced: call 2's wall against theirs is the
  recorder's cost when it is on.

Every answer of calls 1 and 2 is judged as ``run.py`` judges a window's, and,
as ``run.py``, it reports nothing from a process that holds JAX or the JAX
package (``harness.loaded_forbidden``).
One JSON line is printed.  The functions above :func:`measure` are plain
arithmetic on spans and intervals, held by ``portbench/tests``.
"""

from __future__ import annotations

import heapq
import re
import time

import numpy as np

LOOP = ("solve", "trm.outer")   # a gap inside only these is the loop's
SWEEP_LAYERS = ("ode_sweep", "pde_sweep", "conv_sweep")
DP = ("dp.build", "dp.chase")
LAUNCH = re.compile(r"Launch(Cooperative)?Kernel")   # cudaLaunchKernel(ExC), cuLaunchKernel, ...


def is_sweep(name: str) -> bool:
    layer, _, tag = name.rpartition(".")
    return layer in SWEEP_LAYERS and tag in ("f", "df")


def suffix(e2e: str) -> str:
    """The cell suffix of a per-layer metric's name, by its end-to-end metric."""
    return {"solve_s": "solve", "starts_per_s": "multistart"}[e2e]


def innermost(spans):
    """``(bounds, labels)``: ``labels[i]``, the name of the innermost span
    (the latest start) over ``[bounds[i], bounds[i+1])``, or None.  ``spans``
    are ``(name, start, end)``; nested or not."""
    bounds = sorted({t for _, a, b in spans for t in (a, b)})
    order = sorted(range(len(spans)), key=lambda i: spans[i][1])
    heap, j, labels = [], 0, []
    for x in bounds:
        while j < len(order) and spans[order[j]][1] <= x:
            i = order[j]
            heapq.heappush(heap, (-spans[i][1], spans[i][2], i))
            j += 1
        while heap and spans[heap[0][2]][2] <= x:
            heapq.heappop(heap)
        labels.append(spans[heap[0][2]][0] if heap else None)
    return np.asarray(bounds, dtype=np.float64), labels


def label_gaps_nested(gaps, spans, default="loop", loop=LOOP):
    """Idle time by the innermost span that holds each gap's midpoint, over
    the benchmark's spans and the program's together; a gap inside none, or
    inside only ``loop`` spans, is ``default``.  With flat spans this is
    ``trace.label_gaps``."""
    if not gaps:
        return {}
    g = np.asarray(gaps, dtype=np.float64)
    mid, length = g.mean(axis=1), g[:, 1] - g[:, 0]
    totals = {}
    bounds, labels = innermost(spans)
    at = np.searchsorted(bounds, mid, side="right") - 1
    for k, n in zip(at.tolist(), length.tolist()):
        name = labels[k] if k >= 0 else None
        name = default if name is None or name in loop else name
        totals[name] = totals.get(name, 0.0) + n
    return totals


def closed(spans):
    """The program's spans (:class:`~mioc_tpu_torch.utils.trace.Span`) as
    ``(name, start_ns, end_ns)``, open ones left out."""
    return [(s.name, s.t0_ns, s.t1_ns) for s in spans if s.t1_ns is not None]


def launches_per_step(spans, launches_ns, kernel_starts_ns):
    """Device launches inside the program's sweep spans over the sum of
    their ``steps``: the profiler's launch records (host times) where there
    are any, else the kernels that start inside a span.  None without a
    sweep.  Returns ``(value, source)``."""
    sweeps = [s for s in spans if is_sweep(s.name) and s.t1_ns is not None]
    steps = sum(s.attrs["steps"] for s in sweeps)
    if not steps:
        return None, None
    src = "launch records" if len(launches_ns) else "kernel starts"
    t = np.sort(np.asarray(launches_ns if len(launches_ns) else kernel_starts_ns,
                           dtype=np.float64))
    n = sum(int(np.searchsorted(t, s.t1_ns, "right") - np.searchsorted(t, s.t0_ns, "left"))
            for s in sweeps)
    return n / steps, src


def row_use(spans):
    """% of the rows the sweeps computed (padding included) that the solves
    count as evaluations (Σ ``f_evals`` + ``df_evals`` of the ``solve`` spans
    over Σ ``rows_swept``); None without a sweep."""
    swept = sum(s.attrs["rows_swept"] for s in spans if is_sweep(s.name))
    used = sum(s.attrs["f_evals"] + s.attrs["df_evals"] for s in spans if s.name == "solve")
    return 100.0 * used / swept if swept else None


def union_ns(intervals, lo=-np.inf, hi=np.inf) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to ``[lo, hi]``."""
    total, reach = 0.0, -np.inf
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if a > reach:
            total += b - a
            reach = b
        elif b > reach:
            total += b - reach
            reach = b
    return total


def loop_self_ms(spans):
    """Mean ms of a ``trm.outer`` span not covered by a sweep, DP or
    ``trm.read`` span: the loop's own host time per outer iteration."""
    cover = sorted((s.t0_ns, s.t1_ns) for s in spans
                   if (is_sweep(s.name) or s.name in DP or s.name == "trm.read")
                   and s.t1_ns is not None)
    starts = np.asarray([a for a, _ in cover], dtype=np.float64)
    own = []
    for s in spans:
        if s.name != "trm.outer" or s.t1_ns is None:
            continue
        lo = int(np.searchsorted(starts, s.t0_ns, "left"))
        hi = int(np.searchsorted(starts, s.t1_ns, "right"))
        own.append(s.t1_ns - s.t0_ns - union_ns(cover[lo:hi], s.t0_ns, s.t1_ns))
    return float(np.mean(own)) / 1e6 if own else None


def host_wait_share(spans, wall_ns):
    """% of the call's wall inside ``trm.read`` spans: the host waiting on
    the card's flags and results."""
    reads = [(s.t0_ns, s.t1_ns) for s in spans if s.name == "trm.read" and s.t1_ns is not None]
    return 100.0 * union_ns(reads) / wall_ns if reads else None


def launch_times(dev_trace, torch):
    """Host ``perf_counter_ns`` times of the profiler's kernel-launch records
    (the CUDA runtime's API records, on the system clock that
    ``DeviceTrace.clock`` maps)."""
    DeviceType = torch.autograd.DeviceType
    offset = -float(np.mean(dev_trace.clock))
    return np.asarray([e.start_ns() + offset
                       for e in dev_trace.prof.profiler.kineto_results.events()
                       if e.device_type() != DeviceType.CUDA and LAUNCH.search(e.name())],
                      dtype=np.float64)


def measure(cell_name: str, seed: int, untraced: int = 2, device: str = "cuda",
            overrides: dict = None, log=None):
    """The three kinds of call above on one pool item; returns the result
    dict (the printed line).  ``overrides`` as in ``run.run``."""
    import torch

    from mioc_tpu_torch.utils import trace

    from portbench import harness, peaks
    from portbench import run as bench
    from portbench import trace as tracing
    from portbench.reference.levels import admissible_levels
    from portbench.spans import Recorder

    log = log or bench.log
    cell, cfg, traffic = harness.load_cell(cell_name)
    for part, d in (overrides or {}).items():
        {"config": cfg, "traffic": traffic}[part].update(d)
    torch.set_num_threads(1)
    prog = harness.Program(cfg, traffic, device=device)
    pool = harness.pool_starts(admissible_levels(cfg["levels"]), int(cfg["nt"]), traffic)
    prog.solve(pool[0], par=harness.trm_parameters(cfg["preset"],
                                                   maxiter=bench.WARMUP_ITERATIONS))
    cuda = prog.device.type == "cuda"
    dev = None
    if cuda:
        with tracing.DeviceTrace(torch):   # the profiler's first start, as run.py
            prog.sync()
        dev = tracing.DeviceTrace(torch)
    from mioc_tpu_torch.ops import backtrack_cuda, bellman_cuda

    rec = Recorder(prog.sync)
    rec.wrap_sweeps(prog.obj, cfg["sweeps"])
    rec.wrap_dp({"bellman_cuda": bellman_cuda, "backtrack_cuda": backtrack_cuda})
    prog.sync()

    def call():
        return harness.window(prog, pool, seed, 0.0, log, max_calls=1)

    # Call 1: run.py's traced call, with the program's recorder on as well.
    trace.take()
    trace.enable()
    if dev is not None:
        with dev:
            t0, t1, calls1, answers1, failed1 = call()
    else:
        t0, t1, calls1, answers1, failed1 = call()
    trace.disable()
    spans1 = trace.take()
    rec.restore()
    if dev is not None:
        names, ks, ke = dev.kernels()
        launches = launch_times(dev, torch)
    else:
        names, ks, ke, launches = [], np.empty(0), np.empty(0), np.empty(0)
    w0, w1 = t0 * 1e9, t1 * 1e9
    busy = tracing.union_seconds(ks, ke, w0, w1) / 1e9
    is_dp = np.array([any(s in n for s in peaks.DP_KERNEL_SYMBOLS) for n in names], bool)
    bound = sum(peaks.bound_s(*peaks.call_work(n, a)) for n, a in rec.dp_calls)
    metric = traffic["metric"]
    ctx = {"e2e": metric, "spans": rec.spans, "window_s": t1 - t0, "busy_s": busy,
           "dp_device_s": float((ke - ks)[is_dp].sum()) / 1e9 if len(names) else 0.0,
           "dp_bound_s": bound}
    per_layer = {}
    for name, read in harness.readers().items():
        v = read(ctx)
        if v is not None:
            per_layer[name] = v
    gaps = tracing.idle_gaps(ks, ke, w0, w1)
    flat = {k: v / 1e9 for k, v in tracing.label_gaps(gaps, rec.spans).items()}
    nested = {k: v / 1e9 for k, v in
              label_gaps_nested(gaps, rec.spans + closed(spans1)).items()}
    lps, src = launches_per_step(spans1, launches, ks) if dev is not None else (None, None)
    del names, ks, ke, launches, gaps

    # Call 2: the program's recorder alone.
    trace.enable()
    t0, t1, calls2, answers2, failed2 = call()
    trace.disable()
    spans2 = trace.take()
    wall2 = t1 - t0

    # Calls 3 …: untraced.
    walls, same = [], True
    for _ in range(untraced):
        u0, u1, _, answers3, _ = call()
        walls.append(u1 - u0)
        same &= all(np.array_equal(a["u"], b["u"]) and a["J"] == b["J"]
                    for (_, a), (_, b) in zip(answers2, answers3))
    bad = harness.loaded_forbidden()
    if bad:
        raise SystemExit(f"the process holds {', '.join(bad)} after the calls")

    sfx = suffix(metric)
    counts = {}
    for s in spans2:
        counts[s.name] = counts.get(s.name, 0) + 1
    result = {
        "workload": cell_name, "seed": seed,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "call1_s": ctx["window_s"], "call2_s": wall2,
        "untraced_s": walls, "same_answers_untraced": bool(same),
        "per_layer_call1": per_layer,
        "new": {f"sweep_launches_per_step.{sfx}": lps,
                f"sweep_row_use.{sfx}": row_use(spans2),
                f"loop_self_ms.{sfx}": loop_self_ms(spans2),
                f"host_wait_share.{sfx}": host_wait_share(spans2, wall2 * 1e9)},
        "launch_source": src,
        "idle_gaps_flat": tracing.top(flat), "idle_gaps_nested": tracing.top(nested),
        "spans_call2": counts,
    }
    ref = harness.reference_model(cfg)
    readings = harness.judge_answers(prog, ref, answers1 + answers2, failed1 + failed2)
    chk = harness.checks(readings, cell["limits"])
    result["correct"] = harness.passed(chk) and calls1 == calls2 == 1
    result["checks"] = chk
    return result


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--untraced", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no result: no CUDA card", flush=True)
        return 2
    t = time.perf_counter()
    result = measure(args.workload, args.seed, args.untraced)
    result["run_s"] = time.perf_counter() - t
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())
