"""The benchmark's general machinery: it finds a cell's files by name, builds
the program's objective, draws the traffic, runs the measured window, and
judges and reports what the window produced.

A cell (``workloads/<cell>.json``) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<mix>.json``) and
holds the limits of its compared numbers.  A traffic mix names one of the
program's solve entries and its parameters: starts per call (``batch``),
the pool of calls (``pool`` calls, start seeds from ``first_seed``), the
trial-wave switch (``speculative``), and the end-to-end metric it reports.
Each per-layer metric that ``BENCHMARK.json`` lists has a reader,
``metrics/<metric>.py``; it returns a number, or ``None`` where its layer
has nothing to read in this cell.

The window is closed-loop: calls run back to back, each pass over the pool
in an order drawn from ``--seed``, and the window closes at the end of the
first pass that ends at or after ``--seconds``.  Every pass is the same
work, so the metric does not depend on the seed or on where the window is
cut.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time

import numpy as np

from . import judge as judging
from .starts import start

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "mioc_tpu", "bench", "benchmarks")


def load_json(*parts):
    with open(os.path.join(BENCH, *parts)) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str):
    """``(cell, config, traffic)`` of a cell, found by name."""
    cell = load_json("workloads", f"{name}.json")
    return cell, load_json("configs", f"{cell['config']}.json"), \
        load_json("traffic", f"{cell['traffic']}.json")


def reference_model(cfg: dict, dtype=np.float64):
    mod = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    return mod.Model(cfg, dtype)


def readers() -> dict:
    """The reader (``metrics/<name>.py``) of every per-layer metric that
    ``BENCHMARK.json`` lists, by metric name."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        names = [m["name"] for m in json.load(fh)["per_layer"]]
    return {n: load_module(os.path.join(BENCH, "metrics", f"{n}.py"),
                           f"portbench_metric_{i}").read for i, n in enumerate(names)}


def loaded_forbidden() -> list:
    """Top-level names of ``sys.modules`` that the port's process must not
    hold, compared whole (``mioc_tpu_torch`` is not ``mioc_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def pool_starts(levels, nt: int, traffic: dict, first_seed: int = None):
    """The pool: ``pool`` calls of ``batch`` starts each, call j's start i
    drawn from seed ``first_seed + j·batch + i``."""
    b, n = int(traffic["batch"]), int(traffic["pool"])
    s0 = int(traffic["first_seed"] if first_seed is None else first_seed)
    return [np.stack([start(levels, nt, s0 + j * b + i) for i in range(b)]) for j in range(n)]


def trm_parameters(preset: dict, maxiter=None):
    from mioc_tpu_torch.solvers.trm import TRMParameters

    kw = {k: judging.preset_value(v) for k, v in preset.items() if k != "maxiter"}
    kw["kmax"] = int(kw.get("kmax", 40))
    kw["maxiter"] = int(preset.get("maxiter", 1000) if maxiter is None else maxiter)
    return TRMParameters(**kw)


class Program:
    """The program under test for one cell: its objective and its entry."""

    def __init__(self, cfg: dict, traffic: dict, device: str = "cuda", dtype=None):
        import torch

        from mioc_tpu_torch.models.registry import build

        self.torch = torch
        self.cfg, self.traffic = cfg, traffic
        self.device = torch.device(device)
        self.dtype = dtype or getattr(torch, cfg["dtype"])
        self.obj = build(cfg["program"]["problem"], int(cfg["nt"]), device=device,
                         dtype=self.dtype)
        self.par = trm_parameters(cfg["preset"])
        self.entry = traffic["entry"]

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def solve(self, x0s, par=None):
        """One call of the traffic's entry on ``x0s (batch, nt, nx)``; one
        answer per start (numpy)."""
        from mioc_tpu_torch.solvers import trm, trm_device

        par = par or self.par
        spec = self.traffic.get("speculative")
        if self.entry == "trm_solve":
            r = trm.trm_solve(self.obj, par, x0=x0s[0])
            rows = [r]
        elif self.entry == "trm_solve_device":
            rows = [trm_device.trm_solve_device(self.obj, par, x0=x0s[0], speculative=spec)]
        elif self.entry == "multistart_solve_device":
            r = trm_device.multistart_solve_device(self.obj, par, x0s, speculative=spec)
            rows = [type(r)(*[leaf[i] for leaf in r]) for i in range(len(r.J))]
        else:
            raise ValueError(f"unknown entry {self.entry!r}")
        self.sync()
        return [dict(u=np.asarray(r.u), x_final=np.asarray(r.x_final), J=float(r.J),
                     f=float(r.f), tv=float(r.tv), converged=bool(r.converged),
                     iterations=int(r.iterations)) for r in rows]

    def gradients(self, us):
        """The program's gradient at each control of ``us`` by the sweeps
        its entry drives, at the window's row count."""
        torch, obj = self.torch, self.obj
        out = []
        if self.entry == "trm_solve":
            for u in us:
                obj.x = obj.as_control(u)
                obj.eval_f_()
                obj.eval_df_()
                out.append(obj.df.cpu().numpy())
            return out
        b = int(self.traffic["batch"])
        for i in range(0, len(us), b):
            xs = torch.as_tensor(np.stack(us[i:i + b]), dtype=self.dtype, device=self.device)
            _, ys = obj._forward_batch(xs)
            df, _ = obj._adjoint_batch(xs, ys)
            out.extend(df.cpu().numpy())
        return out


def window(prog: Program, pool, seed: int, seconds: float, log=None, max_calls=None):
    """Run passes over the pool until one ends at or after ``seconds`` (or
    ``max_calls`` calls have run: a traced run traces the first call).
    Returns ``(t0, t1, calls, answers, failed)``; ``answers`` holds
    ``(pool index, answer)`` for every start that returned."""
    rng = np.random.default_rng(seed)
    answers, failed, calls = [], 0, 0
    prog.sync()
    t0 = time.perf_counter()
    while True:
        order = rng.permutation(len(pool))
        for j in order[:max_calls]:
            tc, cc = time.perf_counter(), time.thread_time()
            try:
                got = prog.solve(pool[j])
            except Exception as exc:  # a call that raises counts as failed starts
                failed += len(pool[j])
                if log:
                    log(f"call {j} raised {type(exc).__name__}: {exc}")
                continue
            calls += 1
            if log:
                log(f"call {j}: {time.perf_counter() - tc:.3f} s, "
                    f"host thread cpu {time.thread_time() - cc:.3f} s")
            answers.extend((int(j), a) for a in got)
            failed += len(pool[j]) - len(got)
        if max_calls or time.perf_counter() - t0 >= seconds:
            break
    prog.sync()
    return t0, time.perf_counter(), calls, answers, failed


def judge_answers(prog: Program, ref, answers, failed: int):
    """Readings of the compared numbers; identical answers of one pool
    item (a later pass of the same start) are judged once."""
    seen, unique = set(), []
    for j, a in answers:
        key = (j, a["u"].tobytes(), a["x_final"].tobytes(), a["J"], a["f"], a["tv"])
        if key not in seen:
            seen.add(key)
            unique.append(a)
    grads = prog.gradients([a["u"] for a in unique])
    for a, g in zip(unique, grads):
        a["grad"] = g
    failed += sum(not a["converged"] for _, a in answers)
    return judging.judge(ref, prog.cfg["preset"], unique, failed)


def checks(readings: dict, limits: dict) -> dict:
    """Each compared number beside its limit; ``correct`` is every reading
    at or under its limit."""
    return {k: {"value": readings[k], "limit": limits[k]} for k in limits}


def passed(chk: dict) -> bool:
    return all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in chk.values())
