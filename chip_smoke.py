#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mioc_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the CUDA kernels from
``mioc_tpu_torch/csrc`` (one ``nvcc`` per source, all at once), then:

1. holds each kernel against its plain PyTorch version on the card at three
   DP shapes (fishing nt=1024 L=3 B=170; conv nt=2048 L=5 B=128; heat-scale
   nt=1024 L=36 B=204), in float32 and float64, with inputs from a seeded
   numpy generator.  The tables U and phi0 must be BIT-equal and the chased
   level indices equal for B_new ∈ {B, B//2, B//4, 0}.  Times are CUDA-event
   medians, taken in turns (plain, kernel, kernel, plain);
2. drives the port's main path as a user would:
   ``trm_solve(LVMObj(nt=1024), TRMParameters(beta=1e-4, delta0=2.0, p=inf),
   seed=0)`` on the card at float64, with every launch count set to 0 just
   before and read just after.  It must converge in 41 iterations and 193
   inner steps to J = 0.9304798828368771 (rtol 1e-12) — the JAX package's
   result on the CPU at float64 — with 41 ``dp_build`` and 193 ``chase``
   launches and no call of the plain DP; and it must equal the same solve
   run here with ``device="cpu"`` (same iterations, same accepted u, J to
   rtol 1e-12).

Each finding is printed as one JSON object per line; the ``kernels`` line
comes next to last and the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any mismatch, exception or failed build exits non-zero before that line.
Without CUDA, or without the package beside this file, it exits non-zero.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W): HBM
# bandwidth, and the non-tensor-core float32 and float64 rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}

# The JAX package's fishing preset solve, on the CPU at float64, seed 0.
REF_J = 0.9304798828368771
REF_ITERATIONS = 41
REF_INNER = 193

SHAPES = (
    # name, nt, B, level set, (p, beta, tau) — the bundled problems' presets
    ("fishing", 1024, 170, ("bounded", [[0, 1]] * 3), (math.inf, 1e-4, 12.0 / 1024)),
    ("conv", 2048, 128, ("product", [[-2, -1, 0, 1, 2]]), (1, 1e-4, 1.0 / 1024)),
    ("heat", 1024, 204, ("product", [list(range(6))] * 2), (2, 1e-3, 2.0 / 204.8)),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps: int) -> list:
    """Per-call CUDA-event times of ``fn`` (ms)."""
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def in_turns(torch, plain, kernel, reps_plain: int, reps_kernel: int):
    """Median ms of kernel and plain, timed plain, kernel, kernel, plain."""
    plain()
    kernel()
    torch.cuda.synchronize()
    p = median_ms(torch, plain, reps_plain)
    k = median_ms(torch, kernel, reps_kernel)
    k += median_ms(torch, kernel, reps_kernel)
    p += median_ms(torch, plain, reps_plain)
    return statistics.median(k), statistics.median(p)


def bound(nbytes: int, ops: int, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bits(t, torch):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def kernel_phase(torch, name, nt, B, level_spec, preset, dtype, seed):
    from mioc_tpu_torch.ops import levels as lv
    from mioc_tpu_torch.ops.backtrack_cuda import chase
    from mioc_tpu_torch.ops.bellman import (backtrack_plain, build_tables_plain,
                                            max_budget_use, stage_tables)
    from mioc_tpu_torch.ops.bellman_cuda import dp_build

    kind, V = level_spec
    adm = lv.bounded_sum_levels(V, 1, 1) if kind == "bounded" else lv.product_levels(V)
    p, beta, tau = preset
    L = adm.L
    rng = np.random.default_rng(seed)
    dev = torch.device(DEVICE)
    grad = torch.as_tensor(rng.normal(size=(nt, adm.M)), dtype=dtype, device=dev)
    # u_old from the admissible rows, so every b̃ ≤ smax.
    u_old = torch.as_tensor(adm.levels[rng.integers(0, L, size=nt)], dtype=dtype,
                            device=dev)
    jump = torch.as_tensor(lv.jump_cost_table(adm.levels, p, beta=beta), dtype=dtype,
                           device=dev)
    smax = max_budget_use(adm.levels)
    stage, btilde = stage_tables(grad, u_old, adm.levels, tau)

    U_k, phi_k = dp_build(stage, btilde, jump, B, smax)
    U_p, phi_p = build_tables_plain(stage, btilde, jump, B, smax)
    torch.cuda.synchronize()
    require(U_k.dtype == U_p.dtype and U_k.shape == U_p.shape, f"{name} U layout")
    require(torch.equal(U_k, U_p), f"{name} {dtype}: U bit-equal")
    require(torch.equal(bits(phi_k, torch), bits(phi_p, torch)),
            f"{name} {dtype}: phi0 bit-equal")
    finite = torch.isfinite(phi_k)
    phi_err = float((phi_k[finite] - phi_p[finite]).abs().max()) if finite.any() else 0.0
    budgets = sorted({B, B // 2, B // 4, 0}, reverse=True)
    idx_err = 0
    for bn in budgets:
        i_k = chase(U_k, phi_k, btilde, bn)
        i_p = backtrack_plain(U_k, phi_k, btilde, bn)
        require(i_k.shape == (nt,) and i_k.dtype == torch.int32, f"{name} idx layout")
        idx_err = max(idx_err, int((i_k.long() - i_p.long()).abs().max()))
        require(idx_err == 0, f"{name} {dtype}: chase equal at B_new={bn}")

    dt_name = "float64" if dtype == torch.float64 else "float32"
    ds, us = phi_k.element_size(), U_k.element_size()
    # Work this run's data needs: an output (i, l, b) relaxes L successors
    # (L adds, L-1 compares) and adds its stage cost when b̃ ≤ smax and
    # b ≥ b̃; otherwise it only adds the stage cost to +inf.
    s = btilde[:-1].long()
    valid = int(torch.where(s <= min(smax, B), (B + 1 - s).clamp(min=0), 0).sum())
    total = (nt - 1) * L * (B + 1)
    build_ops = valid * 2 * L + (total - valid)
    build_bytes = (nt * L * (ds + 4) + L * L * ds + (nt - 1) * L * (B + 1) * us
                   + L * (B + 1) * ds)
    # The chase reads the phi0 plane for its seed, then one U and one b̃
    # entry per step, and writes nt indices.
    chase_bytes = L * (B + 1) * ds + (nt - 1) * (us + 4) + nt * 4
    chase_ops = L * (B + 1) + (nt - 1)

    b_ms, b_plain = in_turns(
        torch, lambda: build_tables_plain(stage, btilde, jump, B, smax),
        lambda: dp_build(stage, btilde, jump, B, smax), 2, 5)
    c_ms, c_plain = in_turns(
        torch, lambda: backtrack_plain(U_k, phi_k, btilde, B),
        lambda: chase(U_k, phi_k, btilde, B), 3, 10)
    bb_ms, bb_by = bound(build_bytes, build_ops, dt_name)
    cb_ms, cb_by = bound(chase_bytes, chase_ops, dt_name)
    out = {
        "phase": "kernels", "shape": name, "dtype": dt_name, "nt": nt, "L": L,
        "B": B, "smax": smax, "u_dtype": str(U_k.dtype).replace("torch.", ""),
        "dp_build": {"bit_equal": True, "max_abs_err": phi_err, "kernel_ms": b_ms,
                     "plain_ms": b_plain, "bound_ms": bb_ms, "bound_by": bb_by,
                     "ops": build_ops, "bytes": build_bytes},
        "chase": {"equal_at": budgets, "max_abs_err": idx_err, "kernel_ms": c_ms,
                  "plain_ms": c_plain, "bound_ms": cb_ms, "bound_by": cb_by,
                  "ops": chase_ops, "bytes": chase_bytes},
    }
    emit(out)
    return out


def main_path(torch):
    from mioc_tpu_torch.models import LVMObj
    from mioc_tpu_torch.ops import bellman
    from mioc_tpu_torch.ops.backtrack_cuda import chase
    from mioc_tpu_torch.ops.bellman_cuda import dp_build
    from mioc_tpu_torch.solvers.trm import TRMParameters, trm_solve

    par = TRMParameters(beta=1e-4, delta0=2.0, p=math.inf)

    dp_build.launches = 0
    chase.launches = 0
    bellman.build_tables_plain.calls = 0
    bellman.backtrack_plain.calls = 0
    t0 = time.perf_counter()
    res = trm_solve(LVMObj(nt=1024), par, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"dp_build": dp_build.launches, "chase": chase.launches}
    plain_calls = {"build_tables_plain": bellman.build_tables_plain.calls,
                   "backtrack_plain": bellman.backtrack_plain.calls}

    t0 = time.perf_counter()
    ref = trm_solve(LVMObj(nt=1024, device="cpu"), par, seed=0)
    cpu_wall = time.perf_counter() - t0

    emit({"phase": "main_path", "problem": "fishing", "nt": 1024, "dtype": "float64",
          "J": res.J, "converged": res.converged, "iterations": res.iterations,
          "inner_steps": res.inner_steps, "dp_builds": res.dp_builds,
          "f_evals": res.f_evals, "df_evals": res.df_evals,
          "launches": launches, "plain_calls_on_card": plain_calls,
          "wall_s": wall, "timings_s": res.timings,
          "f_ms_per_eval": 1e3 * res.timings["f"] / res.f_evals,
          "df_ms_per_eval": 1e3 * res.timings["df"] / res.df_evals,
          "cpu_solve": {"J": ref.J, "iterations": ref.iterations,
                        "inner_steps": ref.inner_steps, "wall_s": cpu_wall,
                        "timings_s": ref.timings}})

    require(res.converged, "main path converged")
    require(res.u.shape == (1024, 3) and np.isfinite(res.u).all(), "u shape, finite")
    require(bool((res.u.sum(axis=1) == 1).all()), "u rows admissible (SOS1)")
    require(res.iterations == REF_ITERATIONS, f"iterations {res.iterations} == 41")
    require(res.inner_steps == REF_INNER, f"inner steps {res.inner_steps} == 193")
    require(abs(res.J - REF_J) <= 1e-12 * abs(REF_J), f"J {res.J!r} == {REF_J!r}")
    require(launches["dp_build"] == res.dp_builds == REF_ITERATIONS,
            f"dp_build launches {launches['dp_build']} == dp_builds")
    require(launches["chase"] == res.inner_steps,
            f"chase launches {launches['chase']} == inner steps")
    require(plain_calls == {"build_tables_plain": 0, "backtrack_plain": 0},
            f"no plain DP on the card: {plain_calls}")
    require(ref.iterations == res.iterations and ref.inner_steps == res.inner_steps,
            "card solve == CPU solve: iterations")
    require(np.array_equal(ref.u, res.u), "card solve == CPU solve: accepted u")
    require(abs(ref.J - res.J) <= 1e-12 * abs(ref.J), "card solve == CPU solve: J")
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "mioc_tpu_torch")):
        print("chip_smoke.py: the mioc_tpu_torch package is not beside this file",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    emit({"phase": "device", "kind": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    print(smi, flush=True)

    from mioc_tpu_torch.ops import _kernels

    build_s = _kernels.build_all()
    ptxas = {n: [ln.strip() for ln in _kernels.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln] for n in _kernels.SOURCES}
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})

    phases = {}
    for seed, (name, nt, B, spec, preset) in enumerate(SHAPES):
        for dtype in (torch.float32, torch.float64):
            phases[(name, dtype)] = kernel_phase(torch, name, nt, B, spec, preset,
                                                 dtype, seed)

    launches = main_path(torch)

    main_shape = phases[("fishing", torch.float64)]
    rows = []
    for key, src, tpu in (("dp_build", "dp_build.cu", "mioc_tpu/ops/bellman_pallas.py:123"),
                          ("chase", "chase.cu", "mioc_tpu/ops/backtrack_pallas.py:49")):
        m = main_shape[key]
        rows.append({"name": key, "route": "cuda", "source": f"mioc_tpu_torch/csrc/{src}",
                     "replaces": tpu, "launches": launches[key],
                     "max_abs_err": m["max_abs_err"], "ms": m["kernel_ms"],
                     "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                     "bound_by": m["bound_by"], "library_ms": None})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
