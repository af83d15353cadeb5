#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mioc_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--heat-only]

Run from the root of a checkout (``--heat-only``: the build, then only the
heat paths of 7, ``heat_rows`` and ``pde_sweep``).  It builds the CUDA kernels from
``mioc_tpu_torch/csrc`` (one ``nvcc`` per source, all at once), then:

1. holds the single-start kernels (``dp_build``, ``chase``, ``chase_vec``)
   against their plain PyTorch versions on the card at three DP shapes
   (fishing nt=1024 L=3 B=170; conv nt=2048 L=5 B=128; heat-scale nt=1024
   L=36 B=204), in float32 and float64, with inputs from a seeded numpy
   generator.  The tables U and phi0 must be BIT-equal and the chased level
   indices of both chases equal for B_new ∈ {B, B//2, B//4, 0}; at the
   infeasible cap -1, and on tables with a +inf seed (u_old's row 0 more
   than smax from every level), all four chase kernels must equal the plain
   walk.  Times are CUDA-event medians per call, host side of the call
   included, taken in turns (plain, kernel, kernel, plain), and
   ``chase_vec`` in turns with ``chase`` too; each kernel's ns per step is
   its ms·10⁶/(nt-1).  (The kernels' device times alone come from
   ``python -m mioc_tpu_torch.profile_kernels``: a profiler trace here
   would slow every later launch of this process, and so the paths' walls);
2. holds the batched kernels (``dp_build_batched``, ``chase_batched``,
   ``chase_trials``) against their plain versions the same way, at fishing
   (S=32 starts), conv (S=8) and heat scale (S=8), float32 and float64:
   tables bit-equal under the cluster size the plan takes (printed with the
   plan), per-start caps and Kt=9 trial caps (the fishing halving schedule
   170 … 0; B, B/2, … 0 at conv and heat scale) giving equal indices, and a
   trial wave of caps -1, 0, B, past B and between, in another order for
   each start, on tables whose every other start has a +inf seed;
   ``chase_batched`` on the stride-0 trial wave of a single solve (K=9 caps
   against one table set: the fishing preset's halving schedule, and the
   conv device loop's 128 … 0), equal to the plain walk and timed in turns
   with the plain version and with ``chase``; then the edge shapes (nt 1 and
   2, L = 1, B = 0, chase chunks of one step, build rows read in place at the
   shared-memory limit, 149 chase chunks) for ``dp_build``,
   ``dp_build_batched`` (one block per start, and the largest cluster the
   plan takes, forced), ``chase``, ``chase_vec``, ``chase_batched`` (one set
   of maps, and a set per row) and ``chase_trials`` (two starts of the caps);
3. drives the port's paths as a user would, each with every launch count set
   to 0 just before it and read just after, on the card at float64 with the
   fishing preset ``LVMObj(nt=1024)``, ``TRMParameters(beta=1e-4,
   delta0=2.0, p=inf)``:
   a. the host loop ``trm_solve(..., seed=0)``: 41 iterations, 193 inner
      steps, J = 0.9304798828368771 (rtol 1e-12) — the JAX package's result
      on the CPU at float64 — through 41 ``dp_build`` and 193 ``chase``
      launches, equal to the same solve run here with ``device="cpu"``;
   b. the device-resident ``trm_solve_device(..., seed=0)`` (speculative
      trial waves, the ``"vmap"`` wave chase): the same iterations, inner
      steps, J and accepted u as (a), one ∇f fewer, through 41 ``dp_build``
      and 41 ``chase_batched`` launches;
   c. ``multistart_solve_device`` over 32 starts ``rand_func(obj, seed=s)``,
      sequential inner loop: every start converged, admissible, equal to the
      JAX package's result (iterations and inner steps equal, J to rtol
      1e-12; constants below), start 0 equal to (b); through
      ``dp_build_batched`` and 387 ``chase_batched`` launches;
   d. the same with ``speculative=True``: every field equal to (c), through
      ``dp_build_batched`` and ``chase_trials``.
   No path may call a plain DP version on the card, and every fishing path
   here and below (the temporal and sharded host loops, the mesh
   multistarts) launches ``lvm_forward`` once per f sweep and
   ``lvm_adjoint`` once per ∇f sweep that its spans recorded;
   then ``temporal``: the banded temporal DP (``parallel.temporal``, tensor
   code) at the fishing preset (nt=1024, B=170, L=3), heat500 (500, 100, 36)
   and heat200 (200, 40, 36): ``phis[0].T`` equal to ``dp_build``'s Φ0 to
   rtol 1e-10, the paths equal to ``chase``'s at B and every halving cap,
   the tables bit-equal to the same function's on the CPU, with ms per
   ``temporal_tables``/``temporal_backtrack`` beside the kernels' ms and the
   peak device memory; and the fishing preset host loop with
   ``dp_backend="temporal"`` from seed 0, capped at ``TEMPORAL_MAXITER``
   outer iterations (the whole solve takes ~40–50 s, ~20 s of it the
   temporal route's chases): the iterations, inner steps and u of
   the kernel route at the same cap, J to rtol 1e-10, with no kernel
   launched; then ``continuous``:
   ``SteepestDescent(ArmijoLS(sigma=1e-3), maxiter=8)`` on ``LVMObj(nt=1024)``
   from x = 0.5 and ``NonlinCG(WolfeLS())``, ``SteepestDescent(WolfeLS())``
   on a 12×1 quadratic on the card: the JAX package's f (rtol 1e-12),
   iterations and evaluation counts, the quadratic's x within 1e-12
   (``REF_SD_ARMIJO``, ``REF_QUADRATIC``);
4. holds the fishing sweep kernels (``csrc/ode_lvm.cu``) bit-equal to the
   plain PyTorch sweeps on the card at the row counts the paths use (1, 9,
   32 and 288 rows, nt=1024), one launch a call, and times both (ms per
   batched f and ∇f, in turns); then ``ode_bits``: the double tank, Van der Pol and Fuller
   (also with its soft terminal condition) at nt=1024, f and ∇f at ``rand_func(obj, seed=0)`` bit-equal to the JAX
   package's CPU values (``ODE_BITS``: ``float.hex`` of f, sha256 of ∇f),
   with ms per batched f and ∇f at S = 1 and 32;
5. holds the rows of ``ConvObj(nt=2048)``'s batched f and ∇f (1, 9 and 32
   rows) bit-equal to single evaluations, and reports whether one raw
   ``torch.matmul`` would have given each row the same bits (it is why the
   objective evaluates in fixed-shape chunks);
   then ``mixed`` (the kernels first at the integer block's nt=240 shape,
   B=40): (a) ``mixed_solve(LVMMixedObj(nt=1024), MixedParameters(trm=
   preset, rounds=1), seed=0)`` and (b) the port's CLI in this process,
   ``mixed --n 240 --seed 0 --no-plot --no-log``: the JAX package's J (rtol
   1e-12), rounds, ``converged`` and forward/adjoint sweep counts
   (``REF_MIXED_A``/``REF_MIXED_B``), for (a) its history (rtol 1e-12), its
   integer columns equal to the JAX package's and ``c`` within 1e-12
   (``tests/data/jax_mixed_fishing_nt1024_round1.npz``), each through
   ``dp_build`` and ``chase`` only, with where its time goes (sweeps × ms
   per sweep, kernels × ms per call);
6. runs the CLI as a user does, ``mioc_tpu_torch.cli.main`` in this process
   with stdout captured and its JSON line parsed, each run with the launch
   counts set to 0 just before and read just after:
   a. ``convolution --n 2048 --seed 0 --no-plot --no-log``: the JAX
      package's iterations, f and ∇f evaluations and J (rtol 1e-12; the
      constants ``CLI_REFS`` below), through one ``dp_build`` per iteration
      (each on one block: no ``dp_build.cluster_launches``) and one
      ``chase`` per inner step (1696), no ``chase_vec``;
   b. the same under ``MIOC_CHASE=vec``: equal fields and accepted u (read
      from ``--checkpoint``), through 1696 ``chase_vec`` and no ``chase``;
   c. the same with ``--device-loop`` (speculative wave): the JAX package's
      device-loop constants, through one ``dp_build`` and one
      ``chase_batched`` per iteration;
   d. ``doubletank``, ``vanderpol`` and ``fuller`` at ``--n 1024 --seed
      0``: the JAX package's constants, J bit for bit; then ``vanderpol
      --n 2000 --seed 0 --device-loop``, its published grid through the
      device loop (``vanderpol_device_cli``): converged, through one
      ``dp_build`` and one ``chase_batched`` per iteration and no sweep
      kernel (its sweeps are PyTorch's);
   and prints where the time of (a) and (b) goes, the chases against the
   rest, with the A/B of the two chases at every shape;
7. drives the heat problem, ``HeatObj(nt=500)`` (N = 545 P2 dofs from the
   native triangulator, which must build; L = 36, B = 100) under its preset
   ``TRMParameters(beta=1e-3, delta0=2.0, p=2)`` at float64, each path with
   the launch counts set to 0 just before it and read just after:
   e. the host loop through the CLI, ``heat --n 500 --seed 0 --no-plot
      --no-log --checkpoint …`` (the JAX CLI's own example): the JAX
      package's iterations, f and ∇f evaluations and J (``CLI_REFS``),
      through one ``dp_build`` per iteration, each a cluster launch
      (``dp_build.cluster_launches``), and one ``chase`` per inner step and
      no other kernel;
   f. the device loop ``trm_solve_device(HeatObj(nt=500), preset, seed=0)``
      (speculative, the ``"trials"`` wave chase): the iterations, inner
      steps, J and accepted u of (e), one ∇f fewer, through one ``dp_build``
      (a cluster launch) and one ``chase_trials`` per outer iteration and no
      other kernel;
   g. ``multistart_solve_device`` over the 8 starts ``rand_func(obj,
      seed=s)``, sequential and speculative: every start equal to the JAX
      package's result (iterations and inner steps equal, J to rtol 1e-12;
      constants ``REF8_HEAT_*``), start 0 equal to (f), the speculative run
      equal to the sequential one field for field; through
      ``dp_build_batched`` in a cluster form (C > 1, printed with the plan)
      and ``chase_batched`` (sequential) or ``chase_trials`` (speculative);
   each heat path launching the dense sweep kernel (``csrc/pde_dense.cu``)
   once per f and once per ∇f sweep that its spans recorded;
   then ``heat_rows``: a heat forward and adjoint evaluated as 1, 2, 8, 9,
   16, 17, 64 and 72 rows, every row bit-equal to the single evaluation of
   that row, with the ms per batched f and ∇f at each row count; then
   ``pde_sweep``: the dense sweep kernel alone at 1, 8, 16 and 64 rows,
   forward and reverse, against the plain sweep (to 1e-13; ms per call
   beside the library's sweep, ``library_ms``); the
   kernels at the heat solve's shape (``dp_build``, ``chase``, ``chase_vec``;
   the S=8 batched kernels with the preset's 8 halving caps; ``chase_trials``
   on one table set with those caps), each held against its plain version;
   and where each heat path's time goes: the sweeps (evaluations × ms per
   batch), the kernels (launches × ms per call at that shape), the rest;
8. drives large-mesh heat, ``heat_large``: the JAX package's own large-mesh
   configuration ``HeatObj(nt=200, mesh_hierarchy=
   construct_mesh_hierarchy(refinements=5), solver="mg", cg_iters=12,
   sparse_format="banded")`` at float64 (N = 8321 P2 dofs, the banded
   spec R = 66, D = 7, rb = cb = 128, 5 multigrid levels; L = 36, B = 40):
   the host operators (RCM permutation, packed K and M, every level's K/P/R
   blocks, 1/diag(K), the coarse inverse) against the JAX package's
   (``LARGE_OPS``); f and ∇f at ``rand_func(obj, seed=0)`` against its
   values (``LARGE_F``, ``LARGE_DF_B64``) within the measured tolerances;
   the rows of a 16-row batch at nt=200 and of 1, 2, 8, 9, 16 and 17-row
   batches at nt=20 bit-equal to single evaluations (and whether one
   product at the natural width would be); ms per fine banded application
   against its bound; the host loop ``trm_solve`` and the device loop
   ``trm_solve_device``, speculative and sequential, from seed 0 under the
   heat preset capped at ``LARGE_MAXITER`` outer iterations: the JAX
   package's iterations, inner steps, evaluations and J (``LARGE_REF``),
   the device loops equal to the host loop's iterates and to each other
   field for field, through ``dp_build`` and ``chase`` (host and sequential)
   or ``chase_trials`` (speculative) and no plain DP; the batched
   multistart over 8 starts (start 0 is the solves' seed 0) at the same cap,
   sequential and speculative: every start's iterations and inner steps
   equal to the JAX package's and J within 1e-12 (``LARGE8_*``), start 0
   equal to ``LARGE_REF``, speculative equal to sequential field for field,
   through ``dp_build_batched`` and ``chase_batched`` or ``chase_trials``
   only, with each run's wall, ms per start, the wave's rows and the sparse
   engine's rows per chunk, beside the ms per sweep at 1 and 8 rows; the ELL engine's f
   and ∇f at the same model against the banded engine's; then the kernels
   at nt=200, L=36, B=40 (single, S=8 batched, one table set's wave), where
   each large path's time goes, and last (a profiler trace slows every
   later launch) the kernels per fine application and per sweep step
   (``profile_kernels.large_sweep_section``).

9. drives the multi-rank half of ``parallel/`` (``torch.distributed``),
   after the fishing multistarts: ``world_of_one``, the fishing preset host
   loop with ``dp_backend="sharded"`` and no mesh in this process (a world
   of one over NCCL): the (a) result through no ``dp_build`` and one
   ``chase`` per inner step; then a world of ``WORLD`` = 4 ranks spawned on
   this one card (gloo, which ``init_multihost`` picks for ranks that share
   a card; joined under ``WORLD_TIMEOUT``), each rank running
   ``sharded_tables`` (``build_tables_sharded`` at fishing on 1×2 and 1×4,
   heat500 on 1×4: cropped to L bit-equal to ``dp_build``'s and the plain
   build's, the padded rows inert, ``chase`` on the padded tables equal to
   ``chase`` on ``dp_build``'s at B and every halving cap; ms per build and
   µs per collective), ``sharded_host`` (the fishing and heat500 host loops
   on a 1×4 mesh capped at ``SHARDED_MAXITER`` — one collective per DP
   step, ~4.2 ms each over gloo here — equal to the kernel route at the
   same cap, through no ``dp_build`` and one ``chase`` per inner step),
   ``mesh_multistart`` (the 32 starts on 4×1: the JAX constants and this
   process's multistart field for field, through ``dp_build_batched`` and
   ``chase_batched``; 8 starts on 2×2 sharded and speculative, capped at
   ``MESH_SPEC_MAXITER``: the world-of-one run's fields, through
   ``chase_trials`` and no build kernel), ``ode_step_mesh``
   (``make_ode_trm_step`` at S=8 on 4×1 and 2×2, bit-equal to the
   world-of-one step) and ``temporal_sharded`` (fishing and heat200,
   bit-equal to ``temporal_tables``); then ``cli_torchrun``,
   ``torch.distributed.run --standalone --nproc-per-node 4 -m
   mioc_tpu_torch.cli fishing --device-loop --multistart 32`` (nt=1024):
   rank 0's one JSON line equals the one-process CLI's, which is the best
   start of the multistart (c), and its J is the least JAX constant; and,
   after the CLI runs, ``plots``: ``fuller --n 1024`` and ``heat --n 60
   --device-loop`` without ``--no-plot`` in a temporary directory (the
   plot, the ``.dat`` files and the animation; without matplotlib, the
   solve's line and then the ``ModuleNotFoundError`` the JAX CLI raises).
   The walls of the 4-rank phases measure four processes contending for
   one card, not scaling.

Each finding is printed as one JSON object per line; the ``kernels`` line
(every kernel's ms per call, plain ms, bound and launches on each path, the
fishing sweep kernels' too) comes next to last and the last line is
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
# The latency of one float64 fma, add or mul on the H100 (a dependent chain
# of each timed with clock64, profile_kernels.py), and its SM clock at full
# boost: the bound of the fishing sweep kernels, whose rows are chains of
# dependent operations.
F64_LATENCY_CYCLES = 8.3
SM_CLOCK_HZ = 1.98e9
# The fishing sweep kernels (csrc/ode_lvm.cu) and the dependent float64
# operations a step of a row's chain: fma, sub, mul, fma in either sweep.
SWEEP_KERNELS = ("lvm_forward", "lvm_adjoint")
SWEEP_CHAIN_OPS = 4
# The dense PDE sweep kernel (csrc/pde_dense.cu): one launch per heat sweep.
PDE_SWEEP_KERNEL = "dense_sweep"

# The JAX package's fishing preset solve, on the CPU at float64, seed 0.
REF_J = 0.9304798828368771
REF_ITERATIONS = 41
REF_INNER = 193

# The JAX package's batched multistart of the fishing preset (nt=1024) from
# the 32 starts rand_func(obj, seed=s), s = 0 … 31, on the CPU at float64:
#   JAX_PLATFORMS=cpu python -c "import jax, numpy as np
#   jax.config.update('jax_enable_x64', True)
#   from mioc_tpu.models import LVMObj; from mioc_tpu.solvers.trm import TRMParameters
#   from mioc_tpu.solvers.trm_device import multistart_solve_device
#   from mioc_tpu.utils.init import rand_func
#   obj = LVMObj(nt=1024); x0s = np.stack([rand_func(obj, seed=s) for s in range(32)])
#   r = multistart_solve_device(obj, TRMParameters(beta=1e-4, delta0=2.0, p=np.inf), x0s)
#   print(r.iterations.tolist(), r.inner_steps.tolist(), [float(j) for j in r.J])"
REF32_ITERATIONS = (41, 45, 38, 39, 34, 35, 30, 47, 55, 32, 23, 42, 20, 28, 40, 45,
                    19, 56, 53, 45, 35, 54, 37, 33, 48, 48, 18, 47, 28, 31, 35, 46)
REF32_INNER = (193, 217, 168, 182, 165, 175, 136, 229, 279, 143, 88, 200, 72, 122,
               188, 223, 79, 292, 261, 204, 168, 267, 176, 153, 250, 246, 68, 227,
               115, 134, 154, 217)
REF32_J = (0.9304798828368771, 0.9356193732626554, 0.933153304738131,
           0.9336901847730771, 0.9311594529513193, 0.9426448204140109,
           0.9385177634801724, 0.9391829964916898, 0.9313760170590545,
           0.9388375858648962, 0.933378701396758, 0.932653579348153,
           0.9315401910458031, 0.9367911591137649, 0.9309332108899605,
           0.9325019181898286, 0.9402396991763876, 0.9321600570188987,
           0.93532160734833, 0.9332695294235023, 0.9362075716150043,
           0.939046116292238, 0.9411525526690405, 0.9387554655451024,
           0.9367389928210853, 0.9367725490420378, 0.9338187669683115,
           0.9360519109334589, 0.9307827378230108, 0.9351341998846148,
           0.9368280889757825, 0.9342508091655368)
N_STARTS = 32
# The sequential multistart's batched chases: one per step of its inner
# loop, over the 32 starts above (chip_smoke.py, PR 4).
REF32_SEQ_CHASES = 387
PRESET = dict(beta=1e-4, delta0=2.0, p=math.inf)

# The JAX package's CLI on the CPU at float64, one line per run below (the
# printed JSON's J, iterations, f_evals and df_evals); each from
#   JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 python -m mioc_tpu.cli <args> --seed 0 --no-plot --no-log
# The host loop's inner steps are f_evals − 1 (no kmax restore in these
# solves), which is the count of single chases.
CLI_REFS = {
    "convolution --n 2048": (0.004834434453146139, 287, 1697, 288),
    "convolution --n 2048 --device-loop": (0.00483443445314614, 287, 1697, 287),
    "doubletank --n 1024": (4.739496951260922, 11, 42, 12),
    "vanderpol --n 1024": (2.41124024148147, 31, 57, 32),
    "fuller --n 1024": (0.000777635513012828, 32, 183, 33),
    "heat --n 500": (780.5854728417821, 223, 1414, 224),
}

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
    from mioc_tpu_torch.ops.backtrack_cuda import chase, chase_plan, chase_vec, cluster_plan
    from mioc_tpu_torch.ops.bellman import (backtrack_plain, build_tables_plain,
                                            max_budget_use, stage_tables)
    from mioc_tpu_torch.ops.bellman_cuda import cluster_build_plan, dp_build

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
    vec_err = 0
    for bn in budgets:
        i_k = chase(U_k, phi_k, btilde, bn)
        i_v = chase_vec(U_k, phi_k, btilde, bn)
        i_p = backtrack_plain(U_k, phi_k, btilde, bn)
        require(i_k.shape == (nt,) and i_k.dtype == torch.int32, f"{name} idx layout")
        require(i_v.shape == (nt,) and i_v.dtype == torch.int32, f"{name} vec idx layout")
        idx_err = max(idx_err, int((i_k.long() - i_p.long()).abs().max()))
        vec_err = max(vec_err, int((i_v.long() - i_p.long()).abs().max()))
        require(idx_err == 0, f"{name} {dtype}: chase equal at B_new={bn}")
        require(vec_err == 0, f"{name} {dtype}: chase_vec equal at B_new={bn}")
    # The infeasible cap (-1 masks every seed) and a +inf seed (u_old's row 0
    # more than smax from every level, so phi0 is +inf): the walk's budget
    # leaves [0, B], and all four chase kernels follow the plain walk's index
    # rule (a negative budget counts from the end, then clamps).
    all_chases_equal(torch, U_k, phi_k, btilde, (-1,), f"{name} {dtype} infeasible cap")
    u_far = u_old.clone()
    u_far[0] = float(np.abs(adm.levels).max() + smax + 1)
    st_f, bt_f = stage_tables(grad, u_far, adm.levels, tau)
    U_f, phi_f = dp_build(st_f, bt_f, jump, B, smax)
    U_fp, phi_fp = build_tables_plain(st_f, bt_f, jump, B, smax)
    require(torch.equal(U_f, U_fp) and torch.equal(bits(phi_f, torch), bits(phi_fp, torch)),
            f"{name} {dtype}: +inf-seed tables bit-equal")
    require(not bool(torch.isfinite(phi_f).any()), f"{name} {dtype}: phi0 all +inf")
    all_chases_equal(torch, U_f, phi_f, bt_f, budgets, f"{name} {dtype} +inf seed")

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
    v_ms, v_plain = in_turns(
        torch, lambda: backtrack_plain(U_k, phi_k, btilde, B),
        lambda: chase_vec(U_k, phi_k, btilde, B), 3, 10)
    # The A/B of the two chases, in turns within one call: chase, chase_vec,
    # chase_vec, chase; 30 calls a turn, as a call's host side varies by tens
    # of µs from one call to the next.
    ab_vec, ab_chase = in_turns(
        torch, lambda: chase(U_k, phi_k, btilde, B),
        lambda: chase_vec(U_k, phi_k, btilde, B), 30, 30)
    bb_ms, bb_by = bound(build_bytes, build_ops, dt_name)
    cb_ms, cb_by = bound(chase_bytes, chase_ops, dt_name)
    steps = max(nt - 1, 1)
    out = {
        "phase": "kernels", "shape": name, "dtype": dt_name, "nt": nt, "L": L,
        "B": B, "smax": smax, "u_dtype": str(U_k.dtype).replace("torch.", ""),
        "infeasible_equal_at": [-1], "inf_seed_equal_at": budgets,
        "dp_build": {"bit_equal": True, "max_abs_err": phi_err, "kernel_ms": b_ms,
                     "ns_per_step": b_ms * 1e6 / steps, "plain_ms": b_plain,
                     "bound_ms": bb_ms, "bound_by": bb_by, "ops": build_ops,
                     "bytes": build_bytes,
                     "plan": cluster_build_plan(1, nt, L, B, ds, smax)._asdict()},
        "chase": {"equal_at": budgets, "max_abs_err": idx_err, "kernel_ms": c_ms,
                  "ns_per_step": c_ms * 1e6 / steps, "plain_ms": c_plain,
                  "bound_ms": cb_ms, "bound_by": cb_by, "ops": chase_ops,
                  "bytes": chase_bytes, "plan": chase_plan(nt, L, B, us)._asdict()},
        # The same function as chase, so the same bound.
        "chase_vec": {"equal_at": budgets, "max_abs_err": vec_err, "kernel_ms": v_ms,
                      "ns_per_step": v_ms * 1e6 / steps, "plain_ms": v_plain,
                      "bound_ms": cb_ms, "bound_by": cb_by,
                      "plan": cluster_plan(U_k, phi_k)._asdict(),
                      "in_turns_with_chase": {"chase_vec_ms": ab_vec,
                                              "chase_ms": ab_chase}},
    }
    emit(out)
    return out


def all_chases_equal(torch, U, phi0, btilde, caps, what) -> None:
    """``chase``, ``chase_vec``, ``chase_batched`` (two starts reading one
    table set, start stride 0) and ``chase_trials`` equal the plain walk at
    each cap."""
    from mioc_tpu_torch.ops.backtrack_cuda import (chase, chase_batched, chase_trials,
                                                   chase_vec)
    from mioc_tpu_torch.ops.bellman import backtrack_plain

    for cap in caps:
        want = backtrack_plain(U, phi0, btilde, cap)
        two = torch.tensor([cap, cap], dtype=torch.int32, device=phi0.device)
        got = {"chase": chase(U, phi0, btilde, cap),
               "chase_vec": chase_vec(U, phi0, btilde, cap),
               "chase_batched": chase_batched(U.expand(2, -1, -1, -1),
                                              phi0.expand(2, -1, -1),
                                              btilde.expand(2, -1, -1), two),
               "chase_trials": chase_trials(U[None], phi0[None], btilde[None],
                                            two[None])[0]}
        for kernel, idx in got.items():
            require(torch.equal(idx, want.expand_as(idx)),
                    f"{what}: {kernel} equal to the plain walk at cap {cap}")


EDGES = (
    # name, nt, B, level set: nt 1 and 2 (one chase chunk), L = 1, B = 0,
    # chase chunks of one step, build rows read in place (L ≤ 2 at the largest B the first build kernel
    # took, B = None), more chase chunks than the card holds blocks at once.
    ("nt1", 1, 9, ("bounded", [[0, 1]] * 3)),
    ("nt2", 2, 4, ("product", [[-2, -1, 0, 1, 2]])),
    ("L1", 300, 7, ("product", [[0]])),
    ("B0", 300, 0, ("bounded", [[0, 1]] * 3)),
    ("one_step_chunks", 30, 6, ("product", [[-2, -1, 0, 1, 2]])),
    ("L1_limit", 5, None, ("product", [[0]])),
    ("L2_limit", 5, None, ("product", [[0, 1]])),
    ("heat_149_chunks", 4000, 204, ("product", [list(range(6))] * 2)),
)


def edge_phase(torch) -> dict:
    """The edge shapes: ``dp_build`` and ``dp_build_batched`` (two starts,
    at one block per start and at the largest cluster the plan takes there,
    min(16, B+1), forced) bit-equal to the plain build; ``chase``,
    ``chase_vec``, ``chase_batched`` (the caps as rows, on one set of maps
    at stride 0 and on a set per row) and ``chase_trials`` (the caps, in
    two orders, against the two starts' tables) equal to the plain walk at
    caps B+5, B, B/2, B/4, 0 and -1, in float32 and float64."""
    from mioc_tpu_torch.ops import bellman as tb
    from mioc_tpu_torch.ops import levels as lv
    from mioc_tpu_torch.ops.backtrack_cuda import (chase, chase_batched, chase_plan,
                                                   chase_trials, chase_vec, cluster_plan)
    from mioc_tpu_torch.ops.bellman_cuda import (build_plan, cluster_build_plan, dp_build,
                                                 dp_build_batched)

    cases = []
    for seed, (name, nt, B, (kind, V)) in enumerate(EDGES):
        adm = lv.bounded_sum_levels(V, 1, 1) if kind == "bounded" else lv.product_levels(V)
        L = adm.L
        for dtype in (torch.float32, torch.float64):
            item = 8 if dtype == torch.float64 else 4
            Bx = (232448 // item - L * L) // (2 * L) - 1 if B is None else B
            rng = np.random.default_rng(100 + seed)
            grad = torch.as_tensor(rng.normal(size=(2, nt, adm.M)), dtype=dtype, device=DEVICE)
            u_old = torch.as_tensor(adm.levels[rng.integers(0, L, size=(2, nt))],
                                    dtype=dtype, device=DEVICE)
            jump = torch.as_tensor(lv.jump_cost_table(adm.levels, 1, beta=0.05),
                                   dtype=dtype, device=DEVICE)
            smax = tb.max_budget_use(adm.levels)
            stage, btilde = tb.stage_tables(grad, u_old, adm.levels, 0.05)
            U_k, phi_k = dp_build(stage[0], btilde[0], jump, Bx, smax)
            U_p, phi_p = tb.build_tables_plain(stage[0], btilde[0], jump, Bx, smax)
            Ub_p, phib_p = tb.build_tables_batched_plain(stage, btilde, jump, Bx, smax)
            what = f"edge {name} L={L} B={Bx} nt={nt} {dtype}"
            require(torch.equal(U_k, U_p) and torch.equal(bits(phi_k, torch),
                                                          bits(phi_p, torch)),
                    f"{what}: dp_build bit-equal")
            build_plans = {}
            for C in sorted({1, min(16, Bx + 1)}):
                Ub_k, phib_k = dp_build_batched(stage, btilde, jump, Bx, smax, clusters=C)
                require(torch.equal(Ub_k, Ub_p) and torch.equal(bits(phib_k, torch),
                                                                bits(phib_p, torch)),
                        f"{what}: dp_build_batched bit-equal at {C} CTAs per start")
                build_plans[C] = cluster_build_plan(2, nt, L, Bx, item, smax, C)._asdict()
            caps = sorted({Bx + 5, Bx, Bx // 2, Bx // 4, 0, -1}, reverse=True)
            want = torch.stack([tb.backtrack_plain(U_p, phi_p, btilde[0], c) for c in caps])
            for k, cap in enumerate(caps):
                require(torch.equal(chase(U_p, phi_p, btilde[0], cap), want[k]),
                        f"{what}: chase equal at cap {cap}")
                require(torch.equal(chase_vec(U_p, phi_p, btilde[0], cap), want[k]),
                        f"{what}: chase_vec equal at cap {cap}")
            K = len(caps)
            caps_t = torch.tensor(caps, dtype=torch.int32, device=DEVICE)
            wave = (U_p.expand(K, -1, -1, -1), phi_p.expand(K, -1, -1),
                    btilde[0].expand(K, -1, -1))
            require(torch.equal(chase_batched(*wave, caps_t), want),
                    f"{what}: chase_batched on one set of maps equal at caps {caps}")
            require(torch.equal(chase_batched(*(t.contiguous() for t in wave), caps_t), want),
                    f"{what}: chase_batched on a set per row equal at caps {caps}")
            two = torch.stack([caps_t, caps_t.flip(0)])
            require(torch.equal(chase_trials(Ub_p, phib_p, btilde, two),
                                tb.backtrack_trials_plain(Ub_p, phib_p, btilde, two.cpu())),
                    f"{what}: chase_trials equal at caps {caps} on two starts")
            us = U_p.element_size()
            cases.append({"edge": name, "dtype": str(dtype).replace("torch.", ""),
                          "nt": nt, "L": L, "B": Bx, "caps": caps,
                          "build_plan": build_plan(nt, L, Bx, item)._asdict(),
                          "batched_build_plans": build_plans,
                          "trials_plan": chase_plan(nt, L, Bx, us, 2, 2 * K)._asdict(),
                          "chase_plan": chase_plan(nt, L, Bx, us)._asdict(),
                          "batched_plans": [chase_plan(nt, L, Bx, us, 1, K)._asdict(),
                                            chase_plan(nt, L, Bx, us, K, K)._asdict()],
                          "vec_plan": cluster_plan(U_p, phi_p)._asdict()})
    out = {"phase": "edges", "cases": cases}
    emit(out)
    return out


def schedule(delta0: float, dt: float, kmax: int = 40) -> list:
    """The device TRM's static halving caps ⌊δ/Δt⌋, δ = δ₀, δ₀/2, … down to
    0, floored in float64 (the solves' dtype)."""
    caps, d = [], np.float64(delta0)
    for _ in range(kmax):
        caps.append(int(np.floor(d / np.float64(dt))))
        if caps[-1] == 0:
            return caps
        d = d / np.float64(2.0)
    return caps


BATCHED = (
    # name, S, index into SHAPES, trial caps
    ("fishing", 32, 0, schedule(2.0, 12.0 / 1024)),
    ("conv", 8, 1, [128 >> k for k in range(8)] + [0]),
    ("heat", 8, 2, [204 >> k for k in range(8)] + [0]),
)


def batched_phase(torch, name, S, shape, trial_caps, dtype, seed):
    from mioc_tpu_torch.ops import bellman as tb
    from mioc_tpu_torch.ops import levels as lv
    from mioc_tpu_torch.ops.backtrack_cuda import chase_batched, chase_plan, chase_trials
    from mioc_tpu_torch.ops.bellman_cuda import cluster_build_plan, dp_build_batched

    _, nt, B, (kind, V), (p, beta, tau) = shape
    adm = lv.bounded_sum_levels(V, 1, 1) if kind == "bounded" else lv.product_levels(V)
    L = adm.L
    rng = np.random.default_rng(seed)
    dev = torch.device(DEVICE)
    grad = torch.as_tensor(rng.normal(size=(S, nt, adm.M)), dtype=dtype, device=dev)
    u_old = torch.as_tensor(adm.levels[rng.integers(0, L, size=(S, nt))], dtype=dtype,
                            device=dev)
    jump = torch.as_tensor(lv.jump_cost_table(adm.levels, p, beta=beta), dtype=dtype,
                           device=dev)
    smax = tb.max_budget_use(adm.levels)
    stage, btilde = tb.stage_tables(grad, u_old, adm.levels, tau)
    Kt = len(trial_caps)
    caps = torch.tensor([trial_caps[s % Kt] for s in range(S)], dtype=torch.int32,
                        device=dev)
    trials = torch.tensor([trial_caps] * S, dtype=torch.int32, device=dev)

    U_k, phi_k = dp_build_batched(stage, btilde, jump, B, smax)
    U_p, phi_p = tb.build_tables_batched_plain(stage, btilde, jump, B, smax)
    torch.cuda.synchronize()
    require(U_k.shape == U_p.shape and U_k.dtype == U_p.dtype, f"{name} batched U layout")
    require(torch.equal(U_k, U_p), f"{name} S={S} {dtype}: batched U bit-equal")
    require(torch.equal(bits(phi_k, torch), bits(phi_p, torch)),
            f"{name} S={S} {dtype}: batched phi0 bit-equal")
    finite = torch.isfinite(phi_k)
    phi_err = float((phi_k[finite] - phi_p[finite]).abs().max()) if finite.any() else 0.0
    i_k = chase_batched(U_k, phi_k, btilde, caps)
    i_p = tb.backtrack_batched_plain(U_k, phi_k, btilde, caps.cpu())
    idx_err = int((i_k.long() - i_p.long()).abs().max())
    require(idx_err == 0, f"{name} {dtype}: batched chase equal at caps {caps.tolist()}")
    t_k = chase_trials(U_k, phi_k, btilde, trials)
    t_p = tb.backtrack_trials_plain(U_k, phi_k, btilde, trials.cpu())
    trial_err = int((t_k.long() - t_p.long()).abs().max())
    require(trial_err == 0, f"{name} {dtype}: trial chase equal at caps {trial_caps}")
    # Mixed caps in one wave (-1, 0, B, past B and between, another order per
    # start) on tables whose odd starts have a +inf seed (u_old row 0 more
    # than smax from every level): rows of other sets and sentinels side by
    # side in one launch.
    u_far = u_old.clone()
    u_far[1::2, 0] = float(np.abs(adm.levels).max() + smax + 1)
    st_f, bt_f = tb.stage_tables(grad, u_far, adm.levels, tau)
    U_f, phi_f = dp_build_batched(st_f, bt_f, jump, B, smax)
    U_fp, phi_fp = tb.build_tables_batched_plain(st_f, bt_f, jump, B, smax)
    require(torch.equal(U_f, U_fp) and torch.equal(bits(phi_f, torch), bits(phi_fp, torch)),
            f"{name} S={S} {dtype}: +inf-seed batched tables bit-equal")
    require(not bool(torch.isfinite(phi_f[1::2]).any()), f"{name}: odd starts' phi0 +inf")
    mixed = [-1, 0, B, B + 3, B // 2, B // 4, 1, -2, B // 3][:Kt]
    mixed_caps = torch.tensor(np.array([np.random.default_rng(seed + s).permutation(mixed)
                                        for s in range(S)]), dtype=torch.int32, device=dev)
    require(torch.equal(chase_trials(U_f, phi_f, bt_f, mixed_caps),
                        tb.backtrack_trials_plain(U_f, phi_f, bt_f, mixed_caps.cpu())),
            f"{name} S={S} {dtype}: trial chase equal at mixed caps {mixed} on +inf seeds")

    dt_name = "float64" if dtype == torch.float64 else "float32"
    ds, us = phi_k.element_size(), U_k.element_size()
    # Work this run's data needs, as for the single kernels, over S starts.
    s_ = btilde[:, :-1].long()
    valid = int(torch.where(s_ <= min(smax, B), (B + 1 - s_).clamp(min=0), 0).sum())
    total = S * (nt - 1) * L * (B + 1)
    build_ops = valid * 2 * L + (total - valid)
    build_bytes = (S * (nt * L * (ds + 4) + (nt - 1) * L * (B + 1) * us
                        + L * (B + 1) * ds) + L * L * ds)
    one_chase = L * (B + 1) * ds + (nt - 1) * (us + 4) + nt * 4 + 4
    chase_bytes = S * one_chase
    chase_ops = S * (L * (B + 1) + (nt - 1))
    # Trial wave: phi0 once per start, Kt × (nt-1) entries of U and b̃, Kt
    # index rows and caps.
    trial_bytes = S * (L * (B + 1) * ds + Kt * ((nt - 1) * (us + 4) + nt * 4 + 4))
    trial_ops = S * Kt * (L * (B + 1) + (nt - 1))

    b_ms, b_plain = in_turns(
        torch, lambda: tb.build_tables_batched_plain(stage, btilde, jump, B, smax),
        lambda: dp_build_batched(stage, btilde, jump, B, smax), 2, 5)
    c_ms, c_plain = in_turns(
        torch, lambda: tb.backtrack_batched_plain(U_k, phi_k, btilde, caps.cpu()),
        lambda: chase_batched(U_k, phi_k, btilde, caps), 3, 10)
    t_ms, t_plain = in_turns(
        torch, lambda: tb.backtrack_trials_plain(U_k, phi_k, btilde, trials.cpu()),
        lambda: chase_trials(U_k, phi_k, btilde, trials), 3, 10)
    out = {"phase": "batched_kernels", "shape": name, "dtype": dt_name, "S": S,
           "nt": nt, "L": L, "B": B, "u_dtype": str(U_k.dtype).replace("torch.", ""),
           "caps": caps.tolist(), "trial_caps": trial_caps, "mixed_trial_caps": mixed}
    for key, ms, plain, nbytes, ops, err in (
            ("dp_build_batched", b_ms, b_plain, build_bytes, build_ops, phi_err),
            ("chase_batched", c_ms, c_plain, chase_bytes, chase_ops, idx_err),
            ("chase_trials", t_ms, t_plain, trial_bytes, trial_ops, trial_err)):
        bd_ms, bd_by = bound(nbytes, ops, dt_name)
        out[key] = {"bit_equal": True, "max_abs_err": err, "kernel_ms": ms,
                    "ns_per_step": ms * 1e6 / max(nt - 1, 1), "plain_ms": plain,
                    "bound_ms": bd_ms, "bound_by": bd_by, "ops": ops, "bytes": nbytes}
    out["dp_build_batched"]["plan"] = cluster_build_plan(S, nt, L, B, ds, smax)._asdict()
    out["chase_trials"]["plan"] = chase_plan(nt, L, B, us, S, S * Kt)._asdict()
    emit(out)
    return out


WAVES = (
    # name, index into SHAPES, caps: the trial wave of the fishing preset's
    # single device solve (its halving schedule, K=9) and of the conv device
    # loop (B, B/2, …, 1, 0 at the CLI's δ₀ = 0.125, K=9)
    ("fishing", 0, schedule(2.0, 12.0 / 1024)),
    ("conv", 1, [128 >> k for k in range(8)] + [0]),
)


def wave_phase(torch, name, shape, caps, dtype, seed):
    """``chase_batched`` on the stride-0 wave of a single solve: K caps as
    rows against one table set expanded along the start axis (one set of
    state maps), equal to the plain walk of each cap; timed in turns with
    the plain batched chase, and with one ``chase`` call at the same shape
    (chase, wave, wave, chase)."""
    from mioc_tpu_torch.ops import bellman as tb
    from mioc_tpu_torch.ops import levels as lv
    from mioc_tpu_torch.ops.backtrack_cuda import chase, chase_batched, chase_plan
    from mioc_tpu_torch.ops.bellman_cuda import dp_build

    _, nt, B, (kind, V), (p, beta, tau) = shape
    adm = lv.bounded_sum_levels(V, 1, 1) if kind == "bounded" else lv.product_levels(V)
    L = adm.L
    rng = np.random.default_rng(seed)
    grad = torch.as_tensor(rng.normal(size=(nt, adm.M)), dtype=dtype, device=DEVICE)
    u_old = torch.as_tensor(adm.levels[rng.integers(0, L, size=nt)], dtype=dtype,
                            device=DEVICE)
    jump = torch.as_tensor(lv.jump_cost_table(adm.levels, p, beta=beta), dtype=dtype,
                           device=DEVICE)
    smax = tb.max_budget_use(adm.levels)
    stage, btilde = tb.stage_tables(grad, u_old, adm.levels, tau)
    U, phi0 = dp_build(stage, btilde, jump, B, smax)
    K = len(caps)
    wave = (U.expand(K, -1, -1, -1), phi0.expand(K, -1, -1), btilde.expand(K, -1, -1))
    caps_t = torch.tensor(caps, dtype=torch.int32, device=DEVICE)
    got = chase_batched(*wave, caps_t)
    want = torch.stack([tb.backtrack_plain(U, phi0, btilde, c) for c in caps])
    err = int((got.long() - want.long()).abs().max())
    require(err == 0, f"{name} wave {dtype}: chase_batched equal at caps {caps}")
    ms, plain = in_turns(torch, lambda: tb.backtrack_batched_plain(*wave, caps_t.cpu()),
                         lambda: chase_batched(*wave, caps_t), 3, 10)
    ab_wave, ab_chase = in_turns(torch, lambda: chase(U, phi0, btilde, caps[0]),
                                 lambda: chase_batched(*wave, caps_t), 30, 30)
    dt_name = "float64" if dtype == torch.float64 else "float32"
    ds, us = phi0.element_size(), U.element_size()
    # phi0 once (its K masked argmins), one U and one b̃ entry per step and
    # row, K index rows and caps.
    nbytes = L * (B + 1) * ds + K * ((nt - 1) * (us + 4) + nt * 4 + 4)
    ops = K * (L * (B + 1) + (nt - 1))
    bd_ms, bd_by = bound(nbytes, ops, dt_name)
    out = {"phase": "wave_kernels", "shape": name, "dtype": dt_name, "K": K, "nt": nt,
           "L": L, "B": B, "caps": caps,
           "chase_batched": {"bit_equal": True, "max_abs_err": err, "kernel_ms": ms,
                             "ns_per_step": ms * 1e6 / max(nt - 1, 1), "plain_ms": plain,
                             "bound_ms": bd_ms, "bound_by": bd_by, "ops": ops,
                             "bytes": nbytes,
                             "plan": chase_plan(nt, L, B, us, 1, K)._asdict(),
                             "in_turns_with_chase": {"wave_ms": ab_wave,
                                                     "chase_ms": ab_chase}}}
    emit(out)
    return out


def zero_counts(torch):
    """Set every kernel's launch count and every plain version's call count
    to 0; returns a reader of both."""
    from mioc_tpu_torch.ops import bellman as tb
    from mioc_tpu_torch.ops.backtrack_cuda import (chase, chase_batched, chase_trials,
                                                   chase_vec)
    from mioc_tpu_torch.ops.bellman_cuda import dp_build, dp_build_batched
    from mioc_tpu_torch.ops.ode_cuda import lvm_adjoint, lvm_forward
    from mioc_tpu_torch.ops.pde_cuda import dense_sweep

    kernels = {"dp_build": dp_build, "chase": chase, "dp_build_batched": dp_build_batched,
               "chase_batched": chase_batched, "chase_trials": chase_trials,
               "chase_vec": chase_vec, "lvm_forward": lvm_forward, "lvm_adjoint": lvm_adjoint,
               "dense_sweep": dense_sweep}
    plains = {n: getattr(tb, n) for n in (
        "build_tables_plain", "backtrack_plain", "build_tables_batched_plain",
        "backtrack_batched_plain", "backtrack_trials_plain")}
    for f in kernels.values():
        f.launches = 0
    dp_build.cluster_launches = 0
    for f in plains.values():
        f.calls = 0

    def read():
        torch.cuda.synchronize()
        return ({n: f.launches for n, f in kernels.items()},
                {n: f.calls for n, f in plains.items()})

    return read


def cluster_builds() -> int:
    """The ``dp_build`` launches that took a cluster (C > 1) since
    :func:`zero_counts`."""
    from mioc_tpu_torch.ops.bellman_cuda import dp_build

    return dp_build.cluster_launches


def record_sweeps() -> None:
    """Start recording the program's spans (``mioc_tpu_torch/utils/trace.py``)
    with none recorded before; :func:`recorded_sweeps` reads them."""
    from mioc_tpu_torch.utils import trace

    trace.take()
    trace.enable()


def recorded_sweeps() -> dict:
    """Stop recording; the objective's batched sweeps since
    :func:`record_sweeps` by rows passed, ``{"f": {rows: sweeps}, "df":
    {rows: sweeps}}``, from the program's ``<layer>.f``/``<layer>.df`` spans."""
    from mioc_tpu_torch.utils import trace

    trace.disable()
    counts = {"f": {}, "df": {}}
    for sp in trace.take():
        layer, _, tag = sp.name.rpartition(".")
        if layer.endswith("_sweep"):
            rows = sp.attrs["rows"]
            counts[tag][rows] = counts[tag].get(rows, 0) + 1
    return counts


def require_sweep_launches(name, launches, sweeps) -> None:
    """A fishing path (``LVMObj`` float64 on the card) launches the forward
    sweep kernel once per f sweep and the adjoint kernel once per ∇f sweep
    that its spans recorded, whatever the rows."""
    f, df = sum(sweeps["f"].values()), sum(sweeps["df"].values())
    require(f > 0 and df > 0
            and (launches["lvm_forward"], launches["lvm_adjoint"]) == (f, df),
            f"{name}: one lvm_forward per f sweep ({f}) and one lvm_adjoint per ∇f sweep "
            f"({df}): {launches}")


def host_path(torch):
    from mioc_tpu_torch.models import LVMObj
    from mioc_tpu_torch.solvers.trm import TRMParameters, trm_solve

    par = TRMParameters(**PRESET)
    record_sweeps()
    read = zero_counts(torch)
    t0 = time.perf_counter()
    res = trm_solve(LVMObj(nt=1024), par, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = read()
    sweeps = recorded_sweeps()

    t0 = time.perf_counter()
    ref = trm_solve(LVMObj(nt=1024, device="cpu"), par, seed=0)
    cpu_wall = time.perf_counter() - t0

    emit({"phase": "host_path", "problem": "fishing", "nt": 1024, "dtype": "float64",
          "J": res.J, "converged": res.converged, "iterations": res.iterations,
          "inner_steps": res.inner_steps, "dp_builds": res.dp_builds,
          "f_evals": res.f_evals, "df_evals": res.df_evals,
          "launches": launches, "plain_calls_on_card": plain_calls, "sweeps": sweeps,
          "wall_s": wall, "timings_s": res.timings,
          "f_ms_per_eval": 1e3 * res.timings["f"] / res.f_evals,
          "df_ms_per_eval": 1e3 * res.timings["df"] / res.df_evals,
          "cpu_solve": {"J": ref.J, "iterations": ref.iterations,
                        "inner_steps": ref.inner_steps, "wall_s": cpu_wall,
                        "timings_s": ref.timings}})

    require(res.converged, "host path converged")
    require(res.u.shape == (1024, 3) and np.isfinite(res.u).all(), "u shape, finite")
    require(bool((res.u.sum(axis=1) == 1).all()), "u rows admissible (SOS1)")
    require(res.iterations == REF_ITERATIONS, f"iterations {res.iterations} == 41")
    require(res.inner_steps == REF_INNER, f"inner steps {res.inner_steps} == 193")
    require(abs(res.J - REF_J) <= 1e-12 * abs(REF_J), f"J {res.J!r} == {REF_J!r}")
    require(launches["dp_build"] == res.dp_builds == REF_ITERATIONS,
            f"dp_build launches {launches['dp_build']} == dp_builds")
    require(launches["chase"] == res.inner_steps,
            f"chase launches {launches['chase']} == inner steps")
    require_sweep_launches("host path", launches, sweeps)
    require(not any(plain_calls.values()), f"no plain DP on the card: {plain_calls}")
    require(ref.iterations == res.iterations and ref.inner_steps == res.inner_steps,
            "card solve == CPU solve: iterations")
    require(np.array_equal(ref.u, res.u), "card solve == CPU solve: accepted u")
    require(abs(ref.J - res.J) <= 1e-12 * abs(ref.J), "card solve == CPU solve: J")
    return res, launches


def device_single_path(torch, host):
    from mioc_tpu_torch.models import LVMObj
    from mioc_tpu_torch.solvers.trm import TRMParameters
    from mioc_tpu_torch.solvers.trm_device import trm_solve_device

    obj = LVMObj(nt=1024)
    record_sweeps()
    read = zero_counts(torch)
    t0 = time.perf_counter()
    res = trm_solve_device(obj, TRMParameters(**PRESET), seed=0)
    wall = time.perf_counter() - t0
    launches, plain_calls = read()
    sweeps = recorded_sweeps()
    emit({"phase": "device_single", "problem": "fishing", "nt": 1024,
          "dtype": "float64", "speculative": True, "wave_chase": "vmap",
          "J": float(res.J), "converged": bool(res.converged),
          "iterations": int(res.iterations), "inner_steps": int(res.inner_steps),
          "f_evals": int(res.f_evals), "df_evals": int(res.df_evals),
          "dp_builds": int(res.dp_builds), "launches": launches,
          "plain_calls_on_card": plain_calls, "sweeps": sweeps, "wall_s": wall})
    require(bool(res.converged), "device solve converged")
    require(int(res.iterations) == REF_ITERATIONS, "device solve: 41 iterations")
    require(int(res.inner_steps) == REF_INNER, "device solve: 193 inner steps")
    require(abs(float(res.J) - REF_J) <= 1e-12 * abs(REF_J), f"device J {float(res.J)!r}")
    require(int(res.df_evals) == host.df_evals - 1, "device df_evals == host's − 1")
    require(np.array_equal(res.u, host.u), "device solve == host solve: accepted u")
    require(launches["dp_build"] == launches["chase_batched"] == REF_ITERATIONS,
            f"device solve: 41 dp_build and 41 chase_batched launches: {launches}")
    require(launches["chase"] == 0, "device solve's wave chases with chase_batched")
    require_sweep_launches("device solve", launches, sweeps)
    require(not any(plain_calls.values()), f"no plain DP on the card: {plain_calls}")
    return res, launches, wall, sweeps


def multistart_path(torch, x0s, speculative: bool):
    from mioc_tpu_torch.models import LVMObj
    from mioc_tpu_torch.solvers.trm import TRMParameters
    from mioc_tpu_torch.solvers.trm_device import multistart_solve_device

    obj = LVMObj(nt=1024)
    record_sweeps()
    read = zero_counts(torch)
    t0 = time.perf_counter()
    res = multistart_solve_device(obj, TRMParameters(**PRESET), x0s,
                                  speculative=speculative)
    wall = time.perf_counter() - t0
    launches, plain_calls = read()
    sweeps = recorded_sweeps()
    name = "multistart_speculative" if speculative else "multistart_sequential"
    emit({"phase": name, "problem": "fishing", "nt": 1024, "dtype": "float64",
          "S": len(x0s), "J": res.J.tolist(), "converged": res.converged.tolist(),
          "iterations": res.iterations.tolist(), "inner_steps": res.inner_steps.tolist(),
          "max_iterations": int(res.iterations.max()), "launches": launches,
          "plain_calls_on_card": plain_calls, "sweeps": sweeps, "wall_s": wall,
          "ms_per_start": 1e3 * wall / len(x0s)})
    require(bool(res.converged.all()), f"{name}: every start converged")
    require(bool((res.u.sum(axis=2) == 1).all()), f"{name}: rows admissible (SOS1)")
    require(not any(plain_calls.values()), f"{name}: no plain DP on the card")
    its = int(res.iterations.max())
    require(launches["dp_build_batched"] == its, f"{name}: one batched build per outer")
    wave = "chase_trials" if speculative else "chase_batched"
    require(launches[wave] >= its and launches["dp_build"] == launches["chase"] == 0,
            f"{name}: chases through {wave}: {launches}")
    if speculative:
        require(launches["chase_batched"] == 0, f"{name}: no batched chase")
    else:
        require(launches["chase_batched"] == REF32_SEQ_CHASES,
                f"{name}: {REF32_SEQ_CHASES} chase_batched launches: {launches}")
    require_sweep_launches(name, launches, sweeps)
    return res, launches, wall, sweeps


def sweep_times(torch, x0s) -> dict:
    """The fishing sweeps at the row counts the paths use (S = 1, 9, 32 and
    288 rows of the 32 starts, nt=1024, float64): the kernel path
    (``_forward_batch``, ``_adjoint_batch``, one launch of
    ``csrc/ode_lvm.cu`` each) bit-equal to the plain PyTorch sweeps
    (``_forward_batch_torch``, ``_adjoint_batch_torch``) on the same inputs
    in f, the states, ∇f and λ; and ms per batched f and ∇f of each,
    CUDA-event medians with the host side of the call, in turns (plain,
    kernel, kernel, plain)."""
    from mioc_tpu_torch.models import LVMObj
    from mioc_tpu_torch.ops import ode_cuda

    obj = LVMObj(nt=1024)
    xs = torch.as_tensor(x0s, dtype=obj.dtype, device=obj.device)
    out = {"f": {}, "df": {}, "plain_f": {}, "plain_df": {}}
    for S in (1, 9, 32, 288):
        rows = xs[torch.arange(S, device=xs.device) % len(xs)]
        before = ode_cuda.lvm_forward.launches, ode_cuda.lvm_adjoint.launches
        f, ys = obj._forward_batch(rows)
        df, lam = obj._adjoint_batch(rows, ys)
        after = ode_cuda.lvm_forward.launches, ode_cuda.lvm_adjoint.launches
        require((after[0] - before[0], after[1] - before[1]) == (1, 1),
                f"sweeps at {S} rows: one launch of each kernel a call: {before} → {after}")
        f_t, ys_t = obj._forward_batch_torch(rows)
        df_t, lam_t = obj._adjoint_batch_torch(rows, ys_t)
        for name, a, b in (("f", f, f_t), ("ys", ys, ys_t), ("df", df, df_t),
                           ("lam", lam, lam_t)):
            require(torch.equal(bits(a, torch), bits(b, torch)),
                    f"sweeps at {S} rows: the kernel's {name} bit-equal to the plain sweep's")
        out["f"][S], out["plain_f"][S] = in_turns(
            torch, lambda: obj._forward_batch_torch(rows), lambda: obj._forward_batch(rows), 2, 5)
        out["df"][S], out["plain_df"][S] = in_turns(
            torch, lambda: obj._adjoint_batch_torch(rows, ys),
            lambda: obj._adjoint_batch(rows, ys), 2, 5)
    emit({"phase": "sweeps", "nt": 1024, "dtype": "float64", "bit_equal_plain": True,
          **{f"{kind}_ms": t for kind, t in out.items()}})
    return out


# The JAX package's f and ∇f of the double tank, Van der Pol and Fuller at
# nt=1024, rand_func(obj, seed=0), on the CPU at float64 (the default
# sweep_unroll 8): float.hex of f and the sha256 of ∇f's little-endian
# float64 bytes, from
#   JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 python -c "import hashlib, numpy as np, jax.numpy as jnp
#   from mioc_tpu.models import DTMObj, VPOObj, FullerObj
#   from mioc_tpu.utils.init import rand_func
#   for c in (DTMObj, VPOObj, FullerObj):
#       o = c(nt=1024); o.x = jnp.asarray(rand_func(o, seed=0)); f = o.eval_f_(); o.eval_df_()
#       print(c.__name__, float(f).hex(),
#             hashlib.sha256(np.asarray(o.df, dtype='<f8').tobytes()).hexdigest())"
# and "FullerT" (Fuller with the soft terminal condition, ODE_KW) from the
# same command with FullerObj(nt=1024, terminal_weight=50.0).
ODE_KW = {"FullerT": ("FullerObj", {"terminal_weight": 50.0})}
ODE_BITS = {
    "DTMObj": ("0x1.1f5a0aa98e351p+5",
               "8e5771fc50bfc163a27b3cc12bb2d7b5a378e79afacc2e818d2112f28df40d2e"),
    "VPOObj": ("0x1.71f93bf1bf34dp+1",
               "429f4baf17704855105e83da1f183889a2fd9e693ab2266cd7edd3cded19e1fb"),
    "FullerObj": ("0x1.4fbdf6e4b15b6p-15",
                  "e3ce3cc6fa63b968790a7aa1aa8ac4f73a6a7c99a0abd12e984fb3b55565ebb7"),
    "FullerT": ("0x1.40a01e061cc56p-9",
                "c36bbf26d71cec6e4b54cfae31ea40cc72bfddf2fd1adc367e33ecfdd20a334b"),
}


def ode_bits(torch) -> dict:
    """The double tank, Van der Pol and Fuller (also with its soft terminal
    condition) on the card at nt=1024: f and ∇f at ``rand_func(obj,
    seed=0)`` bit-equal to the JAX package's CPU values (:data:`ODE_BITS`),
    and ms per batched f and ∇f at S = 1 and 32 rows (CUDA-event medians of
    5, the sizes in turns)."""
    import hashlib

    from mioc_tpu_torch import models
    from mioc_tpu_torch.ops import xla_order
    from mioc_tpu_torch.utils.init import rand_func

    out = {"phase": "ode_bits", "nt": 1024, "dtype": "float64",
           "sqrt_rounds": xla_order.sqrt_rounds(DEVICE),
           "addcmul_fuses": xla_order.addcmul_fuses(DEVICE), "models": {}}
    for name, (f_hex, df_sha) in ODE_BITS.items():
        cls, kw = ODE_KW.get(name, (name, {}))
        obj = getattr(models, cls)(nt=1024, **kw)
        X = torch.as_tensor(np.stack([rand_func(obj, seed=s) for s in range(32)]),
                            dtype=obj.dtype, device=obj.device)
        f, ys = obj._forward(X[0])
        df, _ = obj._adjoint(X[0], ys)
        got = (float(f).hex(), hashlib.sha256(
            np.ascontiguousarray(df.cpu().numpy(), dtype="<f8").tobytes()).hexdigest())
        times = {"f": {}, "df": {}}
        for S in (1, 32, 32, 1):
            _, ysb = obj._forward_batch(X[:S])
            times["f"].setdefault(S, []).extend(
                median_ms(torch, lambda: obj._forward_batch(X[:S]), 5))
            times["df"].setdefault(S, []).extend(
                median_ms(torch, lambda: obj._adjoint_batch(X[:S], ysb), 5))
        out["models"][name] = {
            "f_hex": got[0], "df_sha256": got[1], "jax_f_hex": f_hex, "jax_df_sha256": df_sha,
            "bit_equal": got == (f_hex, df_sha),
            "f_ms": {S: statistics.median(v) for S, v in times["f"].items()},
            "df_ms": {S: statistics.median(v) for S, v in times["df"].items()}}
    emit(out)
    for name, r in out["models"].items():
        require(r["bit_equal"], f"{name}: f and ∇f at nt=1024 bit-equal to the JAX "
                f"package's ({r['f_hex']} {r['df_sha256'][:16]})")
    return out


def conv_rows(torch) -> dict:
    """ConvObj(nt=2048) on the card: rows of 1-, 9- and 32-row batched f and
    ∇f bit-equal to single evaluations (the speculative wave decides on
    them).  Also whether one raw ``torch.matmul`` gives each row the same
    bits at 1, 9 and 32 rows — the reason the objective evaluates in
    fixed-shape chunks — and ms per batched f and ∇f (CUDA events)."""
    from mioc_tpu_torch.models import ConvObj
    from mioc_tpu_torch.models.convolution import ROWS
    from mioc_tpu_torch.utils.init import rand_func

    obj = ConvObj(nt=2048)
    X = torch.as_tensor(np.stack([rand_func(obj, seed=s) for s in range(32)]),
                        dtype=obj.dtype, device=obj.device)
    f1 = torch.stack([obj._forward_batch(X[s:s + 1])[0][0] for s in range(32)])
    d1 = torch.stack([obj._adjoint_batch(X[s:s + 1], None)[0][0] for s in range(32)])
    raw1 = torch.stack([(X[s:s + 1, :, 0] @ obj._KT)[0] for s in range(32)])
    out = {"phase": "conv_rows", "nt": 2048, "dtype": "float64", "chunk_rows": ROWS,
           "f_rows_bit_equal": {}, "df_rows_bit_equal": {},
           "raw_matmul_rows_bit_equal": {}, "f_ms": {}, "df_ms": {}}
    for S in (1, 9, 32):
        f = obj._forward_batch(X[:S])[0]
        d = obj._adjoint_batch(X[:S], None)[0]
        raw = X[:S, :, 0] @ obj._KT
        out["f_rows_bit_equal"][S] = torch.equal(bits(f, torch), bits(f1[:S], torch))
        out["df_rows_bit_equal"][S] = torch.equal(bits(d, torch), bits(d1[:S], torch))
        out["raw_matmul_rows_bit_equal"][S] = torch.equal(bits(raw, torch),
                                                          bits(raw1[:S], torch))
        out["f_ms"][S] = statistics.median(
            median_ms(torch, lambda: obj._forward_batch(X[:S]), 10))
        out["df_ms"][S] = statistics.median(
            median_ms(torch, lambda: obj._adjoint_batch(X[:S], None), 10))
    emit(out)
    for S in (1, 9, 32):
        require(out["f_rows_bit_equal"][S], f"conv f rows of a {S}-row batch bit-equal")
        require(out["df_rows_bit_equal"][S], f"conv ∇f rows of a {S}-row batch bit-equal")
    return out


def run_cli(torch, name, args, chase_variant=None) -> dict:
    """``mioc_tpu_torch.cli.main(args)`` as a user runs it, in this process
    with stdout captured, launch counts zeroed before and read after;
    ``chase_variant`` sets ``MIOC_CHASE`` for the run.  Returns the parsed
    JSON line with the launches and the wall time added."""
    import contextlib
    import io

    from mioc_tpu_torch import cli

    old = os.environ.get("MIOC_CHASE")
    if chase_variant is not None:
        os.environ["MIOC_CHASE"] = chase_variant
    buf = io.StringIO()
    read = zero_counts(torch)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(args)
        launches, plain_calls = read()
    finally:
        if old is None:
            os.environ.pop("MIOC_CHASE", None)
        else:
            os.environ["MIOC_CHASE"] = old
    wall = time.perf_counter() - t0
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    require(rc == 0 and lines, f"{name}: the CLI returned {rc} and printed its JSON line")
    res = json.loads(lines[-1])
    res.update(phase="cli", path=name, argv=args, chase=chase_variant or "scalar",
               launches=launches, cluster_builds=cluster_builds(),
               plain_calls_on_card=plain_calls, wall_s_measured=wall)
    emit(res)
    require(not any(plain_calls.values()), f"{name}: no plain DP on the card")
    return res


def check_cli(res, ref_key, exact=False) -> None:
    """The JAX constants of ``CLI_REFS``; J to rtol 1e-12, or bit for bit
    where ``exact`` (the ODE models whose sweeps round as the JAX
    package's)."""
    J, its, f_evals, df_evals = CLI_REFS[ref_key]
    name = res["path"]
    require(res["converged"], f"{name}: converged")
    require((res["iterations"], res["f_evals"], res["df_evals"]) == (its, f_evals, df_evals),
            f"{name}: iterations/f_evals/df_evals {res['iterations']}/{res['f_evals']}/"
            f"{res['df_evals']} == JAX {its}/{f_evals}/{df_evals}")
    if exact:
        require(res["J"] == J, f"{name}: J {res['J']!r} == JAX {J!r} bit for bit")
    else:
        require(abs(res["J"] - J) <= 1e-12 * abs(J), f"{name}: J {res['J']!r} == JAX {J!r}")


def cli_paths(torch, tmp) -> dict:
    """The CLI runs (a)–(d) of the docstring; returns their results."""
    base = ["--seed", "0", "--no-plot", "--no-log"]
    conv = ["convolution", "--n", "2048"] + base
    out = {}
    for key, variant, kernel, other in (("conv_scalar", None, "chase", "chase_vec"),
                                        ("conv_vec", "vec", "chase_vec", "chase")):
        ck = os.path.join(tmp, f"{key}.npz")
        r = run_cli(torch, key, conv + ["--checkpoint", ck], chase_variant=variant)
        check_cli(r, "convolution --n 2048")
        n = r["launches"]
        require(n["dp_build"] == r["iterations"] and n[kernel] == r["f_evals"] - 1
                and n[other] == 0 and r["cluster_builds"] == 0,
                f"{key}: {r['iterations']} dp_build (one block each) and "
                f"{r['f_evals'] - 1} {kernel} launches, none of {other}: {n}, "
                f"{r['cluster_builds']} cluster builds")
        with np.load(ck) as z:
            r["u"] = z["u"]
        out[key] = r
    require(np.array_equal(out["conv_scalar"]["u"], out["conv_vec"]["u"]),
            "conv: the accepted u is the same with either chase")
    for field in ("J", "iterations", "f_evals", "df_evals", "converged"):
        require(out["conv_scalar"][field] == out["conv_vec"][field],
                f"conv: {field} is the same with either chase")
    r = run_cli(torch, "conv_device", conv + ["--device-loop"])
    check_cli(r, "convolution --n 2048 --device-loop")
    n = r["launches"]
    require(n["dp_build"] == n["chase_batched"] == r["iterations"] and n["chase"] == 0
            and n["chase_vec"] == 0,
            f"conv_device: one dp_build and one chase_batched per iteration: {n}")
    out["conv_device"] = r
    for problem in ("doubletank", "vanderpol", "fuller"):
        r = run_cli(torch, problem, [problem, "--n", "1024"] + base)
        check_cli(r, f"{problem} --n 1024", exact=True)
        n = r["launches"]
        require(n["dp_build"] == r["iterations"] and n["chase"] == r["f_evals"] - 1,
                f"{problem}: launches {n}")
        out[problem] = r
    out["vanderpol_device"] = vanderpol_device_cli(torch)
    for r in out.values():
        r.pop("u", None)
    return out


def vanderpol_device_cli(torch) -> dict:
    """``vanderpol --n 2000 --seed 0 --device-loop``: the CLI's run of the
    Van der Pol problem on its published grid through the device loop."""
    r = run_cli(torch, "vanderpol_device", ["vanderpol", "--n", "2000", "--seed", "0",
                                            "--no-plot", "--no-log", "--device-loop"])
    n = r["launches"]
    require(r["converged"], "vanderpol --n 2000 --device-loop: converged")
    require(n["dp_build"] == n["chase_batched"] == r["iterations"]
            and n["chase"] == n["chase_trials"] == 0
            and n["lvm_forward"] == n["lvm_adjoint"] == 0,
            f"vanderpol_device: one dp_build and one chase_batched per iteration, "
            f"no sweep kernel: {n}")
    return r


def check_multistarts(seq, spec, single):
    for s in range(N_STARTS):
        require(int(seq.iterations[s]) == REF32_ITERATIONS[s]
                and int(seq.inner_steps[s]) == REF32_INNER[s],
                f"multistart start {s}: iterations/inner steps == JAX "
                f"({int(seq.iterations[s])}/{int(seq.inner_steps[s])})")
        require(abs(float(seq.J[s]) - REF32_J[s]) <= 1e-12 * abs(REF32_J[s]),
                f"multistart start {s}: J {float(seq.J[s])!r} == {REF32_J[s]!r}")
    require(np.array_equal(seq.u[0], single.u) and int(seq.iterations[0]) == int(
        single.iterations) and int(seq.inner_steps[0]) == int(single.inner_steps),
            "multistart start 0 == single device solve")
    require(abs(float(seq.J[0]) - float(single.J)) <= 1e-12 * abs(float(single.J)),
            "multistart start 0 == single device solve: J")
    for field in ("u", "x_final", "converged", "iterations", "inner_steps", "f_evals",
                  "df_evals", "dp_builds"):
        require(np.array_equal(getattr(spec, field), getattr(seq, field)),
                f"speculative multistart == sequential: {field}")
    for field in ("J", "f", "tv"):
        a, b = getattr(spec, field), getattr(seq, field)
        require(bool(np.all(np.abs(a - b) <= 1e-12 * np.abs(b))),
                f"speculative multistart == sequential: {field}")


# The heat problem's paths: HeatObj(nt=500) (N = 545 P2 dofs from the native
# triangulator, L = 36; B = 100 and smax = 10 at the preset's δ₀ = 2, τ =
# 0.02), the JAX CLI's own example.
HEAT_NT = 500
HEAT_N = 545
HEAT_PRESET = dict(beta=1e-3, delta0=2.0, p=2)
HEAT_SHAPE = ("heat500", HEAT_NT, 100, ("product", [list(range(6))] * 2),
              (2, 1e-3, 10.0 / HEAT_NT))
HEAT_STARTS = 8
# The JAX package's batched multistart of the heat preset at nt=500 from the
# 8 starts rand_func(obj, seed=s), s = 0 … 7, on the CPU at float64:
#   JAX_PLATFORMS=cpu python -c "import jax, numpy as np
#   jax.config.update('jax_enable_x64', True)
#   from mioc_tpu.models.heat import HeatObj; from mioc_tpu.solvers.trm import TRMParameters
#   from mioc_tpu.solvers.trm_device import multistart_solve_device
#   from mioc_tpu.utils.init import rand_func
#   obj = HeatObj(nt=500); x0s = np.stack([rand_func(obj, seed=s) for s in range(8)])
#   r = multistart_solve_device(obj, TRMParameters(beta=1e-3, delta0=2.0, p=2), x0s)
#   print(r.iterations.tolist(), r.inner_steps.tolist(), [float(j) for j in r.J])"
REF8_HEAT_ITERATIONS = (223, 322, 254, 282, 252, 217, 233, 250)
REF8_HEAT_INNER = (1413, 1991, 1614, 1801, 1536, 1302, 1408, 1569)
REF8_HEAT_J = (780.5854728417946, 780.6982227170389, 780.7230210272979, 780.6790733967259,
               780.7426547978052, 780.6725156628451, 780.6296444114937, 780.6874820453411)
# Row counts of the heat_rows phase: those the paths evaluate (1, 8 and 64)
# and chunk edges around ROWS = 16.
HEAT_ROWS = (1, 2, 8, 9, 16, 17, 64, 72)


# Large-mesh heat (ROADMAP.md queue A item 4): the JAX package's own large-
# mesh configuration (benchmarks/heat_banded_tpu.py:37-41) at nt=200, on the
# card at float64: HeatObj(nt=200, mesh_hierarchy=construct_mesh_hierarchy(
# refinements=5), solver="mg", cg_iters=12, sparse_format="banded"): N = 8321
# P2 dofs in RCM order, K and M in 66 block rows of 7 block diagonals (rb = cb
# = 128), a V-cycle over 5 levels; L = 36 and B = 40 at the preset's δ₀ = 2,
# τ = 0.05.
LARGE_NT = 200
LARGE_N = 8321
LARGE_LEVELS = 5
LARGE_SHAPE = ("heat200", LARGE_NT, 40, ("product", [list(range(6))] * 2),
               (2, 1e-3, 10.0 / LARGE_NT))
LARGE_KSPEC = (8321, 8321, 128, 128, (-3, -2, -1, 0, 1, 2, 3), 66, 66)
# Row counts of the row check (those the paths use, 1 and 8, and the chunk
# edges around ROWS = 16), at the cut depth LARGE_ROWS_NT (the bits do not
# depend on nt, and 20 steps cost a tenth of 200); at nt=200 a 16-row batch.
LARGE_ROWS = (1, 2, 8, 9, 16, 17)
LARGE_ROWS_NT = 20
# The JAX package's host operators of the same model (banded engine, float64,
# the CPU), for the RCM permutation, the packed K and M, and every level's
# K/P/R blocks, 1/diag(K) and the coarse inverse: the sha256 prefix of the
# nonzero pattern, then the sum, the sum of |a| and the sum of a², then the
# sha256 prefix of the bytes (the permutation: of its int32 bytes).  From
#   JAX_PLATFORMS=cpu python -c "import jax, hashlib, numpy as np
#   jax.config.update('jax_enable_x64', True)
#   from mioc_tpu.models.heat import HeatObj, construct_mesh_hierarchy
#   o = HeatObj(nt=200, mesh_hierarchy=construct_mesh_hierarchy(refinements=5),
#               solver='mg', cg_iters=12, sparse_format='banded')
#   h = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]
#   print(h(o.dof_perm)); a = np.asarray(o._Kblk)
#   print(h(np.packbits(a != 0)), a.sum(), np.abs(a).sum(), (a * a).sum(), h(a))"
# and the same for _Mblk, _mg_ops["levels"][l][k] and _mg_ops["coarse_inv"].
LARGE_OPS = {
    "perm": ("ee9cbfe52425ff62",),
    "K": ("88a2fd1e14e2967b", 4.048000000000011, 4373.470222222224, 664.7921332626877,
          "49c725c5bdbac2ac"),
    "M": ("88a2fd1e14e2967b", 4.000000000000001, 7.200000000000003, 0.0016092441700122989,
          "c7a23637c2831baa"),
    "coarse_inv": ("fab5c5a403499bc9", 79.8168613199358, 89.63643496279101,
                   408.5542622665614, "b34d340a282e32b5"),
    "levels": (
        {"Kblk": ("88a2fd1e14e2967b", 4.048000000000011, 4373.470222222224,
                  664.7921332626877, "49c725c5bdbac2ac"),
         "Pblk": ("408f3ee3ae9318af", 8321.0, 10641.0, 6191.0, "797ffe5835ab38a3"),
         "Rblk": ("537673c59a9e1684", 8321.0, 10641.0, 6191.0, "33eee533240a472e"),
         "dinv": ("11ee6171c554b2e6", 34945.394067239344, 34945.394067239344,
                  155775.53621409158, "7e84dba42c846948")},
        {"Kblk": ("b4637318678ffaa8", 4.048000000000111, 1094.754222222222,
                  166.04820307282307, "c090548402730ac9"),
         "Pblk": ("73b80ec23c39781f", 2113.0, 2697.0, 1576.0, "f74806c8f7514a8c"),
         "Rblk": ("658bcf11078c3104", 2113.0, 2697.0, 1576.0, "974db7d7401b8cda"),
         "dinv": ("4acd2d1f71e4934e", 9157.814752620856, 9157.814752620856,
                  43908.73159743365, "739cd924f95fdea6")},
        {"Kblk": ("147839172ccee11b", 4.0480000000001155, 275.44038194444454,
                  41.890731766494106, "4e456a13e55647f8"),
         "Pblk": ("1f9b114f917f9d9a", 545.0, 693.0, 408.5, "908ef972171db5e9"),
         "Rblk": ("d978eb3acc363fdf", 545.0, 693.0, 408.5, "8abd714cb24cbf78"),
         "dinv": ("5f1c69775a30fdd1", 2494.384766460684, 2494.384766460684,
                  13621.064895296764, "2cb228c58b0bd3e2")},
        {"Kblk": ("abad36cd4918d0a6", 4.0480000000001155, 70.63285633680563,
                  11.093473466223726, "4ce00d09c251e812"),
         "Pblk": ("98111257dd3c5061", 145.0, 183.0, 109.75, "06affe9c8e47bad0"),
         "Rblk": ("7f2d837aebe7c9d6", 145.0, 183.0, 109.75, "fe26e5a439ce34e9"),
         "dinv": ("12bc1fa7e546d130", 716.8306922368027, 716.8306922368027,
                  4731.678114745886, "24b24057446c89d3")},
        {"Kblk": ("223f735824245341", 4.048000000000116, 19.43226435004347,
                  3.613514897497089, "6ebf5ba46d84104d"),
         "Pblk": ("0e378758046b2fa2", 41.0, 51.0, 31.625, "a0c8b3be98408468"),
         "Rblk": ("75ec3d09aa7efd16", 41.0, 51.0, 31.625, "e5aa57b33d0a50fc"),
         "dinv": ("9c8d8bbea28c3ffc", 210.9419710424321, 210.9419710424321,
                  1593.034117841704, "d421bb54f1ce0503")},
    ),
}
# The JAX package's f and ∇f of that model at rand_func(obj, seed=0) on the
# CPU at float64, its banded engine (o as above; x = rand_func(o, seed=0);
# o.x = x; f = o.eval_f_(); o.eval_df_(); ∇f = np.asarray(o.df), (200, 2),
# its little-endian float64 bytes in base64).
LARGE_F = 1953.2363935092235
LARGE_DF_B64 = (
    "mmhusE0RW8AQHbJykCxbwLIEI7j/vVnAJnf3jvvbWcDtxU5XO61ZwCeJTx2zzFnACHVAx66eWcDmX3wab75Z"
    "wLBahrZlklnAk2vOvhKxWcD2rOMT64VZwAw8SlyhpFnAFAM6oYx5WcBZULqyPplZwAUUn0mTbVnAvb3LMjqP"
    "WcCwOdiKY2JZwN+sBDMwh1nANCyc4rhVWcB9kzRYdHxZwMx1Mdr0R1nAAkBB9qZvWcBmToB7VzlZwHXuuYUg"
    "YVnAoNjwVxYqWcATnRBLFVFZwFU/Zb5tGlnABnf9B6Y/WcDqaaY5twpZwGWyL5/oLFnAxoipcaL4WMCDDIsL"
    "7BhZwEZi6b2B5FjAWOnuGrsDWcC0mltGgc5YwKsQwGVd7VjAJJxOSLm2WMBQJZKO2NVYwGFnCos2nVjAo7qj"
    "KDG9WMDpQRie/oFYwOmjVlxro1jAh0huEBJlWMBrICpbi4hYwBq0ZpBtRljAuJlSsJVsWMCZVtNgCiZYwC17"
    "73aPT1jAiEvMUN4DWMC6/it7fjFYwCSgvj7b31fAUtlOSGkSWMBwFpIQ7rlXwAhJuSJX8lfAI8TJ5fyRV8Cj"
    "SevpT9FXwI28Ew7kZ1fACdnJ21uvV8DEoqLicDtXwDNgCjCDjFfACM+cwlgMV8DK+kaCzWhXwFY8n30o2lbA"
    "aTpoBkFEV8CyCSOWI6RWwPz4XpThHlfAW45rQv1oVsB9xr29r/hWwPSWI4v/MVbADpzqbqvRVsBDPKE13/1V"
    "wI107r3TqVbA56Of7uLLVcDv1PuGKYFWwKM3pmScm1XA+3HReK5XVsDElAe0x2xVwD149RJkLVbAl9L+Dzs/"
    "VcCgsMrISgJWwPKj0hreElXAlbQnV2HWVcAkhkBFpedUwG9LGEmkqVXAYFRci4+9VMBUsKijDXxVwEWI9NGl"
    "lFTAQQ5lsZRNVcAceyCu+2xUwF3W5ugtHlXAuzJ4zLFGVMC+/YPsyu1UwNkB2rP6IVTAn9mZolq8VMCtsSCM"
    "I/9TwK/ezWPJiVTAwnVyjqTeU8DS9X8yAVZUwEVyOapBwVPAbMtY1OkgVMCYk+duUahTwAEKP3Fo6lPAMCWO"
    "0pWKU8Cj0+7uWrJTwDxDBh5oaVPAbchQ6pR4U8CLNxSAkUVTwC18QMjXPFPAoPfhj5EfU8BcjAh5yv5SwPpS"
    "jlu+91LAfc7Ntem9UsAntsMpVM5SwImNsO1neVLAKHMuuH2jUsByNi675i9SwFviRy9cd1LAFGhKRJ7qUcCd"
    "Yt8vCkpSwPrFDTwxqFHA0ylRgKAbUsDo5U4C1GdRwCLEy3c27FHA7taLlgUpUcBsa67v4btRwFbn9sFu61DA"
    "g6+jFreKUcBx/Jpi0a5QwFWZ/ErIWFHAg1gVQ/9yUMBDbcgGJiZRwDGNGMrUN1DArV8H3d7yUMDaqkaBa/pP"
    "wAGG3IP/vlDAAibJkxaGT8Dku0jnkopQwCY+8iGFEk/ALdynQKJVUMAqiP/Ml59OwMciDDA1IFDAQJ0USjQt"
    "TsC+Y7yqo9RPwDiklIdEu03ACKeQz/lnT8CUqbEQtklNwDgW1JRz+k7AmnFInHnYTMAUgEg7FYxOwMITDLuC"
    "Z0zAfD4KmeAcTsAWGFWdx/ZLwG7M9SvVrE3AnLym60CGS8CEbwQj8DtNwFBoyK7pFUvA5gsDXizKTMABK4lF"
    "v6VKwOpp32KCV0zA6VgkZ8E1SsACxXtH6ONLwA5G8jHyxUnA4Jp6jlFvS8DOfLdGVlZJwB/3rvSu+UrAN5Gf"
    "8fTmSMCuQ6kr7oJKwM+h52LYd0jAS3n0e/kKSsASv636DQlIwKs2lUa3kUnAzIKvraaaR8COOoBYCRdJwLwM"
    "uoy3LEfAp27D+suaSMAUSZJ/Wr9GwJVtxJzUHEjA5xP8UK9SRsCc6yPf75xHwDhiI0Ld5kXAxaa3nd4aR8Ag"
    "NyuNFXxFwIl5MU5RlkbAOay2qJcSRcCPfW9/4A5GwPH9mBO5qkTA224uNQCERcBh4A3c9EREwIaPJaLp9ETA"
    "gD3d1w3iQ8CaY8E4cGBEwJt54lR5fUPAWDIiyq/EQ8BqBAsP8xdDwL2VxKZZHkPAPxPTteexQsA/DfHjloRC"
    "wHdelHefS0LA+pJXwxr0QcA96gqGTuVBwH91IFsFa0HAiQgUxyR/QcAUInVPM+hAwN75NzZRGUHApMGUzu1q"
    "QMDbI2HTA7RAwE6xDxKI5T/ALBz/6G9PQMBWiaET8/4+wKqsTwOg1z/AAumzogMiPsDSVtSG2hI/wB7dnZkQ"
    "Tz3AMOf17FpRPsBQ3QAPFYc8wC4kDqZelD3AEgsa5DDMO8CUiBpdEt48wPhLJeVACzvAKKyOzRwbPMDQgfgG"
    "FUY6wMIf7z61TDvAfF1OM9d8OcCeAyxawXE6wOIuEobOuTjAIkoArrWdOcDGnZ+tg/w3wBbnuGd/zjjAnlkg"
    "SSlFN8BAqwC98wI4wOp9BUiXlDbAnmHvA0g6N8CX65KQmew1wApf2U23czbAsVKZhv9ENcBJrV7/zrk1wDT/"
    "UsFLoTTAP0tB68MNNcARmkUuL+8zwJt7y4E6XDTAvYeABxYxM8CihltuU6czwFrlvbLXZzLATpXDwDPwMsDa"
    "Y9K9I5MxwMzIOuGANzLA/fg85WqxMMAqg1+hl30xwJrgJXRifi/AFQKI3qbCMMC2Q8F5MrEtwJ3fgnDHBjDA"
    "oP6tdNjzK8BubxCbCZQuwMSWaI8uQirAGIE1sNQYLcCiKRH9tZkowKZHLaEHnCvAmKeDdNj4JsBGSQiTuB0q"
    "wAKawGGIXiXA6kGsXPmdKMDajXQCDcojwHJnrIXUHCfA/k0QkOQ6IsA+1f1QSpolwHDeAxuysCDAJMd3lE0W"
    "JMAw6TFzY1YewNxZB+W/kCLAFIXc9l9UG8BiVMZhbAkhwEj+1EUFWxjAGCDODQAAH8Dw9RQTAmoVwJCzioj7"
    "5xvAOEJ39PSAEsA0+K6gVskYwJRmUJmgPg/AoO8DcOKhFcAMSeMIW4gJwFLyYglHbhLA1AnajwDcA8DcbUKa"
    "clIOwPCjqKUfaPy/SHeA0NyTB8AoKUN1owzxv6ys8ECJgQDA4A/NQ5/q2L+YisINkPTzv8DiTpjCh9A/IJ9m"
    "qt323r+AeQ1e/CbsP0DIsVgZJM4/4PKMaRqf9z+wrb4iEU7tP0AihxZcYwBAAAMhzLL2+D98DQxVDsUEQF6X"
    "uDqhXQFAYvj5+JjzCEC07P0aYfwFQEBClzjp7AxAxOmBCvdXCkCMQVztu1YQQEA06ADcbg5A6ZV8BqcXEkBV"
    "YJUqYx4RQHh/kIzosxNAlEQUfkTcEkCDQARhi1AVQEBo6rG6lhRACYcwOkPoFkBvReQwA0kWQEiG6nsUeBhA"
    "AsWKnZvwF0CaySHjNP4ZQOKPAl4ljBlA6kRRvYR5G0DnTXop4RobQOOTRTNJ6RxApCwLSGucHEBGM2iZBU0e"
    "QP50hJKWEB5Afmw+8GSkH0DKN4NvV3cfQM4RRz6WdyBAe/JX4VtoIEBgeX7rmRYhQPmWChxoDiFAwWLJRjCv"
    "IUD63geH4q0hQGnTvjRSQSJA30+Iu+JGIkAoEdcH/8wiQIqr/KeG2SJAEPeyHz5SI0DDfg269GUjQESFzUoi"
    "0SNAMA/mzV/sI0DgeIbZz0kkQHICCdUNbSRA2DblLYe8JECpOeoDY+gkQExJP063KSVAwm1HEfVeJUDlARHd"
    "H5IlQKiC6++t0SVAfTv8cBP3JUB4ibgGD0ImQG6VaPcFWyZADfCBnsCyJkAK+CoqN6smQDbO/KE9ESdAIioD"
    "JAjqJkChgMfaKmAnQAufN2SjGCdAtiQJLgGhJ0Bd0uvFhTcnQMLq8a+Z1CdANhqWPbdGJ0CtEaHravsnQK2v"
    "dsHcRSdAesootKEVKEAc1ho5MDQnQALaXQQkIyhAfzqCNl4QJ0A+H8m/gCMoQP2tZi4+2CZA5IYI9MYVKEBU"
    "+ygHSIgmQMSAbZcz+CdA3nVb8IAaJkC8NL6piscnQBDwW0wqhCVA/6MrLKh9J0DLILCt2w4lQDGDASgCVSdA"
    "88eWAK6uJECHn8EjukonQEWtafbucSRAOGli3Qc1J0Amjpt70FQkQGQs1g88FidAVdCX6x9XJEBwXNWVZe8m"
    "QC0Hh7YwfCRALPf43BXBJkAMINuggswkQILDyd7eiyZAfJs+5DX8JECD0yP8XjkmQG83uARfFCVAg0qvTkPF"
    "JUBihHTHrQIlQH2bi4wEUyVAubSP1pTEJEB/men19NgkQK6CTM9eTy5AnH/AH45LLkA="
)
# Tolerances of the port against the JAX package: 10 × the largest gap
# measured on the CPU at the meshes refined 1–4 times (N = 41 … 2113; nt=40,
# mg-CG 12, banded, rand_func seeds 0–2; the port at its CPU default): f
# 7.9e-15 relative, ∇f 2.04e-14 of max |∇f|; the port's ELL engine against
# its banded one: f 1.1e-14, ∇f 3.4e-14.
# The solves are capped: an outer iteration costs two sweeps of 4.5–7 s on
# the card (an adjoint and a forward; PERF.md §5), the JAX package's run
# accepts every step at its first trial and has not converged after 8 (heat
# at nt=500 takes 223), and three loops to convergence would take far more
# than the phase's ~150 s; at 2 iterations they take ~90–120 s.  The JAX
# package's host trm_solve from seed 0 under the heat preset with
# maxiter=2, its banded engine on the CPU at float64 (o as above;
# trm_solve(o, TRMParameters(beta=1e-3, delta0=2.0, p=2, maxiter=2),
# seed=0)): iterations, inner steps, f and ∇f evaluations, J.
LARGE_MAXITER = 2
LARGE_REF = (2, 2, 3, 3, 1584.0058808074555)
# The batched multistart over 8 starts rand_func(o, seed=s), s = 0 … 7 (start 0
# is LARGE_REF's), capped likewise: the JAX package's multistart_solve_device
# on the CPU at float64 (o as above), per start iterations, inner steps and J,
# from
#   JAX_PLATFORMS=cpu python -c "import jax, numpy as np
#   jax.config.update('jax_enable_x64', True)
#   from mioc_tpu.models.heat import HeatObj, construct_mesh_hierarchy
#   from mioc_tpu.solvers.trm import TRMParameters
#   from mioc_tpu.solvers.trm_device import multistart_solve_device
#   from mioc_tpu.utils.init import rand_func
#   o = HeatObj(nt=200, mesh_hierarchy=construct_mesh_hierarchy(refinements=5),
#               solver='mg', cg_iters=12, sparse_format='banded')
#   x0s = np.stack([rand_func(o, seed=s) for s in range(8)])
#   r = multistart_solve_device(o, TRMParameters(beta=1e-3, delta0=2.0, p=2, maxiter=2),
#                               x0s, speculative=False)
#   print(r.iterations.tolist(), r.inner_steps.tolist(), [float(j) for j in r.J])"
LARGE_STARTS = 8
LARGE8_ITERATIONS = (2, 2, 2, 2, 2, 2, 2, 2)
LARGE8_INNER = (2, 2, 2, 2, 2, 2, 2, 2)
LARGE8_J = (1584.0058808074534, 975.256622046466, 1002.1950928111586, 993.6988913149524,
            960.9964459449658, 1472.812628818561, 1082.9937148698289, 1159.4756630782053)
LARGE_TOL_F = 8e-14
LARGE_TOL_DF = 2.1e-13
LARGE_TOL_ELL_F = 1.1e-13
LARGE_TOL_ELL_DF = 3.4e-13


def heat_wave_phase(torch, caps, seed, shape=HEAT_SHAPE) -> dict:
    """``chase_trials`` on ONE table set with the preset's K halving caps (the
    single device solve's wave, ``wave_chase="trials"``) at the heat solve's
    shape, float64: equal to the plain walk of each cap, timed in turns with
    the plain trial chase."""
    from mioc_tpu_torch.ops import bellman as tb
    from mioc_tpu_torch.ops import levels as lv
    from mioc_tpu_torch.ops.backtrack_cuda import chase_plan, chase_trials
    from mioc_tpu_torch.ops.bellman_cuda import dp_build

    name, nt, B, (_, V), (p, beta, tau) = shape
    adm = lv.product_levels(V)
    L = adm.L
    rng = np.random.default_rng(seed)
    dtype = torch.float64
    grad = torch.as_tensor(rng.normal(size=(nt, adm.M)), dtype=dtype, device=DEVICE)
    u_old = torch.as_tensor(adm.levels[rng.integers(0, L, size=nt)], dtype=dtype,
                            device=DEVICE)
    jump = torch.as_tensor(lv.jump_cost_table(adm.levels, p, beta=beta), dtype=dtype,
                           device=DEVICE)
    smax = tb.max_budget_use(adm.levels)
    stage, btilde = tb.stage_tables(grad, u_old, adm.levels, tau)
    U, phi0 = dp_build(stage, btilde, jump, B, smax)
    one = (U[None], phi0[None], btilde[None])
    K = len(caps)
    caps_t = torch.tensor([caps], dtype=torch.int32, device=DEVICE)
    got = chase_trials(*one, caps_t)[0]
    want = torch.stack([tb.backtrack_plain(U, phi0, btilde, c) for c in caps])
    err = int((got.long() - want.long()).abs().max())
    require(err == 0, f"heat single wave: chase_trials equal at caps {caps}")
    ms, plain = in_turns(torch, lambda: tb.backtrack_trials_plain(*one, caps_t.cpu()),
                         lambda: chase_trials(*one, caps_t), 3, 10)
    ds, us = phi0.element_size(), U.element_size()
    nbytes = L * (B + 1) * ds + K * ((nt - 1) * (us + 4) + nt * 4 + 4)
    ops = K * (L * (B + 1) + (nt - 1))
    bd_ms, bd_by = bound(nbytes, ops, "float64")
    out = {"phase": "wave_kernels", "shape": name, "dtype": "float64", "S": 1,
           "K": K, "nt": nt, "L": L, "B": B, "caps": caps,
           "chase_trials": {"max_abs_err": err, "kernel_ms": ms, "plain_ms": plain,
                            "ns_per_step": ms * 1e6 / (nt - 1), "bound_ms": bd_ms,
                            "bound_by": bd_by, "ops": ops, "bytes": nbytes,
                            "plan": chase_plan(nt, L, B, us, 1, K)._asdict()}}
    emit(out)
    return out


def heat_rows(torch) -> dict:
    """HeatObj(nt=500) on the card: every row of a batched forward and
    adjoint at :data:`HEAT_ROWS` rows is bit-equal to the single evaluation
    of that row (f, the states, ∇f and the adjoint states), whether one raw
    ``torch.matmul`` of the state step would have given each row the same
    bits, the ms per batched f and ∇f (CUDA-event medians, the row counts in
    turns, ascending then descending), and the ms of one state-step product
    at chunk widths 16 … 128."""
    from mioc_tpu_torch.models import HeatObj
    from mioc_tpu_torch.ops.rows import ROWS
    from mioc_tpu_torch.utils.init import rand_func

    obj = HeatObj(nt=HEAT_NT)
    n = max(HEAT_ROWS)
    X = torch.as_tensor(np.stack([rand_func(obj, seed=s) for s in range(n)]),
                        dtype=obj.dtype, device=obj.device)
    singles = []
    for s in range(n):
        f1, y1 = obj._forward(X[s])
        d1, l1 = obj._adjoint(X[s], y1)
        singles.append((f1, y1, d1, l1))
    v = obj.state0 + obj._drive(X[:, :1].transpose(0, 1))[0]   # (n, N): step 1's input
    raw1 = torch.stack([(v[s:s + 1] @ obj._SinvT)[0] for s in range(n)])
    out = {"phase": "heat_rows", "nt": HEAT_NT, "N": obj.Nglobal_dofs, "dtype": "float64",
           "chunk_rows": ROWS, "rows_bit_equal": {}, "raw_matmul_rows_bit_equal": {},
           "f_ms": {}, "df_ms": {}}
    for R in HEAT_ROWS:
        f, ys = obj._forward_batch(X[:R])
        df, lam = obj._adjoint_batch(X[:R], ys)
        ok = all(torch.equal(bits(f[s], torch), bits(singles[s][0], torch))
                 and torch.equal(bits(ys[:, s], torch), bits(singles[s][1], torch))
                 and torch.equal(bits(df[s], torch), bits(singles[s][2], torch))
                 and torch.equal(bits(lam[s], torch), bits(singles[s][3], torch))
                 for s in range(R))
        out["rows_bit_equal"][R] = ok
        out["raw_matmul_rows_bit_equal"][R] = torch.equal(
            bits(v[:R] @ obj._SinvT, torch), bits(raw1[:R], torch))
    times = {"f": {}, "df": {}}
    for R in HEAT_ROWS + HEAT_ROWS[::-1]:
        _, ys = obj._forward_batch(X[:R])
        times["f"].setdefault(R, []).extend(
            median_ms(torch, lambda: obj._forward_batch(X[:R]), 3))
        times["df"].setdefault(R, []).extend(
            median_ms(torch, lambda: obj._adjoint_batch(X[:R], ys), 3))
    for kind in ("f", "df"):
        out[f"{kind}_ms"] = {R: statistics.median(t) for R, t in times[kind].items()}
    # What one state-step product costs at other chunk widths (the sweep
    # launches nt of them per chunk): ms per (rows, N)·(N, N) product.
    prod = {}
    for rows in (16, 32, 64, 128, 16):
        a = torch.randn(rows, obj.Nglobal_dofs, dtype=obj.dtype, device=obj.device)
        prod.setdefault(rows, []).extend(
            median_ms(torch, lambda: torch.matmul(a, obj._SinvT), 20))
    out["state_product_ms_by_rows"] = {r: statistics.median(t) for r, t in prod.items()}
    emit(out)
    for R in HEAT_ROWS:
        require(out["rows_bit_equal"][R], f"heat rows of a {R}-row batch bit-equal")
    return out


def require_dense_sweeps(name, launches, sweeps) -> None:
    """A heat path (dense ``HeatObj`` on the card) launches the dense sweep
    kernel once per f and once per ∇f sweep that its spans recorded,
    whatever the rows."""
    n = sum(sweeps["f"].values()) + sum(sweeps["df"].values())
    require(n > 0 and launches[PDE_SWEEP_KERNEL] == n,
            f"{name}: one {PDE_SWEEP_KERNEL} per sweep ({n}): {launches}")


# Row counts of the pde_sweep phase: a host-loop sweep, heat.device's wave,
# one group of 16, heat.multistart8's wave.
PDE_SWEEP_ROWS = (1, 8, 16, 64)


def pde_sweep_phase(torch) -> dict:
    """The dense sweep kernel (``csrc/pde_dense.cu``) at heat's shape (N =
    545, nt = 500, float64) against the plain sweep ``PDEObjective._sweep``
    (one ``torch.matmul`` of 16 rows a step: the library's product, whose
    ms per call is ``library_ms``), forward and reverse at
    :data:`PDE_SWEEP_ROWS` rows: the iterates to 1e-13 of the largest, one
    launch a call, and the ms per call with the host side (CUDA-event
    medians, in turns: library, kernel, kernel, library) beside the bound
    (2·R·N² operations a step at the float64 peak)."""
    from mioc_tpu_torch.models import HeatObj
    from mioc_tpu_torch.objectives.pde import _pad_rows
    from mioc_tpu_torch.ops import _kernels, pde_cuda
    from mioc_tpu_torch.utils.init import rand_func

    obj = HeatObj(nt=HEAT_NT)
    N = obj.Nglobal_dofs
    X = torch.as_tensor(np.stack([rand_func(obj, seed=s) for s in range(max(PDE_SWEEP_ROWS))]),
                        dtype=obj.dtype, device=obj.device)
    drive = obj._drive(X.transpose(0, 1)).contiguous()
    out = {"phase": "pde_sweep", "nt": HEAT_NT, "N": N, "dtype": "float64",
           "clusters_held": _kernels.clusters_held(torch.cuda.current_device(), pde_cuda._QUERY,
                                                   N, 8, pde_cuda.MAX_ROWS),
           "by_rows": {}}
    for R in PDE_SWEEP_ROWS:
        dd = drive[:, :R].contiguous()
        for name, v_end, op, rev in (("forward", obj.state0, obj._SinvT, False),
                                     ("reverse", None, obj.Sinv, True)):
            def kernel():
                return pde_cuda.dense_sweep(v_end, dd, op, rev)

            def library():
                return obj._sweep(0.0 if v_end is None else v_end, _pad_rows(dd), op, rev)

            n0 = pde_cuda.dense_sweep.launches
            k = kernel()
            require(pde_cuda.dense_sweep.launches == n0 + 1, f"pde_sweep: one launch a call")
            plain = library()[:, :R]
            err = float((k - plain).abs().max() / plain.abs().max())
            k_ms, lib_ms = in_turns(torch, library, kernel, 2, 5)
            ops = 2 * R * N * N * HEAT_NT
            out["by_rows"].setdefault(R, {})[name] = {
                "group_rows": pde_cuda.group_rows(R, N, obj.dtype, obj.device),
                "max_rel_err": err, "ms": k_ms, "library_ms": lib_ms,
                "us_per_step": 1e3 * k_ms / HEAT_NT,
                "bound_ms": bound(8 * (N * N + 2 * HEAT_NT * R * N), ops, "float64")[0]}
            require(err <= 1e-13, f"pde_sweep {name} at {R} rows: rel err {err} ≤ 1e-13")
    emit(out)
    return out


def heat_host_path(torch, tmp) -> dict:
    """(e): the JAX CLI's heat example through the port's CLI, host loop."""
    ck = os.path.join(tmp, "heat.npz")
    record_sweeps()
    r = run_cli(torch, "heat_host", ["heat", "--n", str(HEAT_NT), "--seed", "0",
                                     "--no-plot", "--no-log", "--checkpoint", ck])
    r["sweeps"] = recorded_sweeps()
    check_cli(r, f"heat --n {HEAT_NT}")
    n = r["launches"]
    require(n["dp_build"] == r["iterations"] == r["cluster_builds"]
            and n["chase"] == r["f_evals"] - 1
            and not any(v for k, v in n.items()
                        if k not in ("dp_build", "chase", PDE_SWEEP_KERNEL)),
            f"heat_host: {r['iterations']} dp_build (each a cluster: {r['cluster_builds']}) "
            f"and {r['f_evals'] - 1} chase launches, no other DP kernel: {n}")
    require_dense_sweeps("heat_host", n, r["sweeps"])
    with np.load(ck) as z:
        r["u"] = z["u"]
    return r


def heat_device_path(torch, host) -> tuple:
    """(f): the device loop from the same start as (e)."""
    from mioc_tpu_torch.models import HeatObj
    from mioc_tpu_torch.solvers.trm import TRMParameters
    from mioc_tpu_torch.solvers.trm_device import trm_solve_device

    obj = HeatObj(nt=HEAT_NT)
    require(obj.Nglobal_dofs == HEAT_N and obj.admissible.L == 36, "heat: N = 545, L = 36")
    record_sweeps()
    read = zero_counts(torch)
    t0 = time.perf_counter()
    res = trm_solve_device(obj, TRMParameters(**HEAT_PRESET), seed=0)
    wall = time.perf_counter() - t0
    launches, plain_calls = read()
    clustered = cluster_builds()
    sweeps = recorded_sweeps()
    emit({"phase": "heat_device", "problem": "heat", "nt": HEAT_NT, "N": HEAT_N,
          "dtype": "float64", "speculative": True, "wave_chase": obj._wave_chase_default,
          "J": float(res.J), "converged": bool(res.converged),
          "iterations": int(res.iterations), "inner_steps": int(res.inner_steps),
          "f_evals": int(res.f_evals), "df_evals": int(res.df_evals),
          "dp_builds": int(res.dp_builds), "launches": launches, "cluster_builds": clustered,
          "plain_calls_on_card": plain_calls, "sweeps": sweeps, "wall_s": wall})
    its = int(res.iterations)
    require(bool(res.converged), "heat device solve converged")
    require(its == host["iterations"] and int(res.inner_steps) == host["f_evals"] - 1,
            f"heat device solve: iterations/inner steps {its}/{int(res.inner_steps)} == "
            f"host's {host['iterations']}/{host['f_evals'] - 1}")
    require(abs(float(res.J) - host["J"]) <= 1e-12 * abs(host["J"]),
            f"heat device J {float(res.J)!r} == host's {host['J']!r}")
    require(int(res.df_evals) == host["df_evals"] - 1, "heat device df_evals == host's − 1")
    require(np.array_equal(res.u, host["u"]), "heat device solve == host: accepted u")
    require(launches["dp_build"] == launches["chase_trials"] == its
            and not any(v for k, v in launches.items()
                        if k not in ("dp_build", "chase_trials", PDE_SWEEP_KERNEL)),
            f"heat device solve: {its} dp_build and {its} chase_trials launches: {launches}")
    require(clustered == its, f"heat device solve: every dp_build a cluster ({clustered})")
    require_dense_sweeps("heat device solve", launches, sweeps)
    require(not any(plain_calls.values()), "heat device: no plain DP on the card")
    return res, launches, wall, sweeps


def heat_multistart_path(torch, x0s, speculative: bool) -> tuple:
    """(g): the batched multistart over the 8 starts, sequential or
    speculative."""
    from mioc_tpu_torch.models import HeatObj
    from mioc_tpu_torch.ops.bellman import max_budget_use
    from mioc_tpu_torch.ops.bellman_cuda import cluster_build_plan
    from mioc_tpu_torch.solvers.trm import TRMParameters
    from mioc_tpu_torch.solvers.trm_device import multistart_solve_device

    obj = HeatObj(nt=HEAT_NT)
    S, B = len(x0s), int(np.floor(HEAT_PRESET["delta0"] / obj.tau))
    plan = cluster_build_plan(S, HEAT_NT, obj.admissible.L, B, 8,
                              max_budget_use(obj.admissible.levels))
    record_sweeps()
    read = zero_counts(torch)
    t0 = time.perf_counter()
    res = multistart_solve_device(obj, TRMParameters(**HEAT_PRESET), x0s,
                                  speculative=speculative)
    wall = time.perf_counter() - t0
    launches, plain_calls = read()
    sweeps = recorded_sweeps()
    name = "heat_multistart_" + ("speculative" if speculative else "sequential")
    emit({"phase": name, "problem": "heat", "nt": HEAT_NT, "N": HEAT_N,
          "dtype": "float64", "S": S, "B": B, "build_plan": plan._asdict(),
          "J": res.J.tolist(), "converged": res.converged.tolist(),
          "iterations": res.iterations.tolist(), "inner_steps": res.inner_steps.tolist(),
          "max_iterations": int(res.iterations.max()), "launches": launches,
          "plain_calls_on_card": plain_calls, "sweeps": sweeps, "wall_s": wall,
          "ms_per_start": 1e3 * wall / S})
    require(plan.C > 1, f"{name}: dp_build_batched takes a cluster (C = {plan.C})")
    require(bool(res.converged.all()), f"{name}: every start converged")
    require(not any(plain_calls.values()), f"{name}: no plain DP on the card")
    its = int(res.iterations.max())
    wave = "chase_trials" if speculative else "chase_batched"
    require(launches["dp_build_batched"] == its and launches[wave] >= its
            and not any(v for k, v in launches.items()
                        if k not in ("dp_build_batched", wave, PDE_SWEEP_KERNEL)),
            f"{name}: {its} dp_build_batched and the {wave} chases only: {launches}")
    require_dense_sweeps(name, launches, sweeps)
    for s in range(S):
        require(int(res.iterations[s]) == REF8_HEAT_ITERATIONS[s]
                and int(res.inner_steps[s]) == REF8_HEAT_INNER[s],
                f"{name} start {s}: iterations/inner steps == JAX "
                f"({int(res.iterations[s])}/{int(res.inner_steps[s])})")
        require(abs(float(res.J[s]) - REF8_HEAT_J[s]) <= 1e-12 * abs(REF8_HEAT_J[s]),
                f"{name} start {s}: J {float(res.J[s])!r} == {REF8_HEAT_J[s]!r}")
    return res, launches, wall, sweeps, plan


def check_heat_multistarts(seq, spec, single) -> None:
    """Start 0 equals the single device solve (f); the speculative
    multistart equals the sequential one field for field, bit for bit."""
    from mioc_tpu_torch.solvers.trm_device import DeviceTRMResult

    require(np.array_equal(seq.u[0], single.u) and int(seq.iterations[0]) == int(
        single.iterations) and int(seq.inner_steps[0]) == int(single.inner_steps)
            and float(seq.J[0]) == float(single.J),
            "heat multistart start 0 == heat device solve")
    for field in DeviceTRMResult._fields:
        require(np.array_equal(getattr(spec, field), getattr(seq, field)),
                f"heat speculative multistart == sequential: {field}")


def large_summary(a) -> tuple:
    """:data:`LARGE_OPS`' summary of one host array."""
    import hashlib

    def h(b):
        return hashlib.sha256(np.ascontiguousarray(b).tobytes()).hexdigest()[:16]

    a = np.asarray(a)
    if a.dtype.kind != "f":
        return (h(a),)
    return (h(np.packbits(a != 0)), float(a.sum()), float(np.abs(a).sum()),
            float((a * a).sum()), h(a))


def large_operators(obj) -> dict:
    """The port's host operators of the large model against the JAX
    package's (:data:`LARGE_OPS`): the permutation and every nonzero
    pattern equal, every sum, |sum| and square sum to rtol 1e-12 (of the
    |sum| for the sum, which cancels); whether the bytes are equal too is
    printed (numpy and scipy of other versions may round otherwise)."""
    arrays = {"perm": obj.dof_perm, "K": obj._Kblk_host, "M": obj._Mblk_host,
              "coarse_inv": obj._mg_host["coarse_inv"]}
    for l, L in enumerate(obj._mg_host["levels"]):
        arrays.update({f"level{l}.{k}": L[k] for k in ("Kblk", "Pblk", "Rblk", "dinv")})
    want = {k: LARGE_OPS[k] for k in ("perm", "K", "M", "coarse_inv")}
    for l, L in enumerate(LARGE_OPS["levels"]):
        want.update({f"level{l}.{k}": v for k, v in L.items()})
    require(arrays.keys() == want.keys(), f"heat_large: operator set {sorted(arrays)}")
    bytes_equal = {}
    for name, a in arrays.items():
        got, ref = large_summary(a), want[name]
        require(got[0] == ref[0], f"heat_large: {name} pattern (or permutation) equal to JAX")
        if len(ref) > 1:
            scale = (ref[2], ref[2], ref[3])  # |sum| scales the sum and itself
            for g, r, sc, what in zip(got[1:4], ref[1:4], scale, ("sum", "abs", "sq")):
                require(abs(g - r) <= 1e-12 * sc, f"heat_large: {name} {what} {g!r} == JAX {r!r}")
            bytes_equal[name] = got[4] == ref[4]
    return bytes_equal


def large_values(torch, obj, x0) -> dict:
    """f and ∇f at ``x0`` (one row) against the JAX package's, and their
    walls."""
    import base64

    x = torch.as_tensor(x0, dtype=obj.dtype, device=obj.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f, ys = obj._forward(x)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    df, lam = obj._adjoint(x, ys)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    df_ref = np.frombuffer(base64.b64decode("".join(LARGE_DF_B64)), dtype="<f8").reshape(
        LARGE_NT, 2)
    f_err = abs(float(f) - LARGE_F) / abs(LARGE_F)
    df_err = float(np.abs(df.cpu().numpy() - df_ref).max() / np.abs(df_ref).max())
    out = {"f": float(f), "jax_f": LARGE_F, "f_rel_err": f_err, "f_tol": LARGE_TOL_F,
           "df_err_of_max": df_err, "df_tol": LARGE_TOL_DF,
           "forward_s": t1 - t0, "adjoint_s": t2 - t1}
    require(f_err <= LARGE_TOL_F, f"heat_large: f {float(f)!r} within {LARGE_TOL_F} of JAX")
    require(df_err <= LARGE_TOL_DF, f"heat_large: ∇f within {LARGE_TOL_DF} of JAX ({df_err})")
    return out, (f, ys, df, lam)


def large_rows(torch, obj, x0s, single0) -> dict:
    """Rows bit-equal to single evaluations: at nt=200, 8- and 16-row
    batches of two controls in alternation (the seconds of a sweep at 1, 8
    and 16 rows); at the cut depth :data:`LARGE_ROWS_NT`,
    every count of :data:`LARGE_ROWS` over three controls in a shifting
    order; whether one banded product at the natural width (the rows, no
    padding) would give each row its single bits; the ms of the batched f
    and ∇f at 16 rows (nt=200)."""
    from mioc_tpu_torch.models import HeatObj

    def check(o, X, idx, singles):
        f, ys = o._forward_batch(X[idx])
        df, lam = o._adjoint_batch(X[idx], ys)
        return all(torch.equal(bits(f[r], torch), bits(singles[i][0], torch))
                   and torch.equal(bits(ys[:, r], torch), bits(singles[i][1], torch))
                   and torch.equal(bits(df[r], torch), bits(singles[i][2], torch))
                   and torch.equal(bits(lam[r], torch), bits(singles[i][3], torch))
                   for r, i in enumerate(idx))

    X = torch.as_tensor(x0s, dtype=obj.dtype, device=obj.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f1, y1 = obj._forward(X[1])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    d1, l1 = obj._adjoint(X[1], y1)
    torch.cuda.synchronize()
    timed = {"forward1_s": t1 - t0, "adjoint1_s": time.perf_counter() - t1}
    singles = [single0, (f1, y1, d1, l1)]
    idx8 = [r % 2 for r in range(8)]
    t0 = time.perf_counter()
    f8, ys8 = obj._forward_batch(X[idx8])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    df8, lam8 = obj._adjoint_batch(X[idx8], ys8)
    torch.cuda.synchronize()
    timed.update(forward8_s=t1 - t0, adjoint8_s=time.perf_counter() - t1)
    ok8 = all(torch.equal(bits(f8[r], torch), bits(singles[i][0], torch))
              and torch.equal(bits(ys8[:, r], torch), bits(singles[i][1], torch))
              and torch.equal(bits(df8[r], torch), bits(singles[i][2], torch))
              and torch.equal(bits(lam8[r], torch), bits(singles[i][3], torch))
              for r, i in enumerate(idx8))
    idx16 = [r % 2 for r in range(16)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f16, ys16 = obj._forward_batch(X[idx16])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    df16, lam16 = obj._adjoint_batch(X[idx16], ys16)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ok16 = all(torch.equal(bits(f16[r], torch), bits(singles[i][0], torch))
               and torch.equal(bits(ys16[:, r], torch), bits(singles[i][1], torch))
               and torch.equal(bits(df16[r], torch), bits(singles[i][2], torch))
               and torch.equal(bits(lam16[r], torch), bits(singles[i][3], torch))
               for r, i in enumerate(idx16))
    cut = HeatObj(nt=LARGE_ROWS_NT, mesh_hierarchy=obj._mesh_hierarchy, solver="mg",
                  cg_iters=obj.cg_iters, sparse_format="banded")
    Xc = X[:, :LARGE_ROWS_NT]
    sc = []
    for s in range(3):
        fs, ys = cut._forward(Xc[s])
        sc.append((fs, ys, *cut._adjoint(Xc[s], ys)))
    rows = {R: check(cut, Xc, [(r + r // 3) % 3 for r in range(R)], sc) for R in LARGE_ROWS}
    # One fine K product at the natural width: the step-1 right-hand sides.
    E = cut._engine
    V = E.pad(cut.state0.expand(3, -1), 3)
    raw = {}
    for R in LARGE_ROWS:
        idx = [(r + r // 3) % 3 for r in range(R)]
        got = E.K(V[idx])
        raw[R] = all(torch.equal(bits(got[r], torch), bits(E.K(V[i:i + 1])[0], torch))
                     for r, i in enumerate(idx))
    out = {"rows_bit_equal_nt200_16": ok16, "rows_bit_equal_nt200_8": ok8,
           "rows_bit_equal_cut": rows,
           "cut_nt": LARGE_ROWS_NT, "natural_width_product_rows_bit_equal": raw,
           "forward16_s": t1 - t0, "adjoint16_s": t2 - t1, **timed}
    require(ok16, "heat_large: the 16 rows of a batch (nt=200) bit-equal to singles")
    require(ok8, "heat_large: the 8 rows of a batch (nt=200) bit-equal to singles")
    for R, ok in rows.items():
        require(ok, f"heat_large: rows of a {R}-row batch (nt={LARGE_ROWS_NT}) bit-equal")
    return out


def large_apply_ms(torch, obj) -> dict:
    """ms per fine-level banded application (K, 16 rows), CUDA-event median
    of 50, beside its bound: one read of the packed operator, the windows
    read and the rows written once."""
    E = obj._engine
    X = E.pad(obj.state0.expand(16, -1))
    E.K(X)
    ms = statistics.median(median_ms(torch, lambda: E.K(X), 50))
    blk = obj._Kdev
    nbytes = blk.numel() * blk.element_size() + 2 * X.numel() * X.element_size()
    ops = 2 * blk.numel() * 16
    bd_ms, bd_by = bound(nbytes, ops, "float64")
    return {"K_apply_ms": ms, "bound_ms": bd_ms, "bound_by": bd_by, "bytes": nbytes,
            "operator_bytes": blk.numel() * blk.element_size(), "ops": ops,
            "V_cycle_ms": statistics.median(median_ms(torch, lambda: E.pc(X), 10)),
            "cg_solve_ms": statistics.median(median_ms(torch, lambda: E.solve(X, X), 5))}


def large_solves(torch, obj) -> dict:
    """The host loop and the device loop (speculative and sequential) from
    seed 0 under the heat preset capped at :data:`LARGE_MAXITER` outer
    iterations: the JAX package's iterations, inner steps and J
    (:data:`LARGE_REF`), the device loops each equal to the host loop's
    iterates and to each other field for field, the launches counted."""
    from mioc_tpu_torch.solvers.trm import TRMParameters, trm_solve
    from mioc_tpu_torch.solvers.trm_device import DeviceTRMResult, trm_solve_device

    par = TRMParameters(**HEAT_PRESET, maxiter=LARGE_MAXITER)
    its, inner, f_evals, df_evals, J = LARGE_REF
    out = {}
    record_sweeps()
    read = zero_counts(torch)
    t0 = time.perf_counter()
    host = trm_solve(obj, par, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = read()
    out["host"] = {"J": host.J, "iterations": host.iterations,
                   "inner_steps": host.inner_steps, "f_evals": host.f_evals,
                   "df_evals": host.df_evals, "launches": launches, "plain_calls_on_card": plain,
                   "sweeps": recorded_sweeps(), "wall_s": wall,
                   "timings_s": host.timings}
    require((host.iterations, host.inner_steps, host.f_evals, host.df_evals) ==
            (its, inner, f_evals, df_evals),
            f"heat_large host: iterations/inner/f/df {host.iterations}/{host.inner_steps}/"
            f"{host.f_evals}/{host.df_evals} == JAX {LARGE_REF[:4]}")
    require(abs(host.J - J) <= 1e-12 * abs(J), f"heat_large host: J {host.J!r} == JAX {J!r}")
    require(launches["dp_build"] == its and launches["chase"] == inner
            and not any(v for k, v in launches.items() if k not in ("dp_build", "chase")),
            f"heat_large host: {its} dp_build, {inner} chase, no other kernel: {launches}")
    require(not any(plain.values()), f"heat_large host: no plain DP on the card: {plain}")
    dev = {}
    for spec in (True, False):
        record_sweeps()
        read = zero_counts(torch)
        t0 = time.perf_counter()
        # The speculative loop in segments of one outer iteration (the JAX
        # package's advice for minutes-long solves at this size,
        # docs/USAGE.md:205-212): segmenting must not change a field.
        res = trm_solve_device(obj, par, seed=0, speculative=spec,
                               outer_chunk=1 if spec else None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = read()
        name = "device_speculative" if spec else "device_sequential"
        dev[spec] = res
        out[name] = {"outer_chunk": 1 if spec else None,
                     "J": float(res.J), "iterations": int(res.iterations),
                     "inner_steps": int(res.inner_steps), "f_evals": int(res.f_evals),
                     "df_evals": int(res.df_evals), "launches": launches,
                     "plain_calls_on_card": plain,
                     "sweeps": recorded_sweeps(), "wall_s": wall}
        wave = "chase_trials" if spec else "chase"
        require(int(res.iterations) == its and int(res.inner_steps) == inner,
                f"heat_large {name}: iterations/inner {int(res.iterations)}/"
                f"{int(res.inner_steps)} == JAX {its}/{inner}")
        require(abs(float(res.J) - J) <= 1e-12 * abs(J), f"heat_large {name}: J == JAX")
        require(np.array_equal(res.u, host.u) and abs(float(res.J) - host.J) <= 1e-12 * abs(J)
                and int(res.df_evals) == host.df_evals - 1,
                f"heat_large {name}: the host loop's iterates (u, J; one ∇f fewer)")
        require(launches["dp_build"] == its and launches[wave] == (its if spec else inner)
                and not any(v for k, v in launches.items() if k not in ("dp_build", wave)),
                f"heat_large {name}: {its} dp_build and the {wave} chases only: {launches}")
        require(not any(plain.values()), f"heat_large {name}: no plain DP on the card")
    for field in DeviceTRMResult._fields:
        require(np.array_equal(getattr(dev[True], field), getattr(dev[False], field)),
                f"heat_large: speculative == sequential: {field}")
    return out


def large_multistart(torch, obj, rows) -> dict:
    """``multistart_solve_device`` over :data:`LARGE_STARTS` starts
    ``rand_func(obj, seed=s)`` (start 0 is :data:`LARGE_REF`'s) under the
    heat preset capped at :data:`LARGE_MAXITER`, sequential and speculative:
    every start's iterations and inner steps equal to the JAX package's and J
    within 1e-12 (``LARGE8_*``), start 0 equal to :data:`LARGE_REF`, the
    speculative run equal to the sequential one field for field, through
    ``dp_build_batched`` and ``chase_batched`` (sequential) or
    ``chase_trials`` (speculative) only and no plain DP.  Each run's wall,
    ms per start, its sweeps by row count, the wave's rows and the rows per
    chunk of the sparse engine; ``rows`` gives the ms per sweep at 1 and 8
    rows (:func:`large_rows`)."""
    from mioc_tpu_torch.ops.rows import ROWS
    from mioc_tpu_torch.solvers.trm import TRMParameters
    from mioc_tpu_torch.solvers.trm_device import DeviceTRMResult, multistart_solve_device
    from mioc_tpu_torch.utils.init import rand_func

    x0s = np.stack([rand_func(obj, seed=s) for s in range(LARGE_STARTS)])
    par = TRMParameters(**HEAT_PRESET, maxiter=LARGE_MAXITER)
    ms_per_sweep = {S: {"f": 1e3 * rows[f"forward{S}_s"], "df": 1e3 * rows[f"adjoint{S}_s"]}
                    for S in (1, 8)}
    out, res = {}, {}
    for spec in (False, True):
        name = "multistart_speculative" if spec else "multistart_sequential"
        record_sweeps()
        read = zero_counts(torch)
        t0 = time.perf_counter()
        r = multistart_solve_device(obj, par, x0s, speculative=spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = read()
        sweeps = recorded_sweeps()
        res[spec] = r
        wave_rows = max(sweeps["f"])
        out[name] = {"S": LARGE_STARTS, "maxiter": LARGE_MAXITER, "J": r.J.tolist(),
                     "iterations": r.iterations.tolist(), "inner_steps": r.inner_steps.tolist(),
                     "f_evals": r.f_evals.tolist(), "df_evals": r.df_evals.tolist(),
                     "launches": launches, "plain_calls_on_card": plain,
                     "sweeps": sweeps, "wall_s": wall,
                     "ms_per_start": 1e3 * wall / LARGE_STARTS,
                     "ms_per_sweep_from_rows": ms_per_sweep, "rows_per_chunk": ROWS,
                     "largest_forward_rows": wave_rows,
                     "chunks_of_largest_forward": -(-wave_rows // ROWS)}
        its = int(r.iterations.max())
        wave = "chase_trials" if spec else "chase_batched"
        require(launches["dp_build_batched"] == its and launches[wave] >= its
                and not any(v for k, v in launches.items()
                            if k not in ("dp_build_batched", wave)),
                f"heat_large {name}: {its} dp_build_batched and the {wave} chases only: "
                f"{launches}")
        require(not any(plain.values()), f"heat_large {name}: no plain DP on the card: {plain}")
        for s in range(LARGE_STARTS):
            require((int(r.iterations[s]), int(r.inner_steps[s])) ==
                    (LARGE8_ITERATIONS[s], LARGE8_INNER[s]),
                    f"heat_large {name} start {s}: iterations/inner "
                    f"{int(r.iterations[s])}/{int(r.inner_steps[s])} == JAX")
            require(abs(float(r.J[s]) - LARGE8_J[s]) <= 1e-12 * abs(LARGE8_J[s]),
                    f"heat_large {name} start {s}: J {float(r.J[s])!r} == JAX {LARGE8_J[s]!r}")
        its0, inner0, _, _, J0 = LARGE_REF
        require((int(r.iterations[0]), int(r.inner_steps[0])) == (its0, inner0)
                and abs(float(r.J[0]) - J0) <= 1e-12 * abs(J0),
                f"heat_large {name}: start 0 == LARGE_REF")
    for field in DeviceTRMResult._fields:
        require(np.array_equal(getattr(res[True], field), getattr(res[False], field)),
                f"heat_large multistart: speculative == sequential: {field}")
    return out


def large_ell(torch, hier, x0, f, df) -> dict:
    """The ELL engine at the same model: f and ∇f at ``x0`` against the
    banded engine's (``f``, ``df``) within the measured tolerance."""
    from mioc_tpu_torch.models import HeatObj

    t0 = time.perf_counter()
    ell = HeatObj(nt=LARGE_NT, mesh_hierarchy=hier, solver="mg", cg_iters=12,
                  sparse_format="ell")
    build = time.perf_counter() - t0
    x = torch.as_tensor(x0, dtype=ell.dtype, device=ell.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fe, ys = ell._forward(x)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dfe, _ = ell._adjoint(x, ys)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    f_err = abs(float(fe) - float(f)) / abs(float(f))
    df_err = float((dfe - df).abs().max() / df.abs().max())
    require(f_err <= LARGE_TOL_ELL_F and df_err <= LARGE_TOL_ELL_DF,
            f"heat_large ELL: f/∇f within {LARGE_TOL_ELL_F}/{LARGE_TOL_ELL_DF} of banded "
            f"({f_err}, {df_err})")
    require(not ell._batched_sweeps_bitexact, "heat_large ELL: the wave stays off")
    return {"build_s": build, "f": float(fe), "f_rel_err_vs_banded": f_err,
            "df_err_of_max_vs_banded": df_err, "f_tol": LARGE_TOL_ELL_F,
            "df_tol": LARGE_TOL_ELL_DF, "forward_s": t1 - t0, "adjoint_s": t2 - t1}


def heat_large(torch) -> dict:
    """Large-mesh heat on the card: construction, operators, values, rows,
    the banded application against its bound, the three solves and the ELL
    engine; emits one ``heat_large`` line."""
    from mioc_tpu_torch.models.heat import HeatObj, construct_mesh_hierarchy
    from mioc_tpu_torch.utils.init import rand_func

    t0 = time.perf_counter()
    hier = construct_mesh_hierarchy(refinements=5)
    obj = HeatObj(nt=LARGE_NT, mesh_hierarchy=hier, solver="mg", cg_iters=12,
                  sparse_format="banded")
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    out = {"phase": "heat_large", "nt": LARGE_NT, "N": obj.Nglobal_dofs, "dtype": "float64",
           "cg_iters": obj.cg_iters, "construction_s": build, "Kspec": list(obj._Kspec),
           "mg_levels": len(obj._mg_static), "layouts": [list(x) for x in obj._mg_ops["layouts"]],
           "device_memory_gb": torch.cuda.memory_allocated() / 1e9}
    require(obj.Nglobal_dofs == LARGE_N and tuple(obj._Kspec) == LARGE_KSPEC
            and len(obj._mg_static) == LARGE_LEVELS and obj.admissible.L == 36,
            f"heat_large: N = 8321, banded spec {tuple(obj._Kspec)}, 5 levels, L = 36")
    out["operators_bytes_equal_to_jax"] = large_operators(obj)
    x0s = np.stack([rand_func(obj, seed=s) for s in range(3)])
    out["values"], single0 = large_values(torch, obj, x0s[0])
    out["rows"] = large_rows(torch, obj, x0s, single0)
    out["apply"] = large_apply_ms(torch, obj)
    out["solves"] = large_solves(torch, obj)
    out["solves"].update(large_multistart(torch, obj, out["rows"]))
    out["ell"] = large_ell(torch, hier, x0s[0], single0[0], single0[2])
    out["peak_device_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit(out)
    return out


# The continuous optimizers (ROADMAP.md queue A item 5): the JAX package's
# results on the CPU at float64, from
#   JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 python -c "import numpy as np, sys
#   sys.path.insert(0, 'tests'); from test_aux import Quadratic
#   from mioc_tpu.models import LVMObj
#   from mioc_tpu.solvers.continuous import (SteepestDescent, NonlinCG, ArmijoLS,
#       WolfeLS, opt_optimize)
#   for opt in (NonlinCG(ls=WolfeLS()), SteepestDescent(ls=WolfeLS())):
#       obj = Quadratic(); opt.maxiter = 500
#       f = opt_optimize(opt, obj, np.zeros((12, 1)))
#       print(f, np.asarray(obj.x)[:, 0].tolist(), opt.iter, obj.f_evals, obj.df_evals)
#   obj = LVMObj(nt=1024)
#   f = opt_optimize(SteepestDescent(ls=ArmijoLS(sigma=1e-3), maxiter=8), obj,
#                    np.full((1024, 3), 0.5))
#   print(f, obj.f_evals, obj.df_evals)"
REF_SD_ARMIJO = (0.4602725065355201, 8, 25, 9)  # f, iterations, f and ∇f evaluations
REF_QUADRATIC = {
    "ncg-wolfe": (-0.18959042767020942, 12, 25, 25, (
        -0.015003609825700343, -0.017492076601305195, -0.1082366408871004,
        -0.016752779396116566, -0.009342553095178986, 0.023652672394100016,
        -0.027610080610073945, 0.015780470711037723, -0.03574496252741391,
        -0.029863312397720852, 0.016549486796858744, -0.0553859330441262)),
    "sd-wolfe": (-0.18959042767020942, 39, 79, 79, (
        -0.015003609544525865, -0.017492076678643945, -0.10823664060257447,
        -0.016752779486099743, -0.009342553188968851, 0.02365267254005254,
        -0.02761008059739668, 0.01578047068542721, -0.03574496269243418,
        -0.029863312069845677, 0.016549486707048606, -0.05538593295538147)),
}

# The mixed solver (ROADMAP.md queue A item 5) on LVMMixedObj under the
# registry's "mixed" preset (β = 1e-4, Δ⁰ = 2, p = ∞), the JAX package's
# results on the CPU at float64, counting calls of obj._forward/_adjoint:
# (a) mixed_solve(LVMMixedObj(nt=1024), MixedParameters(trm=preset,
#     rounds=1), seed=0): J, rounds, converged, history, sweeps; its control
#     res.x in tests/data/jax_mixed_fishing_nt1024_round1.npz (np.savez_compressed(x=...));
# (b) JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 python -m mioc_tpu.cli mixed --n 240
#     --seed 0 --no-plot --no-log: J, rounds, converged (the printed JSON),
#     and the sweeps of mixed_solve(LVMMixedObj(nt=240), MixedParameters(
#     trm=preset), seed=0), the solve that CLI runs.
MIXED_PRESET = dict(beta=1e-4, delta0=2.0, p=math.inf)
REF_MIXED_A = dict(nt=1024, J=0.8986080626037327, rounds=1, converged=False,
                   history=(5.186650813287828, 1.444464319369251, 0.8986080626037327),
                   f=303, df=73)
REF_MIXED_X = os.path.join("tests", "data", "jax_mixed_fishing_nt1024_round1.npz")
REF_MIXED_B = dict(nt=240, J=0.8781014228848273, rounds=20, converged=False, f=2707, df=677)
# The integer block's DP shape at nt = 240 (B = ⌊2/(12/240)⌋ = 40, L = 3).
MIXED240_SHAPE = ("mixed240", 240, 40, ("bounded", [[0, 1]] * 3), (math.inf, 1e-4, 12.0 / 240))

# The temporal DP's shapes: the fishing preset, heat500 and heat200 (name,
# nt, B, level set, (p, beta, tau)).
TEMPORAL_SHAPES = (SHAPES[0], HEAT_SHAPE, LARGE_SHAPE)
TEMPORAL_MAXITER = 10


def quadratic(torch, n=12, seed=0):
    """½ xᵀ Q x − bᵀx on an (n, 1) variable on the card: the port's
    counterpart of tests/test_aux.py's ``Quadratic``."""
    from mioc_tpu_torch.objectives.base import LazyObjective

    class Quadratic(LazyObjective):
        def __init__(self):
            super().__init__()
            self.device, self.dtype = torch.device(DEVICE), torch.float64
            rng = np.random.default_rng(seed)
            A = rng.normal(size=(n, n))
            self.Q = self.as_control(A @ A.T + n * np.eye(n))
            self.b = self.as_control(rng.normal(size=n))
            self.nt, self.nu, self.nv = n, 1, 0
            self.T0, self.T1, self.tau = 0.0, 1.0, 1.0 / n
            self.x = self.as_control(np.zeros((n, 1)))

        def eval_f_impl(self, x, cache):
            v = x[:, 0]
            return 0.5 * v @ (self.Q @ v) - self.b @ v, None

        def eval_df_impl(self):
            return (self.Q @ self.x[:, 0] - self.b)[:, None]

    return Quadratic()


def continuous_phase(torch) -> dict:
    """SD-Armijo on the relaxed fishing preset and the two Wolfe optimizers
    on the quadratic, on the card, against the JAX package's results."""
    from mioc_tpu_torch.models import LVMObj
    from mioc_tpu_torch.solvers.continuous import (ArmijoLS, NonlinCG, SteepestDescent,
                                                   WolfeLS, opt_optimize)

    out = {"phase": "continuous", "dtype": "float64"}
    t0 = time.perf_counter()
    obj = LVMObj(nt=1024)
    opt = SteepestDescent(ls=ArmijoLS(sigma=1e-3), maxiter=8)
    f = opt_optimize(opt, obj, np.full((1024, 3), 0.5))
    torch.cuda.synchronize()
    out["sd_armijo_lvm1024"] = {"f": f, "iterations": opt.iter, "f_evals": obj.f_evals,
                                "df_evals": obj.df_evals, "wall_s": time.perf_counter() - t0}
    for name, opt in (("ncg-wolfe", NonlinCG(ls=WolfeLS())),
                      ("sd-wolfe", SteepestDescent(ls=WolfeLS()))):
        obj = quadratic(torch)
        opt.maxiter = 500
        t0 = time.perf_counter()
        f = opt_optimize(opt, obj, np.zeros((12, 1)))
        x = obj.x[:, 0].cpu().numpy()
        out[name] = {"f": f, "iterations": opt.iter, "f_evals": obj.f_evals,
                     "df_evals": obj.df_evals, "wall_s": time.perf_counter() - t0,
                     "max_abs_x_err": float(np.abs(x - REF_QUADRATIC[name][4]).max())}
    emit(out)
    r = out["sd_armijo_lvm1024"]
    f_ref, its, nf, ndf = REF_SD_ARMIJO
    require(abs(r["f"] - f_ref) <= 1e-12 * abs(f_ref), f"SD-Armijo f {r['f']!r} == {f_ref!r}")
    require((r["iterations"], r["f_evals"], r["df_evals"]) == (its, nf, ndf),
            f"SD-Armijo iterations/f/∇f evaluations == JAX {its}/{nf}/{ndf}")
    for name, (f_ref, its, nf, ndf, _) in REF_QUADRATIC.items():
        r = out[name]
        require((r["iterations"], r["f_evals"], r["df_evals"]) == (its, nf, ndf),
                f"{name}: iterations/f/∇f evaluations == JAX {its}/{nf}/{ndf}")
        require(r["max_abs_x_err"] <= 1e-12, f"{name}: x within 1e-12 of the JAX package's")
        require(abs(r["f"] - f_ref) <= 1e-12 * abs(f_ref), f"{name}: f {r['f']!r}")
    return out


def count_mixed_sweeps(cls):
    """Count ``_forward``/``_adjoint`` calls of every ``cls`` instance (the
    JAX constants count the same calls); returns the counts and an undo."""
    counts = {"f": 0, "df": 0}
    fwd, adj = cls._forward, cls._adjoint

    def forward(self, x):
        counts["f"] += 1
        return fwd(self, x)

    def adjoint(self, x, ys):
        counts["df"] += 1
        return adj(self, x, ys)

    cls._forward, cls._adjoint = forward, adjoint

    def undo():
        cls._forward, cls._adjoint = fwd, adj

    return counts, undo


def mixed_sweep_ms(torch, nt: int) -> dict:
    """ms per mixed forward and adjoint sweep at ``nt`` (CUDA events,
    median of 3), and the sweep's probe of ``torch.addcmul``."""
    from mioc_tpu_torch.models import LVMMixedObj
    from mioc_tpu_torch.ops import xla_order
    from mioc_tpu_torch.utils.init import rand_func

    obj = LVMMixedObj(nt=nt)
    x = obj.as_control(rand_func(obj, seed=0))
    _, ys = obj._forward(x)
    return {"f": statistics.median(median_ms(torch, lambda: obj._forward(x), 3)),
            "df": statistics.median(median_ms(torch, lambda: obj._adjoint(x, ys), 3)),
            "addcmul_fuses": xla_order.addcmul_fuses(obj.device)}


def mixed_phase(torch, kernel_ms: dict) -> dict:
    """(a) one round of the mixed solve at nt=1024 and (b) the port's CLI
    ``mixed --n 240``, each against the JAX package's results; ``kernel_ms``
    gives ms per dp_build and chase at each nt."""
    from mioc_tpu_torch.models import LVMMixedObj
    from mioc_tpu_torch.solvers.mixed import MixedParameters, mixed_solve
    from mioc_tpu_torch.solvers.trm import TRMParameters

    out = {}
    sweep_ms = {1024: mixed_sweep_ms(torch, 1024), 240: mixed_sweep_ms(torch, 240)}
    counts, undo = count_mixed_sweeps(LVMMixedObj)
    try:
        read = zero_counts(torch)
        t0 = time.perf_counter()
        res = mixed_solve(LVMMixedObj(nt=1024), MixedParameters(
            trm=TRMParameters(**MIXED_PRESET), rounds=1), seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain_calls = read()
        a = {"path": "mixed_a", "nt": 1024, "J": res.J, "rounds": res.rounds,
             "converged": res.converged, "history": res.history, "sweeps": dict(counts),
             "launches": launches, "plain_calls_on_card": plain_calls, "wall_s": wall}
        for key in counts:
            counts[key] = 0
        r = run_cli(torch, "mixed_cli", ["mixed", "--n", "240", "--seed", "0", "--no-plot",
                                         "--no-log"])
        b = {"path": "mixed_cli", "nt": 240, "J": r["J"], "rounds": r["rounds"],
             "converged": r["converged"], "sweeps": dict(counts),
             "launches": r["launches"], "plain_calls_on_card": r["plain_calls_on_card"],
             "wall_s": r["wall_s_measured"]}
    finally:
        undo()
    with np.load(os.path.join(ROOT, REF_MIXED_X)) as z:
        x_ref = z["x"]
    a["int_columns_equal"] = bool(np.array_equal(res.x[:, 1:], x_ref[:, 1:]))
    a["c_max_abs_err"] = float(np.abs(res.x[:, 0] - x_ref[:, 0]).max())
    a["x_bit_equal"] = bool(np.array_equal(res.x, x_ref))
    for r, nt in ((a, 1024), (b, 240)):
        ms = sweep_ms[nt]
        sweeps_s = (r["sweeps"]["f"] * ms["f"] + r["sweeps"]["df"] * ms["df"]) / 1e3
        k_s = sum(n * kernel_ms[nt][k] for k, n in r["launches"].items() if n) / 1e3
        r.update(phase="mixed", sweep_ms=ms, sweeps_s_estimate=sweeps_s,
                 kernels_s_estimate=k_s, kernels_share=k_s / r["wall_s"],
                 rest_s=r["wall_s"] - sweeps_s - k_s)
        emit(r)
        out[r["path"]] = r
    for r, ref in ((a, REF_MIXED_A), (b, REF_MIXED_B)):
        name = r["path"]
        require(abs(r["J"] - ref["J"]) <= 1e-12 * abs(ref["J"]),
                f"{name}: J {r['J']!r} == JAX {ref['J']!r}")
        require((r["rounds"], r["converged"]) == (ref["rounds"], ref["converged"]),
                f"{name}: rounds/converged == JAX {ref['rounds']}/{ref['converged']}")
        require((r["sweeps"]["f"], r["sweeps"]["df"]) == (ref["f"], ref["df"]),
                f"{name}: {r['sweeps']} sweeps == JAX {ref['f']}/{ref['df']}")
        n = r["launches"]
        require(n["dp_build"] > 0 and n["chase"] >= n["dp_build"]
                and not any(v for k, v in n.items() if k not in ("dp_build", "chase")),
                f"{name}: dp_build and chase launches, no other kernel: {n}")
        require(not any(r["plain_calls_on_card"].values()), f"{name}: no plain DP on the card")
    require(len(a["history"]) == len(REF_MIXED_A["history"]) and all(
        abs(h - w) <= 1e-12 * abs(w) for h, w in zip(a["history"], REF_MIXED_A["history"])),
        f"mixed_a: history {a['history']} == JAX")
    require(a["int_columns_equal"], "mixed_a: integer columns equal to the JAX package's")
    require(a["c_max_abs_err"] <= 1e-12, f"mixed_a: c within 1e-12 ({a['c_max_abs_err']})")
    return out


def temporal_phase(torch) -> dict:
    """The banded temporal DP on the card at the fishing preset, heat500 and
    heat200 shapes against dp_build + chase and against its own tables on
    the CPU; then the fishing preset host loop on the temporal route against
    the kernel route's, both capped at ``TEMPORAL_MAXITER``."""
    from mioc_tpu_torch.models import LVMObj
    from mioc_tpu_torch.ops import levels as lv
    from mioc_tpu_torch.ops.backtrack_cuda import chase
    from mioc_tpu_torch.ops.bellman import max_budget_use, stage_tables
    from mioc_tpu_torch.ops.bellman_cuda import dp_build
    from mioc_tpu_torch.parallel.temporal import (temporal_backtrack, temporal_dp_solve,
                                                  temporal_tables)
    from mioc_tpu_torch.solvers.trm import TRMParameters, trm_solve

    out = {"phase": "temporal", "dtype": "float64", "shapes": {}}
    dev = torch.device(DEVICE)
    for seed, (name, nt, B, (kind, V), (p, beta, tau)) in enumerate(TEMPORAL_SHAPES):
        adm = lv.bounded_sum_levels(V, 1, 1) if kind == "bounded" else lv.product_levels(V)
        rng = np.random.default_rng(50 + seed)
        grad = torch.as_tensor(rng.normal(size=(nt, adm.M)), dtype=torch.float64, device=dev)
        u_old = torch.as_tensor(adm.levels[rng.integers(0, adm.L, size=nt)],
                                dtype=torch.float64, device=dev)
        jump = torch.as_tensor(lv.jump_cost_table(adm.levels, p, beta=beta),
                               dtype=torch.float64, device=dev)
        smax = max_budget_use(adm.levels)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        u_t, i_t, phis = temporal_dp_solve(grad, u_old, adm.levels, jump, tau, B)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        stage, btilde = stage_tables(grad, u_old, adm.levels, tau)
        U, phi0 = dp_build(stage, btilde, jump, B, smax)
        p_t, p_k = phis[0].T.cpu().numpy(), phi0.cpu().numpy()
        finite = np.isfinite(p_k)
        phi_err = float(np.abs(p_t[finite] - p_k[finite]).max()) if finite.any() else 0.0
        rel_ok = bool(np.allclose(p_t, p_k, rtol=1e-10, atol=0))
        caps = sorted(set(schedule(2.0, tau) + [B]), reverse=True)
        caps = [c for c in caps if c <= B]
        paths_equal = all(torch.equal(temporal_backtrack(phis, btilde, jump, adm.levels, c)[1],
                                      chase(U, phi0, btilde, c)) for c in caps)
        ref = temporal_tables(stage.cpu(), btilde.cpu(), jump.cpu(), B, smax)
        cpu_bits = torch.equal(phis.cpu().view(torch.int64), ref.view(torch.int64))
        t_ms = statistics.median(median_ms(
            torch, lambda: temporal_tables(stage, btilde, jump, B, smax), 3))
        bt_ms = statistics.median(median_ms(
            torch, lambda: temporal_backtrack(phis, btilde, jump, adm.levels, B), 3))
        b_ms = statistics.median(median_ms(
            torch, lambda: dp_build(stage, btilde, jump, B, smax), 5))
        c_ms = statistics.median(median_ms(torch, lambda: chase(U, phi0, btilde, B), 5))
        out["shapes"][name] = {
            "nt": nt, "B": B, "L": adm.L, "phi0_rtol_1e-10": rel_ok, "phi0_max_abs_err": phi_err,
            "caps": caps, "paths_equal": paths_equal, "cpu_tables_bit_equal": cpu_bits,
            "temporal_tables_ms": t_ms, "temporal_backtrack_ms": bt_ms,
            "dp_build_ms": b_ms, "chase_ms": c_ms, "peak_device_memory_mb": peak / 1e6,
            "phis_mb": phis.numel() * 8 / 1e6}
    # The fishing preset host loop on the temporal route, from host_path's
    # start, capped; the kernel route at the same cap is its reference.
    host = trm_solve(LVMObj(nt=1024), TRMParameters(**PRESET, maxiter=TEMPORAL_MAXITER),
                     seed=0)
    record_sweeps()
    read = zero_counts(torch)
    t0 = time.perf_counter()
    res = trm_solve(LVMObj(nt=1024), TRMParameters(**PRESET, dp_backend="temporal",
                                                   maxiter=TEMPORAL_MAXITER), seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = read()
    sweeps = recorded_sweeps()
    out["host_temporal"] = {"J": res.J, "iterations": res.iterations,
                            "inner_steps": res.inner_steps, "launches": launches,
                            "plain_calls_on_card": plain_calls, "sweeps": sweeps, "wall_s": wall,
                            "timings_s": res.timings}
    emit(out)
    for name, s in out["shapes"].items():
        require(s["phi0_rtol_1e-10"], f"temporal {name}: phis[0].T == Φ0 (rtol 1e-10)")
        require(s["paths_equal"], f"temporal {name}: paths equal at {s['caps']}")
        require(s["cpu_tables_bit_equal"], f"temporal {name}: tables bit-equal to the CPU's")
    h = out["host_temporal"]
    require((h["iterations"], h["inner_steps"]) == (host.iterations, host.inner_steps),
            f"temporal host loop: iterations/inner steps {h['iterations']}/"
            f"{h['inner_steps']} == the kernel route's")
    require(np.array_equal(res.u, host.u), "temporal host loop: u == the kernel route's")
    require(abs(res.J - host.J) <= 1e-10 * abs(host.J), "temporal host loop: J (rtol 1e-10)")
    require(not any(v for k, v in launches.items() if k not in SWEEP_KERNELS)
            and not any(plain_calls.values()),
            f"temporal host loop: no DP kernel and no plain DP: {launches} {plain_calls}")
    require_sweep_launches("temporal host loop", launches, sweeps)
    return out


# The multi-rank paths (parallel/ on torch.distributed).  Four ranks share
# the one card, so they talk over gloo (NCCL refuses two ranks on one GPU),
# and their walls measure four processes contending for one card, not
# scaling.  A sharded build makes one collective per DP step, ~4.2 ms over
# gloo between four ranks here (``sharded_tables``' gather_us): the
# fishing host loop on a 1×4 mesh would spend ~185 s in its 41 builds.  So
# the 4-rank host loops are capped (``SHARDED_MAXITER``) and held against
# the kernel route at the same cap; the whole fishing solve on the sharded
# route runs in the world of one.
WORLD = 4
WORLD_TIMEOUT = 420
SHARDED_MAXITER = {"fishing": 2, "heat": 2}
MESH_SPEC_STARTS = 8
MESH_SPEC_MAXITER = 2
# nt is the CLI's default, 1024: torchrun's own parser (torch 2.11 on Python
# 3.12.3) takes a script's "--n" for an ambiguous abbreviation of its options.
TORCHRUN_ARGS = ["fishing", "--device-loop", "--multistart", str(N_STARTS),
                 "--seed", "0", "--no-plot", "--no-log"]
SHARDED_SHAPES = (  # name, nt, B, levels, (p, beta, tau), level-axis sizes
    (*SHAPES[0], (2, 4)),
    ("heat500", HEAT_NT, 100, ("product", [list(range(6))] * 2),
     (2, 1e-3, 10.0 / HEAT_NT), (4,)),
)
TEMPORAL_SHARDED = (SHAPES[0], ("heat200", 200, 40, ("product", [list(range(6))] * 2),
                                (2, 1e-3, 10.0 / 200)))


def _dp_inputs(torch, nt, B, level_spec, preset, seed):
    from mioc_tpu_torch.ops import levels as lv
    from mioc_tpu_torch.ops.bellman import max_budget_use, stage_tables

    kind, V = level_spec
    adm = lv.bounded_sum_levels(V, 1, 1) if kind == "bounded" else lv.product_levels(V)
    p, beta, tau = preset
    rng = np.random.default_rng(seed)
    dev = torch.device(DEVICE)
    grad = torch.as_tensor(rng.normal(size=(nt, adm.M)), dtype=torch.float64, device=dev)
    u_old = torch.as_tensor(adm.levels[rng.integers(0, adm.L, size=nt)],
                            dtype=torch.float64, device=dev)
    jump = torch.as_tensor(lv.jump_cost_table(adm.levels, p, beta=beta),
                           dtype=torch.float64, device=dev)
    stage, btilde = stage_tables(grad, u_old, adm.levels, tau)
    return adm, stage, btilde, jump, max_budget_use(adm.levels)


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def world_sharded_tables(torch, rank) -> dict:
    """1: the level-sharded tables at fishing (level 2 and 4) and heat500
    (level 4), cropped to L, bit-equal to dp_build's and to the plain
    build's on the card; ``chase`` on the padded tables equal to ``chase``
    on dp_build's at B and every halving cap; ms per build and µs per
    collective of one step's packed planes."""
    from mioc_tpu_torch.ops.backtrack_cuda import chase
    from mioc_tpu_torch.ops.bellman import build_tables_plain
    from mioc_tpu_torch.ops.bellman_cuda import dp_build
    from mioc_tpu_torch.parallel import build_tables_sharded, make_device_mesh
    from mioc_tpu_torch.parallel.shard_dp import pad_level_axis

    out = {}
    for seed, (name, nt, B, spec, preset, sizes) in enumerate(SHARDED_SHAPES):
        adm, stage, btilde, jump, smax = _dp_inputs(torch, nt, B, spec, preset, 60 + seed)
        Uk, phik = dp_build(stage, btilde, jump, B, smax)
        Up, phip = build_tables_plain(stage, btilde, jump, B, smax)
        caps = [c for c in sorted(set(schedule(2.0, preset[2]) + [B]), reverse=True) if c <= B]
        for D in sizes:
            mesh = make_device_mesh(batch=1, level=D, devices=list(range(D)))
            if rank >= D:
                continue
            (U, phi0), build_s = _timed(torch, lambda: build_tables_sharded(
                stage, btilde, jump, B, smax, mesh))
            bt_p = pad_level_axis(stage, btilde, jump, D, B)[1]
            L = adm.L
            part = torch.zeros((2, 1, U.shape[1], B + 1), dtype=torch.float64,
                               device=stage.device)
            _, gather_s = _timed(torch, lambda: [mesh.all_gather(part, "level")
                                                 for _ in range(100)])
            out[f"{name}_level{D}"] = {
                "nt": nt, "B": B, "L": L, "Lp": int(U.shape[1]), "D": D,
                "U_equal_dp_build": torch.equal(U[:, :L], Uk),
                "U_equal_plain": torch.equal(U[:, :L], Up),
                "phi0_bits_equal_dp_build": torch.equal(bits(phi0[:L], torch), bits(phik, torch)),
                "phi0_bits_equal_plain": torch.equal(bits(phi0[:L], torch), bits(phip, torch)),
                "padded_rows_inert": bool(torch.isinf(phi0[L:]).all()) and not bool(U[:, L:].any()),
                "caps": caps,
                "chases_equal": all(torch.equal(chase(U, phi0, bt_p, c), chase(Uk, phik, btilde, c))
                                    for c in caps),
                "build_ms": 1e3 * build_s, "gather_us": 1e6 * gather_s / 100,
                "build_us_per_step": 1e6 * build_s / (nt - 1)}
    return out


def world_sharded_host(torch, rank) -> dict:
    """2: the fishing preset and heat nt=500 host loops on the sharded route
    over a 1×4 mesh, capped at ``SHARDED_MAXITER``."""
    from mioc_tpu_torch.models import HeatObj, LVMObj
    from mioc_tpu_torch.parallel import make_device_mesh
    from mioc_tpu_torch.solvers.trm import TRMParameters, trm_solve

    mesh = make_device_mesh(batch=1, level=WORLD)
    out = {}
    for name, make, preset in (("fishing", lambda: LVMObj(nt=1024), PRESET),
                               ("heat", lambda: HeatObj(nt=HEAT_NT), HEAT_PRESET)):
        obj = make()
        par = TRMParameters(**preset, maxiter=SHARDED_MAXITER[name], dp_backend="sharded",
                            mesh=mesh)
        record_sweeps()
        read = zero_counts(torch)
        res, wall = _timed(torch, lambda: trm_solve(obj, par, seed=0))
        launches, plain_calls = read()
        sweeps = recorded_sweeps()
        out[name] = {"J": res.J, "iterations": res.iterations, "inner_steps": res.inner_steps,
                     "dp_builds": res.dp_builds, "u": res.u.tolist(), "launches": launches,
                     "plain_calls_on_card": plain_calls, "sweeps": sweeps, "wall_s": wall,
                     "timings_s": res.timings}
    return out


def _summary(res) -> dict:
    return {f: np.asarray(getattr(res, f)).tolist() for f in res._fields}


def world_mesh_multistart(torch, rank) -> dict:
    """3: the 32 fishing starts on a 4×1 mesh (sequential), then the first 8
    on a 2×2 mesh, sharded and speculative, capped at
    ``MESH_SPEC_MAXITER``."""
    from mioc_tpu_torch.models import LVMObj
    from mioc_tpu_torch.parallel import make_device_mesh
    from mioc_tpu_torch.solvers.trm import TRMParameters
    from mioc_tpu_torch.solvers.trm_device import multistart_solve_device
    from mioc_tpu_torch.utils.init import rand_func

    x0s = np.stack([rand_func(LVMObj(nt=1024), seed=s) for s in range(N_STARTS)])
    out = {}
    for name, shape, kw, x, par in (
            ("4x1_sequential", (4, 1), dict(speculative=False), x0s, TRMParameters(**PRESET)),
            ("2x2_sharded_speculative", (2, 2), dict(speculative=True, dp_backend="sharded"),
             x0s[:MESH_SPEC_STARTS], TRMParameters(**PRESET, maxiter=MESH_SPEC_MAXITER))):
        mesh = make_device_mesh(*shape)
        record_sweeps()
        read = zero_counts(torch)
        res, wall = _timed(torch, lambda: multistart_solve_device(LVMObj(nt=1024), par, x,
                                                                  mesh=mesh, **kw))
        launches, plain_calls = read()
        sweeps = recorded_sweeps()
        out[name] = {**_summary(res), "launches": launches, "plain_calls_on_card": plain_calls,
                     "sweeps": sweeps, "wall_s": wall}
    return out


def _step_starts(torch):
    from mioc_tpu_torch.models import LVMObj
    from mioc_tpu_torch.utils.init import rand_func

    obj = LVMObj(nt=1024)
    x0s = np.stack([rand_func(obj, seed=s) for s in range(8)])
    return obj, torch.as_tensor(x0s, dtype=obj.dtype, device=obj.device)


def world_ode_step(torch, rank) -> dict:
    """4: make_ode_trm_step at fishing nt=1024, S=8, on 4×1 and 2×2."""
    from mioc_tpu_torch.parallel import make_device_mesh, make_ode_trm_step

    obj, u = _step_starts(torch)
    out = {}
    for shape in ((4, 1), (2, 2)):
        step = make_ode_trm_step(obj, **PRESET, mesh=make_device_mesh(*shape))
        (un, J, M), wall = _timed(torch, lambda: step(u))
        out[f"{shape[0]}x{shape[1]}"] = {"u": un.cpu().numpy().tolist(),
                                         "J": bits(J, torch).cpu().tolist(),
                                         "M": bits(M, torch).cpu().tolist(), "wall_s": wall}
    return out


def world_temporal(torch, rank) -> dict:
    """5: temporal_tables_sharded over the 4 ranks at fishing and heat200,
    bit-equal to temporal_tables on the card."""
    from mioc_tpu_torch.parallel import make_device_mesh, temporal_tables_sharded
    from mioc_tpu_torch.parallel.temporal import temporal_tables

    mesh = make_device_mesh(batch=WORLD, level=1)
    out = {}
    for seed, (name, nt, B, spec, preset) in enumerate(TEMPORAL_SHARDED):
        adm, stage, btilde, jump, smax = _dp_inputs(torch, nt, B, spec, preset, 70 + seed)
        sh, wall = _timed(torch, lambda: temporal_tables_sharded(stage, btilde, jump, B,
                                                                 smax, mesh))
        ref, ref_wall = _timed(torch, lambda: temporal_tables(stage, btilde, jump, B, smax))
        out[name] = {"bit_equal": torch.equal(bits(sh, torch), bits(ref, torch)),
                     "sharded_ms": 1e3 * wall, "single_ms": 1e3 * ref_wall}
    return out


WORLD_PHASES = (("sharded_tables", world_sharded_tables), ("sharded_host", world_sharded_host),
                ("mesh_multistart", world_mesh_multistart), ("ode_step_mesh", world_ode_step),
                ("temporal_sharded", world_temporal))


def world_rank(rank: int, world: int, store: str, out_dir: str) -> int:
    """One rank of the multi-rank phases (``chip_smoke.py --world-rank R W
    STORE DIR``, spawned by :func:`multi_rank`): joins the world with the
    backend ``init_multihost`` picks and writes its results to
    ``DIR/rank{R}.json``."""
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    from mioc_tpu_torch.parallel import init_multihost

    t0 = time.perf_counter()
    init_multihost(f"file://{store}", world, rank)
    out = {"rank": rank, "backend": dist.get_backend(), "init_s": time.perf_counter() - t0}
    for name, fn in WORLD_PHASES:
        t0 = time.perf_counter()
        out[name] = fn(torch, rank)
        out[name]["phase_s"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    dist.barrier()  # no rank leaves while another still talks to it
    dist.destroy_process_group()
    return 0


def spawn(cmd, n, timeout, env=None, cwd=None):
    """Run ``cmd(r)`` for r < n at once; kill them all when one fails or
    ``timeout`` runs out.  Returns their outputs."""
    procs = [subprocess.Popen(cmd(r), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env, cwd=cwd) for r in range(n)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate()[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        require(p.returncode == 0, f"process {r} of {n} exited {p.returncode} "
                                   f"(timeout {timeout} s):\n{out[-3000:]}")
    return outs


def _world_env():
    return {k: v for k, v in os.environ.items()
            if not k.startswith(("MASTER_", "WORLD_SIZE", "RANK", "LOCAL_"))}


def multi_rank(torch, host, seq) -> dict:
    """The multi-rank phases: 6 (world of one, this process), 1–5 (a world
    of ``WORLD`` ranks spawned here), 7 (the CLI under torchrun); each
    checked against the kernel routes' results."""
    import tempfile

    import torch.distributed as dist

    from mioc_tpu_torch.models import HeatObj, LVMObj
    from mioc_tpu_torch.parallel import make_ode_trm_step
    from mioc_tpu_torch.solvers.trm import TRMParameters, trm_solve
    from mioc_tpu_torch.solvers.trm_device import multistart_solve_device
    from mioc_tpu_torch.utils.init import rand_func

    # 6: the sharded host loop with no mesh: a world of one (NCCL).
    record_sweeps()
    read = zero_counts(torch)
    res, wall = _timed(torch, lambda: trm_solve(
        LVMObj(nt=1024), TRMParameters(**PRESET, dp_backend="sharded"), seed=0))
    launches, plain_calls = read()
    sweeps = recorded_sweeps()
    one = {"phase": "world_of_one", "backend": dist.get_backend(),
           "world": dist.get_world_size(), "J": res.J, "iterations": res.iterations,
           "inner_steps": res.inner_steps, "dp_builds": res.dp_builds, "launches": launches,
           "plain_calls_on_card": plain_calls, "sweeps": sweeps, "wall_s": wall,
           "timings_s": res.timings}
    emit(one)
    require(one["world"] == 1 and one["backend"] == "nccl", "world of one over NCCL")
    require((res.iterations, res.inner_steps) == (host.iterations, host.inner_steps)
            and np.array_equal(res.u, host.u) and abs(res.J - host.J) <= 1e-12 * abs(host.J),
            "world of one: the sharded host loop gives the kernel route's (a) result")
    require(launches["dp_build"] == 0 and launches["chase"] == res.inner_steps
            and not any(plain_calls.values()),
            f"world of one: no dp_build, one chase per inner step: {launches}")
    require_sweep_launches("world of one", launches, sweeps)

    # The kernel-route and world-of-one references of phases 2–4.
    refs = {}
    for name, make, preset in (("fishing", lambda: LVMObj(nt=1024), PRESET),
                               ("heat", lambda: HeatObj(nt=HEAT_NT), HEAT_PRESET)):
        refs[name] = trm_solve(make(), TRMParameters(**preset,
                                                     maxiter=SHARDED_MAXITER[name]), seed=0)
    x0s = np.stack([rand_func(LVMObj(nt=1024), seed=s) for s in range(MESH_SPEC_STARTS)])
    spec_one = multistart_solve_device(
        LVMObj(nt=1024), TRMParameters(**PRESET, maxiter=MESH_SPEC_MAXITER), x0s,
        speculative=True, dp_backend="sharded")
    obj, u = _step_starts(torch)
    step_one = [t.cpu() for t in make_ode_trm_step(obj, **PRESET)(u)]

    # 1–5 in a world of WORLD ranks on this card.
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn(lambda r: [sys.executable, os.path.abspath(__file__), "--world-rank", str(r),
                         str(WORLD), os.path.join(tmp, "store"), tmp],
              WORLD, WORLD_TIMEOUT, env=_world_env())
        world_wall = time.perf_counter() - t0
        ranks = []
        for r in range(WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
    out = {"world_of_one": one, "world_wall_s": world_wall,
           "backend": ranks[0]["backend"]}
    require(all(r["backend"] == "gloo" for r in ranks),
            f"{WORLD} ranks on one card take gloo: {[r['backend'] for r in ranks]}")

    tables = {k: v for r in ranks for k, v in r["sharded_tables"].items() if k != "phase_s"}
    emit({"phase": "sharded_tables", "backend": out["backend"], "dtype": "float64",
          "ranks": [r["sharded_tables"] for r in ranks]})
    for r in ranks:
        for key, t in r["sharded_tables"].items():
            if key == "phase_s":
                continue
            for check in ("U_equal_dp_build", "U_equal_plain", "phi0_bits_equal_dp_build",
                          "phi0_bits_equal_plain", "padded_rows_inert", "chases_equal"):
                require(t[check], f"sharded_tables {key} rank {r['rank']}: {check}")
    require(set(tables) == {"fishing_level2", "fishing_level4", "heat500_level4"},
            f"sharded_tables: every shape built: {sorted(tables)}")

    host_ranks = [r["sharded_host"] for r in ranks]
    emit({"phase": "sharded_host", "backend": out["backend"], "mesh": [1, WORLD],
          "maxiter": SHARDED_MAXITER,
          "ranks": [{n: {k: v for k, v in h[n].items() if k != "u"} for n in ("fishing", "heat")}
                    for h in host_ranks],
          "kernel_route": {n: {"J": r.J, "iterations": r.iterations,
                               "inner_steps": r.inner_steps} for n, r in refs.items()}})
    for h in host_ranks:
        for name, ref in refs.items():
            g = h[name]
            require((g["iterations"], g["inner_steps"]) == (ref.iterations, ref.inner_steps)
                    and np.array_equal(np.asarray(g["u"]), ref.u)
                    and abs(g["J"] - ref.J) <= 1e-12 * abs(ref.J),
                    f"sharded_host {name}: the kernel route's iterates at maxiter "
                    f"{SHARDED_MAXITER[name]}")
            n = g["launches"]
            require(n["dp_build"] == 0 and n["chase"] == g["inner_steps"]
                    and not any(g["plain_calls_on_card"].values()),
                    f"sharded_host {name}: 0 dp_build and one chase per inner step: {n}")
            if name == "fishing":
                require_sweep_launches(f"sharded_host {name}", n, g["sweeps"])
            else:
                require(not any(n[k] for k in SWEEP_KERNELS),
                        f"sharded_host {name}: no fishing sweep kernel: {n}")

    ms = [r["mesh_multistart"] for r in ranks]
    emit({"phase": "mesh_multistart", "backend": out["backend"],
          "ranks": [{k: {f: v[f] for f in ("launches", "plain_calls_on_card", "wall_s")}
                     for k, v in m.items() if k != "phase_s"} for m in ms],
          "iterations_4x1": ms[0]["4x1_sequential"]["iterations"],
          "iterations_2x2": ms[0]["2x2_sharded_speculative"]["iterations"]})
    for m in ms:
        a, b = m["4x1_sequential"], m["2x2_sharded_speculative"]
        for s in range(N_STARTS):
            require(a["iterations"][s] == REF32_ITERATIONS[s]
                    and a["inner_steps"][s] == REF32_INNER[s]
                    and abs(a["J"][s] - REF32_J[s]) <= 1e-12 * abs(REF32_J[s]),
                    f"mesh_multistart 4x1 start {s}: the JAX constants")
        for f in seq._fields:
            require(np.array_equal(np.asarray(a[f]), getattr(seq, f)),
                    f"mesh_multistart 4x1 == the one-process multistart: {f}")
            require(np.array_equal(np.asarray(b[f]), getattr(spec_one, f)),
                    f"mesh_multistart 2x2 sharded speculative == world of one: {f}")
        require(a["launches"]["dp_build_batched"] > 0 and a["launches"]["chase_batched"] > 0,
                f"mesh_multistart 4x1: dp_build_batched and chase_batched: {a['launches']}")
        require(b["launches"]["chase_trials"] > 0 and b["launches"]["dp_build_batched"] == 0
                and b["launches"]["dp_build"] == 0,
                f"mesh_multistart 2x2: chase_trials, no build kernel: {b['launches']}")
        require(not any(a["plain_calls_on_card"].values())
                and not any(b["plain_calls_on_card"].values()),
                "mesh_multistart: no plain DP on the card")
        require_sweep_launches("mesh_multistart 4x1", a["launches"], a["sweeps"])
        require_sweep_launches("mesh_multistart 2x2", b["launches"], b["sweeps"])

    steps = [r["ode_step_mesh"] for r in ranks]
    emit({"phase": "ode_step_mesh", "backend": out["backend"],
          "wall_s": {k: [s[k]["wall_s"] for s in steps] for k in ("4x1", "2x2")}})
    for s in steps:
        for k in ("4x1", "2x2"):
            require(np.array_equal(np.asarray(s[k]["u"]), step_one[0].numpy())
                    and s[k]["J"] == bits(step_one[1], torch).tolist()
                    and s[k]["M"] == bits(step_one[2], torch).tolist(),
                    f"ode_step_mesh {k}: bit-equal to the world-of-one step")

    temp = [r["temporal_sharded"] for r in ranks]
    emit({"phase": "temporal_sharded", "backend": out["backend"], "ranks": temp})
    for t in temp:
        for name, _, _, _, _ in TEMPORAL_SHARDED:
            require(t[name]["bit_equal"], f"temporal_sharded {name}: bit-equal")

    # 7: the CLI under torchrun, 4 processes on this card.
    t0 = time.perf_counter()
    [run] = spawn(lambda r: [sys.executable, "-m", "torch.distributed.run", "--standalone",
                             "--nproc-per-node", str(WORLD), "-m", "mioc_tpu_torch.cli",
                             *TORCHRUN_ARGS], 1, WORLD_TIMEOUT, env=_world_env(), cwd=ROOT)
    cli_wall = time.perf_counter() - t0
    lines = [ln for ln in run.splitlines() if ln.startswith("{")]
    require(len(lines) == 1, f"cli_torchrun: rank 0 alone prints one JSON line: {lines}")
    got = json.loads(lines[0])
    best = int(np.argmin(seq.J))
    want = {"J": float(seq.J[best]), "iterations": int(seq.iterations[best]),
            "f_evals": int(seq.f_evals[best]), "df_evals": int(seq.df_evals[best]),
            "converged": bool(seq.converged[best])}
    emit({"phase": "cli_torchrun", "argv": TORCHRUN_ARGS, "nproc": WORLD, "line": got,
          "one_process": want, "wall_s": cli_wall})
    for k, v in want.items():
        require(got[k] == v, f"cli_torchrun: {k} {got[k]!r} == one process's {v!r}")
    require(got["J"] == min(REF32_J), "cli_torchrun: J is the least JAX constant")
    out.update({name: [r[name] for r in ranks] for name, _ in WORLD_PHASES})
    out["cli_torchrun_wall_s"] = cli_wall
    return out


def plots_phase(torch) -> dict:
    """8: the CLI without --no-plot in a temporary directory: fuller
    nt=1024 (the JAX CLI's J) writes results.png and the .dat files; heat
    nt=60 with --device-loop the plot and the animation.  Where matplotlib
    is not installed, the solve still prints its line and the plot raises
    ModuleNotFoundError for it, which is what the JAX CLI does there."""
    import contextlib
    import io
    import tempfile

    from mioc_tpu_torch import cli

    try:
        import matplotlib  # noqa: F401
        have_mpl = True
    except ModuleNotFoundError:
        have_mpl = False
    out = {"phase": "plots", "matplotlib": have_mpl, "runs": {}}
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for key, argv in (("fuller", ["fuller", "--n", "1024", "--seed", "0", "--no-log"]),
                              ("heat_device", ["heat", "--n", "60", "--device-loop", "--seed",
                                               "0", "--no-log"])):
                buf = io.StringIO()
                t0 = time.perf_counter()
                err = None
                try:
                    with contextlib.redirect_stdout(buf):
                        cli.main(argv)
                except ModuleNotFoundError as e:
                    err = e.name
                wall = time.perf_counter() - t0
                lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
                files = sorted(os.path.relpath(os.path.join(d, f), tmp)
                               for d, _, fs in os.walk(tmp) for f in fs)
                out["runs"][key] = {"argv": argv, "seconds": wall, "files": files,
                                    "error": err, "line": json.loads(lines[-1]) if lines else None}
                for f in files:
                    os.remove(os.path.join(tmp, f))
        finally:
            os.chdir(old)
    emit(out)
    fuller = out["runs"]["fuller"]
    J = CLI_REFS["fuller --n 1024"][0]
    require(fuller["line"] is not None and abs(fuller["line"]["J"] - J) <= 1e-12 * abs(J),
            "plots: fuller's J is the JAX CLI's")
    for key, want in (("fuller", ("results.png", "data_files/v(1).dat", "data_files/y(1).dat")),
                      ("heat_device", ("results.png", "final-state."))):
        r = out["runs"][key]
        if have_mpl:
            require(r["error"] is None and all(any(f.startswith(w) for f in r["files"])
                                               for w in want), f"plots {key}: wrote {want}")
        else:
            require(r["error"] == "matplotlib" and r["line"] is not None,
                    f"plots {key}: solved, then needs matplotlib ({r['error']})")
    return out


def heat_only(torch) -> int:
    """``--heat-only``: the heat paths of 7 (e–g), ``heat_rows`` and
    ``pde_sweep`` alone, after the build."""
    import tempfile

    from mioc_tpu_torch.fem import _native_triangle
    from mioc_tpu_torch.models import HeatObj
    from mioc_tpu_torch.utils.init import rand_func

    require(_native_triangle.available(), "the native triangulator builds")
    with tempfile.TemporaryDirectory() as tmp:
        host = heat_host_path(torch, tmp)
    single = heat_device_path(torch, host)
    x0s = np.stack([rand_func(HeatObj(nt=HEAT_NT), seed=s) for s in range(HEAT_STARTS)])
    seq = heat_multistart_path(torch, x0s, False)
    spec = heat_multistart_path(torch, x0s, True)
    check_heat_multistarts(seq[0], spec[0], single[0])
    heat_rows(torch)
    pde_sweep_phase(torch)
    emit({"ok": True, "heat_only": True})
    return 0


def main(heat: bool = False) -> int:
    t_start = time.perf_counter()
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
    from mioc_tpu_torch.utils.init import rand_func

    build_s = _kernels.build_all()
    ptxas = {n: [ln.strip() for ln in _kernels.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln] for n in _kernels.SOURCES}
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})
    if heat:
        return heat_only(torch)

    phases = {}
    for seed, (name, nt, B, spec, preset) in enumerate(SHAPES):
        for dtype in (torch.float32, torch.float64):
            phases[(name, dtype)] = kernel_phase(torch, name, nt, B, spec, preset,
                                                 dtype, seed)
    for seed, (name, S, shape_i, caps) in enumerate(BATCHED):
        for dtype in (torch.float32, torch.float64):
            phases[("batched", name, dtype)] = batched_phase(
                torch, name, S, SHAPES[shape_i], caps, dtype, 10 + seed)
    for seed, (name, shape_i, caps) in enumerate(WAVES):
        for dtype in (torch.float32, torch.float64):
            phases[("wave", name, dtype)] = wave_phase(torch, name, SHAPES[shape_i], caps,
                                                       dtype, 20 + seed)
    edge_phase(torch)

    host, host_launches = host_path(torch)
    temporal = temporal_phase(torch)
    continuous_phase(torch)
    single, single_launches, single_wall, single_sweeps = device_single_path(torch, host)
    from mioc_tpu_torch.models import LVMObj

    x0s = np.stack([rand_func(LVMObj(nt=1024), seed=s) for s in range(N_STARTS)])
    seq, seq_launches, seq_wall, seq_sweeps = multistart_path(torch, x0s, False)
    spec, spec_launches, spec_wall, spec_sweeps = multistart_path(torch, x0s, True)
    check_multistarts(seq, spec, single)
    multi = multi_rank(torch, host, seq)
    sweeps = sweep_times(torch, x0s)
    ode_bits(torch)
    conv = conv_rows(torch)
    import tempfile

    _, mnt, mB, mspec, mpreset = MIXED240_SHAPE
    mixed240 = kernel_phase(torch, "mixed240", mnt, mB, mspec, mpreset, torch.float64, 33)
    fishing64 = phases[("fishing", torch.float64)]
    mixed = mixed_phase(torch, {
        nt: {k: ph[k]["kernel_ms"] for k in ("dp_build", "chase")}
        for nt, ph in ((1024, fishing64), (240, mixed240))})
    with tempfile.TemporaryDirectory() as tmp:
        cli = cli_paths(torch, tmp)
        from mioc_tpu_torch.fem import _native_triangle

        require(_native_triangle.available(), "the native triangulator builds")
        heat_host = heat_host_path(torch, tmp)
    plots = plots_phase(torch)
    heat_single, heat_single_launches, heat_single_wall, heat_single_sweeps = (
        heat_device_path(torch, heat_host))
    from mioc_tpu_torch.models import HeatObj

    heat_x0s = np.stack([rand_func(HeatObj(nt=HEAT_NT), seed=s) for s in range(HEAT_STARTS)])
    heat_seq = heat_multistart_path(torch, heat_x0s, False)
    heat_spec = heat_multistart_path(torch, heat_x0s, True)
    check_heat_multistarts(heat_seq[0], heat_spec[0], heat_single)
    hrows = heat_rows(torch)
    pde_sweep = pde_sweep_phase(torch)
    _, hnt, hB, hspec, hpreset = HEAT_SHAPE
    heat64 = kernel_phase(torch, "heat500", hnt, hB, hspec, hpreset, torch.float64, 30)
    heat_batched = batched_phase(torch, "heat500", HEAT_STARTS, HEAT_SHAPE,
                                 schedule(HEAT_PRESET["delta0"], 10.0 / HEAT_NT),
                                 torch.float64, 31)
    heat_wave = heat_wave_phase(torch, schedule(HEAT_PRESET["delta0"], 10.0 / HEAT_NT), 32)
    large = heat_large(torch)
    _, lnt, lB, lspec, lpreset = LARGE_SHAPE
    large_caps = schedule(HEAT_PRESET["delta0"], 10.0 / LARGE_NT)
    large64 = kernel_phase(torch, "heat200", lnt, lB, lspec, lpreset, torch.float64, 40)
    large_batched = batched_phase(torch, "heat200", HEAT_STARTS, LARGE_SHAPE, large_caps,
                                  torch.float64, 41)
    large_wave = heat_wave_phase(torch, large_caps, 42, LARGE_SHAPE)

    # Where the time of each path goes: the sweeps (batches × measured ms per
    # batch), the kernels (launches × measured kernel ms), and the rest
    # (stage tables, selects, the flag reads that end each loop, Python).
    batched64 = phases[("batched", "fishing", torch.float64)]
    kernel_ms = {"dp_build": fishing64["dp_build"]["kernel_ms"],
                 "chase": fishing64["chase"]["kernel_ms"],
                 "chase_vec": fishing64["chase_vec"]["kernel_ms"],
                 **{k: batched64[k]["kernel_ms"] for k in (
                     "dp_build_batched", "chase_batched", "chase_trials")}}
    paths = {"device_single": (single_wall, single_launches, single_sweeps),
             "multistart_sequential": (seq_wall, seq_launches, seq_sweeps),
             "multistart_speculative": (spec_wall, spec_launches, spec_sweeps)}
    for name, (wall, launches, counts) in paths.items():
        # the sweep kernels are in the sweeps' estimate
        k_s = sum(n * kernel_ms[k] for k, n in launches.items()
                  if k not in (*SWEEP_KERNELS, PDE_SWEEP_KERNEL)) / 1e3
        sweep_s = sum(n * sweeps[kind][S] for kind in ("f", "df")
                      for S, n in counts[kind].items()) / 1e3
        emit({"phase": "where_the_time_goes", "path": name, "wall_s": wall,
              "sweeps_s_estimate": sweep_s, "kernels_s_estimate": k_s,
              "rest_s": wall - sweep_s - k_s, "sweep_counts": counts})

    # The conv CLI solves with each chase: the chases (launches × the conv
    # shape's kernel ms) against the rest of the wall (sweeps, builds,
    # stage tables, host reads and Python).
    conv64 = phases[("conv", torch.float64)]
    for key in ("conv_scalar", "conv_vec"):
        r = cli[key]
        kernel = "chase_vec" if key == "conv_vec" else "chase"
        chase_s = r["launches"][kernel] * conv64[kernel]["kernel_ms"] / 1e3
        build_s = r["launches"]["dp_build"] * conv64["dp_build"]["kernel_ms"] / 1e3
        emit({"phase": "where_the_time_goes", "path": f"cli_{key}",
              "wall_s": r["wall_s_measured"], "chase_kernel": kernel,
              "chases_s_estimate": chase_s, "builds_s_estimate": build_s,
              "chase_share": chase_s / r["wall_s_measured"],
              "rest_s": r["wall_s_measured"] - chase_s - build_s,
              "timings_s": r["timings"],
              "f_ms_per_batch": conv["f_ms"][1], "df_ms_per_batch": conv["df_ms"][1]})
    # The chunked chase against chase_vec, in turns within this call (chase,
    # chase_vec, chase_vec, chase), at every shape: the same-call yardstick.
    emit({"phase": "chase_ab", "path": "cli conv nt=2048 host loop",
          "wall_s": {"chase": cli["conv_scalar"]["wall_s_measured"],
                     "chase_vec": cli["conv_vec"]["wall_s_measured"]},
          "kernel_ms_in_turns": {
              f"{shape} {'f64' if dtype == torch.float64 else 'f32'}":
                  phases[(shape, dtype)]["chase_vec"]["in_turns_with_chase"]
              for shape, *_ in SHAPES for dtype in (torch.float32, torch.float64)}})

    # Where the time of each heat path goes: the sweeps (evaluations × the
    # heat_rows ms per batch of their row count), the kernels (launches × the
    # ms per call at the heat solve's shape) and the rest.
    heat_kernel_ms = {"dp_build": heat64["dp_build"]["kernel_ms"],
                      "chase": heat64["chase"]["kernel_ms"],
                      "chase_vec": heat64["chase_vec"]["kernel_ms"],
                      **{k: heat_batched[k]["kernel_ms"] for k in (
                          "dp_build_batched", "chase_batched", "chase_trials")}}
    heat_host_sweeps = {"f": {1: heat_host["f_evals"]}, "df": {1: heat_host["df_evals"]}}
    heat_paths = {
        "heat_host": (heat_host["wall_s_measured"], heat_host["launches"], heat_host_sweeps),
        "heat_device": (heat_single_wall, heat_single_launches, heat_single_sweeps),
        "heat_multistart_sequential": (heat_seq[2], heat_seq[1], heat_seq[3]),
        "heat_multistart_speculative": (heat_spec[2], heat_spec[1], heat_spec[3])}
    for name, (wall, launches, counts) in heat_paths.items():
        per_call = dict(heat_kernel_ms)
        if name == "heat_device":  # one table set of K caps, not S = 8 sets
            per_call["chase_trials"] = heat_wave["chase_trials"]["kernel_ms"]
        # the sweep kernel is in the sweeps' estimate
        kernels_s = {k: n * per_call[k] / 1e3 for k, n in launches.items()
                     if n and k != PDE_SWEEP_KERNEL}
        sweep_s = {kind: sum(n * hrows[f"{kind}_ms"][R] for R, n in counts[kind].items()) / 1e3
                   for kind in ("f", "df")}
        emit({"phase": "where_the_time_goes", "path": name, "wall_s": wall,
              "sweeps_s_estimate": sweep_s, "kernels_s_estimate": kernels_s,
              "rest_s": wall - sum(sweep_s.values()) - sum(kernels_s.values()),
              "sweep_counts": counts, "kernel_ms_per_call": per_call,
              **({"timings_s": heat_host["timings"]} if name == "heat_host" else {})})
    heat_launches = {name: launches for name, (_, launches, _) in heat_paths.items()}

    # Where the time of each large-mesh path goes: the sweeps (forwards and
    # adjoints × the heat_large ms per sweep at their row count), the kernels
    # (launches × ms per call at nt=200, L=36, B=40) and the rest.
    large_kernel_ms = {"dp_build": large64["dp_build"]["kernel_ms"],
                       "chase": large64["chase"]["kernel_ms"],
                       "chase_vec": large64["chase_vec"]["kernel_ms"],
                       "chase_trials": large_wave["chase_trials"]["kernel_ms"],
                       **{k: large_batched[k]["kernel_ms"] for k in (
                           "dp_build_batched", "chase_batched")}}
    sweep_s = {("f", 1): large["values"]["forward_s"], ("df", 1): large["values"]["adjoint_s"],
               ("f", 8): large["rows"]["forward8_s"], ("df", 8): large["rows"]["adjoint8_s"],
               ("f", 16): large["rows"]["forward16_s"], ("df", 16): large["rows"]["adjoint16_s"]}
    large_launches = {}
    for name, r in large["solves"].items():
        large_launches[name] = r["launches"]
        kernels_s = {k: n * large_kernel_ms[k] / 1e3 for k, n in r["launches"].items() if n}
        # A batch of up to 16 rows is one chunk (timed at 8 and 16 rows), a
        # larger batch one 16-row sweep per chunk.
        sw = {kind: sum(n * (sweep_s[kind, R] if R in (1, 8)
                             else -(-R // 16) * sweep_s[kind, 16])
                        for R, n in r["sweeps"][kind].items())
              for kind in ("f", "df")}
        emit({"phase": "where_the_time_goes", "path": f"heat_large_{name}", "wall_s": r["wall_s"],
              "sweeps_s_estimate": sw, "kernels_s_estimate": kernels_s,
              "kernels_share": sum(kernels_s.values()) / r["wall_s"],
              "rest_s": r["wall_s"] - sum(sw.values()) - sum(kernels_s.values()),
              "sweep_counts": r["sweeps"], "kernel_ms_per_call": large_kernel_ms})

    rows = []
    for key, src, tpu, launches, path, m in (
            ("dp_build", "dp_build.cu", "mioc_tpu/ops/bellman_pallas.py:123",
             host_launches, "host_path", fishing64["dp_build"]),
            ("chase", "chase.cu", "mioc_tpu/ops/backtrack_pallas.py:49",
             host_launches, "host_path", fishing64["chase"]),
            ("dp_build_batched", "dp_build_batched.cu",
             "mioc_tpu/ops/bellman_pallas.py:275", seq_launches,
             "multistart_sequential", batched64["dp_build_batched"]),
            ("chase_batched", "chase_batched.cu", "mioc_tpu/ops/backtrack_pallas.py:283",
             seq_launches, "multistart_sequential", batched64["chase_batched"]),
            ("chase_trials", "chase_trials.cu", "mioc_tpu/ops/backtrack_pallas.py:415",
             spec_launches, "multistart_speculative", batched64["chase_trials"]),
            ("chase_vec", "chase_vec.cu", "mioc_tpu/ops/backtrack_pallas.py:176",
             cli["conv_vec"]["launches"], "cli_conv_vec", conv64["chase_vec"])):
        require(launches[key] > 0, f"{key} launched on its path {path}")
        rows.append({"name": key, "route": "cuda", "source": f"mioc_tpu_torch/csrc/{src}",
                     "replaces": tpu, "launches": launches[key], "path": path,
                     "shape": "conv f64" if key == "chase_vec" else "fishing f64",
                     "max_abs_err": m["max_abs_err"], "ms": m["kernel_ms"],
                     "ns_per_step": m["ns_per_step"],
                     "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                     "bound_by": m["bound_by"], "library_ms": None,
                     "heat_launches": {p: n[key] for p, n in heat_launches.items()},
                     "heat_shape_ms": heat_kernel_ms[key],
                     "heat_large_launches": {p: n[key] for p, n in large_launches.items()},
                     "heat_large_shape_ms": large_kernel_ms[key],
                     "mixed_launches": {p: r["launches"][key] for p, r in mixed.items()},
                     "mixed240_shape_ms": (mixed240[key]["kernel_ms"]
                                           if key in ("dp_build", "chase") else None),
                     "temporal_host_launches": temporal["host_temporal"]["launches"][key],
                     "multi_rank_launches_per_rank": {
                         "world_of_one": multi["world_of_one"]["launches"][key],
                         **{f"sharded_host_{n}": [h[n]["launches"][key]
                                                  for h in multi["sharded_host"]]
                            for n in ("fishing", "heat")},
                         **{f"mesh_multistart_{n}": [m[n]["launches"][key]
                                                     for m in multi["mesh_multistart"]]
                            for n in ("4x1_sequential", "2x2_sharded_speculative")}}})
    # The fishing sweep kernels replace no Pallas kernel (the JAX package's
    # sweeps are lax.scan loops): ms per call at the multistart's 32 rows
    # (and at 1, 9 and 288) against the plain sweeps, bit-equal in
    # sweep_times; the bound is a row's chain of dependent float64
    # operations, SWEEP_CHAIN_OPS a step; the launches of every path.
    fishing_launches = {
        "host_path": host_launches, "device_single": single_launches,
        "multistart_sequential": seq_launches, "multistart_speculative": spec_launches,
        "temporal_host": temporal["host_temporal"]["launches"],
        "world_of_one": multi["world_of_one"]["launches"]}
    for key, tag, steps in (("lvm_forward", "f", 1024), ("lvm_adjoint", "df", 1023)):
        chain = steps * SWEEP_CHAIN_OPS
        rows.append({"name": key, "route": "cuda", "source": "mioc_tpu_torch/csrc/ode_lvm.cu",
                     "replaces": None, "launches": seq_launches[key],
                     "path": "multistart_sequential", "shape": "fishing f64 nt=1024, 32 rows",
                     "max_abs_err": 0.0, "ms": sweeps[tag][32],
                     "plain_ms": sweeps[f"plain_{tag}"][32],
                     "bound_ms": chain * F64_LATENCY_CYCLES / SM_CLOCK_HZ * 1e3,
                     "bound_by": f"latency of {chain} dependent float64 operations",
                     "library_ms": None, "ms_by_rows": sweeps[tag],
                     "plain_ms_by_rows": sweeps[f"plain_{tag}"],
                     "fishing_launches": {p: n[key] for p, n in fishing_launches.items()},
                     "heat_launches": {p: n[key] for p, n in heat_launches.items()},
                     "heat_large_launches": {p: n[key] for p, n in large_launches.items()},
                     "mixed_launches": {p: r["launches"][key] for p, r in mixed.items()},
                     "multi_rank_launches_per_rank": {
                         **{f"sharded_host_{n}": [h[n]["launches"][key]
                                                  for h in multi["sharded_host"]]
                            for n in ("fishing", "heat")},
                         **{f"mesh_multistart_{n}": [m[n]["launches"][key]
                                                     for m in multi["mesh_multistart"]]
                            for n in ("4x1_sequential", "2x2_sharded_speculative")}}})
    # The dense PDE sweep kernel replaces no Pallas kernel (the JAX package's
    # sweep is a lax.scan of one product a step): ms per call at 8 rows (the
    # heat device loop's wave) and at every row count of pde_sweep, against
    # the library's sweep, and its launches on every heat path.
    key, by = PDE_SWEEP_KERNEL, pde_sweep["by_rows"]
    rows.append({"name": key, "route": "cuda", "source": "mioc_tpu_torch/csrc/pde_dense.cu",
                 "replaces": None, "launches": heat_launches["heat_device"][key],
                 "path": "heat_device", "shape": f"heat f64 nt={HEAT_NT}, N={HEAT_N}, 8 rows",
                 "max_rel_err": max(r[d]["max_rel_err"] for r in by.values() for d in r),
                 "ms": by[8]["forward"]["ms"], "library_ms": by[8]["forward"]["library_ms"],
                 "bound_ms": by[8]["forward"]["bound_ms"], "bound_by": "operations",
                 "ms_by_rows": {R: r["forward"]["ms"] for R, r in by.items()},
                 "library_ms_by_rows": {R: r["forward"]["library_ms"] for R, r in by.items()},
                 "heat_launches": {p: n[key] for p, n in heat_launches.items()},
                 "heat_large_launches": {p: n[key] for p, n in large_launches.items()}})
    # Last, as a profiler trace slows every later launch of the process: the
    # kernels of a large-mesh sweep step and of one fine banded application.
    from mioc_tpu_torch.profile_kernels import large_sweep_section

    emit({"phase": "heat_large_launch_profile", **large_sweep_section()})
    emit({"phase": "run", "seconds": time.perf_counter() - t_start,
          "plots_seconds": {k: r["seconds"] for k, r in plots["runs"].items()}})
    import torch.distributed as dist

    dist.destroy_process_group()  # the world of one of phase 6
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--world-rank"]:
        sys.exit(world_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    sys.exit(main(heat=sys.argv[1:2] == ["--heat-only"]))
