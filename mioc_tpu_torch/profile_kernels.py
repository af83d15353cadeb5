"""Timing experiments on the DP build and chase kernels, on one NVIDIA card.

    python -m mioc_tpu_torch.profile_kernels

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``.
At the three DP shapes of ``chip_smoke.py`` (fishing, conv, heat scale), in
float64, it prints one JSON object per line with the device time of the
kernel alone (:func:`device_ms`, a ``torch.profiler`` trace) under:

* other one-block launch plans of one start's build (C = 1 forced; threads per
  block capped at 1024, 512 or 256; ``bellman_cuda.TPL_ALIGN`` 16 or 1),
  each bit-equal to the plain build;
* other chunk counts of ``chase`` (``backtrack_cuda.CHASE_CHUNKS`` 8 … 128),
  each equal to the plain walk;
* variants of the build body compiled from edited copies of
  ``csrc/dp_build.cuh`` into ``mioc_tpu_torch/_build/variants/`` (the
  batched entry, launched at S = 1 on one block): without the U store,
  without the relaxation, without both, and with the step's barrier
  replaced by a warp sync.  The variants compute wrong tables and
  are timed only: they show what a step costs beyond its relaxation.

* the cluster chase ``chase_vec`` at cluster sizes 8 and 16
  (``backtrack_cuda.VEC_CLUSTERS``) and sub-chunks of about 8, 16 or 32
  steps (``VEC_SUBCHUNK_STEPS``), each equal to the plain walk;

and at fishing S=32 (float64):

* ``chase_batched`` over 32 table sets with 8, 16 or 32 chunks per set
  (``backtrack_cuda.CHASE_TASKS``), and on the stride-0 trial wave (one set,
  K=9 caps; fishing and conv) with 8, 16 or 32 chunks (``CHASE_CHUNKS``),
  each equal to the plain walk;
* ``dp_build_batched`` and ``chase_trials`` (Kt=9), and ``chase_trials``
  as built and without one phase's work (``phase_costs``);

and ``dp_build_batched`` under every cluster size C ∈ {1, 2, 4, 8, 16}
(``build_sweep``) at fishing S=32, conv S=8 and heat scale S=8 and S=1, in
float64 and float32, each bit-equal to the plain build: device ms, and ms
per call with CUDA events (the host side included), the sizes in turns.
The rule of ``bellman_cuda.batched_build_plan`` is read off this sweep.

At the shape a heat solve runs (``HeatObj(nt=500)`` under its preset: nt=500,
L=36, B=100, float64; :func:`heat_solve_section`) it takes the device ms of
``dp_build`` (under the cluster size its plan takes, printed with the plan,
and at C = 1), ``chase`` and ``chase_trials`` (one table set, the preset's
K=8 halving caps) at S=1, and of ``dp_build_batched`` (under the cluster
size its plan takes, and at C = 1), ``chase_batched`` and ``chase_trials``
(K=8) at S=8, each equal to its plain version; then
:func:`single_build_sweep`: ``dp_build`` under every C in
:data:`SINGLE_SIZES` at heat500, large heat (nt=200, B=40) and heat at
nt=1024 (B=204), float64, each bit-equal to the plain build, ms per call
and device ms.  ``--heat-only`` runs just these two (a few minutes).
``--heat-large`` runs the first at the large-mesh heat solve's shape
instead (``HeatObj(nt=200)`` on 8321 dofs: nt=200, L=36, B=40), then
:func:`large_sweep_section`: the kernels and device µs of a step of that
model's sparse sweeps, by kernel.

The fishing sweep kernels (``csrc/ode_lvm.cu``, :func:`lvm_sweep_section`):
device µs and ms per call at 1, 32 and 288 rows of ``LVMObj(nt=1024)``,
against the plain PyTorch sweeps; ``--lvm-only`` runs just that section.
The dense heat sweep kernel (``csrc/pde_dense.cu``,
:func:`pde_sweep_section`): device µs and ms per call at 1, 8, 16 and 64
rows of ``HeatObj(nt=500)``, against the library's sweep (``library_ms``);
``--pde-only`` runs just that section.

It also samples the SM clock (``nvidia-smi --query-gpu=clocks.sm``) while
``dp_build`` runs back to back for a second at each shape: a kernel that
keeps one SM busy may not lift the card to its full clock.  First of all,
before any profiler trace (after one, every launch of the process is
slower), it times the host side of a call (:func:`host_side`): an empty
kernel (``csrc/launch_probe.cu``) launched through the same ctypes route as
an ordinary, a cooperative and a cluster launch, the wrappers' allocations,
and whole calls of the chase wrappers.

The first line is the card's name and power limit (``nvidia-smi``).
"""

from __future__ import annotations

import ctypes
import json
import math
import shutil
import subprocess
import time

import numpy as np
import torch

SHAPES = (
    # name, nt, B, level set, (p, beta, tau): chip_smoke.py's kernel shapes
    ("fishing", 1024, 170, ("bounded", [[0, 1]] * 3), (math.inf, 1e-4, 12.0 / 1024)),
    ("conv", 2048, 128, ("product", [[-2, -1, 0, 1, 2]]), (1, 1e-4, 1.0 / 1024)),
    ("heat", 1024, 204, ("product", [list(range(6))] * 2), (2, 1e-3, 2.0 / 204.8)),
)

BODY_VARIANTS = {
    # name: (text in dp_build.cuh, its replacement)
    "no_U_store": [("Urow[b] = static_cast<UT>(arg);", "if (arg < 0) Urow[b] = 0;")],
    "no_relax": [("if (sh <= smax && b >= sh) {", "if (sh < 0) {")],
    "warp_sync": [("step_barrier<CLUSTER>();  // Φ_i complete",
                   "__syncwarp();  // Φ_i complete")],
}
BODY_VARIANTS["no_store_no_relax"] = BODY_VARIANTS["no_U_store"] + BODY_VARIANTS["no_relax"]


CHASE_VARIANTS = {
    # name: (source, library, [(text, its replacement)]): the redesigned
    # chases without one of their phases' work, to see what each costs.
    # They compute wrong paths and are timed only.
    "vec_no_maps": ("chase_vec.cu", "chase_vec", [
        ("      for (int kk = 0; kk < kn; ++kk) {\n        const UT* upk",
         "      for (int kk = 0; kk < 0; ++kk) {\n        const UT* upk")]),
    "vec_no_compose": ("chase_vec.cu", "chase_vec", [
        ("for (int w = 0; w < W && x != mioc::kSentinel; ++w) {",
         "for (int w = 0; w < 0; ++w) {")]),
    "vec_no_chain_lookups": ("chase_vec.cu", "chase_vec", [
        ("        e = Eg != nullptr ? __ldcg(Eg + (size_t)j * P + s) : Ec[s];",
         "        e = s;")]),
    "vec_no_rewalk": ("chase_vec.cu", "chase_vec", [
        ("      for (int kk = 0; kk < kn; ++kk) {\n        const int nl",
         "      for (int kk = 0; kk < 0; ++kk) {\n        const int nl")]),
    # Not a phase removed: timestamps of CTA 0's phases (clock64, cycles
    # from its first instruction) into out[1:9], and each CTA's first and
    # last %globaltimer (ns, low 31 bits) into out[9:9+2N] (timeline()).
    "vec_timeline": ("chase_vec.cu", "chase_vec", [
        ("  const int steps = nt - 1;\n",
         "  const int steps = nt - 1;\n  long long tk[8] = {clock64(), 0, 0, 0, 0, 0, 0, 0};\n"
         "  __shared__ unsigned long long gt[2];\n  if (threadIdx.x == 0) asm volatile("
         "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(gt[0]));\n"),
        ("      seeded = true;\n", "      seeded = true;\n      tk[1] = clock64();\n"),
        ("    held = q;\n    int32_t* E =", "    held = q;\n    tk[2] = clock64();\n    int32_t* E ="),
        ("    if (W > 1) {\n      __syncthreads();\n",
         "    if (W > 1) {\n      __syncthreads();\n      tk[3] = clock64();\n"),
        ("    __syncthreads();  // the planes are free for the next round\n",
         "    __syncthreads();  // the planes are free for the next round\n    tk[4] = clock64();\n"),
        ("  cluster.sync();  // the shares, the maps and the empty mailboxes are in place\n",
         "  cluster.sync();\n  tk[5] = clock64();\n"),
        ("  __syncthreads();\n\n  // Phase 3", "  tk[6] = clock64();\n  __syncthreads();\n"
         "  tk[7] = clock64();\n\n  // Phase 3"),
        ("""    __syncthreads();  // the planes are free for the next slice
  }
}""", """    __syncthreads();  // the planes are free for the next slice
  }
  const long long tend = clock64();
  if (threadIdx.x == 0) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt[1]));
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    for (int i = 1; i < 8; ++i) out[i] = (int)(tk[i] - tk[0]);
    out[8] = (int)(tend - tk[0]);
    for (int r = 0; r < N; ++r) {
      for (int h = 0; h < 2; ++h) {
        int v;
        asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v)
                     : "r"(remote(&gt[h], r)) : "memory");
        out[9 + 2 * r + h] = v & 0x7fffffff;
      }
    }
  }
  cluster.sync();
}""")]),
    "chunked_no_maps": ("chase_chunked.cuh", "chase_batched", [
        ("""      for (int kk = 0; kk < v.kn; ++kk) {
        const int nl = static_cast<int>(v.up[(size_t)kk * P + l * B1 + b]);
        b -= v.bp[kk * L + l];
        l = nl;
        if (b < 0) break;
      }""", "")]),
    "chunked_no_chain_reads": ("chase_chunked.cuh", "chase_batched", [
        ("const int e = __ldcg(E + (size_t)c * P + s);", "const int e = s;")]),
    "chunked_no_rewalk": ("chase_chunked.cuh", "chase_batched", [
        ("""      for (int kk = 0; kk < v.kn; ++kk) {
        const int nl = static_cast<int>(v.up[(size_t)kk * P + l * B1 + b]);
        b -= v.bp[kk * L + l];
        l = nl;
        o[kk] = l;""", """      for (int kk = 0; kk < 0; ++kk) {
        const int nl = static_cast<int>(v.up[(size_t)kk * P + l * B1 + b]);
        b -= v.bp[kk * L + l];
        l = nl;
        o[kk] = l;""")]),
}
# The same three edits of the chunked body, built as the trial-wave chase.
for _name in ("no_maps", "no_chain_reads", "no_rewalk"):
    CHASE_VARIANTS[f"trials_{_name}"] = ("chase_chunked.cuh", "chase_trials",
                                         CHASE_VARIANTS[f"chunked_{_name}"][2])


def _chase_variants() -> dict:
    """Build every CHASE_VARIANTS library from an edited copy of csrc/ (one
    nvcc each, all at once); returns ``{name: ctypes.CDLL}``."""
    from .ops import _kernels

    procs = {}
    for name, (source, lib_name, edits) in CHASE_VARIANTS.items():
        out = _kernels.BUILD_DIR / "variants" / name
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(_kernels.CSRC, out)
        text = (out / source).read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in {source}")
            text = text.replace(old, new)
        (out / source).write_text(text)
        lib = out / f"lib{lib_name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", str(out), "-o", str(lib),
             str(out / f"{lib_name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def timeline(lib, U, phi0, btilde, B) -> dict:
    """One call of the ``vec_timeline`` variant of chase_vec: CTA 0's phase
    ends in µs from its first instruction (its seed share, slice staged,
    maps, slice map, the cluster.sync, its chain hop posted, the barrier
    before its re-walk, end), and each CTA's start and end in µs from the
    first CTA's start (globaltimer)."""
    from .ops import _kernels
    from .ops import backtrack_cuda as kc

    fn = lib.mioc_chase_vec
    fn.argtypes = list(kc._VEC[2])
    fn.restype = ctypes.c_int
    real_fn = _kernels.entry
    _kernels.entry = lambda lib_name, symbol, argtypes: (
        fn if symbol == "mioc_chase_vec" else real_fn(lib_name, symbol, argtypes))
    try:
        for _ in range(3):
            out = kc.chase_vec(U, phi0, btilde, B)
        plan = kc.cluster_plan(U, phi0)
    finally:
        _kernels.entry = real_fn
    o = out.cpu().tolist()
    mhz = 1980.0  # the SM clock under load (profile_kernels, sm_clock_mhz)
    starts = [o[9 + 2 * r] for r in range(plan.N)]
    t0 = min(starts)
    return {"cta0_us": dict(zip(("seed_share", "staged", "maps", "slice_map", "sync",
                                 "chain_posted", "barrier", "end"),
                                [round(c / mhz, 3) for c in o[1:9]])),
            "cta_start_end_us": [(round((o[9 + 2 * r] - t0) / 1e3, 3),
                                  round((o[10 + 2 * r] - t0) / 1e3, 3))
                                 for r in range(plan.N)]}


def phase_costs() -> dict:
    """Device ms of chase_vec (conv and fishing), chase_batched at fishing
    S=32 and on the fishing wave, and chase_trials at fishing S=32, Kt=9,
    each as built and without one phase's work (CHASE_VARIANTS), launched
    through the same wrappers."""
    from .ops import _kernels
    from .ops import backtrack_cuda as kc
    from .ops import bellman as tb

    libs = _chase_variants()
    real_fn = _kernels.entry

    def run_with(name, call, kernel):
        if name is None:
            return device_ms(call, kernel)
        lib = libs[name]

        def fn(lib_name, symbol, argtypes):
            if symbol not in ("mioc_chase_vec", "mioc_chase_batched", "mioc_chase_trials"):
                return real_fn(lib_name, symbol, argtypes)
            f = getattr(lib, symbol)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
            return f

        _kernels.entry = fn
        try:
            return device_ms(call, kernel)
        finally:
            _kernels.entry = real_fn

    out = {}
    for name, nt, B, spec, preset in SHAPES[:2]:
        stage, btilde, jump, smax = _tables(nt, B, spec, preset, torch.float64)
        U, phi0 = tb.build_tables(stage, btilde, jump, B, smax)
        K = 9
        wave = (U.expand(K, -1, -1, -1), phi0.expand(K, -1, -1), btilde.expand(K, -1, -1))
        caps = torch.tensor([B >> k for k in range(8)] + [0], dtype=torch.int32,
                            device="cuda")
        rows = {"vec_timeline": timeline(libs["vec_timeline"], U, phi0, btilde, B)}
        for v in (None, *(k for k in CHASE_VARIANTS if k != "vec_timeline")):
            key = v or "as_built"
            if v is None or v.startswith("vec"):
                rows.setdefault("chase_vec", {})[key] = run_with(
                    v, lambda: kc.chase_vec(U, phi0, btilde, B), "chase_vec_kernel")
            if v is None or v.startswith("chunked"):  # (trials_*: chase_trials only)
                rows.setdefault("chase_batched_wave", {})[key] = run_with(
                    v, lambda: kc.chase_batched(*wave, caps), "chunked_chase_kernel")
        out[name] = rows
    S = 32
    _, nt, B, spec, preset = SHAPES[0]
    st, bt, jump, smax = _tables(nt, B, spec, preset, torch.float64)
    stage = st[None].repeat(S, 1, 1)
    btilde = bt[None].repeat(S, 1, 1)
    U, phi0 = tb.build_tables_batched(stage, btilde, jump, B, smax)
    caps = torch.full((S,), B, dtype=torch.int32, device="cuda")
    out["fishing_S32"] = {(v or "as_built"): run_with(
        v, lambda: kc.chase_batched(U, phi0, btilde, caps), "chunked_chase_kernel")
        for v in (None, *CHASE_VARIANTS) if v is None or v.startswith("chunked")}
    trials = torch.tensor([[B >> k for k in range(8)] + [0]] * S, dtype=torch.int32,
                          device="cuda")
    out["fishing_S32_trials"] = {(v or "as_built"): run_with(
        v, lambda: kc.chase_trials(U, phi0, btilde, trials), "chunked_chase_kernel")
        for v in (None, *CHASE_VARIANTS) if v is None or v.startswith("trials")}
    return out


def _events_ms(fn, reps: int = 10) -> float:
    """Median ms per call of ``fn`` with CUDA events around each call (the
    host side of the call included)."""
    import statistics

    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


BUILD_SWEEP = (("fishing", 32, 0), ("conv", 8, 1), ("heat", 8, 2), ("heat", 1, 2))
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # and the size the plan takes, where another


def build_sweep() -> list:
    """dp_build_batched under each cluster size in CLUSTER_SIZES, forced
    (``clusters=C``), at each (shape, S) of BUILD_SWEEP in float64 and
    float32: the plan, bit-equality to the plain build, ms per call (CUDA
    events; the sizes in turns, ascending then descending, both medians
    kept) and then, after every per-call time (a trace slows every later
    launch), device ms.  A size the card does not schedule is recorded as
    refused."""
    from .ops import bellman as tb
    from .ops import bellman_cuda as bc
    from .ops import levels as lv

    rows, calls = [], []
    for name, S, i in BUILD_SWEEP:
        _, nt, B, (kind, V), (p, beta, tau) = SHAPES[i]
        adm = lv.bounded_sum_levels(V, 1, 1) if kind == "bounded" else lv.product_levels(V)
        for dtype in (torch.float64, torch.float32):
            rng = np.random.default_rng(10 + i)
            grad = torch.as_tensor(rng.normal(size=(S, nt, adm.M)), dtype=dtype,
                                   device="cuda")
            u_old = torch.as_tensor(adm.levels[rng.integers(0, adm.L, size=(S, nt))],
                                    dtype=dtype, device="cuda")
            jump = torch.as_tensor(lv.jump_cost_table(adm.levels, p, beta=beta), dtype=dtype,
                                   device="cuda")
            smax = tb.max_budget_use(adm.levels)
            stage, btilde = tb.stage_tables(grad, u_old, adm.levels, tau)
            U_p, phi_p = tb.build_tables_batched_plain(stage, btilde, jump, B, smax)
            item = stage.element_size()
            taken = bc.cluster_build_plan(S, nt, adm.L, B, item, smax).C
            sizes = tuple(sorted(set(CLUSTER_SIZES) | {taken}))
            res = {}
            for C in sizes + sizes[::-1]:
                try:
                    plan = bc.cluster_build_plan(S, nt, adm.L, B, item, smax, clusters=C)
                except RuntimeError as e:  # a cluster size this card does not schedule
                    res[C] = {"refused": str(e)}
                    continue

                def call(C=C, a=(stage, btilde, jump, B, smax)):
                    return bc.dp_build_batched(*a, clusters=C)

                U, phi = call()
                if not (torch.equal(U, U_p) and torch.equal(phi, phi_p)):
                    raise RuntimeError(f"{name} S={S} {dtype}: dp_build_batched at C={C} "
                                       "differs from the plain build")
                r = res.setdefault(C, {"plan": plan._asdict(), "call_ms": [],
                                       "clusters_at_once": None if C == 1 else
                                       bc.clusters_at_once(S, nt, adm.L, B, item, smax, C)})
                r["call_ms"].append(_events_ms(call))
                if len(r["call_ms"]) == 1:
                    calls.append((r, call))
            rows.append({"shape": name, "S": S, "dtype": str(dtype).replace("torch.", ""),
                         "nt": nt, "L": adm.L, "B": B, "smax": smax,
                         "rule_C": bc.batched_build_plan(S, nt, adm.L, B, item, smax).C,
                         "taken_C": taken, "by_C": res})
    for r, call in calls:
        r["device_ms"] = device_ms(call, "dp_build_kernel", reps=10)
    return rows


SINGLE_SIZES = (1, 2, 4, 8, 12, 16)  # and the size the plan takes, where another


def _one_start(bc, stage, btilde, jump, B, smax, C):
    """One start's build under C CTAs, forced: the batched entry at S = 1,
    the launch ``dp_build`` makes under a plan of that C."""
    U, phi = bc.dp_build_batched(stage[None], btilde[None], jump, B, smax, clusters=C)
    return U[0], phi[0]


def single_build_sweep(shapes=None, sizes=SINGLE_SIZES) -> list:
    """One start's build (:func:`_one_start`) under each cluster size in
    SINGLE_SIZES, forced, at heat500 (nt 500, B 100), large heat (nt 200, B 40: a halo of
    10 wider than a 16-CTA slice of 3) and heat at nt 1024 (B 204), float64:
    the plan, bit-equality to the plain build, ms per call (CUDA events; the
    sizes in turns, ascending then descending, both medians kept) and then
    device ms.  A size the card does not schedule is recorded as
    refused.  ``shapes`` and ``sizes`` replace the shapes (as
    :data:`HEAT_SOLVE`) and the sizes."""
    from .ops import bellman as tb
    from .ops import bellman_cuda as bc

    rows, calls = [], []
    for name, nt, B, spec, preset in shapes or (HEAT_SOLVE, HEAT_LARGE,
                                                ("heat1024", *SHAPES[2][1:])):
        tables = _tables(nt, B, spec, preset, torch.float64, seed=40)
        stage, btilde, jump, smax = tables
        L = stage.shape[1]
        U_p, phi_p = tb.build_tables_plain(stage, btilde, jump, B, smax)
        taken = bc.cluster_build_plan(1, nt, L, B, 8, smax).C
        both = tuple(sorted(set(sizes) | {taken}))
        res = {}
        for C in both + both[::-1]:
            try:
                plan = bc.cluster_build_plan(1, nt, L, B, 8, smax, clusters=C)
            except RuntimeError as e:  # a cluster size this card does not schedule
                res[C] = {"refused": str(e)}
                continue

            def call(C=C, t=tables, B=B):  # bound now: device_ms runs after the loop
                return _one_start(bc, *t[:3], B, t[3], C)

            U, phi = call()
            if not (torch.equal(U, U_p) and torch.equal(phi, phi_p)):
                raise RuntimeError(f"{name}: one start at C={C} differs from the plain build")
            r = res.setdefault(C, {"plan": plan._asdict(), "call_ms": []})
            r["call_ms"].append(_events_ms(call))
            if len(r["call_ms"]) == 1:
                calls.append((r, call))
        rows.append({"shape": name, "nt": nt, "L": L, "B": B, "smax": smax,
                     "taken_C": taken, "by_C": res})
    for r, call in calls:
        r["device_ms"] = device_ms(call, "dp_build_kernel", reps=10)
    return rows


LVM_ROWS = (1, 32, 288)  # the host loop, the multistart's ∇f, its 9-trial wave


def lvm_sweep_section(nt: int = 1024) -> list:
    """The fishing sweeps (``csrc/ode_lvm.cu``) at ``LVMObj(nt)`` in float64
    for 1, 32 and 288 rows of binary controls: the device µs of each kernel,
    the ms of a whole ``_forward_batch`` / ``_adjoint_batch`` call with CUDA
    events (the couplings, the wrapper and the launch included) and host µs
    to issue one, each against the plain PyTorch sweeps on the card, which
    must give the same bits; and the bounds of the kernels: the dependent
    float64 operations of a row's chain and the bytes each moves."""
    from .models import LVMObj
    from .utils.init import rand_func

    rows_out = []
    for rows in LVM_ROWS:
        obj = LVMObj(nt=nt, device="cuda")
        X = torch.as_tensor(np.stack([rand_func(obj, seed=r) for r in range(rows)]),
                            dtype=torch.float64, device="cuda")
        f, ys = obj._forward_batch(X)
        df, lam = obj._adjoint_batch(X, ys)
        f_t, ys_t = obj._forward_batch_torch(X)
        df_t, lam_t = obj._adjoint_batch_torch(X, ys_t)
        for a, b in ((f, f_t), (ys, ys_t), (df, df_t), (lam, lam_t)):
            if not torch.equal(a, b):
                raise RuntimeError(f"lvm sweeps at {rows} rows differ from the plain sweeps")
        fwd_bytes = rows * (nt * 16 * 2 + 8)  # A in, ys out, f out
        adj_bytes = rows * nt * (16 * 2 + 16 + 8 * obj.nx)  # A, ys in; λ, ∇f out
        rows_out.append({
            "rows": rows, "nt": nt,
            # the host-clock and event timings before the first profiler trace
            "forward_call_ms": _events_ms(lambda: obj._forward_batch(X)),
            "adjoint_call_ms": _events_ms(lambda: obj._adjoint_batch(X, ys)),
            "forward_host_us": _host_us(lambda: obj._forward_batch(X), n=200),
            "adjoint_host_us": _host_us(lambda: obj._adjoint_batch(X, ys), n=200),
            "forward_device_us": 1e3 * device_ms(lambda: obj._forward_batch(X),
                                                 "lvm_forward_kernel"),
            "adjoint_device_us": 1e3 * device_ms(lambda: obj._adjoint_batch(X, ys),
                                                 "lvm_adjoint_kernel"),
            "plain_forward_call_ms": _events_ms(lambda: obj._forward_batch_torch(X), reps=3),
            "plain_adjoint_call_ms": _events_ms(lambda: obj._adjoint_batch_torch(X, ys),
                                                reps=3),
            "chain_ops": {"forward": 4 * nt, "adjoint": 4 * (nt - 1)},
            "bytes": {"forward": fwd_bytes, "adjoint": adj_bytes},
            "byte_bound_us": {"forward": fwd_bytes / 3.35e12 * 1e6,
                              "adjoint": adj_bytes / 3.35e12 * 1e6},
        })
    return rows_out


PDE_ROWS = (1, 8, 16, 64)  # a host-loop sweep, heat.device's wave, one full group, heat.multistart8's wave
FP64_FMA_PER_S = 33.5e12 / 2  # the H100 SXM's float64 peak outside the tensor cores, in FMA


def pde_sweep_section(nt: int = 500) -> list:
    """The dense heat sweep (``csrc/pde_dense.cu``) at ``HeatObj(nt)`` in
    float64 (N = 545) for 1, 8, 16 and 64 rows, forward (rows · S⁻ᵀ from
    state0) and reverse (rows · S⁻¹ from 0): the kernel's device µs a call
    and a step (a profiler trace), the ms of a call with its host side (CUDA
    events), the host µs to issue one, and beside them the plain sweep
    (``PDEObjective._sweep``: one ``torch.matmul`` of 16 rows a chunk and
    step, cuBLAS) as ``library_ms``; the iterates to 1e-13 of the plain
    sweep's; the rows a group takes; and the bound of a step, R·N² FMA at
    the float64 peak (9.5 MFLOP a step at 16 rows) with op's 2.38 MB read
    once a call."""
    from .models import HeatObj
    from .objectives.pde import _pad_rows
    from .ops import pde_cuda
    from .utils.init import rand_func

    obj = HeatObj(nt=nt, device="cuda")
    N = obj.Nglobal_dofs
    X = torch.as_tensor(np.stack([rand_func(obj, seed=s) for s in range(max(PDE_ROWS))]),
                        dtype=obj.dtype, device="cuda")
    drive = obj._drive(X.transpose(0, 1)).contiguous()
    out = []
    for rows in PDE_ROWS:
        dd = drive[:, :rows].contiguous()
        for name, v_end, op, rev in (("forward", obj.state0, obj._SinvT, False),
                                     ("reverse", None, obj.Sinv, True)):
            def kernel():
                return pde_cuda.dense_sweep(v_end, dd, op, rev)

            def library():
                return obj._sweep(0.0 if v_end is None else v_end, _pad_rows(dd), op, rev)

            plain = library()[:, :rows]
            err = float((kernel() - plain).abs().max() / plain.abs().max())
            if err > 1e-13:
                raise RuntimeError(f"dense sweep at {rows} rows: rel err {err} > 1e-13")
            call_ms = _events_ms(kernel)
            host_us = _host_us(kernel, n=50)
            library_ms = _events_ms(library, reps=3)
            dev_ms = device_ms(kernel, "pde_dense_kernel", reps=10)
            out.append({
                "rows": rows, "direction": name, "nt": nt, "N": N,
                "group_rows": pde_cuda.group_rows(rows, N, obj.dtype, obj.device),
                "max_rel_err": err, "ms_per_call": call_ms, "host_us": host_us,
                "library_ms": library_ms,
                "device_us": None if dev_ms is None else 1e3 * dev_ms,
                "device_us_per_step": None if dev_ms is None else 1e3 * dev_ms / nt,
                "bound_us_per_step": rows * N * N / FP64_FMA_PER_S * 1e6,
                "op_bytes": 8 * N * N})
    return out


def device_ms(fn, kernel: str, reps: int = 20):
    """Device time (ms) per call of the kernels whose name contains
    ``kernel`` that ``fn`` launches, from a ``torch.profiler`` trace of
    ``reps`` calls: the kernel alone, without the host's share of a call
    (the wrapper's Python, the launch).  A trace that shows no device time
    (it happens now and then) is taken once more; None if that one shows
    none either."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
                       for e in prof.key_averages() if kernel in e.key)
        if total_us:
            return total_us / 1e3 / reps
    return None


def sm_clock_mhz(fn, seconds: float = 1.0) -> dict:
    """The SM clock (MHz) that ``nvidia-smi`` reports every 100 ms while
    ``fn`` runs back to back for ``seconds``: median and range, and the
    card's maximum."""
    import time

    mon = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
    finally:
        mon.terminate()
        out, _ = mon.communicate(timeout=30)
    rows = [[int(x) for x in ln.split(",")] for ln in out.splitlines() if ln.strip()]
    sm = sorted(r[0] for r in rows)
    return {"median": sm[len(sm) // 2], "min": sm[0], "max": sm[-1],
            "card_max": rows[0][1], "samples": len(sm)} if rows else {}


def _tables(nt, B, spec, preset, dtype, seed=0):
    from .ops import bellman as tb
    from .ops import levels as lv

    kind, V = spec
    adm = lv.bounded_sum_levels(V, 1, 1) if kind == "bounded" else lv.product_levels(V)
    rng = np.random.default_rng(seed)
    grad = torch.as_tensor(rng.normal(size=(nt, adm.M)), dtype=dtype, device="cuda")
    u_old = torch.as_tensor(adm.levels[rng.integers(0, adm.L, size=nt)], dtype=dtype,
                            device="cuda")
    p, beta, tau = preset
    jump = torch.as_tensor(lv.jump_cost_table(adm.levels, p, beta=beta), dtype=dtype,
                           device="cuda")
    stage, btilde = tb.stage_tables(grad, u_old, adm.levels, tau)
    return stage, btilde, jump, tb.max_budget_use(adm.levels)


def _body_variant(name: str):
    """``mioc_dp_build_batched`` of an edited copy of the build body."""
    from .ops import _kernels

    src = _kernels.CSRC
    out = _kernels.BUILD_DIR / "variants" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(src, out)
    text = (out / "dp_build.cuh").read_text()
    for old, new in BODY_VARIANTS[name]:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} is not in dp_build.cuh")
        text = text.replace(old, new)
    (out / "dp_build.cuh").write_text(text)
    lib = out / "libdp_build_batched.so"
    run = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", str(out), "-o",
                          str(lib), str(out / "dp_build_batched.cu")], capture_output=True,
                         text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{run.stdout}{run.stderr}")
    fn = ctypes.CDLL(str(lib)).mioc_dp_build_batched
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _host_us(fn, n: int = 400) -> float:
    """Host time per call (µs) of ``n`` calls of ``fn`` back to back, with no
    synchronisation inside the loop: what the host spends to issue a call."""
    import time

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def host_side() -> dict:
    """The host side of a call, at the fishing shape (float64): an empty
    kernel through ctypes as an ordinary launch (1 block), a cooperative
    launch (32 blocks of 1024 threads, as the chase's grid) and a cluster
    launch (8 CTAs of 1024); two ``torch.empty`` of the chase's sizes; and
    the pieces of a wrapper call (the table checks, the plan, the current
    stream, a device switch); and whole wrapper calls of ``chase``,
    ``chase_vec`` and ``chase_batched`` (the K=9 wave).  µs per call, host
    clock."""
    from .ops import backtrack_cuda as kc
    from .ops import bellman as tb
    from .ops._kernels import library

    fn = library("launch_probe").mioc_launch_probe
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def probe(kind, blocks, threads):
        def call():
            err = fn(kind, blocks, threads, stream)
            if err != 0:
                raise RuntimeError(f"launch_probe kind {kind}: CUDA error {err}")
        return call

    _, nt, B, spec, preset = SHAPES[0]
    stage, btilde, jump, smax = _tables(nt, B, spec, preset, torch.float64)
    U, phi0 = tb.build_tables(stage, btilde, jump, B, smax)
    plan = kc.chase_plan(nt, U.shape[1], B, 1)
    K = 9
    wave = (U.expand(K, -1, -1, -1), phi0.expand(K, -1, -1), btilde.expand(K, -1, -1))
    caps = torch.tensor([B >> k for k in range(8)] + [0], dtype=torch.int32, device="cuda")

    def device_switch():
        with torch.cuda.device(phi0.device):
            pass

    out = {}
    for _ in range(2):  # in turns: the second pass is the one reported
        out = {
            "empty_ordinary": _host_us(probe(0, 1, 32)),
            "empty_cooperative": _host_us(probe(1, 32, 1024)),
            "empty_cluster_8": _host_us(probe(2, 8, 1024)),
            "two_torch_empty": _host_us(lambda: (
                torch.empty(nt, dtype=torch.int32, device="cuda"),
                torch.empty(plan.scratch, dtype=torch.int32, device="cuda"))),
            "check_tables": _host_us(lambda: kc._check_tables(U, phi0, btilde, False)),
            "check_batched_strides": _host_us(lambda: kc.table_sets(*wave)),
            "chase_plan": _host_us(lambda: kc.chase_plan(nt, U.shape[1], B, 1)),
            "current_stream": _host_us(lambda: torch.cuda.current_stream().cuda_stream),
            "current_device": _host_us(torch.cuda.current_device),
            "data_ptr_x6": _host_us(lambda: [t.data_ptr() for t in (U, phi0, btilde) * 2]),
            "device_switch": _host_us(device_switch),
            "chase": _host_us(lambda: kc.chase(U, phi0, btilde, B)),
            "chase_vec": _host_us(lambda: kc.chase_vec(U, phi0, btilde, B)),
            "chase_batched_wave": _host_us(lambda: kc.chase_batched(*wave, caps)),
        }
    return out


def batched_section() -> dict:
    """chase_batched at fishing S=32 (G = 32) under 8, 16 and 32 chunks per
    set, the stride-0 wave (G = 1, K=9) at fishing and conv under 8, 16 and
    32 chunks, dp_build_batched and chase_trials; device ms, float64."""
    from .ops import backtrack_cuda as kc
    from .ops import bellman as tb
    from .ops import bellman_cuda as bc
    from .ops import levels as lv

    S = 32
    _, nt, B, (kind, V), (p, beta, tau) = SHAPES[0]
    adm = lv.bounded_sum_levels(V, 1, 1)
    rng = np.random.default_rng(10)
    grad = torch.as_tensor(rng.normal(size=(S, nt, adm.M)), device="cuda")
    u_old = torch.as_tensor(adm.levels[rng.integers(0, adm.L, size=(S, nt))], device="cuda")
    jump = torch.as_tensor(lv.jump_cost_table(adm.levels, p, beta=beta), device="cuda")
    smax = tb.max_budget_use(adm.levels)
    stage, btilde = tb.stage_tables(grad, u_old, adm.levels, tau)
    U, phi0 = bc.dp_build_batched(stage, btilde, jump, B, smax)
    wave_caps = [170, 85, 42, 21, 10, 5, 2, 1, 0]
    caps = torch.tensor([wave_caps[s % 9] for s in range(S)], dtype=torch.int32,
                        device="cuda")
    trials = torch.tensor([wave_caps] * S, dtype=torch.int32, device="cuda")
    want = tb.backtrack_batched_plain(U, phi0, btilde, caps.cpu())
    out = {"S": S, "dp_build_batched_ms": device_ms(
        lambda: bc.dp_build_batched(stage, btilde, jump, B, smax), "dp_build_kernel"),
           "chase_trials_ms": device_ms(lambda: kc.chase_trials(U, phi0, btilde, trials),
                                        "chunked_chase_kernel"),
           "chase_batched_sets": [], "chase_batched_wave": {}}
    saved = kc.CHASE_TASKS, kc.CHASE_CHUNKS
    try:
        for chunks in (8, 16, 32):
            kc.CHASE_TASKS = chunks * S
            if not torch.equal(kc.chase_batched(U, phi0, btilde, caps), want):
                raise RuntimeError(f"chase_batched with {chunks} chunks per set differs")
            plan = kc.chase_plan(nt, adm.L, B, 1, sets=S, rows=S)
            out["chase_batched_sets"].append({"chunks": chunks, "C": plan.C, "T": plan.T,
                                              "device_ms": device_ms(
                lambda: kc.chase_batched(U, phi0, btilde, caps), "chunked_chase_kernel")})
        kc.CHASE_TASKS = saved[0]
        for name, nt_, B_, spec, preset in SHAPES[:2]:
            st1, bt1, jp1, sm1 = _tables(nt_, B_, spec, preset, torch.float64)
            U1, phi1 = bc.dp_build(st1, bt1, jp1, B_, sm1)
            K = 9
            wc = [B_ >> k for k in range(8)] + [0] if name == "conv" else wave_caps
            wave = (U1.expand(K, -1, -1, -1), phi1.expand(K, -1, -1), bt1.expand(K, -1, -1))
            ct = torch.tensor(wc, dtype=torch.int32, device="cuda")
            w_want = torch.stack([tb.backtrack_plain(U1, phi1, bt1, c) for c in wc])
            rows = []
            for chunks in (8, 16, 32):
                kc.CHASE_CHUNKS = chunks
                if not torch.equal(kc.chase_batched(*wave, ct), w_want):
                    raise RuntimeError(f"{name} wave with {chunks} chunks differs")
                plan = kc.chase_plan(nt_, U1.shape[1], B_, 1, sets=1, rows=K)
                rows.append({"chunks": chunks, "C": plan.C, "T": plan.T,
                             "device_ms": device_ms(lambda: kc.chase_batched(*wave, ct),
                                                    "chunked_chase_kernel")})
            kc.CHASE_CHUNKS = saved[1]
            rows.append({"chase_device_ms": device_ms(
                lambda: kc.chase(U1, phi1, bt1, wc[0]), "chunked_chase_kernel")})
            out["chase_batched_wave"][name] = rows
    finally:
        kc.CHASE_TASKS, kc.CHASE_CHUNKS = saved
    return out


def vec_section(U, phi0, btilde, B) -> list:
    """chase_vec's device ms under each cluster size and sub-chunk length,
    each equal to the plain walk at caps B, B/2, 0, -1."""
    from .ops import backtrack_cuda as kc
    from .ops import bellman as tb

    rows = []
    saved = kc.VEC_CLUSTERS, kc.VEC_SUBCHUNK_STEPS
    try:
        for cluster in (8, 16):
            for sub in (8, 16, 32):
                kc.VEC_CLUSTERS, kc.VEC_SUBCHUNK_STEPS = (cluster,), sub
                try:
                    plan = kc.cluster_plan(U, phi0)
                except RuntimeError as e:  # a cluster size this card does not schedule
                    rows.append({"cluster": cluster, "subchunk_steps": sub,
                                 "refused": str(e)})
                    continue
                for cap in (B, B // 2, 0, -1):
                    if not torch.equal(kc.chase_vec(U, phi0, btilde, cap),
                                       tb.backtrack_plain(U, phi0, btilde, cap)):
                        raise RuntimeError(f"chase_vec {cluster}/{sub} differs at {cap}")
                rows.append({"cluster": cluster, "subchunk_steps": sub,
                             "plan": plan._asdict(),
                             "device_ms": device_ms(lambda: kc.chase_vec(U, phi0, btilde, B),
                                                    "chase_vec_kernel")})
    finally:
        kc.VEC_CLUSTERS, kc.VEC_SUBCHUNK_STEPS = saved
    return rows


HEAT_SOLVE = ("heat500", 500, 100, ("product", [list(range(6))] * 2), (2, 1e-3, 10.0 / 500))
HEAT_CAPS = [100, 50, 25, 12, 6, 3, 1, 0]  # ⌊δ/Δt⌋, δ = 2, 1, …, at Δt = 0.02
# The large-mesh heat solve (HeatObj(nt=200, 8321 dofs, mg-CG 12, banded)).
HEAT_LARGE = ("heat200", 200, 40, ("product", [list(range(6))] * 2), (2, 1e-3, 10.0 / 200))
HEAT_LARGE_CAPS = [40, 20, 10, 5, 2, 1, 0]  # ⌊δ/Δt⌋ at Δt = 0.05


def heat_solve_section(shape=HEAT_SOLVE, HEAT_CAPS=HEAT_CAPS) -> dict:
    """Device ms of the kernels at a heat solve's shape (``shape``, its
    halving caps ``HEAT_CAPS``), S=1 (``dp_build``, ``chase``,
    ``chase_vec``, ``chase_trials``) and S=8, float64, each equal to its
    plain version first."""
    from .ops import backtrack_cuda as kc
    from .ops import bellman as tb
    from .ops import bellman_cuda as bc

    name, nt, B, spec, preset = shape
    out = {"shape": name, "nt": nt, "B": B, "dtype": "float64", "caps": HEAT_CAPS}
    stage, btilde, jump, smax = _tables(nt, B, spec, preset, torch.float64, seed=40)
    L = stage.shape[1]
    U, phi0 = bc.dp_build(stage, btilde, jump, B, smax)
    U_p, phi_p = tb.build_tables_plain(stage, btilde, jump, B, smax)
    if not (torch.equal(U, U_p) and torch.equal(phi0, phi_p)):
        raise RuntimeError(f"{name}: dp_build differs from the plain build")
    one = (U[None], phi0[None], btilde[None])
    caps1 = torch.tensor([HEAT_CAPS], dtype=torch.int32, device="cuda")
    walk = tb.backtrack_plain(U, phi0, btilde, B)
    if not torch.equal(kc.chase(U, phi0, btilde, B), walk) \
            or not torch.equal(kc.chase_vec(U, phi0, btilde, B), walk) \
            or not torch.equal(kc.chase_trials(*one, caps1),
                               tb.backtrack_trials_plain(*one, caps1.cpu())):
        raise RuntimeError(f"{name}: a chase differs from the plain walk")
    taken = bc.cluster_build_plan(1, nt, L, B, 8, smax)
    U1, phi1 = _one_start(bc, stage, btilde, jump, B, smax, 1)
    if not (torch.equal(U1, U_p) and torch.equal(phi1, phi_p)):
        raise RuntimeError(f"{name}: dp_build at C=1 differs from the plain build")
    out["S1"] = {
        "L": L, "taken_plan": taken._asdict(),
        "dp_build_ms": device_ms(lambda: bc.dp_build(stage, btilde, jump, B, smax),
                                 "dp_build_kernel"),
        "dp_build_ms_at_C1": device_ms(
            lambda: _one_start(bc, stage, btilde, jump, B, smax, 1), "dp_build_kernel"),
        "chase_ms": device_ms(lambda: kc.chase(U, phi0, btilde, B), "chase_kernel"),
        "chase_vec_ms": device_ms(lambda: kc.chase_vec(U, phi0, btilde, B),
                                  "chase_vec_kernel"),
        "chase_trials_ms": device_ms(lambda: kc.chase_trials(*one, caps1),
                                     "chunked_chase_kernel")}

    S = 8
    tabs = [_tables(nt, B, spec, preset, torch.float64, seed=41 + s) for s in range(S)]
    stage = torch.stack([t[0] for t in tabs])
    btilde = torch.stack([t[1] for t in tabs])
    U_p, phi_p = tb.build_tables_batched_plain(stage, btilde, jump, B, smax)
    taken = bc.cluster_build_plan(S, nt, L, B, 8, smax)
    builds = {}
    for C in sorted({1, taken.C}):
        Uc, phic = bc.dp_build_batched(stage, btilde, jump, B, smax, clusters=C)
        if not (torch.equal(Uc, U_p) and torch.equal(phic, phi_p)):
            raise RuntimeError(f"{name} S=8: dp_build_batched at C={C} differs")
        builds[C] = device_ms(lambda C=C: bc.dp_build_batched(stage, btilde, jump, B, smax,
                                                              clusters=C), "dp_build_kernel")
    capsS = torch.tensor([HEAT_CAPS[s % len(HEAT_CAPS)] for s in range(S)],
                         dtype=torch.int32, device="cuda")
    trials = torch.tensor([HEAT_CAPS] * S, dtype=torch.int32, device="cuda")
    if not torch.equal(kc.chase_batched(U_p, phi_p, btilde, capsS),
                       tb.backtrack_batched_plain(U_p, phi_p, btilde, capsS.cpu())) \
            or not torch.equal(kc.chase_trials(U_p, phi_p, btilde, trials),
                               tb.backtrack_trials_plain(U_p, phi_p, btilde, trials.cpu())):
        raise RuntimeError(f"{name} S=8: a batched chase differs from the plain walk")
    out["S8"] = {
        "taken_plan": taken._asdict(), "dp_build_batched_ms_by_C": builds,
        "chase_batched_ms": device_ms(lambda: kc.chase_batched(U_p, phi_p, btilde, capsS),
                                      "chunked_chase_kernel"),
        "chase_trials_ms": device_ms(lambda: kc.chase_trials(U_p, phi_p, btilde, trials),
                                     "chunked_chase_kernel")}
    return out


def large_sweep_section() -> dict:
    """Where a step of the large-mesh heat sweep goes on the device
    (``HeatObj(nt=2, 8321 dofs, mg-CG 12, banded)``, one row): kernels and
    device µs per forward and adjoint step, by kernel name (the twelve with
    the most device time), the host µs per step, and the kernels of one
    fine K application at 16 rows (one ``bmm`` and the zeroed output)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .models.heat import HeatObj, construct_mesh_hierarchy

    obj = HeatObj(nt=2, mesh_hierarchy=construct_mesh_hierarchy(refinements=5), solver="mg",
                  cg_iters=12, sparse_format="banded")
    x = torch.zeros((2, 2), dtype=obj.dtype, device=obj.device)
    _, ys = obj._forward(x)
    X = obj._engine.pad(obj.state0.expand(16, -1))
    out = {"N": obj.Nglobal_dofs, "cg_iters": obj.cg_iters, "mg_levels": len(obj._mg_static)}
    for kind, fn, steps in (("forward", lambda: obj._forward(x), 2),
                            ("adjoint", lambda: obj._adjoint(x, ys), 2),
                            ("K_apply", lambda: obj._engine.K(X), 1)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        dev = {e.key: (e.count / steps, e.device_time_total / steps) for e in ev}
        top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:12]
        out[kind] = {"launches_per_step": sum(c for c, _ in dev.values()),
                     "device_us_per_step": sum(t for _, t in dev.values()),
                     "host_us_per_step_traced": wall * 1e6 / steps,
                     "top_kernels_launches_us_per_step": dict(top)}
    return out


def main(argv=None) -> int:
    import argparse

    from .ops import backtrack_cuda as kc
    from .ops import bellman as tb
    from .ops import bellman_cuda as bc
    from .ops import _kernels

    if not torch.cuda.is_available():
        print("profile_kernels: CUDA is not available")
        return 3
    ap = argparse.ArgumentParser(description="kernel timing experiments on the card")
    ap.add_argument("--heat-only", action="store_true",
                    help="only the kernels at the heat solve's shape")
    ap.add_argument("--heat-large", action="store_true",
                    help="only the large-mesh heat solve: its kernels and its sweep step")
    ap.add_argument("--lvm-only", action="store_true",
                    help="only the fishing sweep kernels (csrc/ode_lvm.cu)")
    ap.add_argument("--pde-only", action="store_true",
                    help="only the dense heat sweep kernel (csrc/pde_dense.cu)")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _kernels.build_all(_kernels.SOURCES + _kernels.PROBES)
    if args.lvm_only:
        print(json.dumps({"lvm_sweeps": lvm_sweep_section(), "nvidia_smi": smi}), flush=True)
        return 0
    if args.pde_only:
        print(json.dumps({"pde_sweeps": pde_sweep_section(), "nvidia_smi": smi}), flush=True)
        return 0
    if args.heat_only:
        sweep = single_build_sweep()  # its per-call times before the first trace
        print(json.dumps({"heat_solve": heat_solve_section(), "nvidia_smi": smi}), flush=True)
        print(json.dumps({"single_build_sweep": sweep, "nvidia_smi": smi}), flush=True)
        return 0
    if args.heat_large:
        print(json.dumps({"heat_large_kernels": heat_solve_section(HEAT_LARGE, HEAT_LARGE_CAPS),
                          "nvidia_smi": smi}), flush=True)
        print(json.dumps({"heat_large_sweep": large_sweep_section(), "nvidia_smi": smi}),
              flush=True)
        return 0
    host = host_side()
    sweep = build_sweep()  # its per-call times before the first trace
    single = single_build_sweep()
    probe = _kernels.library("launch_probe").mioc_launch_probe
    host["empty_device_ms"] = device_ms(
        lambda: probe(1, 32, 1024, torch.cuda.current_stream().cuda_stream), "empty_kernel")
    print(json.dumps({"host_side_us": host, "nvidia_smi": smi}), flush=True)
    print(json.dumps({"build_sweep": sweep, "nvidia_smi": smi}), flush=True)
    print(json.dumps({"single_build_sweep": single, "nvidia_smi": smi}), flush=True)
    print(json.dumps({"batched": batched_section(), "nvidia_smi": smi}), flush=True)
    print(json.dumps({"phase_costs": phase_costs(), "nvidia_smi": smi}), flush=True)
    print(json.dumps({"heat_solve": heat_solve_section(), "nvidia_smi": smi}), flush=True)
    print(json.dumps({"lvm_sweeps": lvm_sweep_section(), "nvidia_smi": smi}), flush=True)
    print(json.dumps({"pde_sweeps": pde_sweep_section(), "nvidia_smi": smi}), flush=True)
    bodies = {name: _body_variant(name) for name in BODY_VARIANTS}
    for name, nt, B, spec, preset in SHAPES:
        stage, btilde, jump, smax = _tables(nt, B, spec, preset, torch.float64)
        L = stage.shape[1]
        U_p, phi_p = tb.build_tables_plain(stage, btilde, jump, B, smax)

        plans = []
        saved = bc.MAX_THREADS, bc.TPL_ALIGN
        try:
            for cap, align in ((1024, 16), (1024, 1), (512, 16), (256, 16)):
                bc.MAX_THREADS, bc.TPL_ALIGN = cap, align
                bc._cluster_build_plan.cache_clear()  # plans cached under other limits

                def one_block():
                    return _one_start(bc, stage, btilde, jump, B, smax, 1)

                U, phi = one_block()
                if not (torch.equal(U, U_p) and torch.equal(phi, phi_p)):
                    raise RuntimeError(f"{name}: dp_build under {cap}/{align} differs")
                plan = bc.build_plan(nt, L, B, 8)
                plans.append({"max_threads": cap, "tpl_align": align, "tpl": plan.tpl,
                              "K": plan.K,
                              "device_ms": device_ms(one_block, "dp_build_kernel")})
        finally:
            bc.MAX_THREADS, bc.TPL_ALIGN = saved
            bc._cluster_build_plan.cache_clear()

        plan = bc.build_plan(nt, L, B, 8)
        U = torch.empty_like(U_p)
        phi = torch.empty_like(phi_p)
        body = {}
        for vname, fn in [("base", None), *bodies.items()]:
            fn = fn or _kernels.entry(*bc._BATCHED)

            def call(fn=fn):  # one start on one block (S = 1, C = 1, H = 0)
                err = fn(stage.data_ptr(), btilde.data_ptr(), jump.data_ptr(),
                         U.data_ptr(), phi.data_ptr(), 1, nt, L, B, min(smax, B), plan.R,
                         int(plan.jsmem), plan.tpl, plan.K, 1, 0, 8, U.element_size(),
                         torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"{name} {vname}: CUDA error {err}")

            body[vname] = device_ms(call, "dp_build_kernel")

        chunks = []
        saved = kc.CHASE_CHUNKS
        try:
            for cc in (8, 16, 32, 64, 128):
                kc.CHASE_CHUNKS = cc
                for cap in (B, B // 2, 0, -1):
                    if not torch.equal(kc.chase(U_p, phi_p, btilde, cap),
                                       tb.backtrack_plain(U_p, phi_p, btilde, cap)):
                        raise RuntimeError(f"{name}: chase with {cc} chunks differs")
                cplan = kc.chase_plan(nt, L, B, U_p.element_size())
                chunks.append({"target": cc, "C": cplan.C, "T": cplan.T,
                               "device_ms": device_ms(
                                   lambda: kc.chase(U_p, phi_p, btilde, B),
                                   "chase_kernel")})
        finally:
            kc.CHASE_CHUNKS = saved
        vec = vec_section(U_p, phi_p, btilde, B)
        clock = sm_clock_mhz(lambda: bc.dp_build(stage, btilde, jump, B, smax))
        print(json.dumps({"shape": name, "nt": nt, "L": L, "B": B, "dtype": "float64",
                          "sm_clock_mhz_during_dp_build": clock,
                          "dp_build_plans": plans, "dp_build_body_ms": body,
                          "chase_chunks": chunks, "chase_vec": vec,
                          "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
