"""Timing experiments on the DP build and chase kernels, on one NVIDIA card.

    python -m mioc_tpu_torch.profile_kernels

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``.
At the three DP shapes of ``chip_smoke.py`` (fishing, conv, heat scale), in
float64, it prints one JSON object per line with the device time of the
kernel alone (:func:`device_ms`, a ``torch.profiler`` trace) under:

* other launch plans of ``dp_build`` (threads per block capped at 1024, 512
  or 256; ``bellman_cuda.TPL_ALIGN`` 16 or 1), each bit-equal to the plain
  build;
* other chunk counts of ``chase`` (``backtrack_cuda.CHASE_CHUNKS`` 8 … 128),
  each equal to the plain walk;
* variants of the build body compiled from edited copies of
  ``csrc/dp_build.cuh`` into ``mioc_tpu_torch/_build/variants/``: without the
  U store, without the relaxation, without both, and with the step's
  barrier replaced by a warp sync.  The variants compute wrong tables and
  are timed only: they show what a step costs beyond its relaxation.

It also samples the SM clock (``nvidia-smi --query-gpu=clocks.sm``) while
``dp_build`` runs back to back for a second at each shape: a kernel that
keeps one SM busy may not lift the card to its full clock.

The first line is the card's name and power limit (``nvidia-smi``).
"""

from __future__ import annotations

import ctypes
import json
import math
import shutil
import subprocess

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
    "warp_sync": [("__syncthreads();  // Φ_i complete", "__syncwarp();  // Φ_i complete")],
}
BODY_VARIANTS["no_store_no_relax"] = BODY_VARIANTS["no_U_store"] + BODY_VARIANTS["no_relax"]


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
    """``mioc_dp_build`` of an edited copy of the build body."""
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
    lib = out / "libdp_build.so"
    run = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", str(out), "-o",
                          str(lib), str(out / "dp_build.cu")], capture_output=True,
                         text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{run.stdout}{run.stderr}")
    fn = ctypes.CDLL(str(lib)).mioc_dp_build
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    from .ops import backtrack_cuda as kc
    from .ops import bellman as tb
    from .ops import bellman_cuda as bc
    from .ops import _kernels

    if not torch.cuda.is_available():
        print("profile_kernels: CUDA is not available")
        return 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _kernels.build_all(("dp_build", "chase"))
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
                U, phi = bc.dp_build(stage, btilde, jump, B, smax)
                if not (torch.equal(U, U_p) and torch.equal(phi, phi_p)):
                    raise RuntimeError(f"{name}: dp_build under {cap}/{align} differs")
                plan = bc.build_plan(nt, L, B, 8)
                plans.append({"max_threads": cap, "tpl_align": align, "tpl": plan.tpl,
                              "K": plan.K, "device_ms": device_ms(
                                  lambda: bc.dp_build(stage, btilde, jump, B, smax),
                                  "dp_build_kernel")})
        finally:
            bc.MAX_THREADS, bc.TPL_ALIGN = saved

        plan = bc.build_plan(nt, L, B, 8)
        U = torch.empty_like(U_p)
        phi = torch.empty_like(phi_p)
        body = {}
        for vname, fn in [("base", None), *bodies.items()]:
            fn = fn or bc._fn("dp_build", "mioc_dp_build", 10)

            def call(fn=fn):
                err = fn(stage.data_ptr(), btilde.data_ptr(), jump.data_ptr(),
                         U.data_ptr(), phi.data_ptr(), nt, L, B, min(smax, B), plan.R,
                         int(plan.jsmem), plan.tpl, plan.K, 8, U.element_size(),
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
        clock = sm_clock_mhz(lambda: bc.dp_build(stage, btilde, jump, B, smax))
        print(json.dumps({"shape": name, "nt": nt, "L": L, "B": B, "dtype": "float64",
                          "sm_clock_mhz_during_dp_build": clock,
                          "dp_build_plans": plans, "dp_build_body_ms": body,
                          "chase_chunks": chunks, "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
