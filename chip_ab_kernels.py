#!/usr/bin/env python3
"""Per-call kernel times of one tree of this repository, for an A/B of two.

    python3 chip_ab_kernels.py TREE

On a machine with one NVIDIA card.  TREE is the root of a checkout (for
example a ``git archive`` of the parent commit unpacked into a git-ignored
directory, or ``.``).  The script puts TREE first on the import path, builds
its kernels, and runs that tree's own ``chip_smoke.py`` kernel phases: the
single kernels (``dp_build``, ``chase``, ``chase_vec``) at the three DP shapes
and the batched kernels (``dp_build_batched`` under its plan, ``chase_batched``,
``chase_trials``) at fishing S=32, conv S=8 and heat S=8, float32 and float64,
each held equal to its plain version and timed in turns with it (CUDA-event
medians per call, the host side of a call included).  It then times, with any tree's wrappers, the stride-0
trial wave of ``chase_batched`` (K=9 caps against one table set) in turns with
one ``chase`` call, and ``chase_vec`` in turns with ``chase``, at fishing and
conv.  One JSON object per line.

Run two trees in turns within one call to the card (parent, change, change,
parent): a call's host side differs between machines by tens of µs.
"""
import json
import os
import sys

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mioc_tpu_torch.ops import _kernels  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_ab_kernels.py: CUDA is not available")
print(json.dumps({"tree": tree, "nvidia_smi": cs.nvidia_smi(),
                  "build_s": _kernels.build_all()}), flush=True)


def wave(name, shape, caps, dtype, seed):
    from mioc_tpu_torch.ops import bellman as tb
    from mioc_tpu_torch.ops import levels as lv
    from mioc_tpu_torch.ops.backtrack_cuda import chase, chase_batched, chase_vec
    from mioc_tpu_torch.ops.bellman_cuda import dp_build

    _, nt, B, (kind, V), (p, beta, tau) = shape
    adm = lv.bounded_sum_levels(V, 1, 1) if kind == "bounded" else lv.product_levels(V)
    rng = np.random.default_rng(seed)
    grad = torch.as_tensor(rng.normal(size=(nt, adm.M)), dtype=dtype, device="cuda")
    u_old = torch.as_tensor(adm.levels[rng.integers(0, adm.L, size=nt)], dtype=dtype,
                            device="cuda")
    jump = torch.as_tensor(lv.jump_cost_table(adm.levels, p, beta=beta), dtype=dtype,
                           device="cuda")
    smax = tb.max_budget_use(adm.levels)
    stage, btilde = tb.stage_tables(grad, u_old, adm.levels, tau)
    U, phi0 = dp_build(stage, btilde, jump, B, smax)
    K = len(caps)
    w = (U.expand(K, -1, -1, -1), phi0.expand(K, -1, -1), btilde.expand(K, -1, -1))
    ct = torch.tensor(caps, dtype=torch.int32, device="cuda")
    want = torch.stack([tb.backtrack_plain(U, phi0, btilde, c) for c in caps])
    cs.require(torch.equal(chase_batched(*w, ct), want), f"{name} wave")
    wave_ms, chase_ms = cs.in_turns(torch, lambda: chase(U, phi0, btilde, caps[0]),
                                    lambda: chase_batched(*w, ct), 30, 30)
    vec_ms, chase2_ms = cs.in_turns(torch, lambda: chase(U, phi0, btilde, caps[0]),
                                    lambda: chase_vec(U, phi0, btilde, caps[0]), 30, 30)
    print(json.dumps({"phase": "wave_ab", "shape": name, "dtype": str(dtype), "K": K,
                      "wave_ms": wave_ms, "chase_ms": chase_ms, "vec_ms": vec_ms,
                      "chase_with_vec_ms": chase2_ms}), flush=True)


for seed, (name, nt, B, spec, preset) in enumerate(cs.SHAPES):
    for dtype in (torch.float32, torch.float64):
        cs.kernel_phase(torch, name, nt, B, spec, preset, dtype, seed)
for seed, (name, S, i, caps) in enumerate(cs.BATCHED):
    for dtype in (torch.float32, torch.float64):
        cs.batched_phase(torch, name, S, cs.SHAPES[i], caps, dtype, 10 + seed)
for seed, (name, i, caps) in enumerate((("fishing", 0, cs.schedule(2.0, 12.0 / 1024)),
                                        ("conv", 1, [128 >> k for k in range(8)] + [0]))):
    for dtype in (torch.float32, torch.float64):
        wave(name, cs.SHAPES[i], caps, dtype, 20 + seed)
