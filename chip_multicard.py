#!/usr/bin/env python3
"""One rank per card: the level-sharded DP and the multistart over NCCL.

    python -m torch.distributed.run --standalone --nproc-per-node 4 chip_multicard.py

Run from the root of a checkout on a host with one GPU per rank, where
``init_multihost`` takes NCCL.  Each rank builds the kernels (rank 0 first),
then:

1. ``build_tables_sharded`` at the fishing preset's shape (nt=1024, B=170,
   L=3 padded to the world size) on a 1×W mesh: cropped to L, bit-equal to
   ``dp_build``'s on its own card, ``chase`` on the padded tables equal to
   ``chase`` on ``dp_build``'s at B, B/2, B/4 and 0; ms per build and µs per
   collective of one step's packed planes (200 calls);
2. the fishing preset host loop with ``dp_backend="sharded"`` on that mesh:
   41 iterations, 193 inner steps and the JAX package's J (rtol 1e-12);
3. ``multistart_solve_device`` over the 32 fishing starts on a W×1 mesh:
   every start's iterations, inner steps and J equal to the JAX constants.

Rank 0 prints one JSON line with every rank's results and exits non-zero
if any check failed on any rank.  ``chip_smoke.py`` covers the one-card
case (ranks sharing the card over gloo).
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from mioc_tpu_torch.models import LVMObj
    from mioc_tpu_torch.ops import _kernels
    from mioc_tpu_torch.parallel import build_tables_sharded, init_multihost, make_device_mesh
    from mioc_tpu_torch.parallel.shard_dp import pad_level_axis
    from mioc_tpu_torch.solvers.trm import TRMParameters, trm_solve
    from mioc_tpu_torch.solvers.trm_device import multistart_solve_device
    from mioc_tpu_torch.utils.init import rand_func

    rank, world = init_multihost()
    out = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "device": torch.cuda.get_device_name(), "card": torch.cuda.current_device()}
    if rank == 0:
        _kernels.build_all()
    dist.barrier()
    _kernels.build_all()
    from mioc_tpu_torch.ops.backtrack_cuda import chase
    from mioc_tpu_torch.ops.bellman_cuda import dp_build

    _, nt, B, spec, preset = cs.SHAPES[0]
    adm, stage, btilde, jump, smax = cs._dp_inputs(torch, nt, B, spec, preset, 60)
    mesh = make_device_mesh(batch=1, level=world)
    (U, phi0), build_s = cs._timed(torch, lambda: build_tables_sharded(
        stage, btilde, jump, B, smax, mesh))
    Uk, phik = dp_build(stage, btilde, jump, B, smax)
    bt_p = pad_level_axis(stage, btilde, jump, world, B)[1]
    part = torch.zeros((2, 1, U.shape[1], B + 1), dtype=torch.float64, device=stage.device)
    _, gather_s = cs._timed(torch, lambda: [mesh.all_gather(part, "level") for _ in range(200)])
    out["tables"] = {
        "U_equal": torch.equal(U[:, :adm.L], Uk),
        "phi0_bits_equal": torch.equal(cs.bits(phi0[:adm.L], torch), cs.bits(phik, torch)),
        "chases_equal": all(torch.equal(chase(U, phi0, bt_p, c), chase(Uk, phik, btilde, c))
                            for c in (B, B // 2, B // 4, 0)),
        "build_ms": 1e3 * build_s, "gather_us": 1e6 * gather_s / 200}

    par = TRMParameters(**cs.PRESET, dp_backend="sharded", mesh=mesh)
    res, wall = cs._timed(torch, lambda: trm_solve(LVMObj(nt=1024), par, seed=0))
    out["host_sharded"] = {
        "J": res.J, "iterations": res.iterations, "inner_steps": res.inner_steps,
        "wall_s": wall, "timings_s": res.timings,
        "ok": (res.iterations, res.inner_steps) == (cs.REF_ITERATIONS, cs.REF_INNER)
        and abs(res.J - cs.REF_J) <= 1e-12 * cs.REF_J}

    x0s = np.stack([rand_func(LVMObj(nt=1024), seed=s) for s in range(cs.N_STARTS)])
    ms, wall = cs._timed(torch, lambda: multistart_solve_device(
        LVMObj(nt=1024), TRMParameters(**cs.PRESET), x0s,
        mesh=make_device_mesh(batch=world)))
    out["multistart"] = {
        "wall_s": wall, "max_iterations": int(ms.iterations.max()),
        "ok": ms.iterations.tolist() == list(cs.REF32_ITERATIONS)
        and ms.inner_steps.tolist() == list(cs.REF32_INNER)
        and all(abs(a - b) <= 1e-12 * b for a, b in zip(ms.J.tolist(), cs.REF32_J))}

    ranks = [None] * world
    dist.all_gather_object(ranks, out)
    dist.destroy_process_group()
    ok = all(r["backend"] == "nccl" and all(r["tables"][k] for k in (
        "U_equal", "phi0_bits_equal", "chases_equal")) and r["host_sharded"]["ok"]
        and r["multistart"]["ok"] for r in ranks)
    if rank == 0:
        print(json.dumps({"phase": "multicard", "ok": ok, "ranks": ranks}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
