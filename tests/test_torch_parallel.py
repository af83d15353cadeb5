"""The port's multi-rank ``parallel/`` against the JAX package, on the CPU.

Gloo worlds of 2 and 4 ranks are spawned once per module (the ``world2``
and ``world4`` fixtures, :func:`run_world`): each rank runs this file as a
script (``_worker``), which imports only torch, numpy and the port, joins
the world over a ``FileStore`` in ``tmp_path`` (no port is bound), runs
every case of its world and writes one npz per case and rank.  A world that does not finish within ``TIMEOUT`` seconds, or whose
rank fails, is killed and fails the fixture: no world can hang the suite.
The parent holds the ranks' results against each other and against the
JAX package on its 8 virtual CPU devices (``tests/conftest.py``), imported
inside the parent-side fixtures only.

Integer outputs (U after a cast to int32, level indices, accepted and
candidate controls, counters) must be equal and the tables' values bit-equal
(float64 views); J and the step's model values agree with the JAX package's
to rtol 1e-12, as the port's other solver tests hold them.
"""

import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
TIMEOUT = 300.0
PINF = dict(beta=1e-4, p=np.inf, delta0=2.0)
HEAT = dict(beta=1e-3, p=2, delta0=2.0)
INTS = ("converged", "iterations", "inner_steps", "f_evals", "df_evals", "dp_builds")

# Table cases: (level spec, nt, B, p, beta, tau, level-axis sizes, caps).
TABLES = {
    "l8": (("product", [[0, 1]] * 3), 40, 10, 1, 0.1, 0.1, (1, 2, 3, 4), (10, 5, 2, 0)),
    "heat": (("product", [list(range(6))] * 2), 128, 204, 2, 1e-3, 10.0 / 128, (4,),
             (204, 102, 3)),
    "indivisible": (("bounded", [[0, 1]] * 3), 40, 8, np.inf, 1e-4, 0.1, (2, 4), (8, 4, 0)),
    "ties": (("product", [[0, 1, 2]] * 2), 30, 9, None, None, 0.5, (2, 3, 4), (9, 4, 1)),
}
TEMPORAL = (("bounded", [[0, 1]] * 3), 37, 9, 1, 0.1, 0.01)
MULTISTART_NT, MULTISTART_S = 48, 4


# -- problems (numpy and the port only: the workers run these) ----------------

def _admissible(spec):
    from mioc_tpu_torch.ops.levels import bounded_sum_levels, product_levels

    kind, V = spec
    return bounded_sum_levels(V, 1, 1) if kind == "bounded" else product_levels(V)


def _stage(name):
    """The stage tables, jump table and smax of a table case, on the CPU.
    ``ties`` has one jump cost for every change of level and integer grads,
    so many successors and many paths tie."""
    from mioc_tpu_torch.ops.bellman import max_budget_use, stage_tables
    from mioc_tpu_torch.ops.levels import jump_cost_table

    spec, nt, B, p, beta, tau = (TABLES[name][:6] if name in TABLES else TEMPORAL)
    adm = _admissible(spec)
    rng = np.random.default_rng(0)
    if name == "ties":
        grad = rng.integers(-2, 3, size=(nt, adm.M)).astype(float)
        jump = 0.5 * (1.0 - np.eye(adm.L))
    else:
        grad = rng.normal(size=(nt, adm.M))
        jump = jump_cost_table(adm.levels, p, beta=beta)
    u_old = adm.levels[rng.integers(0, adm.L, size=nt)]
    stage, btilde = stage_tables(torch.as_tensor(grad), torch.as_tensor(u_old, dtype=torch.float64),
                                 adm.levels, tau)
    return adm, stage, btilde, torch.as_tensor(jump), max_budget_use(adm.levels), B


def _starts(obj, n, seed=0):
    from mioc_tpu_torch.utils.init import rand_func

    return np.stack([rand_func(obj, seed=seed + s) for s in range(n)])


def _result(res):
    return {f: np.asarray(getattr(res, f)) for f in res._fields}


# -- the worker's cases ---------------------------------------------------------

def _tables_case(name):
    def run(rank, world):
        from mioc_tpu_torch.ops.bellman import backtrack
        from mioc_tpu_torch.parallel import build_tables_sharded, make_device_mesh
        from mioc_tpu_torch.parallel.shard_dp import pad_level_axis

        adm, stage, btilde, jump, smax, B = _stage(name)
        out = {"stage": stage.numpy(), "btilde": btilde.numpy(), "jump": jump.numpy()}
        for D in (d for d in TABLES[name][6] if d <= world):
            mesh = make_device_mesh(batch=1, level=D, devices=list(range(D)),
                                    device_type="cpu")
            if rank >= D:
                continue
            U, phi0 = build_tables_sharded(stage, btilde, jump, B, smax, mesh)
            bt_p = pad_level_axis(stage, btilde, jump, D, B)[1]
            out[f"U{D}"], out[f"phi{D}"] = U.numpy(), phi0.numpy()
            for cap in TABLES[name][7]:
                out[f"idx{D}_{cap}"] = backtrack(U, phi0, bt_p, adm.levels, cap)[1].numpy()
            if name == "l8" and D == world:
                # A leading start axis: two starts share each step's collective.
                U2, phi2 = build_tables_sharded(torch.stack([stage, stage.flip(0)]),
                                                torch.stack([btilde, btilde.flip(0)]),
                                                jump, B, smax, mesh)
                U1, phi1 = build_tables_sharded(stage.flip(0), btilde.flip(0), jump, B,
                                                smax, mesh)
                out["batched_equal"] = np.array(
                    torch.equal(U2[0], U) and torch.equal(U2[1], U1)
                    and torch.equal(phi2[0].view(torch.int64), phi0.view(torch.int64))
                    and torch.equal(phi2[1].view(torch.int64), phi1.view(torch.int64)))
        return out
    return run


def _temporal(rank, world):
    from mioc_tpu_torch.parallel import make_device_mesh, temporal_tables_sharded
    from mioc_tpu_torch.parallel.temporal import temporal_backtrack, temporal_tables

    adm, stage, btilde, jump, smax, B = _stage("temporal")
    mesh = make_device_mesh(batch=world, level=1, device_type="cpu")
    sh = temporal_tables_sharded(stage, btilde, jump, B, smax, mesh)
    out = {"stage": stage.numpy(), "btilde": btilde.numpy(), "jump": jump.numpy(),
           "sharded": sh.numpy(), "plain": temporal_tables(stage, btilde, jump, B, smax).numpy()}
    for cap in (9, 4):
        out[f"idx_{cap}"] = temporal_backtrack(sh, btilde, jump, adm.levels, cap)[1].numpy()
    return out


def _step(shape):
    def run(rank, world):
        from mioc_tpu_torch.models import LVMObj
        from mioc_tpu_torch.parallel import make_device_mesh, make_ode_trm_step

        obj = LVMObj(nt=48, device="cpu")
        mesh = make_device_mesh(*shape, device_type="cpu")
        step = make_ode_trm_step(obj, **PINF, mesh=mesh)
        u, J, M = step(torch.as_tensor(_starts(obj, 8)))
        return {"u": u.numpy(), "J": J.numpy(), "M": M.numpy()}
    return run


def _heat_obj(nt, refinements):
    from mioc_tpu_torch.models.heat import HeatObj, construct_mesh

    return HeatObj(nt=nt, mesh=construct_mesh(refinements=refinements), device="cpu")


def _host_heat(rank, world):
    from mioc_tpu_torch.solvers.trm import TRMParameters, trm_solve

    par = TRMParameters(**HEAT, maxiter=12, dp_backend="sharded")  # all ranks on "level"
    r = trm_solve(_heat_obj(40, 2), par, seed=0)
    return {"u": r.u, "x_final": r.x_final, "J": np.array(r.J),
            **{f: np.array(getattr(r, f)) for f in ("converged", "iterations",
                                                    "inner_steps", "dp_builds")}}


def _device_heat(rank, world):
    from mioc_tpu_torch.parallel import make_device_mesh
    from mioc_tpu_torch.solvers.trm import TRMParameters
    from mioc_tpu_torch.solvers.trm_device import trm_solve_device

    mesh = make_device_mesh(batch=1, level=world, device_type="cpu")
    par = TRMParameters(**HEAT, maxiter=10)
    out = {}
    for chunk in (None, 4):
        r = trm_solve_device(_heat_obj(16, 1), par, seed=0, dp_backend="sharded",
                             mesh=mesh, outer_chunk=chunk)
        out.update({f"{k}_{chunk}": v for k, v in _result(r).items()})
    return out


def _device_fishing(rank, world):
    from mioc_tpu_torch.models import LVMObj
    from mioc_tpu_torch.parallel import make_device_mesh
    from mioc_tpu_torch.solvers.trm import TRMParameters
    from mioc_tpu_torch.solvers.trm_device import trm_solve_device
    from mioc_tpu_torch.utils.init import rand_func

    mesh = make_device_mesh(batch=1, level=world, device_type="cpu")
    x0 = rand_func(LVMObj(nt=96, device="cpu"), seed=2)
    out = {}
    for spec in (False, True):
        r = trm_solve_device(LVMObj(nt=96, device="cpu"), TRMParameters(**PINF), x0=x0,
                             dp_backend="sharded", mesh=mesh, speculative=spec,
                             outer_chunk=None)
        out.update({f"{k}_{spec}": v for k, v in _result(r).items()})
    return out


def _multistart(shape, sharded):
    def run(rank, world):
        from mioc_tpu_torch.models import LVMObj
        from mioc_tpu_torch.parallel import make_device_mesh
        from mioc_tpu_torch.solvers.trm import TRMParameters
        from mioc_tpu_torch.solvers.trm_device import multistart_solve_device

        obj = LVMObj(nt=MULTISTART_NT, device="cpu")
        mesh = make_device_mesh(*shape, device_type="cpu")
        out = {}
        for spec in ((False, True) if sharded else (False,)):
            r = multistart_solve_device(obj, TRMParameters(**PINF), _starts(obj, MULTISTART_S),
                                        mesh=mesh, speculative=spec,
                                        dp_backend="sharded" if sharded else None,
                                        outer_chunk=3 if spec else None)
            out.update({f"{k}_{spec}": v for k, v in _result(r).items()})
        return out
    return run


def _cuda_tables(rank, world):
    """The fishing preset's shape on ``cuda:0``, level-sharded over the
    world (gloo, as ranks that share a card take), and ``dp_build``'s
    tables of the same inputs."""
    from mioc_tpu_torch.ops.bellman import backtrack, build_tables, stage_tables
    from mioc_tpu_torch.ops.levels import bounded_sum_levels, jump_cost_table
    from mioc_tpu_torch.parallel import build_tables_sharded, make_device_mesh
    from mioc_tpu_torch.parallel.shard_dp import pad_level_axis

    dev = torch.device("cuda")
    adm = bounded_sum_levels([[0, 1]] * 3, 1, 1)
    rng = np.random.default_rng(5)
    nt, B = 1024, 170
    grad = torch.as_tensor(rng.normal(size=(nt, 3)), device=dev)
    u_old = torch.as_tensor(adm.levels[rng.integers(0, 3, size=nt)], dtype=torch.float64,
                            device=dev)
    jump = torch.as_tensor(jump_cost_table(adm.levels, np.inf, beta=1e-4), device=dev)
    stage, btilde = stage_tables(grad, u_old, adm.levels, 12.0 / nt)
    mesh = make_device_mesh(batch=1, level=world)  # device_type "cuda"
    U, phi0 = build_tables_sharded(stage, btilde, jump, B, 2, mesh)
    Uk, phik = build_tables(stage, btilde, jump, B, 2)
    bt_p = pad_level_axis(stage, btilde, jump, world, B)[1]
    idx = [backtrack(U, phi0, bt_p, adm.levels, c)[1] for c in (B, B // 2, 0)]
    idxk = [backtrack(Uk, phik, btilde, adm.levels, c)[1] for c in (B, B // 2, 0)]
    return {"U": U[:, :3].cpu().numpy(), "Uk": Uk.cpu().numpy(),
            "phi": phi0[:3].cpu().numpy(), "phik": phik.cpu().numpy(),
            "idx": torch.stack(idx).cpu().numpy(), "idxk": torch.stack(idxk).cpu().numpy()}


CASES = {
    "tables_l8": _tables_case("l8"), "tables_heat": _tables_case("heat"),
    "tables_indivisible": _tables_case("indivisible"), "tables_ties": _tables_case("ties"),
    "temporal": _temporal, "step_4x1": _step((4, 1)), "step_2x2": _step((2, 2)),
    "host_heat": _host_heat, "device_heat": _device_heat, "device_fishing": _device_fishing,
    "multistart_2x1": _multistart((2, 1), False), "multistart_2x2": _multistart((2, 2), True),
    "cuda_tables": _cuda_tables,
}
# The cases of each CPU world, in the order its ranks run them (the
# collectives of one case match across the ranks, case by case).
WORLDS = {
    2: ("tables_indivisible", "temporal", "multistart_2x1"),
    4: ("tables_l8", "tables_heat", "tables_indivisible", "tables_ties", "temporal",
        "step_4x1", "step_2x2", "host_heat", "device_heat", "device_fishing",
        "multistart_2x2"),
}


def _worker(rank, world, store, out_dir, cases):
    torch.set_num_threads(1)
    from mioc_tpu_torch.parallel import init_multihost

    assert init_multihost(f"file://{store}", world, rank, backend="gloo") == (rank, world)
    for name in cases:
        np.savez(os.path.join(out_dir, f"{name}_r{rank}.npz"), **CASES[name](rank, world))
    torch.distributed.barrier()  # no rank leaves while another still talks to it


def run_world(world, tmp, cases=None):
    """Spawn ``world`` ranks of this file's worker over a ``FileStore`` in
    ``tmp``; kill every rank and fail when one fails or when ``TIMEOUT``
    runs out.  Returns ``{case: [npz of rank r, …]}``."""
    tmp = pathlib.Path(tmp)
    cases = list(cases or WORLDS[world])
    env = {k: v for k, v in os.environ.items() if not k.startswith(("MASTER_", "WORLD_SIZE", "RANK"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])))
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world), str(tmp / "store"),
                               str(tmp), ",".join(cases)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=str(tmp))
             for r in range(world)]
    deadline = time.monotonic() + TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate()[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            pytest.fail(f"rank {r} of {world} exited {p.returncode} "
                        f"(timeout {TIMEOUT} s):\n{out[-4000:]}")
    return {c: [np.load(tmp / f"{c}_r{r}.npz") for r in range(world)] for c in cases}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world(2, tmp_path_factory.mktemp("world2"))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    from mioc_tpu_torch.fem import _native_triangle

    _native_triangle.available()  # build the port's triangulator once, before the ranks
    return run_world(4, tmp_path_factory.mktemp("world4"))


def _same_on_every_rank(runs, keys=None):
    first = runs[0]
    for r, other in enumerate(runs[1:], 1):
        if keys is None:
            assert set(other.files) == set(first.files)
        for k in keys or first.files:
            np.testing.assert_array_equal(other[k], first[k], err_msg=f"rank {r}: {k}")
    return first


def _bits(a):
    return np.asarray(a, np.float64).view(np.int64)


# -- (a)–(d): level-sharded tables ----------------------------------------------

def _jax_tables(res, B, levels_np, caps, sharded_levels=()):
    """The JAX package's tables and chases from the port's stage tables."""
    import jax.numpy as jnp
    from mioc_tpu.ops.bellman import backtrack, build_tables, max_budget_use
    from mioc_tpu.parallel import build_tables_sharded, make_device_mesh

    stage, btilde, jump = (jnp.asarray(res[k]) for k in ("stage", "btilde", "jump"))
    smax = max_budget_use(levels_np)
    U, phi0 = build_tables(stage, btilde, jump, B, smax)
    idx = {cap: np.asarray(backtrack(U, phi0, btilde, jnp.asarray(levels_np),
                                     jnp.int32(cap))[1]) for cap in caps}
    sh = {D: build_tables_sharded(stage, btilde, jump, B, smax,
                                  make_device_mesh(batch=1, level=D))
          for D in sharded_levels}
    return np.asarray(U), np.asarray(phi0), idx, sh


@pytest.mark.parametrize("name,world,D", [
    ("l8", 4, 1), ("l8", 4, 2), ("l8", 4, 3), ("l8", 4, 4), ("heat", 4, 4),
    ("indivisible", 2, 2), ("indivisible", 4, 2), ("indivisible", 4, 4),
    ("ties", 4, 2), ("ties", 4, 3), ("ties", 4, 4)])
def test_sharded_tables_bit_equal_jax(request, name, world, D):
    runs = request.getfixturevalue(f"world{world}")[f"tables_{name}"]
    for r in range(D, world):  # ranks outside the mesh built nothing
        assert f"U{D}" not in runs[r].files
    caps = TABLES[name][7]
    res = _same_on_every_rank(runs[:D], [f"U{D}", f"phi{D}"] + [f"idx{D}_{c}" for c in caps])
    B = TABLES[name][2]
    adm = _admissible(TABLES[name][0])
    L, Lp = adm.L, -(-adm.L // D) * D
    U, phi0 = res[f"U{D}"], res[f"phi{D}"]
    assert U.shape == (TABLES[name][1] - 1, Lp, B + 1) and phi0.shape == (Lp, B + 1)
    assert U.dtype == np.int8  # the port's u_dtype(Lp): the chase kernels take it as is
    jU, jphi, jidx, jsh = _jax_tables(res, B, adm.levels, caps,
                                      sharded_levels=[d for d in (2, 4) if d == D])
    np.testing.assert_array_equal(U[:, :L].astype(np.int32), jU)
    np.testing.assert_array_equal(_bits(phi0[:L]), _bits(jphi))
    assert np.all(np.isposinf(phi0[L:])) and not U[:, L:].any()  # inert padded rows
    for jD, (jUs, jphis) in jsh.items():  # the JAX package's sharded tables, padded
        assert np.asarray(jUs).shape == U.shape
        np.testing.assert_array_equal(U.astype(np.int32), np.asarray(jUs))
        np.testing.assert_array_equal(_bits(phi0), _bits(jphis))
    for cap in caps:
        np.testing.assert_array_equal(res[f"idx{D}_{cap}"], jidx[cap], err_msg=f"cap {cap}")
    if name == "l8" and D == world:
        assert bool(res["batched_equal"])


# -- (e): time-sharded temporal tables ------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_temporal_sharded_bit_equal(request, world):
    import jax.numpy as jnp
    from mioc_tpu.ops.bellman import max_budget_use
    from mioc_tpu.parallel.temporal import temporal_backtrack, temporal_tables

    res = _same_on_every_rank(request.getfixturevalue(f"world{world}")["temporal"])
    np.testing.assert_array_equal(_bits(res["sharded"]), _bits(res["plain"]))
    adm = _admissible(TEMPORAL[0])
    stage, btilde, jump = (jnp.asarray(res[k]) for k in ("stage", "btilde", "jump"))
    ref = temporal_tables(stage, btilde, jump, TEMPORAL[2], max_budget_use(adm.levels))
    np.testing.assert_array_equal(_bits(res["sharded"]), _bits(ref))
    for cap in (9, 4):
        _, idx = temporal_backtrack(ref, btilde, jump, jnp.asarray(adm.levels), jnp.int32(cap))
        np.testing.assert_array_equal(res[f"idx_{cap}"], np.asarray(idx))


# -- (f): the batch x level TRM step --------------------------------------------

@pytest.fixture(scope="module")
def jax_step():
    import jax.numpy as jnp
    from mioc_tpu.models import LVMObj as JaxLVM
    from mioc_tpu.parallel import make_device_mesh, make_ode_trm_step

    from mioc_tpu_torch.models import LVMObj

    u0 = jnp.asarray(_starts(LVMObj(nt=48, device="cpu"), 8))
    out = {}
    for shape in ((4, 1), (2, 2)):
        step = make_ode_trm_step(JaxLVM(nt=48), **PINF, mesh=make_device_mesh(*shape))
        out[shape] = [np.asarray(a) for a in step(u0)]
    return out


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_ode_step_on_a_mesh(world4, jax_step, shape):
    from mioc_tpu_torch.models import LVMObj
    from mioc_tpu_torch.parallel import make_ode_trm_step

    res = _same_on_every_rank(world4[f"step_{shape[0]}x{shape[1]}"])
    obj = LVMObj(nt=48, device="cpu")
    one = [t.numpy() for t in make_ode_trm_step(obj, **PINF)(torch.as_tensor(_starts(obj, 8)))]
    np.testing.assert_array_equal(res["u"], one[0])  # the world-of-one step, bit for bit
    np.testing.assert_array_equal(_bits(res["J"]), _bits(one[1]))
    np.testing.assert_array_equal(_bits(res["M"]), _bits(one[2]))
    ju, jJ, jM = jax_step[shape]
    np.testing.assert_array_equal(res["u"], ju)
    np.testing.assert_allclose(res["J"], jJ, rtol=1e-12)
    np.testing.assert_allclose(res["M"], jM, rtol=1e-12)


# -- (g)–(i): the solves ----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_triangulator():
    from test_torch_fem import load_jax_triangulator

    load_jax_triangulator()


def _assert_same_solve(got, ref, suffix=""):
    for f in INTS:
        np.testing.assert_array_equal(got[f + suffix], np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_array_equal(got["u" + suffix], np.asarray(ref.u))
    np.testing.assert_array_equal(got["x_final" + suffix], np.asarray(ref.x_final))
    np.testing.assert_allclose(got["J" + suffix], np.asarray(ref.J), rtol=1e-12)


def test_host_loop_sharded_heat(world4, jax_triangulator):
    from mioc_tpu.models.heat import HeatObj, construct_mesh
    from mioc_tpu.solvers.trm import TRMParameters, trm_solve

    got = _same_on_every_rank(world4["host_heat"])
    ref = trm_solve(HeatObj(nt=40, mesh=construct_mesh(refinements=2)),
                    TRMParameters(**HEAT, maxiter=12, dp_backend="scan"), seed=0)
    for f in ("converged", "iterations", "inner_steps", "dp_builds"):
        assert got[f] == getattr(ref, f), f
    np.testing.assert_array_equal(got["u"], np.asarray(ref.u))
    np.testing.assert_array_equal(got["x_final"], np.asarray(ref.x_final))
    np.testing.assert_allclose(got["J"], ref.J, rtol=1e-12)


def test_device_loop_sharded_heat(world4, jax_triangulator):
    from mioc_tpu.models.heat import HeatObj, construct_mesh
    from mioc_tpu.solvers.trm import TRMParameters
    from mioc_tpu.solvers.trm_device import trm_solve_device

    got = _same_on_every_rank(world4["device_heat"])
    ref = trm_solve_device(HeatObj(nt=16, mesh=construct_mesh(refinements=1)),
                           TRMParameters(**HEAT, maxiter=10), seed=0, use_pallas=False,
                           outer_chunk=None)
    for chunk in (None, 4):
        _assert_same_solve(got, ref, f"_{chunk}")


@pytest.mark.parametrize("speculative", [False, True])
def test_device_loop_sharded_fishing(world4, speculative):
    from mioc_tpu.models import LVMObj as JaxLVM
    from mioc_tpu.solvers.trm import TRMParameters
    from mioc_tpu.solvers.trm_device import trm_solve_device

    from mioc_tpu_torch.models import LVMObj
    from mioc_tpu_torch.utils.init import rand_func

    got = _same_on_every_rank(world4["device_fishing"])
    x0 = rand_func(LVMObj(nt=96, device="cpu"), seed=2)
    ref = trm_solve_device(JaxLVM(nt=96), TRMParameters(**PINF), x0=x0, use_pallas=False,
                           outer_chunk=None)
    _assert_same_solve(got, ref, f"_{speculative}")


@pytest.fixture(scope="module")
def jax_multistart():
    from mioc_tpu.models import LVMObj as JaxLVM
    from mioc_tpu.solvers.trm import TRMParameters
    from mioc_tpu.solvers.trm_device import multistart_solve_device

    from mioc_tpu_torch.models import LVMObj

    x0s = _starts(LVMObj(nt=MULTISTART_NT, device="cpu"), MULTISTART_S)
    return multistart_solve_device(JaxLVM(nt=MULTISTART_NT), TRMParameters(**PINF), x0s)


@pytest.mark.parametrize("world,shape,speculative", [
    (2, "2x1", False), (4, "2x2", False), (4, "2x2", True)])
def test_multistart_on_a_mesh(request, jax_multistart, world, shape, speculative):
    got = _same_on_every_rank(request.getfixturevalue(f"world{world}")[f"multistart_{shape}"])
    assert got[f"u_{speculative}"].shape[0] == MULTISTART_S
    _assert_same_solve(got, jax_multistart, f"_{speculative}")
    for f in ("f", "tv"):
        np.testing.assert_allclose(got[f"{f}_{speculative}"], np.asarray(getattr(jax_multistart, f)),
                                   rtol=1e-12)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5].split(","))
