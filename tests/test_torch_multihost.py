"""``init_multihost`` in two processes, the mesh's errors and the JAX
positions of ``mesh``/``dp_backend``, and the sharded route in a world of
one (no process group initialized by the caller).

The two-process world and the world-of-one solve run in child processes
that import only torch, numpy and the port, joined under a timeout.
"""

import dataclasses
import inspect
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT = 120

_TWO = """
import sys, torch, torch.distributed as dist
from mioc_tpu_torch.parallel import init_multihost
rank, store = int(sys.argv[1]), sys.argv[2]
first = init_multihost("file://" + store, 2, rank)
again = init_multihost("file://" + store, 2, rank)
try:
    init_multihost(num_processes=3)
    wrong = "no error"
except RuntimeError as e:
    wrong = str(e)
print("RESULT", first, again, dist.get_backend(), wrong, flush=True)
dist.barrier()  # neither rank leaves while the other still talks to it
dist.destroy_process_group()
"""

_ONE = """
import json, numpy as np, torch, torch.distributed as dist
from mioc_tpu_torch.models import LVMObj
from mioc_tpu_torch.solvers.trm import TRMParameters, trm_solve
assert not dist.is_initialized()
out = {}
for backend in ("scan", "sharded"):
    r = trm_solve(LVMObj(nt=64, device="cpu"),
                  TRMParameters(beta=1e-4, delta0=2.0, p=np.inf, dp_backend=backend), seed=0)
    out[backend] = dict(J=r.J, iterations=r.iterations, inner=r.inner_steps,
                        u=r.u.tolist(), dp_builds=r.dp_builds)
out["world"] = [dist.get_world_size(), dist.get_backend()]
print("RESULT", json.dumps(out), flush=True)
"""


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MASTER_", "WORLD_SIZE", "RANK", "LOCAL_"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])))
    return env


def _run(code, args, n, tmp):
    procs = [subprocess.Popen([sys.executable, "-c", code, *[a.format(r=r) for a in args]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=_env(), cwd=tmp) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"processes did not finish within {TIMEOUT} s")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [next(ln[len("RESULT "):] for ln in out.splitlines() if ln.startswith("RESULT"))
            for out in outs]


def test_init_multihost_two_processes(tmp_path):
    lines = _run(_TWO, ["{r}", str(tmp_path / "store")], 2, tmp_path)
    for rank, line in enumerate(lines):
        assert line.startswith(f"({rank}, 2) ({rank}, 2) gloo "), line  # no CUDA: gloo
        assert "already initialized, not 3" in line


def test_default_backend(monkeypatch):
    from mioc_tpu_torch.parallel.multihost import default_backend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert default_backend(1) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert default_backend(1) == "nccl"
    assert default_backend(4) == "gloo"  # four ranks share the card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert default_backend(4) == "nccl"


def test_sharded_solve_in_a_world_of_one(tmp_path):
    out = json.loads(_run(_ONE, [], 1, tmp_path)[0])
    assert out["world"] == [1, "gloo"]
    assert out["sharded"] == out["scan"]


def test_make_device_mesh_errors_are_jax_errors():
    import jax
    from mioc_tpu.parallel import make_device_mesh as jmesh

    from mioc_tpu_torch.parallel import make_device_mesh
    from mioc_tpu_torch.parallel.device_mesh import ensure_world

    world = ensure_world("cpu")
    jdevs = jax.devices()[:world]
    for kw in (dict(level=world + 1), dict(batch=world + 1, level=1),
               dict(batch=1, level=world + 1)):
        with pytest.raises(ValueError) as want:
            jmesh(devices=jdevs, **kw)
        with pytest.raises(ValueError, match=str(want.value)):
            make_device_mesh(device_type="cpu", **kw)
    mesh = make_device_mesh(device_type="cpu")
    assert mesh.shape == {"batch": world, "level": 1}
    assert mesh.axis_names == ("batch", "level")


def test_mesh_and_dp_backend_at_the_jax_positions():
    from mioc_tpu.solvers import trm as jtrm
    from mioc_tpu.solvers import trm_device as jdev

    from mioc_tpu_torch.solvers import trm as ttrm
    from mioc_tpu_torch.solvers import trm_device as tdev

    fields = [f.name for f in dataclasses.fields(ttrm.TRMParameters)]
    assert fields == [f.name for f in dataclasses.fields(jtrm.TRMParameters)]
    assert fields.index("mesh") == fields.index("dp_backend") + 1
    for name in ("make_device_trm", "trm_solve_device", "multistart_solve_device"):
        port = list(inspect.signature(getattr(tdev, name)).parameters)
        jax_ = list(inspect.signature(getattr(jdev, name)).parameters)
        assert port == jax_, name


def test_parallel_exports_the_jax_names():
    from mioc_tpu import parallel as jpar

    from mioc_tpu_torch import parallel as tpar

    assert sorted(tpar.__all__) == sorted(jpar.__all__)
    for name in tpar.__all__:
        assert callable(getattr(tpar, name))
