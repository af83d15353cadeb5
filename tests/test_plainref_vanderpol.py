"""The plain PyTorch reference of the Van der Pol problem
(``plainref/vanderpol.py``): the port's ``VPOObj`` agrees with it on f and
∇f at float64, its NumPy copy that the benchmark's judge runs
(``portbench/reference/vanderpol.py``) agrees with it, its gradient is the
derivative of its f, and it imports nothing of the port or of JAX."""

import ast
import json
import os

import numpy as np
import pytest
import torch

from mioc_tpu_torch.models.registry import build
from mioc_tpu_torch.utils.init import rand_func
from plainref.vanderpol import VanDerPol
from portbench.reference import vanderpol as numpy_ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NT = 240
RTOL = 1e-12


def config(nt=NT):
    with open(os.path.join(ROOT, "portbench", "configs", "vanderpol-nt2000.json")) as fh:
        cfg = json.load(fh)
    cfg["nt"] = nt
    return cfg


@pytest.fixture(scope="module")
def ref():
    return VanDerPol(config())


@pytest.fixture(scope="module")
def obj():
    return build("vanderpol", NT, device="cpu")


def controls(obj, kind, seed):
    """Seeded admissible (a level at every step) or relaxed (in [0, 1]³) controls."""
    if kind == "admissible":
        return rand_func(obj, seed=seed)
    return np.random.default_rng(seed).random((NT, 3))


def rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("kind", ["admissible", "relaxed"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_agrees_with_the_plain_reference(ref, obj, kind, seed):
    u = controls(obj, kind, seed)
    x = torch.as_tensor(u)[None]
    f, ys = obj._forward_batch(x)
    df, _ = obj._adjoint_batch(x, ys)
    f_ref, g_ref = ref.value(u).item(), ref.gradient(u).numpy()
    # rounding: the port fuses multiply-adds (ops/xla_order.py) and sums the
    # cost by windows
    assert f.item() == pytest.approx(f_ref, rel=RTOL)
    assert rel(df[0].numpy(), g_ref) <= RTOL
    obj.x = obj.as_control(u)
    obj.eval_f_()
    obj.eval_df_()
    assert obj.f == pytest.approx(f_ref, rel=RTOL)
    assert rel(obj.df.numpy(), g_ref) <= RTOL


@pytest.mark.parametrize("kind", ["admissible", "relaxed"])
def test_numpy_copy_agrees_with_the_plain_reference(ref, obj, kind):
    us = np.stack([controls(obj, kind, s) for s in range(3)])
    model = numpy_ref.Model(config())
    assert model.tau == ref.tau and model.levels.shape == (3, 3)
    np.testing.assert_allclose(model.states(us), ref.states(us).numpy(), rtol=RTOL, atol=0)
    np.testing.assert_allclose(model.value(us), ref.value(us).numpy(), rtol=RTOL)
    g = ref.gradient(us).numpy()
    assert model.gradient(us).shape == g.shape == (3, NT, 3)
    assert rel(model.gradient(us), g) <= RTOL


@pytest.mark.parametrize("k", [0, 101, NT - 1])
def test_reference_gradient_matches_central_differences(ref, k):
    rng = np.random.default_rng(k)
    u = rng.random((NT, 3))
    e = 1e-5
    for m in range(3):
        up, um = u.copy(), u.copy()
        up[k, m] += e
        um[k, m] -= e
        fd = (ref.value(up) - ref.value(um)).item() / (2 * e) / ref.tau
        # f is smooth in u: the central difference is exact to O(e²)
        assert ref.gradient(u)[k, m].item() == pytest.approx(fd, rel=1e-6, abs=1e-9)


def test_the_coarse_grid_overflows_to_a_non_finite_f():
    # example_vanderpol.jl:3: explicit Euler on the unstable ODE may overflow
    cfg = config(64)
    ref, model = VanDerPol(cfg), numpy_ref.Model(cfg)
    u = rand_func(build("vanderpol", 64, device="cpu"), seed=0)   # τ = 0.3125
    assert not np.isfinite(ref.value(u).item())
    assert not np.isfinite(model.value(u[None])[0])


@pytest.mark.parametrize("path", ["plainref/vanderpol.py", "portbench/reference/vanderpol.py"])
def test_reference_imports_neither_jax_nor_the_port(path):
    with open(os.path.join(ROOT, path)) as fh:
        tree = ast.parse(fh.read())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module and n.level == 0}
    assert names <= {"__future__", "math", "numpy", "torch"}, names
    relative = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level > 0}
    assert relative <= {"levels"}, relative    # portbench/reference/levels.py alone


def test_reference_is_float64_without_tf32():
    had = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        r = VanDerPol(config(16))
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        assert r.c.dtype == r.y0.dtype == r.w.dtype == torch.float64
        assert r.states(np.zeros((16, 3))).shape == (17, 2) and r.tau == 20.0 / 16
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = had
