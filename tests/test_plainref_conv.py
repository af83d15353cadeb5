"""The plain PyTorch reference of the signal-reconstruction problem
(``plainref/conv.py``): the port's ``ConvObj`` agrees with it on f and ∇f,
its gradient is the derivative of its f, and it imports nothing of the port
or of JAX."""

import ast
import json
import os

import numpy as np
import pytest
import torch

from mioc_tpu_torch.models.registry import build
from mioc_tpu_torch.utils.init import rand_func
from plainref.conv import Conv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NT = 64


def config(nt=NT):
    with open(os.path.join(ROOT, "portbench", "configs", "conv-nt2048.json")) as fh:
        cfg = json.load(fh)
    cfg["nt"] = nt
    return cfg


@pytest.fixture(scope="module")
def ref():
    return Conv(config())


@pytest.fixture(scope="module")
def obj():
    return build("convolution", NT, device="cpu")


def test_operators_are_the_ports(ref, obj):
    np.testing.assert_allclose(ref.K.numpy(), obj.K.numpy(), rtol=1e-14, atol=1e-17)
    np.testing.assert_array_equal(ref.fhat.numpy(), obj.fvec.numpy())
    M = np.diag(obj._Mdiag.numpy()) + obj._Moff.item() * (np.eye(NT + 1, k=1) + np.eye(NT + 1, k=-1))
    np.testing.assert_array_equal(ref.M.numpy(), M)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_agrees_with_the_plain_reference(ref, obj, seed):
    u = rand_func(obj, seed=seed)
    x = torch.as_tensor(u)[None]
    f, _ = obj._forward_batch(x)
    df, _ = obj._adjoint_batch(x, None)
    f_ref, g_ref = ref.value(u).item(), ref.gradient(u).numpy()
    # rounding: the port sums in another order (16-row chunks, a pairwise fold)
    assert f.item() == pytest.approx(f_ref, rel=1e-13)
    assert np.abs(df[0].numpy() - g_ref).max() <= 1e-13 * np.abs(g_ref).max()
    obj.x = obj.as_control(u)
    obj.eval_f_()
    obj.eval_df_()
    assert obj.f == pytest.approx(f_ref, rel=1e-13)
    assert np.abs(obj.df.numpy() - g_ref).max() <= 1e-13 * np.abs(g_ref).max()


@pytest.mark.parametrize("k", [0, 17, NT - 1])
def test_reference_gradient_matches_central_differences(ref, k):
    rng = np.random.default_rng(k)
    u = rng.integers(-2, 3, (NT, 1)).astype(np.float64)
    e = 1e-3
    up, um = u.copy(), u.copy()
    up[k, 0] += e
    um[k, 0] -= e
    fd = (ref.value(up) - ref.value(um)).item() / (2 * e)
    # f is quadratic in u: the central difference is exact up to rounding
    assert ref.gradient(u)[k, 0].item() == pytest.approx(fd, rel=1e-8, abs=1e-12)


def test_reference_imports_neither_jax_nor_the_port():
    with open(os.path.join(ROOT, "plainref", "conv.py")) as fh:
        tree = ast.parse(fh.read())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module and n.level == 0}
    assert names <= {"__future__", "math", "numpy", "torch"}, names
    assert not any(isinstance(n, ast.ImportFrom) and n.level > 0 for n in ast.walk(tree))


def test_reference_is_float64_without_tf32():
    had = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        r = Conv(config(16))
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        assert r.K.dtype == r.M.dtype == r.fhat.dtype == torch.float64
        assert r.K.shape == (17, 16) and r.M.shape == (17, 17)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = had
