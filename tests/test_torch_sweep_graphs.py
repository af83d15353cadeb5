"""CUDA graphs of the Van der Pol sweeps (``mioc_tpu_torch/ops/graphs.py``):
a replayed sweep has the bits of the sweep run op by op, at every row count,
precision and ``sweep_unroll``; a caller's answers survive later replays;
a device-loop solve captures each shape once, in its first iteration; on the
CPU nothing is captured.

The CPU tests run everywhere; those marked ``cuda`` ask the ``cuda_device``
fixture, which skips without a card.  This file imports neither JAX nor
``mioc_tpu``::

    python -m pytest --noconftest -m cuda tests/test_torch_sweep_graphs.py -q
"""

import numpy as np
import pytest
import torch

from mioc_tpu_torch.models.vanderpol import VPOObj
from mioc_tpu_torch.ops.graphs import SweepGraphs
from mioc_tpu_torch.solvers.trm import TRMParameters
from mioc_tpu_torch.solvers.trm_device import trm_solve_device

PRESET = dict(beta=0.1, delta0=1.0, p=np.inf)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _controls(obj, rows, seed):
    """``rows`` controls: admissible levels, then relaxed ones on the simplex."""
    rng = np.random.default_rng(seed)
    levels = np.asarray(obj.admissible.levels, dtype=np.float64)
    out = [levels[rng.integers(0, len(levels), size=obj.nt)] for _ in range((rows + 1) // 2)]
    out += [rng.dirichlet(np.ones(obj.nx), size=obj.nt) for _ in range(rows // 2)]
    return torch.as_tensor(np.stack(out), dtype=obj.dtype, device=obj.device)


def _eager(obj, xs):
    """Both sweeps op by op, past the graphs."""
    cu = obj._cu(xs)
    f, ys = obj._forward_steps(cu)
    df, lam = obj._adjoint_steps(xs, cu, ys)
    return f, ys, df, lam


def _graphed(obj, xs):
    f, ys = obj._forward_batch(xs)
    df, lam = obj._adjoint_batch(xs, ys)
    return f, ys, df, lam


def _same_bits(a, b):
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y), (x - y).abs().max()


@pytest.mark.parametrize("rows", [1, 3])
def test_cpu_sweeps_capture_nothing(rows):
    obj = VPOObj(nt=64, device="cpu")
    xs = _controls(obj, rows, 0)
    _same_bits(_graphed(obj, xs), _eager(obj, xs))
    _graphed(obj, xs)
    assert len(obj._graphs) == 0


def test_cpu_graphs_call_through():
    calls = []

    def fn(a, b):
        calls.append(1)
        return a + b, a * b

    graphs = SweepGraphs()
    a, b = torch.arange(3.0), torch.ones(3)
    for _ in range(2):
        s, p = graphs(fn, a, b, key=1)
        assert torch.equal(s, a + b) and torch.equal(p, a)
    assert len(calls) == 2 and len(graphs) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("rows", [1, 8])
def test_replayed_sweeps_have_the_eager_bits(cuda_device, dtype, rows):
    obj = VPOObj(nt=2000, device=cuda_device, dtype=dtype)
    first = None
    for seed in range(3):  # capture, then two replays on other controls
        xs = _controls(obj, rows, seed)
        got = _graphed(obj, xs)
        _same_bits(got, _eager(obj, xs))
        assert all(torch.isfinite(t).all() for t in got)
        if first is None:
            first, kept = got, tuple(t.clone() for t in got)
    _same_bits(first, kept)  # a later replay leaves an earlier answer alone
    assert len(obj._graphs) == 2


@pytest.mark.cuda
def test_each_unroll_has_its_own_adjoint_graph(cuda_device):
    obj = VPOObj(nt=240, device=cuda_device)
    xs = _controls(obj, 2, 5)
    for unroll in (8, 4, 8, 4):
        obj.sweep_unroll = unroll
        obj._build()
        _same_bits(_graphed(obj, xs), _eager(obj, xs))
    assert len(obj._graphs) == 3  # one forward, an adjoint per unroll


@pytest.mark.cuda
def test_a_device_solve_captures_each_shape_once(cuda_device):
    obj = VPOObj(nt=480, device=cuda_device)
    par = TRMParameters(**PRESET, maxiter=4)
    first = trm_solve_device(obj, par, seed=0)
    # f at one row (the start) and at the wave's rows, ∇f at one row
    assert len(obj._graphs) == 3
    again = trm_solve_device(obj, par, seed=0)
    assert len(obj._graphs) == 3
    np.testing.assert_array_equal(np.asarray(again.u), np.asarray(first.u))
    assert float(first.J) == float(again.J)
    fresh = trm_solve_device(VPOObj(nt=480, device="cpu"), par, seed=0)
    assert int(fresh.iterations) == int(first.iterations)
    np.testing.assert_array_equal(np.asarray(fresh.u), np.asarray(first.u))
