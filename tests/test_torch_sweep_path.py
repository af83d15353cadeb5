"""The ``path`` attribute of the program's sweep spans
(``mioc_tpu_torch/utils/trace.py``): ``"kernel"`` where one hand-written
launch computed the sweep's recursion (fishing's ``ops/ode_cuda.py``, the
dense heat sweep's ``ops/pde_cuda.py``), ``"torch"`` otherwise; and a traced
solve opens no more spans and reads the card no more often than the spans
themselves account for.

The CPU tests run everywhere; those marked ``cuda`` ask the ``cuda_device``
fixture, which skips without a card.  This file imports neither JAX nor
``mioc_tpu``::

    python -m pytest --noconftest -m cuda tests/test_torch_sweep_path.py -q
"""

import collections

import numpy as np
import pytest
import torch

from mioc_tpu_torch.models.heat import HeatObj, construct_mesh
from mioc_tpu_torch.models.registry import build
from mioc_tpu_torch.solvers.trm import TRMParameters
from mioc_tpu_torch.solvers.trm_device import trm_solve_device
from mioc_tpu_torch.utils import trace

# (problem, nt, preset): coarse grids on which the seed-0 start stays finite.
PROBLEMS = {
    "vanderpol": (240, dict(beta=0.1, delta0=1.0, p=np.inf)),
    "fishing": (64, dict(beta=1e-4, delta0=2.0, p=np.inf)),
    "convolution": (64, dict(beta=1e-4, delta0=0.125, p=1)),
}
ITERATIONS = 3
# The host reads a solve can make: each ends in a wait for the card.
READS = ("__bool__", "__float__", "__int__", "item", "tolist", "cpu", "numpy")


@pytest.fixture(autouse=True)
def _fresh_recorder():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _objective(name, device):
    if name == "heat":
        return HeatObj(nt=40, mesh=construct_mesh(refinements=1), device=device), \
            dict(beta=1e-3, delta0=16.0, p=2)
    nt, preset = PROBLEMS[name]
    return build(name, nt, device=device), preset


def _solve(name, device, traced):
    obj, preset = _objective(name, device)
    par = TRMParameters(**preset, maxiter=ITERATIONS)
    if traced:
        trace.enable()
    res = trm_solve_device(obj, par, seed=0)
    trace.disable()
    return res, trace.take()


def _sweep_paths(spans):
    return collections.Counter((s.name, s.attrs["path"]) for s in spans
                               if s.name.split(".")[0].endswith("_sweep"))


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_cpu_sweeps_are_torch(name):
    _, spans = _solve(name, "cpu", True)
    paths = _sweep_paths(spans)
    assert paths and {p for _, p in paths} == {"torch"}, paths


def _count_reads(monkeypatch, device):
    counts = collections.Counter()
    for attr in READS:
        real = getattr(torch.Tensor, attr)

        def counted(self, *a, _real=real, _attr=attr, **kw):
            if self.device.type == device:
                counts[_attr] += 1
            return _real(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, attr, counted)
    if device == "cuda":
        real_sync = torch.cuda.synchronize

        def sync(*a, **kw):
            counts["synchronize"] += 1
            return real_sync(*a, **kw)

        monkeypatch.setattr(torch.cuda, "synchronize", sync)
    return counts


def _same_reads_and_spans(name, device, monkeypatch):
    counts = _count_reads(monkeypatch, device)
    plain, _ = _solve(name, device, False)
    untraced = collections.Counter(counts)
    counts.clear()
    traced, spans = _solve(name, device, True)
    assert counts == untraced and sum(untraced.values()) > 0, (counts, untraced)
    # the same solve, the same sweeps: one span a sweep call, no other span opened
    assert int(traced.iterations) == int(plain.iterations)
    names = collections.Counter(s.name for s in spans)
    assert names["solve"] == 1 and names["trm.outer"] == int(traced.iterations)
    layer = next(s.name.split(".")[0] for s in spans if s.name.endswith("_sweep.f"))
    f_rows = sum(s.attrs["rows"] for s in spans if s.name == f"{layer}.f")
    assert names[f"{layer}.df"] == int(traced.df_evals)
    assert f_rows >= int(traced.f_evals)
    assert set(names) <= {"solve", "trm.outer", "trm.read", "trm.stage", "trm.tv",
                          f"{layer}.f", f"{layer}.df", "dp.build", "dp.chase"}, names


@pytest.mark.parametrize("name", ["vanderpol", "fishing"])
def test_tracing_adds_no_host_read_on_the_cpu(name, monkeypatch):
    _same_reads_and_spans(name, "cpu", monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("name,path", [("fishing", "kernel"), ("heat", "kernel"),
                                       ("vanderpol", "torch")])
def test_card_sweep_paths(cuda_device, name, path):
    _, spans = _solve(name, cuda_device, True)
    paths = _sweep_paths(spans)
    assert paths and {p for _, p in paths} == {path}, paths


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fishing", "heat", "vanderpol"])
def test_tracing_adds_no_host_read_on_the_card(cuda_device, name, monkeypatch):
    _same_reads_and_spans(name, cuda_device, monkeypatch)
