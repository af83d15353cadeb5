"""The program's spans (``mioc_tpu_torch/utils/trace.py``) on
the CPU at small sizes: off, nothing is recorded; on, no result changes by a
bit; the spans nest as the solves run, one ``call`` per solve; and the sweep
spans' rows add up to the evaluations the solves report."""

import numpy as np
import pytest
import torch

from mioc_tpu_torch.models import LVMObj
from mioc_tpu_torch.models.heat import HeatObj, construct_mesh
from mioc_tpu_torch.solvers.trm import TRMParameters, trm_solve
from mioc_tpu_torch.solvers.trm_device import (DeviceTRMResult, make_device_trm,
                                               multistart_solve_device, trm_solve_device)
from mioc_tpu_torch.utils import trace
from mioc_tpu_torch.utils.init import rand_func

NT = 64
PAR = TRMParameters(beta=1e-4, delta0=2, p=np.inf)
HOST_FIELDS = ("J", "u", "x_final", "converged", "iterations", "inner_steps", "f_evals",
               "df_evals", "tv", "f", "dp_builds")

# The spans each span may open inside: the table of utils/trace.py.
PARENTS = {
    "solve": {None},
    "trm.outer": {"solve"},
    "trm.read": {"solve", "trm.outer"},
    "trm.stage": {"trm.outer"},
    "trm.tv": {"solve", "trm.outer"},
    "ode_sweep.f": {"solve", "trm.outer"},
    "ode_sweep.df": {"solve", "trm.outer"},
    "dp.build": {"trm.outer"},
    "dp.chase": {"trm.outer"},
}


@pytest.fixture(autouse=True)
def _fresh_recorder():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x0s(n):
    obj = LVMObj(nt=NT, device="cpu")
    return np.stack([rand_func(obj, seed=s) for s in range(n)])


SOLVES = {
    "host": lambda x0s: trm_solve(LVMObj(nt=NT, device="cpu"), PAR, x0=x0s[0]),
    "device": lambda x0s: trm_solve_device(LVMObj(nt=NT, device="cpu"), PAR, x0=x0s[0]),
    "multistart_speculative": lambda x0s: multistart_solve_device(
        LVMObj(nt=NT, device="cpu"), PAR, x0s, speculative=True),
    "multistart_sequential": lambda x0s: multistart_solve_device(
        LVMObj(nt=NT, device="cpu"), PAR, x0s, speculative=False),
}


def _fields(res):
    names = DeviceTRMResult._fields if isinstance(res, DeviceTRMResult) else HOST_FIELDS
    return {n: np.asarray(getattr(res, n)) for n in names}


def _traced(name, x0s):
    trace.enable()
    res = SOLVES[name](x0s)
    trace.disable()
    return res, trace.take()


def test_off_records_nothing():
    assert not trace.enabled()
    assert trace.span("a", rows=1) is trace.span("b")  # one shared no-op context
    x0s = _x0s(3)
    for name in SOLVES:
        SOLVES[name](x0s)
    assert trace.take() == []


def test_spans_take_attributes_and_take_clears():
    trace.enable()
    with trace.span("outer", rows=2) as sp:
        with trace.span("inner"):
            pass
        sp.set(k=1)
    trace.disable()
    with trace.span("off"):
        pass
    spans = trace.take()
    outer = spans[0]
    assert [(s.name, s.parent, s.call, s.attrs) for s in spans] == [
        ("outer", None, outer.id, {"rows": 2, "k": 1}), ("inner", outer.id, outer.id, {})]
    assert trace.take() == []


def test_annotate_sets_the_innermost_open_span():
    trace.annotate(k=0)  # off: nothing
    trace.enable()
    trace.annotate(k=1)  # no span open: nothing
    with trace.span("outer"):
        with trace.span("inner"):
            trace.annotate(ctas=16)
        trace.annotate(k=2)
    trace.disable()
    assert [(s.name, s.attrs) for s in trace.take()] == [
        ("outer", {"k": 2}), ("inner", {"ctas": 16})]


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_results_are_bit_identical_with_tracing_on(name):
    x0s = _x0s(3)
    off = _fields(SOLVES[name](x0s))
    on, spans = _traced(name, x0s)
    assert spans
    on = _fields(on)
    for k in off:
        assert np.array_equal(off[k], on[k]), k


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_spans_nest_in_one_call_per_solve(name):
    x0s = _x0s(3)
    trace.enable()
    SOLVES[name](x0s)
    SOLVES[name](x0s)
    trace.disable()
    spans = trace.take()
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["solve", "solve"]
    assert len({s.call for s in spans}) == 2
    for s in spans:
        parent = by_id.get(s.parent)
        assert (None if parent is None else parent.name) in PARENTS[s.name], (s.name, parent)
        assert s.t0_ns <= s.t1_ns
        if parent is not None:
            assert parent.t0_ns <= s.t0_ns and s.t1_ns <= parent.t1_ns
            assert s.call == parent.call
        else:
            assert s.call == s.id
    names = {s.name for s in spans}
    assert {"solve", "trm.outer", "trm.stage", "ode_sweep.f", "ode_sweep.df", "dp.build",
            "dp.chase"} <= names
    if name != "host":
        assert {"trm.read", "trm.tv"} <= names
        reads = {s.attrs["what"] for s in spans if s.name == "trm.read"}
        expect = {"device": {"outer", "segment", "result"},  # outer_chunk="auto"
                  "multistart_sequential": {"outer", "inner", "result"},
                  "multistart_speculative": {"outer", "result"}}
        assert reads == expect[name]


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_solve_span_counts_the_result(name):
    x0s = _x0s(3)
    res, spans = _traced(name, x0s)
    (solve,) = [s for s in spans if s.name == "solve"]
    assert solve.attrs == {"f_evals": int(np.sum(res.f_evals)),
                           "df_evals": int(np.sum(res.df_evals))}
    for s in spans:
        if s.name.startswith("ode_sweep."):
            assert s.attrs["steps"] == NT and s.attrs["rows_swept"] == s.attrs["rows"]
        if s.name.startswith("dp.") or (s.name.startswith("trm.") and s.name != "trm.read"):
            assert s.attrs == {}, s.name


def test_host_loop_sweeps_every_row_it_counts():
    x0s = _x0s(1)
    _, spans = _traced("host", x0s)
    (solve,) = [s for s in spans if s.name == "solve"]
    swept = sum(s.attrs["rows_swept"] for s in spans if s.name.startswith("ode_sweep."))
    assert swept == solve.attrs["f_evals"] + solve.attrs["df_evals"]  # 100% row use


def test_host_loop_timers_fit_in_the_solve_span():
    x0s = _x0s(1)
    res, spans = _traced("host", x0s)
    (solve,) = [s for s in spans if s.name == "solve"]
    assert set(res.timings) == {"dp", "backtrack", "f", "df"}
    assert 0 < sum(res.timings.values()) <= (solve.t1_ns - solve.t0_ns) / 1e9


def test_multistart_sweeps_rows_it_does_not_count():
    x0s = _x0s(3)
    _, spans = _traced("multistart_speculative", x0s)
    (solve,) = [s for s in spans if s.name == "solve"]
    K = make_device_trm(LVMObj(nt=NT, device="cpu"), PAR, speculative=True).K
    waves = [s.attrs["rows"] for s in spans if s.name == "ode_sweep.f" and s.parent != solve.id]
    assert waves and set(waves) == {3 * K}  # every start's K trials, stopped starts too
    swept = sum(s.attrs["rows_swept"] for s in spans if s.name.startswith("ode_sweep."))
    assert swept > solve.attrs["f_evals"] + solve.attrs["df_evals"]


def test_heat_wave_is_padded_to_the_chunk():
    # nt = 40 steps of 0.25 and Δ⁰ = 16: B = 64, a wave of K = 8 trials.
    obj = HeatObj(nt=40, mesh=construct_mesh(refinements=1), device="cpu")
    trace.enable()
    par = TRMParameters(beta=1e-3, delta0=16, p=2, maxiter=1)
    trm_solve_device(obj, par, seed=0)
    trace.disable()
    spans = trace.take()
    assert make_device_trm(obj, par, speculative=True).K == 8
    sweeps = [(s.name, s.attrs["rows"], s.attrs["rows_swept"], s.attrs["steps"])
              for s in spans if s.name.startswith("pde_sweep.")]
    assert sweeps == [("pde_sweep.f", 1, 16, 40), ("pde_sweep.df", 1, 16, 40),
                      ("pde_sweep.f", 8, 16, 40)]
