"""The benchmark's own arithmetic: the window, the idle union and its gaps,
the roofline counts and the per-layer readers."""

import os
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness, peaks  # noqa: E402
from portbench import trace as tracing  # noqa: E402


def test_union_and_gaps():
    s = [0, 2, 3, 10, 11]
    e = [1, 5, 4, 12, 13]
    assert tracing.union_seconds(s, e, 0, 20) == 1 + 3 + 3
    assert tracing.union_seconds(s, e, 3, 11) == 2 + 1
    assert tracing.union_seconds([], [], 0, 5) == 0.0
    assert tracing.idle_gaps(s, e, 0, 20) == [(1, 2), (5, 10), (13, 20)]
    assert tracing.idle_gaps(s, e, -1, 12.5) == [(-1, 0), (1, 2), (5, 10)]
    assert tracing.idle_gaps([], [], 0, 2) == [(0, 2)]
    busy = tracing.union_seconds(s, e, 0, 20)
    assert busy + sum(b - a for a, b in tracing.idle_gaps(s, e, 0, 20)) == 20


def test_gaps_labelled_by_the_host_span():
    gaps = [(1, 2), (5, 10), (13, 20)]
    spans = [("ode_sweep.f", 0, 3), ("dp.build", 9, 11)]
    # (5, 10) has its midpoint 7.5 outside both spans: the loop.
    assert tracing.label_gaps(gaps, spans) == {"ode_sweep.f": 1, "loop": 12}
    assert tracing.label_gaps(gaps, []) == {"loop": 13}
    assert tracing.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0], ["c", 2.0]]


def test_build_and_chase_work_counts():
    # fishing: nt=4, L=3, B=2, every b̃ ≤ smax = 2
    bt = np.array([[[0, 2, 2], [2, 0, 2], [0, 2, 2], [2, 2, 0]]])
    nbytes, ops = peaks.build_work(bt, 3, 2, 2, 8, 1)
    # feasible outputs per (step, l): B + 1 − b̃ over the 3 relaxed steps
    valid = sum(max(3 - b, 0) for row in bt[0, :-1] for b in row)
    total = 3 * 3 * 3
    assert ops == valid * 2 * 3 + (total - valid)
    assert nbytes == 4 * 3 * (8 + 4) + 3 * 3 * 3 * 1 + 3 * 3 * 8 + 3 * 3 * 8
    nbytes, ops = peaks.chase_work(4, 3, 2, 8, 1, sets=2, rows=6)
    assert nbytes == 2 * 3 * 3 * 8 + 6 * (3 * 5 + 4 * 4 + 4)
    assert ops == 6 * (3 * 3 + 3)
    assert peaks.bound_s(3.35e12, 0, "float64") == pytest.approx(1.0)
    assert peaks.bound_s(0, 34e12, "float64") == pytest.approx(1.0)


def test_readers_on_a_made_up_trace():
    read = harness.readers()
    ms = 1e6  # ns
    spans = [("ode_sweep.f", 0, 40 * ms), ("ode_sweep.df", 50 * ms, 150 * ms),
             ("dp.build", 150 * ms, 151 * ms), ("dp.chase", 160 * ms, 160.5 * ms)]
    ctx = {"e2e": "solve_s", "spans": spans, "window_s": 0.2, "busy_s": 0.05,
           "dp_device_s": 0.001, "dp_bound_s": 0.00002}
    assert read["ode_sweep_ms.multistart"](ctx) is None
    assert read["pde_sweep_ms.solve"](ctx) is None
    assert read["dp_roofline.solve"](ctx) == pytest.approx(2.0)
    assert read["loop_share.solve"](ctx) == pytest.approx(100 * (0.2 - 0.1415) / 0.2)
    assert read["idle_share.solve"](ctx) == pytest.approx(75.0)
    assert read["idle_share.multistart"](ctx) is None
    ctx["spans"] = [("pde_sweep" + n[len("ode_sweep"):], a, b) if n.startswith("ode") else
                    (n, a, b) for n, a, b in spans]
    assert read["pde_sweep_ms.solve"](ctx) == pytest.approx(70.0)
    ctx.update(e2e="starts_per_s", dp_device_s=0.0, spans=spans)
    assert read["dp_roofline.multistart"](ctx) is None  # nothing to read: no DP kernel ran
    assert read["ode_sweep_ms.multistart"](ctx) == pytest.approx(70.0)


class _FakeProgram:
    """Calls that take a fixed time per start index."""

    def __init__(self, seconds_per_call):
        self.t = seconds_per_call
        self.calls = []

    def sync(self):
        pass

    def solve(self, x0s):
        self.calls.append(int(x0s[0, 0, 0]))
        time.sleep(self.t[int(x0s[0, 0, 0])])
        return [dict(converged=True)] * len(x0s)


def test_window_runs_whole_passes():
    pool = [np.full((2, 1, 1), j, float) for j in range(3)]
    prog = _FakeProgram([0.01, 0.02, 0.03])
    t0, t1, calls, answers, failed = harness.window(prog, pool, 2**40 + 3, 0.07)
    # one pass takes 0.06 s < 0.07 s: a second whole pass, then the window closes
    assert calls == 6 and len(answers) == 12 and failed == 0
    assert sorted(prog.calls[:3]) == [0, 1, 2] and sorted(prog.calls[3:]) == [0, 1, 2]
    assert t1 - t0 >= 0.12
    prog2 = _FakeProgram([0.01, 0.02, 0.03])
    harness.window(prog2, pool, 2**40 + 3, 0.07)
    assert prog2.calls == prog.calls  # the seed fixes the order


def test_window_counts_a_call_that_raises():
    class Raising(_FakeProgram):
        def solve(self, x0s):
            if int(x0s[0, 0, 0]) == 1:
                raise RuntimeError("boom")
            return super().solve(x0s)

    pool = [np.full((2, 1, 1), j, float) for j in range(2)]
    _, _, calls, answers, failed = harness.window(Raising([0.0, 0.0]), pool, 1, 0.0)
    assert calls == 1 and len(answers) == 2 and failed == 2


def test_traced_window_runs_one_call():
    pool = [np.full((1, 1, 1), j, float) for j in range(3)]
    prog = _FakeProgram([0.0, 0.0, 0.0])
    _, _, calls, answers, _ = harness.window(prog, pool, 7, 100.0, max_calls=1)
    assert calls == 1 and len(answers) == 1
