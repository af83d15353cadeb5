"""``portbench/program_trace.py``: the innermost-span labels of the idle
gaps, the readers of the program's spans on made-up spans, and one
measurement of each cell on the CPU at small sizes."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from mioc_tpu_torch.utils.trace import Span  # noqa: E402

from portbench import program_trace as pt  # noqa: E402
from portbench import trace as tracing  # noqa: E402

SMALL = {"heat.device": {"config": {"nt": 20}, "traffic": {"pool": 2}},
         "fishing.multistart32": {"config": {"nt": 64}, "traffic": {"pool": 2, "batch": 4}}}


def spans_of(*rows):
    """Spans ``(name, t0, t1, attrs)`` nested by time, as the recorder makes them."""
    out, stack = [], []
    for i, (name, a, b, attrs) in enumerate(sorted(rows, key=lambda r: (r[1], -r[2]))):
        while stack and stack[-1].t1_ns <= a:
            stack.pop()
        top = stack[-1] if stack else None
        s = Span(i, None if top is None else top.id, i if top is None else top.call,
                 name, a, b, dict(attrs))
        out.append(s)
        stack.append(s)
    return out


def test_gap_takes_the_innermost_span():
    program = [("solve", 0, 100), ("trm.outer", 10, 90), ("trm.read", 20, 30),
               ("trm.stage", 40, 45), ("pde_sweep.f", 50, 80), ("trm.tv", 55, 60)]
    bench = [("pde_sweep.f", 49, 81)]
    gaps = [(21, 23), (41, 44), (46, 48), (56, 58), (62, 64), (85, 87), (95, 96), (101, 103)]
    got = pt.label_gaps_nested(gaps, bench + program)
    # (62, 64): after trm.tv has ended, inside the sweep: the sweep's, not the loop's.
    assert got == {"trm.read": 2, "trm.stage": 3, "loop": 2 + 2 + 1 + 2, "trm.tv": 2,
                   "pde_sweep.f": 2}
    # Today's labels pick the latest-starting span and fall to the loop.
    assert tracing.label_gaps([(62, 64)], bench + program) == {"loop": 2}
    assert pt.label_gaps_nested([], program) == {}
    assert pt.label_gaps_nested([(1, 3)], []) == {"loop": 2}


def test_flat_spans_keep_todays_labels():
    rng = np.random.default_rng(2**33 + 1)
    names = ["ode_sweep.f", "ode_sweep.df", "dp.build", "dp.chase"]
    for _ in range(20):
        cuts = np.sort(rng.choice(1000, size=16, replace=False)).reshape(-1, 2)
        spans = [(names[rng.integers(4)], int(a), int(b)) for a, b in cuts]
        g = np.sort(rng.choice(1000, size=20, replace=False)).reshape(-1, 2)
        gaps = [(a + 0.25, b + 0.25) for a, b in g.tolist()]  # no midpoint on a bound
        assert pt.label_gaps_nested(gaps, spans) == pytest.approx(
            tracing.label_gaps(gaps, spans))


def test_readers_on_made_up_spans():
    ms = 1_000_000
    spans = spans_of(
        ("solve", 0, 100 * ms, {"f_evals": 5, "df_evals": 2}),
        ("ode_sweep.f", 1 * ms, 5 * ms, {"rows": 1, "rows_swept": 1, "steps": 10}),
        ("trm.outer", 10 * ms, 50 * ms, {}),
        ("ode_sweep.df", 11 * ms, 21 * ms, {"rows": 1, "rows_swept": 1, "steps": 10}),
        ("dp.build", 22 * ms, 24 * ms, {}),
        ("ode_sweep.f", 25 * ms, 35 * ms, {"rows": 8, "rows_swept": 16, "steps": 10}),
        ("trm.read", 40 * ms, 48 * ms, {"what": "outer"}),
        ("trm.outer", 50 * ms, 70 * ms, {}),
        ("trm.read", 60 * ms, 61 * ms, {"what": "outer"}),
        ("trm.read", 95 * ms, 99 * ms, {"what": "result"}))
    assert pt.row_use(spans) == pytest.approx(100 * 7 / 18)
    # outer 1: 40 ms less 10 + 2 + 10 + 8 covered; outer 2: 20 ms less 1
    assert pt.loop_self_ms(spans) == pytest.approx((10 + 19) / 2)
    assert pt.host_wait_share(spans, 100 * ms) == pytest.approx(13.0)
    launches = np.array([2, 3, 12, 13, 14, 26, 45, 51]) * ms
    assert pt.launches_per_step(spans, launches, []) == (6 / 30, "launch records")
    assert pt.launches_per_step(spans, [], launches) == (6 / 30, "kernel starts")
    assert pt.launches_per_step(spans[:1], launches, []) == (None, None)
    assert pt.row_use(spans[:1]) is None and pt.host_wait_share(spans[:1], 1) is None
    assert pt.union_ns([(0, 4), (2, 6), (8, 9)]) == 7
    assert pt.union_ns([(0, 4), (2, 6)], lo=3, hi=5) == 2


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_measure_on_the_cpu(cell):
    r = pt.measure(cell, 2**31 + 13, untraced=1, device="cpu", overrides=SMALL[cell],
                   log=lambda msg: None)
    assert r["correct"], r["checks"]
    assert r["same_answers_untraced"]
    sfx = "solve" if cell == "heat.device" else "multistart"
    new = r["new"]
    assert new[f"sweep_launches_per_step.{sfx}"] is None  # no device trace on the CPU
    assert 0 < new[f"sweep_row_use.{sfx}"] < 100
    assert new[f"loop_self_ms.{sfx}"] > 0
    assert 0 < new[f"host_wait_share.{sfx}"] < 100
    assert r["spans_call2"]["solve"] == 1 and r["spans_call2"]["trm.outer"] >= 1
    assert f"loop_share.{sfx}" in r["per_layer_call1"]


def test_measure_reports_nothing_from_a_process_holding_jax(monkeypatch):
    from portbench import harness

    monkeypatch.setattr(harness, "loaded_forbidden", lambda: ["jax"])
    with pytest.raises(SystemExit, match="holds jax"):
        pt.measure("heat.device", 2**31 + 17, untraced=0, device="cpu",
                   overrides=SMALL["heat.device"], log=lambda msg: None)
