"""Runs of ``fishing.device`` and ``vanderpol.device`` on the card through
``run.py``'s path at a reduced pool and grid: every run is correct, and a
traced run reads every per-layer metric that ``BENCHMARK.json`` lists for
the cell, each within its range.  Marked ``cuda``; on a machine without a
card each test skips.

    python -m pytest --noconftest -m cuda portbench/tests -q
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402
from test_portbench_card import card, per_layer  # noqa: E402,F401  (the fixture, the listed metrics)

SMALL = {"fishing.device": {"config": {"nt": 256}, "traffic": {"pool": 2}},
         "vanderpol.device": {"config": {"nt": 480}, "traffic": {"pool": 1}}}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("traced", [False, True])
def test_device_cell_runs_correct_on_the_card(card, cell, traced):
    r = run.run(cell, 2**32 + 13, 0.0, traced, device="cuda", overrides=SMALL[cell])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0
    if not traced:
        assert set(r["metrics"]) == {"solve_s", "setup_s"}
        return
    assert per_layer(cell) <= set(r["metrics"])
    assert "ode_sweep_ms.solve" in r["metrics"]
    for name, m in r["metrics"].items():
        assert m["value"] > 0, name
        if m["unit"] == "%":
            assert m["value"] <= 100.0, name
    d = r["device"]
    assert 0 < d["busy_s"] <= d["window_s"]
    assert r["breakdown"]["device_ops"] and r["breakdown"]["idle_gaps"]
