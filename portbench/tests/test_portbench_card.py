"""Runs on the card at small sizes: every cell's run is correct, and a traced
run reads every per-layer metric the cell lists, each within its range
(``fishing.host``, left out of ``BENCHMARK.json``, runs here too).
Marked ``cuda``; on a machine without a card each test skips.

    python -m pytest --noconftest -m cuda portbench/tests -q
"""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402

SMALL = {"fishing.host": {"config": {"nt": 128}, "traffic": {"pool": 2}},
         "heat.device": {"config": {"nt": 40}, "traffic": {"pool": 2}},
         "fishing.multistart32": {"config": {"nt": 128}, "traffic": {"pool": 2, "batch": 8}}}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run only on the card")
    return torch


def per_layer(cell):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    return {m["name"] for m in spec["per_layer"] if cell in m["workloads"]}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_correct_on_the_card(card, cell, traced):
    r = run.run(cell, 2**32 + 5, 0.0, traced, device="cuda", overrides=SMALL[cell])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0
    if not traced:
        return
    assert per_layer(cell) <= set(r["metrics"])
    for name, m in r["metrics"].items():
        assert m["value"] > 0, name
        if m["unit"] == "%":
            assert m["value"] <= 100.0, name
    d = r["device"]
    assert 0 < d["busy_s"] <= d["window_s"]
    assert r["breakdown"]["device_ops"] and r["breakdown"]["idle_gaps"]
