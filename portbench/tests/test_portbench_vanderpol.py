"""Two single-start cells of the device loop: the Van der Pol deployment
(``vanderpol.device`` on ``vanderpol-nt2000``) and the canonical fishing
problem (``fishing.device`` on ``fishing-nt1024``).  The configuration
against the problem the program builds, the new reader, and small whole
runs on the CPU: correct as the program is, not correct for the float32
control, for an altered Euler step, for a chase that returns the current
path and for an altered answer."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness, run, starts  # noqa: E402
from portbench.reference import dp, vanderpol  # noqa: E402
from portbench.reference.levels import admissible_levels  # noqa: E402

# nt = 240 is the coarsest grid on which no start of the pool overflows (τ = 1/12).
SMALL = {"vanderpol.device": {"config": {"nt": 240}, "traffic": {"pool": 2}},
         "fishing.device": {"config": {"nt": 64}, "traffic": {"pool": 2}}}
CELLS = sorted(SMALL)


def small_run(cell, **extra):
    over = {k: dict(v) for k, v in SMALL[cell].items()}
    for part, d in extra.items():
        over.setdefault(part, {}).update(d)
    return run.run(cell, 2**33 + 21, 0.0, False, device="cpu", overrides=over)


def test_configuration_describes_the_programs_problem():
    from mioc_tpu_torch.models import registry
    from mioc_tpu_torch.utils.init import rand_func

    cell, cfg, traffic = harness.load_cell("vanderpol.device")
    assert (cell["config"], traffic["entry"], traffic["batch"]) == (
        "vanderpol-nt2000", "trm_solve_device", 1)
    preset = {k: (float("inf") if v == "inf" else v) for k, v in cfg["preset"].items()
              if k in ("beta", "delta0", "p")}
    assert preset == registry.get(cfg["program"]["problem"]).preset
    levels = admissible_levels(cfg["levels"])
    p = cfg["problem"]
    tau = (p["T1"] - p["T0"]) / cfg["nt"]
    assert len(levels) == cfg["sizes"]["L"] == 3 and levels.shape[1] == cfg["sizes"]["nx"]
    assert dp.halving_caps(cfg["preset"]["delta0"], tau, 40)[0] == cfg["sizes"]["B"] == 100
    nt = SMALL["vanderpol.device"]["config"]["nt"]
    obj = registry.build(cfg["program"]["problem"], nt, device="cpu")
    assert (obj.nt, obj.T0, obj.T1, obj.ny) == (nt, p["T0"], p["T1"], cfg["sizes"]["ny"])
    np.testing.assert_array_equal(obj.c, p["c"])
    np.testing.assert_array_equal(obj.state0.numpy(), p["state0"])
    np.testing.assert_array_equal(levels, obj.admissible.levels)
    for seed in (0, 5, 2**33 + 1):
        np.testing.assert_array_equal(starts.start(levels, nt, seed), rand_func(obj, seed=seed))
    ref = vanderpol.Model(dict(cfg, nt=nt))
    us = np.stack([starts.start(levels, nt, s) for s in range(3)])
    f, ys = obj._forward_batch(torch.as_tensor(us))
    df, _ = obj._adjoint_batch(torch.as_tensor(us), ys)
    np.testing.assert_allclose(f.numpy(), ref.value(us), rtol=1e-12)
    g = ref.gradient(us)
    assert np.abs(df.numpy() - g).max() <= 1e-12 * np.abs(g).max()


def test_new_reader_on_a_made_up_trace():
    read = harness.readers()["ode_sweep_ms.solve"]
    ms = 1e6  # ns
    spans = [("ode_sweep.f", 0, 2 * ms), ("ode_sweep.df", 3 * ms, 7 * ms),
             ("dp.build", 8 * ms, 18 * ms), ("ode_sweep.f", 20 * ms, 23 * ms)]
    ctx = {"e2e": "solve_s", "spans": spans, "window_s": 0.03, "busy_s": 0.01,
           "dp_device_s": 0.001, "dp_bound_s": 0.00002}
    assert read(ctx) == pytest.approx(3.0)
    assert read(dict(ctx, spans=spans[2:3])) is None      # no ODE sweep ran
    assert read(dict(ctx, e2e="starts_per_s")) is None     # the multistart cells' own metric


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell):
    r = small_run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] == SMALL[cell]["traffic"]["pool"]
    assert set(r["metrics"]) == {"solve_s", "setup_s"}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_float32_is_not_correct(cell):
    r = small_run(cell, config={"dtype": "float32"})
    assert not r["correct"]
    assert r["checks"]["f_rel"]["value"] > r["checks"]["f_rel"]["limit"]


def test_altered_euler_step_is_not_correct(monkeypatch):
    from mioc_tpu_torch.models import vanderpol as program

    real = program.VPOObj.__init__

    def longer_step(self, *a, **kw):
        # every Euler step of the states and the adjoints one part in 10⁶ too long
        real(self, *a, **kw)
        self._tau_t = self._tau_t * (1.0 + 1e-6)

    monkeypatch.setattr(program.VPOObj, "__init__", longer_step)
    r = small_run("vanderpol.device")
    assert not r["correct"]
    assert r["checks"]["f_rel"]["value"] > r["checks"]["f_rel"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_step_returning_its_state_is_not_correct(cell, monkeypatch):
    from mioc_tpu_torch.ops import bellman

    def own_path(btilde):
        return torch.argmin(btilde, dim=-1).to(torch.int32)

    monkeypatch.setattr(bellman, "backtrack_plain", lambda U, phi0, bt, B: own_path(bt))
    monkeypatch.setattr(bellman, "backtrack_batched_plain", lambda U, phi0, bt, B: own_path(bt))
    monkeypatch.setattr(bellman, "backtrack_trials_plain",
                        lambda U, phi0, bt, Bs: own_path(bt)[:, None].expand(
                            -1, Bs.shape[1], -1).contiguous())
    r = small_run(cell)
    assert not r["correct"]
    assert r["checks"]["stationary"]["value"] > r["checks"]["stationary"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_not_correct(cell, monkeypatch):
    from mioc_tpu_torch.solvers import trm_device

    real = trm_device.trm_solve_device

    def altered(*a, **kw):
        r = real(*a, **kw)
        u = np.array(r.u, copy=True)
        k = u.shape[-2] // 2
        u[..., k, :] = np.roll(u[..., k, :], 1, axis=-1)   # the next SOS1 mode
        return r._replace(u=u)

    monkeypatch.setattr(trm_device, "trm_solve_device", altered)
    r = small_run(cell)
    assert not r["correct"]
    assert r["checks"]["f_rel"]["value"] > r["checks"]["f_rel"]["limit"]
