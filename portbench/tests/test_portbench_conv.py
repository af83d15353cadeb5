"""Two cells beside the first ones: the signal-reconstruction
deployment (``conv.host`` on ``conv-nt2048``) and the 8-start heat search
(``heat.multistart8``).  The NumPy reference against the plain PyTorch one,
the configuration against the problem the program builds, the new readers,
and small whole runs on the CPU: correct as the program is, not correct for
the float32 control and for an altered answer."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from plainref.conv import Conv  # noqa: E402
from portbench import harness, run, starts  # noqa: E402
from portbench.reference import conv, dp  # noqa: E402
from portbench.reference.levels import admissible_levels  # noqa: E402

SMALL = {"conv.host": {"config": {"nt": 64}, "traffic": {"pool": 2}},
         "heat.multistart8": {"config": {"nt": 20}, "traffic": {"pool": 1, "batch": 4}}}
CELLS = sorted(SMALL)


def config(nt=None):
    cfg = harness.load_json("configs", "conv-nt2048.json")
    if nt is not None:
        cfg["nt"] = nt
    return cfg


def small_run(cell, **extra):
    over = {k: dict(v) for k, v in SMALL[cell].items()}
    for part, d in extra.items():
        over.setdefault(part, {}).update(d)
    return run.run(cell, 2**33 + 7, 0.0, False, device="cpu", overrides=over)


def test_numpy_copy_equals_the_torch_reference():
    cfg = config(96)
    ref, plain = conv.Model(cfg), Conv(cfg)
    np.testing.assert_array_equal(ref.K, plain.K.numpy())
    np.testing.assert_array_equal(ref.fhat, plain.fhat.numpy())
    M = np.diag(ref.mdiag) + ref.moff * (np.eye(97, k=1) + np.eye(97, k=-1))
    np.testing.assert_array_equal(M, plain.M.numpy())
    us = np.stack([starts.start(ref.levels, 96, s) for s in range(3)])
    np.testing.assert_allclose(ref.value(us), plain.value(us).numpy(), rtol=1e-13)
    g = plain.gradient(us).numpy()
    assert ref.gradient(us).shape == g.shape == (3, 96, 1)
    assert np.abs(ref.gradient(us) - g).max() <= 1e-13 * np.abs(g).max()


def test_configuration_describes_the_programs_problem():
    from mioc_tpu_torch.models import registry
    from mioc_tpu_torch.utils.init import rand_func

    cfg = config()
    preset = {k: (float("inf") if v == "inf" else v) for k, v in cfg["preset"].items()
              if k in ("beta", "delta0", "p")}
    assert preset == registry.get(cfg["program"]["problem"]).preset
    levels = admissible_levels(cfg["levels"])
    tau = (cfg["problem"]["T1"] - cfg["problem"]["T0"]) / cfg["nt"]
    assert len(levels) == cfg["sizes"]["L"] == 5 and levels.shape[1] == cfg["sizes"]["nx"]
    assert dp.halving_caps(cfg["preset"]["delta0"], tau, 40)[0] == cfg["sizes"]["B"] == 128
    nt = 64
    obj = registry.build(cfg["program"]["problem"], nt, device="cpu")
    assert (obj.nt, obj.T0, obj.T1, obj.omega0) == (nt, cfg["problem"]["T0"],
                                                    cfg["problem"]["T1"], cfg["problem"]["omega0"])
    np.testing.assert_array_equal(levels, obj.admissible.levels)
    for seed in (0, 5, 2**33 + 1):
        np.testing.assert_array_equal(starts.start(levels, nt, seed), rand_func(obj, seed=seed))
    ref = conv.Model(config(nt))
    np.testing.assert_allclose(ref.K, obj.K.numpy(), rtol=1e-14, atol=1e-17)
    us = np.stack([starts.start(levels, nt, s) for s in range(3)])
    f, _ = obj._forward_batch(torch.as_tensor(us))
    df, _ = obj._adjoint_batch(torch.as_tensor(us), None)
    np.testing.assert_allclose(f.numpy(), ref.value(us), rtol=1e-13)
    g = ref.gradient(us)
    assert np.abs(df.numpy() - g).max() <= 1e-13 * np.abs(g).max()


def test_new_readers_on_a_made_up_trace():
    read = harness.readers()
    ms = 1e6  # ns
    spans = [("conv_sweep.f", 0, 2 * ms), ("conv_sweep.df", 3 * ms, 7 * ms),
             ("dp.build", 8 * ms, 18 * ms), ("dp.chase", 20 * ms, 20.5 * ms),
             ("dp.chase", 21 * ms, 22.5 * ms)]
    ctx = {"e2e": "solve_s", "spans": spans, "window_s": 0.03, "busy_s": 0.01,
           "dp_device_s": 0.001, "dp_bound_s": 0.00002}
    assert read["conv_sweep_ms.solve"](ctx) == pytest.approx(3.0)
    assert read["chase_call_ms.solve"](ctx) == pytest.approx(1.0)
    assert read["pde_sweep_ms.solve"](ctx) is None
    assert read["pde_sweep_ms.multistart"](ctx) is None
    ctx["spans"] = [("pde_sweep.f", 0, 30 * ms), ("pde_sweep.df", 40 * ms, 50 * ms)]
    assert read["chase_call_ms.solve"](ctx) is None  # no chase ran
    assert read["conv_sweep_ms.solve"](ctx) is None
    ctx["e2e"] = "starts_per_s"
    assert read["pde_sweep_ms.multistart"](ctx) == pytest.approx(20.0)
    assert read["conv_sweep_ms.solve"](ctx) is None
    assert read["chase_call_ms.solve"](ctx) is None


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell):
    r = small_run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] == SMALL[cell]["traffic"].get("batch", 1) * \
        SMALL[cell]["traffic"]["pool"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_float32_is_not_correct(cell):
    r = small_run(cell, config={"dtype": "float32"})
    assert not r["correct"]
    assert r["checks"]["f_rel"]["value"] > r["checks"]["f_rel"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_not_correct(cell, monkeypatch):
    from mioc_tpu_torch.solvers import trm, trm_device

    def altered(u):
        u = np.array(u, copy=True)
        k = u.shape[-2] // 2
        # another admissible level: the next conv level down, the next heat pair
        u[..., k, :] = (np.where(u[..., k, :] > -2, u[..., k, :] - 1, 2) if u.shape[-1] == 1
                        else (u[..., k, :] + 1) % 6)
        return u

    for mod, name in ((trm, "trm_solve"), (trm_device, "multistart_solve_device")):
        real = getattr(mod, name)

        def wrapped(*a, _real=real, **kw):
            r = _real(*a, **kw)
            if hasattr(r, "_replace"):
                return r._replace(u=altered(r.u))
            r.u = altered(r.u)
            return r

        monkeypatch.setattr(mod, name, wrapped)
    r = small_run(cell)
    assert not r["correct"]
    assert r["checks"]["f_rel"]["value"] > r["checks"]["f_rel"]["limit"]
