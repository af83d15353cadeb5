"""The plain reference: its DP against brute force, its f and gradient
against finite differences, and its problems against the program's on the
CPU at small sizes."""

import itertools
import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import starts  # noqa: E402
from portbench.reference import dp, fishing, heat  # noqa: E402
from portbench.reference.levels import admissible_levels, jump_costs, max_budget_use  # noqa: E402
from portbench.reference.tv import tv_p  # noqa: E402

CONFIGS = os.path.join(ROOT, "portbench", "configs")


def config(name, **over):
    with open(os.path.join(CONFIGS, f"{name}.json")) as fh:
        cfg = json.load(fh)
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("p", [np.inf, 1, 2])
@pytest.mark.parametrize("V,sums", [([[0, 1]] * 3, [1, 1]), ([[0, 1, 2]] * 2, None)])
def test_dp_matches_brute_force(p, V, sums):
    spec = {"V": V} if sums is None else {"V": V, "sum": sums}
    levels = admissible_levels(spec)
    L, nt, tau, beta = len(levels), 4, 0.25, 0.3
    rng = np.random.default_rng(7)
    g = rng.standard_normal((nt, levels.shape[1]))
    u = levels[rng.integers(0, L, nt)]
    jump = jump_costs(levels, p, beta)
    B = 5
    stage, btilde = dp.stage_tables(g[None], u[None], levels, tau)
    U, phi0 = dp.build(stage, btilde, jump, B, max_budget_use(levels))
    for cap in range(B + 1):
        best = np.inf
        for path in itertools.product(range(L), repeat=nt):
            v = levels[list(path)]
            if np.abs(v - u).sum() > cap:
                continue
            best = min(best, tau * (g * v).sum() + beta * tv_p(v, p))
        got = levels[dp.chase(U, phi0, btilde, [cap])[0]]
        assert np.abs(got - u).sum() <= cap
        assert tau * (g * got).sum() + beta * tv_p(got, p) == pytest.approx(best, abs=1e-12)


def _fd_check(model, us, entries):
    g = model.gradient(us)
    for k, m in entries:
        e = 1e-6
        up, um = us.copy(), us.copy()
        up[0, k, m] += e
        um[0, k, m] -= e
        fd = (model.value(up)[0] - model.value(um)[0]) / (2 * e) / model.tau
        assert g[0, k, m] == pytest.approx(fd, rel=1e-5, abs=1e-7)


def test_fishing_gradient_matches_finite_differences():
    model = fishing.Model(config("fishing-nt1024", nt=48))
    us = starts.start(model.levels, 48, 3)[None]
    _fd_check(model, us, [(0, 0), (10, 1), (30, 2), (47, 0)])


def test_heat_gradient_matches_finite_differences():
    cfg = config("heat-nt500", nt=12)
    cfg["problem"]["mesh"]["refinements"] = 1
    model = heat.Model(cfg)
    us = starts.start(model.levels, 12, 5)[None]
    _fd_check(model, us, [(0, 0), (5, 1), (11, 0), (11, 1)])


def test_starts_are_the_programs_starts():
    from mioc_tpu_torch.models.registry import build
    from mioc_tpu_torch.utils.init import rand_func

    for name, prob, nt in (("fishing-nt1024", "fishing", 64), ("heat-nt500", "heat", 20)):
        obj = build(prob, nt, device="cpu")
        levels = admissible_levels(config(name)["levels"])
        np.testing.assert_array_equal(levels, obj.admissible.levels)
        for seed in (0, 5, 2**33 + 1):
            np.testing.assert_array_equal(starts.start(levels, nt, seed), rand_func(obj, seed=seed))


@pytest.mark.parametrize("name,prob,nt,rtol", [("fishing-nt1024", "fishing", 64, 1e-14),
                                               ("heat-nt500", "heat", 20, 1e-11)])
def test_reference_problem_is_the_programs(name, prob, nt, rtol):
    """The configuration describes the problem the program builds: same
    size, preset, f and gradient to rounding."""
    import torch

    from mioc_tpu_torch.models import registry

    cfg = config(name, nt=nt)
    ref = {"fishing": fishing, "heat": heat}[cfg["reference"]].Model(cfg)
    obj = registry.build(prob, nt, device="cpu")
    preset = {k: (float("inf") if v == "inf" else v) for k, v in cfg["preset"].items()
              if k in ("beta", "delta0", "p")}
    assert preset == registry.get(prob).preset
    if prob == "heat":
        assert ref.N == obj.Nglobal_dofs == cfg["sizes"]["N"]
    us = np.stack([starts.start(ref.levels, nt, s) for s in range(3)])
    f, ys = obj._forward_batch(torch.as_tensor(us))
    df, _ = obj._adjoint_batch(torch.as_tensor(us), ys)
    np.testing.assert_allclose(f.numpy(), ref.value(us), rtol=rtol)
    g = ref.gradient(us)
    assert np.abs(df.numpy() - g).max() <= 10 * rtol * np.abs(g).max()


def test_sizes_stated_in_the_configurations():
    for name in ("fishing-nt1024", "heat-nt500"):
        cfg = config(name)
        levels = admissible_levels(cfg["levels"])
        tau = (cfg["problem"]["T1"] - cfg["problem"]["T0"]) / cfg["nt"]
        assert len(levels) == cfg["sizes"]["L"]
        assert dp.halving_caps(cfg["preset"]["delta0"], tau, 40)[0] == cfg["sizes"]["B"]
