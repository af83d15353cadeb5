"""``correct`` comes out false for the control and for every fault a cell can
have, and true for the program as it is.

Each test drives a whole run (``run.run``) on the CPU at a small size,
skipping only the look for a card, with the timed path broken underneath:

* the control: the program in float32 where the configuration states
  float64;
* a step that returns its state unchanged: every chase returns the
  current iterate's own path, so each solve stops at once, at its start;
* half of the batch left out (the multistart): the second half of every
  batch is returned as its starts;
* an answer altered where it is produced: the returned control has one
  step moved to another admissible level.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402

SMALL = {"fishing.host": {"config": {"nt": 64}, "traffic": {"pool": 2}},
         "heat.device": {"config": {"nt": 20}, "traffic": {"pool": 2}},
         "fishing.multistart32": {"config": {"nt": 64}, "traffic": {"pool": 2, "batch": 4}}}
CELLS = sorted(SMALL)


def small_run(cell, **extra):
    over = {k: dict(v) for k, v in SMALL[cell].items()}
    for part, d in extra.items():
        over.setdefault(part, {}).update(d)
    return run.run(cell, 2**31 + 11, 0.0, False, device="cpu", overrides=over)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell):
    r = small_run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_float32_is_not_correct(cell):
    r = small_run(cell, config={"dtype": "float32"})
    assert not r["correct"]
    assert r["checks"]["f_rel"]["value"] > r["checks"]["f_rel"]["limit"]


def _own_path(btilde):
    return torch.argmin(btilde, dim=-1).to(torch.int32)


@pytest.mark.parametrize("cell", CELLS)
def test_step_returning_its_state_is_not_correct(cell, monkeypatch):
    from mioc_tpu_torch.ops import bellman

    monkeypatch.setattr(bellman, "backtrack_plain", lambda U, phi0, bt, B: _own_path(bt))
    monkeypatch.setattr(bellman, "backtrack_batched_plain", lambda U, phi0, bt, B: _own_path(bt))
    monkeypatch.setattr(bellman, "backtrack_trials_plain",
                        lambda U, phi0, bt, Bs: _own_path(bt)[:, None].expand(
                            -1, Bs.shape[1], -1).contiguous())
    r = small_run(cell)
    assert not r["correct"]
    assert r["checks"]["stationary"]["value"] > r["checks"]["stationary"]["limit"]


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    from mioc_tpu_torch.solvers import trm_device

    real = trm_device.multistart_solve_device

    def half(obj, par, x0s, **kw):
        x0s = np.asarray(x0s)
        h = len(x0s) // 2
        r = real(obj, par, x0s[:h], **kw)
        fill = {"u": x0s[h:], "x_final": x0s[h:]}
        return type(r)(*[np.concatenate([leaf, fill.get(name, leaf[:len(x0s) - h])])
                         for name, leaf in zip(r._fields, r)])

    monkeypatch.setattr(trm_device, "multistart_solve_device", half)
    r = small_run("fishing.multistart32")
    assert not r["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_not_correct(cell, monkeypatch):
    from mioc_tpu_torch.solvers import trm, trm_device

    def altered(u):
        u = np.array(u, copy=True)
        k = u.shape[-2] // 2
        # another admissible level: the next fishing mode, the next heat pair
        u[..., k, :] = (np.roll(u[..., k, :], 1, axis=-1) if u.shape[-1] == 3
                        else (u[..., k, :] + 1) % 6)
        return u

    for mod, name in ((trm, "trm_solve"), (trm_device, "trm_solve_device"),
                      (trm_device, "multistart_solve_device")):
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
