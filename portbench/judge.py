"""The comparison that decides ``correct``.

Every answer the window produced (one per start) is judged by the plain
reference, which derives its own operators from the configuration and reads
the program's outputs only to judge them:

* ``f_rel``: the returned objective value ``f`` against the reference's
  ``f(u)`` at the returned control ``u``;
* ``df_rel``: the program's gradient at ``u`` (its own sweeps, at the
  window's row count) against the reference's, by the largest entry;
* ``J_rel``: the returned ``J = f(u) + β·TV_p(x_final)`` (the upstream
  return convention, TV at the last DP candidate) against the reference's;
* ``tv_rel``: the returned ``TV_p(u)``;
* ``stationary``: the reference replays the trust-region step from ``u``
  (its own gradient, DP tables and chases at the halving caps, and ``f`` of
  each candidate) and reports the largest ``(ared − σ·pred)/|f(u)|`` of a
  trial before the DP certifies (``pred ≤ 0``).  A positive value means
  the step accepts a trial: ``u`` is no certified stationary point.  This
  covers the objective, the DP build and chase, and TV_p together;
* ``admissible``: answers whose ``u`` or ``x_final`` leaves the level set;
* ``failed``: starts that got no answer, raised, or did not converge.

Limits live in the cell's file; the configuration states the two
guarantees (admissible, stationary) that the last three hold.
"""

from __future__ import annotations

import numpy as np

from .reference import dp
from .reference.levels import jump_costs, level_index, max_budget_use
from .reference.tv import tv_p

# The replay counts a trial as certified where its pred is at most this
# share of |f(u)|: a pred that is 0 in exact arithmetic reads a few ulps.
CERT_TOL = 1e-12
BLOCK = 32  # answers whose DP tables the replay holds at once


def preset_value(v):
    return float("inf") if v == "inf" else float(v)


def judge(ref, preset: dict, answers: list, failed: int) -> dict:
    """Readings of every compared number over ``answers`` (dicts with the
    program's numpy ``u``, ``x_final``, ``J``, ``f``, ``tv``, ``grad``).
    ``failed`` counts the starts that got no answer or did not converge."""
    beta, p = preset_value(preset["beta"]), preset_value(preset["p"])
    sigma = preset_value(preset.get("sigma", 0.5))
    tau, levels = ref.tau, ref.levels
    out = {"f_rel": 0.0, "df_rel": 0.0, "J_rel": 0.0, "tv_rel": 0.0,
           "stationary": -1.0, "admissible": 0, "failed": int(failed)}
    if not answers:
        return out
    caps = dp.halving_caps(preset_value(preset["delta0"]), tau, int(preset.get("kmax", 40)))
    jump = jump_costs(levels, p, beta)
    smax = max_budget_use(levels)
    for b0 in range(0, len(answers), BLOCK):
        block = answers[b0:b0 + BLOCK]
        u = np.stack([np.asarray(a["u"], np.float64) for a in block])
        xf = np.stack([np.asarray(a["x_final"], np.float64) for a in block])
        ok = np.array([np.isfinite(a["u"]).all() and (level_index(a["u"], levels) >= 0).all()
                       and np.isfinite(a["x_final"]).all()
                       and (level_index(a["x_final"], levels) >= 0).all() for a in block])
        out["admissible"] += int((~ok).sum())
        f = ref.value(u)
        g = ref.gradient(u)
        tv_u, tv_x = tv_p(u, p), tv_p(xf, p)
        for k, a in enumerate(block):
            out["f_rel"] = max(out["f_rel"], abs(float(a["f"]) - f[k]) / abs(f[k]))
            J = f[k] + beta * tv_x[k]
            out["J_rel"] = max(out["J_rel"], abs(float(a["J"]) - J) / abs(J))
            out["tv_rel"] = max(out["tv_rel"], abs(float(a["tv"]) - tv_u[k]) / max(tv_u[k], 1.0))
            gp = np.asarray(a["grad"], np.float64)
            out["df_rel"] = max(out["df_rel"],
                                float(np.abs(gp - g[k]).max() / np.abs(g[k]).max()))
        out["stationary"] = max(out["stationary"],
                                replay(ref, u[ok], g[ok], f[ok], tv_u[ok], caps, jump, smax,
                                       beta, sigma, p))
    for key in ("f_rel", "df_rel", "J_rel", "tv_rel"):
        if not np.isfinite(out[key]):
            out[key] = 1.0
    return out


def replay(ref, u, g, f, tv_u, caps, jump, smax, beta, sigma, p) -> float:
    """The largest ``(ared − σ·pred)/|f|`` over the trials the trust-region
    step from each ``u`` evaluates before its DP certifies (−1 where none
    is evaluated)."""
    if len(u) == 0:
        return -1.0
    tau, levels = ref.tau, ref.levels
    stage, btilde = dp.stage_tables(g, u, levels, tau)
    U, phi0 = dp.build(stage, btilde, jump, caps[0], smax)
    worst = np.full(len(u), -1.0)
    active = np.ones(len(u), dtype=bool)
    for cap in caps:
        idx = np.nonzero(active)[0]
        if idx.size == 0:
            break
        lv = dp.chase(U[idx], phi0[idx], btilde[idx], np.full(idx.size, cap))
        v = levels[lv]                                             # (n, nt, M)
        tv_v = tv_p(v, p)
        pred = tau * np.einsum("nim,nim->n", g[idx], u[idx] - v) + beta * (tv_u[idx] - tv_v)
        trial = pred > CERT_TOL * np.abs(f[idx])
        active[idx[~trial]] = False                                # certified
        if not trial.any():
            continue
        t = idx[trial]
        fv = ref.value(v[trial])
        ared = f[t] - fv + beta * (tv_u[t] - tv_v[trial])
        ared = np.where(np.isfinite(fv), ared, -np.inf)
        margin = (ared - sigma * pred[trial]) / np.abs(f[t])
        worst[t] = np.maximum(worst[t], np.maximum(margin, -1.0))
        active[t[margin >= 0]] = False                             # accepted: not stationary
    return float(worst.max())
