"""ODE sweeps (objectives/ode.py, models/fishing.py, models/vanderpol.py,
ops/xla_order.py, ops/ode_cuda.py): mean ms of one f or gradient call, from the
synchronised spans on the objective's ``_forward_batch`` and ``_adjoint_batch``,
in the single-start cells."""


LAYER = "ode_sweep."


def read(ctx):
    if ctx["e2e"] != "solve_s":
        return None
    d = [b - a for n, a, b in ctx["spans"] if n.startswith(LAYER)]
    return sum(d) / len(d) / 1e6 if d else None
