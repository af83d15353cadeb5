"""PDE sweeps (objectives/pde.py, models/heat.py, ops/rows.py, ops/detred.py): mean
ms of one batched f or gradient call, from the synchronised spans on the
objective's ``_forward_batch`` and ``_adjoint_batch``, in the multistart cells."""


LAYER = "pde_sweep."


def read(ctx):
    if ctx["e2e"] != "starts_per_s":
        return None
    d = [b - a for n, a, b in ctx["spans"] if n.startswith(LAYER)]
    return sum(d) / len(d) / 1e6 if d else None
