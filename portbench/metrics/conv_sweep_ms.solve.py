"""Conv sweeps (models/convolution.py, ops/rows.py, ops/tv.py::fold_sum): mean ms
of one f or gradient call, from the synchronised spans on the objective's
``_forward_batch`` and ``_adjoint_batch``, in the single-start cells."""


LAYER = "conv_sweep."


def read(ctx):
    if ctx["e2e"] != "solve_s":
        return None
    d = [b - a for n, a, b in ctx["spans"] if n.startswith(LAYER)]
    return sum(d) / len(d) / 1e6 if d else None
