"""TRM loop (solvers/trm.py, solvers/trm_device.py, ops/bellman.py::stage_tables,
ops/tv.py, the kernel wrappers' host side): share of the traced window
outside the sweep spans and the DP spans, in %."""


def read(ctx):
    if ctx["e2e"] != "solve_s":
        return None
    inside = sum(b - a for _, a, b in ctx["spans"]) / 1e9
    return 100.0 * (ctx["window_s"] - inside) / ctx["window_s"]
