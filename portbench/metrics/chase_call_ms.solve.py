"""DP kernels (ops/backtrack_cuda.py, csrc/chase*.cu): mean ms of one chase call,
the wrapper's host side and its kernel together, from the synchronised
``dp.chase`` spans on the chase wrappers, in the single-start cells."""


SPAN = "dp.chase"


def read(ctx):
    if ctx["e2e"] != "solve_s":
        return None
    d = [b - a for n, a, b in ctx["spans"] if n == SPAN]
    return sum(d) / len(d) / 1e6 if d else None
