"""DP kernels (ops/bellman_cuda.py, ops/backtrack_cuda.py, csrc/*.cu): the sum of every
DP call's roofline bound (portbench/peaks.py: its bytes and operations
against the published H100 peaks) over the profiler's device time of the
DP kernels, in %."""


def read(ctx):
    if ctx["e2e"] != "solve_s":
        return None
    if ctx["dp_device_s"] <= 0 or ctx["dp_bound_s"] <= 0:
        return None
    return 100.0 * ctx["dp_bound_s"] / ctx["dp_device_s"]
