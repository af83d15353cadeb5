"""Device: share of the traced window in which no operation runs on the card,
from the union of the profiler's device intervals, in %."""


def read(ctx):
    if ctx["e2e"] != "starts_per_s":
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
