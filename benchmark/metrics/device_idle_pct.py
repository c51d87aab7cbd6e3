"""The share of the passes' time in which no operation ran on the card,
from the profiler's device events inside the pass spans."""

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "device", "reads_per_s"


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
