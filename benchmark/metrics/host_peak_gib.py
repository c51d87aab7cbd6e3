"""The process's peak resident memory (ru_maxrss) when the window closes:
what a cluster job must request for one sample."""

UNIT, SOURCE, MOVES = "GiB", "host_clock", None


def read(ctx):
    return ctx["host_peak_bytes"] / 2**30
