"""Seconds from the process's start to the first timed pass: imports, the
sample written, the index built (first run in a checkout) and loaded, the
kernels built or loaded, and one warm-up pass."""

UNIT, SOURCE, MOVES = "s", "host_clock", None


def read(ctx):
    return ctx["setup_s"]
