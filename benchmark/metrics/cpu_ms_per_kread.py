"""CPU milliseconds (user + system, getrusage of the process) per 1,000
reads over the window's passes."""

UNIT, SOURCE, LAYER, MOVES = "ms", "program_counter", "host process", "reads_per_s"


def read(ctx):
    s = sum(p["user_s"] + p["sys_s"] for p in ctx["passes"])
    return 1e6 * s / ctx["reads"] if s > 0 else None
