"""Seconds of the index load at set-up (config.Info.load +
index.lshe.ContainmentIndex.load), a span the benchmark takes."""

UNIT, SOURCE, LAYER, MOVES = "s", "program_span", "index load", "setup_s"


def read(ctx):
    return ctx["index_load_s"]
