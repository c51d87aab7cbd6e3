"""Reads aligned and reported a second: all the reads of all the window's
passes over the sum of the passes' seconds (host clock)."""

UNIT, SOURCE, MOVES = "reads/s", "host_clock", None


def read(ctx):
    seconds = sum(p["seconds"] for p in ctx["passes"])
    return ctx["reads"] / seconds if seconds > 0 else None
