"""Milliseconds per 1,000 reads that the launch thread (the one that
launches phase A) waited for the next prepared batch: the program's
stage_times wait_ingest_s, the `next()` on the ingest prefetch."""

UNIT, SOURCE, LAYER, MOVES = "ms", "program_counter", "ingest", "reads_per_s"


def read(ctx):
    st = [p["stage_times"] for p in ctx["passes"]]
    if not st or not all("wait_ingest_s" in s for s in st):
        return None
    return 1e6 * sum(s["wait_ingest_s"] for s in st) / ctx["reads"]
