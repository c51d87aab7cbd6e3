"""Thread-milliseconds per 1,000 reads in align_pipeline._map_hits's prep
(pad, KHF sketch, host LSH query, hit sort), summed over the ingest
workers: the program's stage_times prep_s, the in-program counterpart of
ingest_ms_per_kread."""

UNIT, SOURCE, LAYER, MOVES = "ms", "program_counter", "ingest", "reads_per_s"


def read(ctx):
    st = [p["stage_times"] for p in ctx["passes"]]
    if not st or not all("prep_s" in s for s in st):
        return None
    return 1e6 * sum(s["prep_s"] for s in st) / ctx["reads"]
