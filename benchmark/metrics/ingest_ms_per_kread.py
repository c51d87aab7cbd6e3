"""Thread-milliseconds per 1,000 reads inside align_pipeline._compute_hits
(the KHF sketch, the host LSH query and the hit sort of a batch), summed
over the prep threads, from a wrapper installed in the traced run only."""

UNIT, SOURCE, LAYER, MOVES = "ms", "program_span", "ingest", "reads_per_s"


def read(ctx):
    s = ctx["spans"].seconds("ingest")
    return 1e6 * s / ctx["reads"] if s > 0 else None
