"""Milliseconds per 1,000 reads of prune + report (prune_graphs, then
report_from_bam and format_report), a span the benchmark takes."""

UNIT, SOURCE, LAYER, MOVES = "ms", "program_span", "prune and report", "reads_per_s"


def read(ctx):
    s = sum(p["report_s"] for p in ctx["passes"])
    return 1e6 * s / ctx["reads"] if s > 0 else None
