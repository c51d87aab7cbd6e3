"""Thread-milliseconds per 1,000 reads of phase A: the program's own
stage_times submit_s (read_hash + seed_scan launches and their copies) and
drain_s (the copies back)."""

UNIT, SOURCE, LAYER, MOVES = "ms", "program_counter", "phase A", "reads_per_s"


def read(ctx):
    s = sum(p["stage_times"].get(k, 0.0) for p in ctx["passes"]
            for k in ("submit_s", "drain_s"))
    return 1e6 * s / ctx["reads"] if s > 0 else None
