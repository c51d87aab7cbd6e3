"""Thread-milliseconds per 1,000 reads of the host tail
(device_join.collect_pairs: native reduce, stage 2, byte verify, BAM
records): the program's stage_times reduce_s + verify_emit_s + residue_s."""

UNIT, SOURCE, LAYER, MOVES = "ms", "program_counter", "host tail", "reads_per_s"


def read(ctx):
    s = sum(p["stage_times"].get(k, 0.0) for p in ctx["passes"]
            for k in ("reduce_s", "verify_emit_s", "residue_s"))
    return 1e6 * s / ctx["reads"] if s > 0 else None
