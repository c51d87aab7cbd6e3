"""The share of the host tail's thread time spent on a CPU: the program's
stage_times tail_cpu_s (thread CPU seconds in device_join.collect_pairs)
over reduce_s + verify_emit_s + residue_s (its wall seconds, the same
intervals). The rest is waiting for the GIL and the run queue."""

UNIT, SOURCE, LAYER, MOVES = "%", "program_counter", "host tail", "reads_per_s"

WALL = ("reduce_s", "verify_emit_s", "residue_s")


def read(ctx):
    st = [p["stage_times"] for p in ctx["passes"]]
    if not st or not all("tail_cpu_s" in s for s in st):
        return None
    wall = sum(s.get(k, 0.0) for s in st for k in WALL)
    return 100.0 * sum(s["tail_cpu_s"] for s in st) / wall if wall > 0 else None
