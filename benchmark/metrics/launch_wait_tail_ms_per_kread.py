"""Milliseconds per 1,000 reads that the launch thread waited for a host
tail to finish a batch: the program's stage_times wait_tail_s, the
`fut.result()` of align_pipeline's replay_one."""

UNIT, SOURCE, LAYER, MOVES = "ms", "program_counter", "host tail", "reads_per_s"


def read(ctx):
    st = [p["stage_times"] for p in ctx["passes"]]
    if not st or not all("wait_tail_s" in s for s in st):
        return None
    return 1e6 * sum(s["wait_tail_s"] for s in st) / ctx["reads"]
