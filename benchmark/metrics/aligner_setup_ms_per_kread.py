"""Milliseconds per 1,000 reads from the entry of run_align to its first
batch (the native runtime, the BAM references, the aligner with its
sidecar load and device tables), paid on every call: the program's
stage_times aligner_setup_s."""

UNIT, SOURCE, LAYER, MOVES = "ms", "program_counter", "align set-up", "reads_per_s"


def read(ctx):
    st = [p["stage_times"] for p in ctx["passes"]]
    if not st or not all("aligner_setup_s" in s for s in st):
        return None
    return 1e6 * sum(s["aligner_setup_s"] for s in st) / ctx["reads"]
