"""System time as a share of the process's CPU time over the passes
(getrusage): the kernel's page faults and mmap/munmap."""

UNIT, SOURCE, LAYER, MOVES = "%", "program_counter", "host process", "reads_per_s"


def read(ctx):
    u = sum(p["user_s"] for p in ctx["passes"])
    s = sum(p["sys_s"] for p in ctx["passes"])
    return 100.0 * s / (u + s) if u + s > 0 else None
