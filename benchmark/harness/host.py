"""The host side of a run: its thread count and the cores it runs on.

Called before numpy and torch are imported, so that their thread pools
take the configuration's count.
"""

from __future__ import annotations

import os

THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def fix_threads(processors: int) -> str:
    """Set the thread pools to `processors` and pin the process, and every
    thread it starts later, to that many fixed cores: the highest-numbered
    of those it may use, as a cluster job that asks for `-p` cores gets
    them. Returns a line that says so."""
    for var in THREAD_VARS:
        os.environ[var] = str(processors)
    allowed = sorted(os.sched_getaffinity(0))
    cores = allowed[-processors:]
    os.sched_setaffinity(0, cores)
    return (f"host: os.cpu_count() {os.cpu_count()}, affinity {len(allowed)}, "
            f"threads {processors}, pinned to cores {cores}")
