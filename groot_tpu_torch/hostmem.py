"""Host allocator tuning for the batch pipeline (counterpart of
groot_tpu/hostmem.py).

The align pipeline allocates and frees large per-batch buffers (a 128k-read
code matrix is ~20 MB; BGZF blocks, payload gathers and sketch scratch are
of similar size). glibc malloc serves allocations above M_MMAP_THRESHOLD
(128 KB default) with fresh mmap()s and returns them on free, so EVERY
batch round-trips tens of MB through the kernel: mmap + page-zeroing +
munmap. Measured on the 2-core bench host this adds 0.1-4 s of SYSTEM time
per 1M-read pass with huge variance (the r4 official bench captured one of
the bad draws — 725k reads/s vs the same code's 2.03M with the fix; see
BENCHNOTES.md). Production allocators (jemalloc/tcmalloc) retain such
blocks by design; plain glibc needs mallopt.

`tune()` raises M_MMAP_THRESHOLD and M_TRIM_THRESHOLD to 1 GB via ctypes
so batch-sized buffers come from the reusable heap. It is called from the
pipeline entry points (run_align/run_index) and is a no-op on failure or
when GROOT_NO_MALLOC_TUNE is set. The reference has no analog (Go's
runtime already retains and reuses spans — this is the CPython/glibc tax
the rebuild has to pay down explicitly).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import logging
import os

log = logging.getLogger("groot")

# glibc mallopt parameter numbers (malloc.h)
M_TRIM_THRESHOLD = -1
M_MMAP_THRESHOLD = -3

_done = False


def tune(threshold: int = 1 << 30) -> bool:
    """Keep batch-sized buffers on the glibc heap (idempotent)."""
    global _done
    if _done:
        return True
    if os.environ.get("GROOT_NO_MALLOC_TUNE"):
        return False
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                           use_errno=True)
        ok = libc.mallopt(M_MMAP_THRESHOLD, threshold)
        ok &= libc.mallopt(M_TRIM_THRESHOLD, threshold)
        _done = bool(ok)
    except (OSError, AttributeError) as e:  # musl/macOS: no mallopt
        log.debug("malloc tuning unavailable: %s", e)
        return False
    return _done
