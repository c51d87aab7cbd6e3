"""The comparison that decides `correct`: every pass of the window against
the plain reference, each number beside its limit.

The readings each limit was set from are in PERF.md. The weights are sums
of float64 shares that the program adds in its own order across threads,
so they are held to a gap relative to max(|reference|, 1); everything else
is exact.
"""

from __future__ import annotations

import collections
import hashlib
from typing import Dict, List

import numpy as np

from . import bamread

LIMITS = {
    "index_off": 0,      # index faults against the raw alleles (sampled windows)
    "header_off": 0,     # BAM references unlike the store's paths
    "stats_off": 0,      # |program - reference| over the four stats counters
    "records_off": 0,    # records in one multiset and not the other
    "kept_off": 0,       # pruned paths unlike the reference's
    "rows_off": 0,       # report rows unlike the reference's
    "passes_off": 0,     # passes whose answer differs from the judged pass
    "weight_gap": 1e-10,  # max |w - w_ref| / max(|w_ref|, 1) over nodes and passes
}


def digest(out) -> str:
    """What a pass answered, but the weights, as one hash: its stats, its
    BAM references and order-canonical records, pruned paths and rows."""
    refs, records = bamread.parse(out.bam)
    h = hashlib.sha256(repr((sorted(out.stats.items()), refs, sorted(records),
                             out.kept, out.rows)).encode())
    return h.hexdigest()


def weight_gap(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return float("inf")
    if not len(want):
        return 0.0
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))


def compare(stats, refs, records, kept, rows, digests: List[str],
            weights: List[np.ndarray], ref, index_faults: int, ref_refs) -> Dict[str, float]:
    """The numbers compared for a judged answer (stats, BAM references,
    record keys, pruned paths, report rows), with the digests and weights
    of every pass of the window, against the reference `ref`."""
    got = collections.Counter(records)
    want = collections.Counter(ref.records)
    return {
        "index_off": index_faults,
        "header_off": int(refs != ref_refs) * max(len(refs), len(ref_refs), 1),
        "stats_off": int(sum(abs(stats[k] - ref.stats[k]) for k in ref.stats)),
        "records_off": int(sum(((got - want) + (want - got)).values())),
        "kept_off": len(set(kept) ^ set(ref.kept)) + int(kept != ref.kept and
                                                        set(kept) == set(ref.kept)),
        "rows_off": len(set(rows) ^ set(ref.rows)),
        "passes_off": sum(d != digests[-1] for d in digests),
        "weight_gap": max(weight_gap(w, ref.weights) for w in weights),
    }


def compare_pass(last, digests, weights, ref, index_faults, ref_refs):
    """compare() for the program's last pass, its BAM read here."""
    refs, records = bamread.parse(last.bam)
    return compare(last.stats, refs, records, last.kept, last.rows, digests, weights,
                   ref, index_faults, ref_refs)


def verdict(numbers: Dict[str, float]) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)


def lines(numbers: Dict[str, float]) -> List[str]:
    return [f"check {k}: {numbers[k]!r} (limit {LIMITS[k]!r})" for k in LIMITS]
