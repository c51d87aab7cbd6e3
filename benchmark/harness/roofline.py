"""The chip's peaks and the least work of each kernel the cells time.

A kernel's roofline share is the least time the card could take for the
work its launches were given (the larger of its bytes over the memory
bandwidth and its operations over the scalar rate) over the device time
the trace gives those launches. The counts come from the launches' shapes
alone, whatever implements them: each input byte read once, each output
byte written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at its 700 W limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "ops_per_s": 67e12},
}


def peaks(kind: str) -> dict:
    """The peaks of the card `kind`; a card not in the table has none."""
    return PEAKS.get(kind)


def khf_sketch_cost(B: int, L: int, s: int, sum_len: int, n_kmers: int):
    """(bytes, operations) of one KHF-sketch launch over B reads padded to
    L: the reads' real bases and their lengths in, the s 64-bit slots out;
    per k-mer the canonical rolling hash (~8 operations) and s multiply-
    xorshift-min slots (~4 each)."""
    return sum_len + 4 * B + 8 * B * s, n_kmers * (8 + 4 * s)


def seed_scan_cost(n_rows: int, n_reads: int, n_offs: int):
    """(bytes, operations) of one seed-scan launch: five int32 words a row
    in and one out, and per row and strand at least one anchor chain of
    n_offs + 1 words from the path table, per read and strand the same from
    its anchor hashes; an operation a chain word."""
    chain = 2 * n_rows * (n_offs + 1)
    return 24 * n_rows + 4 * chain + 8 * n_reads * (n_offs + 1), chain


def share(costs, device_s: float, kind: str):
    """Percent of the roofline that `device_s` of device time reached for
    launches of the given (bytes, operations); None without a peak or a
    time."""
    pk = peaks(kind)
    if pk is None or not device_s or not costs:
        return None
    least = sum(max(b / pk["bytes_per_s"], o / pk["ops_per_s"]) for b, o in costs)
    return 100.0 * least / device_s
