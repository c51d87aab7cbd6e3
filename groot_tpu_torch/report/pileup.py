"""Resistome report: BAM -> coverage-filtered TSV.

A copy of groot_tpu/report/pileup.py reading BAMs through the port's io.bam.
Reference: src/reporting/reporting.go. Behavioral quirks
reproduced exactly (they are observable in the output):

  * only records with Flags == 4 are skipped (secondary alignments count,
    reporting.go:82-84);
  * the pileup loop is INCLUSIVE of recStart + alignment length, i.e. each
    record covers Len()+1 bases unless truncated at the reference end
    (reporting.go:106-123);
  * a leading '*' (cluster representative marker) is stripped from reported
    names (reporting.go:131-134);
  * the coverage cigar comes from cigarClean, including its quirky handling
    of single-symbol and final-element cases (reporting.go:178-213);
  * --lowCov drops ARGs whose cigar shows INTERNAL deletions only
    (reporting.go:147-149).

Output rows are sorted by reference name (the reference's order is
goroutine-nondeterministic)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

import numpy as np

from ..io import bam as bamio


@dataclass
class Annotation:
    arg: str
    count: int
    length: int
    cigar: str


def cigar_clean(symbols: List[str]) -> Tuple[str, bool]:
    """Behavioral port of cigarClean (reporting.go:178-213)."""
    counter = 1
    pre_val = symbols[0]
    cigar = ""
    dm: dict = {}
    for i, val in enumerate(symbols):
        if i == 0:
            continue
        if i == len(symbols) - 1:
            if val == pre_val:
                counter += 1
                cigar += f"{counter}{val}"
                dm[val] = dm.get(val, 0) + 1
            else:
                cigar += f"{counter}{pre_val}1{val}"
                dm[val] = dm.get(val, 0) + 1
            break
        if val == pre_val:
            counter += 1
        else:
            dm[pre_val] = dm.get(pre_val, 0) + 1
            cigar += f"{counter}{pre_val}"
            pre_val = val
            counter = 1
    d, m = dm.get("D", 0), dm.get("M", 0)
    internal_d = not ((d + m <= 2) or (d == 2 and m == 1))
    return cigar, internal_d


def report_from_bam(
    bam_path: Optional[str],
    coverage_cutoff: float = 0.97,
    low_cov: bool = False,
    fh=None,
) -> List[Annotation]:
    """BAMreader.Run equivalent; returns annotations (and prints via caller)."""
    if bam_path is None:
        import sys

        fh = fh or sys.stdin.buffer

    # fast path: native record scan + one global range-update pileup
    fast = _report_fast(bam_path, fh, coverage_cutoff, low_cov)
    if fast is not None:
        return fast

    if bam_path:
        refs, records = bamio.read_bam(bam_path)
    else:
        refs, records = bamio.read_bam(fh)

    per_ref: dict = {}
    for rec in records:
        if rec.flag == bamio.FLAG_UNMAPPED:
            continue
        per_ref.setdefault(rec.ref_id, []).append(rec)

    annotations: List[Annotation] = []
    for ref in refs:
        recs = per_ref.get(ref.ref_id)
        if not recs:
            continue
        pileup = np.zeros(ref.length, dtype=np.int64)
        for rec in recs:
            start = rec.pos
            end = start + rec.aln_len()
            if end > ref.length - 1:
                end = ref.length - 1
            pileup[start : end + 1] += 1  # inclusive-end quirk
        covered = int((pileup > 0).sum())
        if covered / ref.length < coverage_cutoff:
            continue
        name = ref.name[1:] if ref.name.startswith("*") else ref.name
        symbols = ["M" if v else "D" for v in pileup]
        cigar, internal_d = cigar_clean(symbols)
        if internal_d and low_cov:
            continue
        annotations.append(
            Annotation(arg=name, count=len(recs), length=ref.length, cigar=cigar)
        )
    annotations.sort(key=lambda a: a.arg)
    return annotations


def _report_fast(
    bam_path, fh, coverage_cutoff: float, low_cov: bool
) -> Optional[List[Annotation]]:
    """Vectorized report: gio_bam_scan extracts (ref, pos, flag, aln_len)
    per record in one C pass; the per-base pileup is a single global
    range-update (+1/-1 diffs + cumsum over the concatenated reference
    coordinate space). Byte-identical output to the record-loop path."""
    from ..io import native

    if not native.available():
        return None
    if bam_path:
        import mmap as _mmap

        with open(bam_path, "rb") as _fh:
            try:  # zero-copy input; empty/unmappable falls back to read()
                raw = _mmap.mmap(_fh.fileno(), 0, access=_mmap.ACCESS_READ)
            except (ValueError, OSError):
                raw = _fh.read()
    else:
        raw = fh.read()
    data = bamio.bgzf_decompress(raw, as_array=True)
    refs, off = bamio.parse_bam_header(data)
    data_np = (
        data if isinstance(data, np.ndarray)
        else np.frombuffer(data, np.uint8)
    )
    res = native.bam_scan(data_np, off)
    if res is None:
        return None
    ref_id, pos, flag, aln = res
    keep = (flag != bamio.FLAG_UNMAPPED) & (ref_id >= 0)
    ref_id = ref_id[keep].astype(np.int64)
    pos = pos[keep].astype(np.int64)
    aln = aln[keep].astype(np.int64)

    lens = np.array([r.length for r in refs], dtype=np.int64)
    counts = np.bincount(ref_id, minlength=len(refs))
    offs = np.concatenate(([0], np.cumsum(lens)))
    end = np.minimum(pos + aln, lens[ref_id] - 1)
    diff = np.zeros(int(offs[-1]) + 1, dtype=np.int64)
    np.add.at(diff, offs[ref_id] + pos, 1)
    np.add.at(diff, offs[ref_id] + end + 1, -1)  # inclusive-end quirk
    pile = np.cumsum(diff[:-1])

    annotations: List[Annotation] = []
    for i, ref in enumerate(refs):
        if counts[i] == 0:
            continue
        pileup = pile[offs[i] : offs[i + 1]]
        covered = int((pileup > 0).sum())
        if covered / ref.length < coverage_cutoff:
            continue
        name = ref.name[1:] if ref.name.startswith("*") else ref.name
        symbols = ["M" if v else "D" for v in pileup]
        cigar, internal_d = cigar_clean(symbols)
        if internal_d and low_cov:
            continue
        annotations.append(
            Annotation(
                arg=name, count=int(counts[i]), length=ref.length, cigar=cigar
            )
        )
    annotations.sort(key=lambda a: a.arg)
    return annotations


def format_report(annotations: Iterable[Annotation]) -> str:
    return "".join(
        f"{a.arg}\t{a.count}\t{a.length}\t{a.cigar}\n" for a in annotations
    )
