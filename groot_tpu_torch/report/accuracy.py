"""Alignment accuracy harness.

Counterpart of groot_tpu/report/accuracy.py, reading BAMs through the
port's io.bam (the reference's io.bam imports JAX through align.aligner).
Reference: testing/groot-accuracy.go — parses a BAM of
simulated reads whose bbmap-randomreads names encode the origin reference
and position (field 9 after '_' splitting holds the reference ID, field 2
the position), and reports %aligned / %multialigned / %unaligned /
%misaligned. Usable via the `accuracy` command or the library."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from ..io import bam as bamio


@dataclass
class AccuracyStats:
    num_test_reads: int
    aligned: int
    multialigned: int
    unaligned: int
    misaligned: int
    correct_start: int
    false_positive_alignments: int

    def format(self) -> str:
        n = self.num_test_reads
        lines = [
            f"{self.aligned}\t{self.aligned / n * 100:.2f}%\t\taligned reads",
            f"{self.multialigned}\t{self.multialigned / n * 100:.2f}%\t\t"
            "multialigned reads",
            f"{self.unaligned}\t{self.unaligned / n * 100:.2f}%\t\t"
            "unaligned reads",
            f"{self.misaligned}\t{self.misaligned / n * 100:.2f}%\t\t"
            "incorrectly aligned reads",
        ]
        return "\n".join(lines) + "\n"


def evaluate_bam(bam_path: str, num_test_reads: int) -> AccuracyStats:
    refs, records = bamio.read_bam(bam_path)
    names = {r.ref_id: r.name for r in refs}
    read_map: Dict[str, List] = {}
    multimap = 0
    for rec in records:
        if rec.flag == bamio.FLAG_UNMAPPED:
            continue
        hits = read_map.setdefault(rec.name, [])
        if len(hits) == 1:
            multimap += 1
        hits.append(rec)

    aligned = len(read_map)
    correct_aligned = 0
    correct_start = 0
    false_pos = 0
    for read, hits in read_map.items():
        parts = read.split("_")
        read_id = parts[9].split("$")[0].split(" ")[0] if len(parts) > 9 else ""
        try:
            read_pos = int(parts[2])
        except (IndexError, ValueError):
            read_pos = -1
        match = False
        for hit in hits:
            ref = names[hit.ref_id]
            if ref.startswith("*"):
                ref = ref[1:]
            if ref != read_id:
                false_pos += 1
            else:
                match = True
                if hit.pos == read_pos:
                    correct_start += 1
        if match:
            correct_aligned += 1

    return AccuracyStats(
        num_test_reads=num_test_reads,
        aligned=aligned,
        multialigned=multimap,
        unaligned=num_test_reads - aligned,
        misaligned=aligned - correct_aligned,
        correct_start=correct_start,
        false_positive_alignments=false_pos,
    )


def misaligned_breakdown(bam_path: str, store) -> Dict[str, int]:
    """Classify the harness's "incorrectly aligned" reads (aligned, but
    no hit names the origin reference). Three bins:

      same_cluster  — some hit lies in the SAME variation graph as the
                      origin reference: a paralog/allele multimap inside
                      the origin's ~90%-identity cluster. The reference
                      harness (testing/groot-accuracy.go:82-132) counts
                      these as misaligned the same way — exact alignment
                      against near-identical alleles is genuinely
                      ambiguous for error-free 150 bp reads;
      cross_cluster — every hit lies in a different graph than the
                      origin's: a real seeding/cascade divergence worth
                      investigating;
      mangled_correct — the read IS aligned to its origin reference, but
                      bbmap randomreads mangles '_' to '{' in the
                      embedded origin name, so the string compare fails.
                      The reference's own harness does no un-mangling
                      (testing/groot-accuracy.go:86-109) and counts
                      these "misaligned" identically;
      origin_unknown — the origin is not an indexed path even after
                      un-mangling.
    """
    refs, records = bamio.read_bam(bam_path)
    names = {r.ref_id: r.name for r in refs}
    name2gid: Dict[str, int] = {}
    for gid, graph in store.items():
        for name in graph.paths.values():
            name2gid[name.lstrip("*")] = gid
    ref_gid: Dict[int, int] = {
        rid: name2gid[n.lstrip("*")]
        for rid, n in names.items()
        if n.lstrip("*") in name2gid
    }
    read_map: Dict[str, List] = {}
    for rec in records:
        if rec.flag == bamio.FLAG_UNMAPPED:
            continue
        read_map.setdefault(rec.name, []).append(rec)
    out = {
        "same_cluster": 0,
        "cross_cluster": 0,
        "mangled_correct": 0,
        "origin_unknown": 0,
    }
    for read, hits in read_map.items():
        parts = read.split("_")
        origin = parts[9].split("$")[0].split(" ")[0] if len(parts) > 9 else ""
        if any(names[h.ref_id].lstrip("*") == origin for h in hits):
            continue  # correctly aligned
        ogid = name2gid.get(origin)
        if ogid is None:
            unmangled = origin.replace("{", "_")
            if any(
                names[h.ref_id].lstrip("*") == unmangled for h in hits
            ):
                out["mangled_correct"] += 1
                continue
            ogid = name2gid.get(unmangled)
            if ogid is None:
                out["origin_unknown"] += 1
                continue
        if any(ref_gid.get(h.ref_id) == ogid for h in hits):
            out["same_cluster"] += 1
        else:
            out["cross_cluster"] += 1
    return out
