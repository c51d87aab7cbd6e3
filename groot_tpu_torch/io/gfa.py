"""GFA1 reading/writing (host side).

Covers the subset of GFA1 the reference produces/consumes via will-rowe/gfa:
H (version), comment lines, S segments with optional LN:i:/KC:i: fields,
L links (+/+ orientation, 0M overlap), P paths. Output format matches the
fixtures in src/graph/test.gfa and the writer behavior of
SaveGraphAsGFA (src/graph/graphio.go:19-112).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class GFASegment:
    name: str
    sequence: str
    kmer_count: Optional[int] = None  # KC:i:


@dataclass
class GFALink:
    frm: str
    to: str
    from_orient: str = "+"
    to_orient: str = "+"
    overlap: str = "0M"


@dataclass
class GFAPath:
    name: str
    segment_names: List[str]  # orientation suffixes stripped
    overlaps: List[str] = field(default_factory=list)


@dataclass
class GFA:
    version: int = 1
    comments: List[str] = field(default_factory=list)
    segments: List[GFASegment] = field(default_factory=list)
    links: List[GFALink] = field(default_factory=list)
    paths: List[GFAPath] = field(default_factory=list)


def parse_gfa(path_or_text: str) -> GFA:
    if "\n" in path_or_text or path_or_text.startswith(("H\t", "#")):
        text = path_or_text
    else:
        with open(path_or_text) as fh:
            text = fh.read()
    g = GFA()
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("#"):
            g.comments.append(line[1:].strip())
            continue
        fields = line.rstrip("\n").split("\t")
        tag = fields[0]
        if tag == "H":
            for f in fields[1:]:
                if f.startswith("VN:Z:"):
                    g.version = int(float(f[5:]))
        elif tag == "S":
            seg = GFASegment(name=fields[1], sequence=fields[2])
            for f in fields[3:]:
                if f.startswith("KC:i:"):
                    seg.kmer_count = int(f[5:])
            g.segments.append(seg)
        elif tag == "L":
            g.links.append(
                GFALink(
                    frm=fields[1],
                    from_orient=fields[2],
                    to=fields[3],
                    to_orient=fields[4],
                    overlap=fields[5] if len(fields) > 5 else "0M",
                )
            )
        elif tag == "P":
            segs = [s.rstrip("+-") for s in fields[2].split(",")]
            overlaps = fields[3].split(",") if len(fields) > 3 else []
            g.paths.append(GFAPath(name=fields[1], segment_names=segs, overlaps=overlaps))
        # other line types ignored
    return g


def write_gfa(g: GFA, path: Optional[str] = None) -> str:
    lines = [f"H\tVN:Z:{g.version}"]
    for c in g.comments:
        lines.append(f"#\t{c}")
    for s in g.segments:
        parts = ["S", s.name, s.sequence, f"LN:i:{len(s.sequence)}"]
        if s.kmer_count is not None:
            parts.append(f"KC:i:{s.kmer_count}")
        lines.append("\t".join(parts))
    for l in g.links:
        lines.append(
            "\t".join(["L", l.frm, l.from_orient, l.to, l.to_orient, l.overlap])
        )
    for p in g.paths:
        segs = ",".join(s + "+" for s in p.segment_names)
        overlaps = ",".join(p.overlaps) if p.overlaps else "*"
        lines.append("\t".join(["P", p.name, segs, overlaps]))
    text = "\n".join(lines) + "\n"
    if path is not None:
        with open(path, "w") as fh:
            fh.write(text)
    return text
