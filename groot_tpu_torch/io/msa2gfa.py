"""MSA -> variation graph (GFA) conversion.

Re-implements the role of will-rowe/gfa's MSA2GFA (called from
src/pipeline/index.go:49): collapse a gapped multiple
sequence alignment into a variation graph where runs of identical alignment
columns become shared segments and runs of divergent columns become
branching segments — the structure exemplified by the checked-in fixture
src/graph/test.gfa (e.g. paths "1+,3+,..." vs "2+,3+,...").

Algorithm (block collapsing):
  1. Drop rows named 'consensus' (the DB build script adds one per cluster;
     the reference's observable outputs contain no consensus path — the CI
     e2e test requires exactly one reported ARG, testing/run_travis_tests.sh:44-60).
  2. Classify each column: shared (all remaining rows identical) or variant.
  3. Merge maximal runs of equally-classified columns into blocks.
  4. Within each block, group rows by their *ungapped* block substring; each
     non-empty group becomes one segment (shared blocks have one group).
  5. Segments are numbered 1..N in emission order (groot requires integer
     segment names, src/graph/graph.go:59-62).
  6. Links join consecutive segments per row; paths list each row's segments.

Invariant (tested): concatenating each path's segment sequences reproduces
exactly the row's ungapped input sequence.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .gfa import GFA, GFALink, GFAPath, GFASegment


def msa_to_gfa(rows: List[Tuple[str, str]], drop_consensus: bool = True) -> GFA:
    if drop_consensus:
        rows = [(n, s) for (n, s) in rows if n != "consensus"]
    if not rows:
        raise ValueError("MSA contains no sequences (after dropping consensus)")
    names = [n for n, _ in rows]
    mat = np.array(
        [np.frombuffer(s.upper().encode(), dtype=np.uint8) for _, s in rows]
    )  # [R, L]
    R, L = mat.shape
    if L == 0:
        raise ValueError("MSA rows are empty")

    shared = (mat == mat[0]).all(axis=0)  # column identical across rows

    # maximal runs of same classification
    boundaries = np.flatnonzero(np.diff(shared.astype(np.int8)) != 0) + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [L]])

    g = GFA(version=1)
    gap = ord("-")
    seg_counter = 0
    row_paths: List[List[str]] = [[] for _ in range(R)]

    for s, e in zip(starts, ends):
        block = mat[:, s:e]
        if shared[s]:
            seq = block[0][block[0] != gap].tobytes().decode()
            if not seq:
                continue
            seg_counter += 1
            name = str(seg_counter)
            g.segments.append(GFASegment(name=name, sequence=seq))
            for r in range(R):
                row_paths[r].append(name)
        else:
            # group rows by ungapped substring, ordered by first occurrence
            groups: dict = {}
            for r in range(R):
                sub = block[r][block[r] != gap].tobytes()
                groups.setdefault(sub, []).append(r)
            for sub, members in groups.items():
                if not sub:
                    continue
                seg_counter += 1
                name = str(seg_counter)
                g.segments.append(GFASegment(name=name, sequence=sub.decode()))
                for r in members:
                    row_paths[r].append(name)

    # links (deduped, stable order) and paths
    seen = set()
    for r in range(R):
        p = row_paths[r]
        for a, b in zip(p, p[1:]):
            if (a, b) not in seen:
                seen.add((a, b))
                g.links.append(GFALink(frm=a, to=b))
        seqlens = {seg.name: len(seg.sequence) for seg in g.segments}
        g.paths.append(
            GFAPath(
                name=names[r],
                segment_names=p,
                overlaps=[f"{seqlens[s]}M" for s in p],
            )
        )
    return g
