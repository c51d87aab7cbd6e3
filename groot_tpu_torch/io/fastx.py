"""FASTA / MSA / FASTQ readers (host side).

Mirrors the behavior of the reference's ingest:
  * MSA reading       — gfa.ReadMSA call site src/pipeline/index.go:43
  * FASTQ streaming   — DataStreamer/FastqHandler src/pipeline/sketch.go:41-238
  * FASTA-as-reads    — FastqHandler fasta mode  src/pipeline/sketch.go:178-212

Reads are parsed 4-lines-at-a-time with the same minimal checks (ID line must
start with '@'); gzip inputs are detected by the ".gz" suffix like the
reference (sketch.go:60-66). Batching into padded uint8 code matrices happens
in pipeline.align_pipeline; this module yields plain records (counterpart
of groot_tpu/io/fastx.py).
"""

from __future__ import annotations

import gzip
import io
import sys
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Tuple


@dataclass
class FastqRead:
    id: bytes  # includes the leading '@'
    seq: bytes
    misc: bytes = b""
    qual: bytes = b""
    rc: bool = False

    @property
    def name(self) -> str:
        """Record name as used in BAM output: ID minus the '@'
        (src/graph/alignment.go:119)."""
        return self.id[1:].split()[0].decode() if self.id else ""


def _open_text(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def read_fasta(path_or_lines) -> List[Tuple[str, str]]:
    """Read a (possibly aligned) FASTA file -> [(name, sequence)]."""
    if isinstance(path_or_lines, str):
        with _open_text(path_or_lines) as fh:
            lines = fh.read().splitlines()
    else:
        lines = [
            l.decode() if isinstance(l, bytes) else l for l in path_or_lines
        ]
    out: List[Tuple[str, str]] = []
    name = None
    chunks: List[str] = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if name is not None:
                out.append((name, "".join(chunks)))
            name = line[1:].strip()
            chunks = []
        else:
            chunks.append(line)
    if name is not None:
        out.append((name, "".join(chunks)))
    return out


def read_msa(path: str) -> List[Tuple[str, str]]:
    """Read an MSA fasta. Validates equal aligned lengths.

    Names keep any leading '*' (cluster representative marker); the
    'consensus' row emitted by the DB build script is NOT dropped here —
    msa_to_gfa handles that (matching the reference pipeline's observable
    output, see tests and testing/run_travis_tests.sh:55-60).
    """
    rows = read_fasta(path)
    if not rows:
        raise ValueError(f"empty MSA file: {path}")
    L = len(rows[0][1])
    for name, seq in rows:
        if len(seq) != L:
            raise ValueError(
                f"MSA rows have unequal aligned lengths in {path}: "
                f"{name} ({len(seq)} vs {L})"
            )
    return rows


def stream_lines(paths: List[str]) -> Iterator[bytes]:
    """Line stream from files (gzip-aware) or STDIN when paths is empty,
    mirroring DataStreamer (src/pipeline/sketch.go:41-77)."""
    if not paths:
        for line in sys.stdin.buffer:
            yield line.rstrip(b"\r\n")
        return
    for p in paths:
        opener = gzip.open if p.endswith(".gz") else open
        with opener(p, "rb") as fh:
            for line in fh:
                yield line.rstrip(b"\r\n")


def stream_fastq(paths: List[str], fasta: bool = False) -> Iterator[FastqRead]:
    """Yield FastqRead records from FASTQ (or FASTA when fasta=True) files."""
    lines = stream_lines(paths)
    if fasta:
        l1: bytes = b""
        l2: List[bytes] = []
        for line in lines:
            if not line:
                continue
            if line.startswith(b">"):
                if l1:
                    yield FastqRead(id=b"@" + l1[1:], seq=b"".join(l2))
                l1, l2 = line, []
            else:
                l2.append(line)
        if l1:
            yield FastqRead(id=b"@" + l1[1:], seq=b"".join(l2))
        return
    quad: List[bytes] = []
    for line in lines:
        quad.append(line)
        if len(quad) == 4:
            l1, l2, l3, l4 = quad
            quad = []
            if not l1.startswith(b"@"):
                raise ValueError(
                    f"read ID in fastq file does not begin with @: {l1!r}"
                )
            yield FastqRead(id=l1, seq=l2, misc=l3, qual=l4)
