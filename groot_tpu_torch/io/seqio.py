"""Sequence helpers — the reference's src/seqio API surface.

Reference: src/seqio/seqio.go; counterpart of
groot_tpu/io/seqio.py. FastqRead itself lives in io.fastx; this module adds the mutation helpers: BaseCheck,
RevComplement (flips the RC flag), bwa-style QualTrim (plumbed but disabled
in the reference's FastqChecker, sketch.go:258), DeepCopy."""

from __future__ import annotations

import copy

import numpy as np

from ..ops.nthash import ASCII_TO_CODE, CODE_TO_ASCII, RC_CODE_NP
from .fastx import FastqRead

ENCODING = 33  # FASTQ phred offset (seqio.go:14)


def base_check(seq: bytes) -> bytes:
    """Uppercase + map non-ACGTN to N (seqio.go:72-91)."""
    return CODE_TO_ASCII[ASCII_TO_CODE[np.frombuffer(seq, np.uint8)]].tobytes()


def rev_complement(read: FastqRead) -> None:
    """In-place reverse complement; flips the RC flag (seqio.go:120-133)."""
    codes = ASCII_TO_CODE[np.frombuffer(read.seq, np.uint8)]
    read.seq = CODE_TO_ASCII[RC_CODE_NP[codes][::-1]].tobytes()
    read.qual = read.qual[::-1]
    read.rc = not read.rc


def deep_copy(read: FastqRead) -> FastqRead:
    return copy.deepcopy(read)


def qual_trim(read: FastqRead, min_qual: int) -> None:
    """bwa-style quality trim (seqio.go:141-170): for each end, accumulate
    (minQual - q) and trim at the index maximising the running sum."""
    qual = read.qual
    start, qual_sum, qual_max = 0, 0, 0
    end = len(qual)
    for i, q in enumerate(qual):
        qual_sum += min_qual - (q - ENCODING)
        if qual_sum < 0:
            break
        if qual_sum > qual_max:
            qual_max = qual_sum
            start = i + 1
    qual_sum, qual_max = 0, 0
    for j in range(len(qual) - 1, -1, -1):
        qual_sum += min_qual - (qual[j] - ENCODING)
        if qual_sum < 0:
            break
        if qual_sum > qual_max:
            qual_max = qual_sum
            end = j
    if start >= end:
        start, end = 0, 0
    read.seq = read.seq[start:end]
    read.qual = read.qual[start:end]
