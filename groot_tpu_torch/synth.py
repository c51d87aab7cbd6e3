"""Synthetic clustered ARG databases and read sets, made from a seed.

Used by the port's tests (a few small clusters) and by chip_smoke.py (a
database at the scale of arg-annot.90: 583 clusters, ~1,700 alleles). A
cluster is a founder sequence plus alleles at most `max_div` divergent from
it (substitutions, plus a few short deletions that become MSA gaps); each
cluster is written as an aligned FASTA `cluster-N.msa`, the layout `index`
reads. Reads are sampled from the ungapped alleles with numpy.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

_ACGT = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _COMP[_a] = _b


def make_clusters(
    rng: np.random.Generator,
    n_clusters: int,
    alleles: Tuple[int, int] = (1, 12),
    mean_alleles: float = 2.9,
    length: Tuple[int, int] = (500, 1500),
    max_div: float = 0.10,
    max_gaps: int = 2,
) -> List[List[Tuple[str, bytes]]]:
    """[cluster][allele] = (name, aligned sequence with '-' gaps). The
    allele count is 1 + a Poisson draw (mean `mean_alleles`), clipped to
    `alleles`; each allele's divergence is max_div * U^2 (mean max_div/3)."""
    out = []
    for c in range(n_clusters):
        L = int(rng.integers(length[0], length[1] + 1))
        founder = _ACGT[rng.integers(0, 4, L)]
        n_al = int(np.clip(1 + rng.poisson(mean_alleles - 1), *alleles))
        rows = []
        for a in range(n_al):
            seq = founder.copy()
            n_sub = int(round(max_div * rng.random() ** 2 * L))
            pos = rng.choice(L, size=n_sub, replace=False)
            seq[pos] = _ACGT[(np.searchsorted(_ACGT, seq[pos]) + rng.integers(1, 4, n_sub)) % 4]
            for _ in range(int(rng.integers(0, max_gaps + 1))):
                g0 = int(rng.integers(1, L - 8))
                seq[g0 : g0 + int(rng.integers(1, 7))] = ord("-")
            name = f"argsyn~~~(Syn)C{c}-{a}~~~SYN{c:04d}{a:02d}:1-{L}"
            rows.append((name, seq.tobytes()))
        out.append(rows)
    return out


def write_msa_dir(clusters, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for c, rows in enumerate(clusters):
        with open(os.path.join(out_dir, f"cluster-{c}.msa"), "wb") as fh:
            for name, seq in rows:
                fh.write(b">%s\n%s\n" % (name.encode(), seq))


def alleles_of(clusters) -> List[bytes]:
    """Ungapped allele sequences, in cluster then allele order."""
    return [seq.replace(b"-", b"") for rows in clusters for _n, seq in rows]


def sample_reads(
    rng: np.random.Generator,
    alleles: Sequence[bytes],
    n: int,
    lengths: Sequence[int] = (150,),
    rc_frac: float = 0.5,
    sub_frac: float = 0.25,
    sub_rate: float = 0.005,
    n_frac: float = 0.01,
    tail_frac: float = 0.0,
) -> List[bytes]:
    """n reads: length drawn from `lengths`, start uniform in the allele
    (or flush with its end for a `tail_frac` share), reverse-complemented
    for `rc_frac`, with `sub_rate` substitutions in a `sub_frac` share and
    one N in an `n_frac` share."""
    lens = np.asarray(lengths)[rng.integers(0, len(lengths), n)]
    which = rng.integers(0, len(alleles), n)
    reads = []
    for i in range(n):
        ref = np.frombuffer(alleles[which[i]], np.uint8)
        ln = int(min(lens[i], len(ref)))
        if rng.random() < tail_frac:
            start = len(ref) - ln
        else:
            start = int(rng.integers(0, len(ref) - ln + 1))
        r = ref[start : start + ln].copy()
        if rng.random() < sub_frac:
            k = rng.random(ln) < sub_rate
            r[k] = _ACGT[(np.searchsorted(_ACGT, r[k]) + rng.integers(1, 4, int(k.sum()))) % 4]
        if rng.random() < n_frac:
            r[int(rng.integers(0, ln))] = ord("N")
        if rng.random() < rc_frac:
            r = _COMP[r[::-1]]
        reads.append(r.tobytes())
    return reads


def tiny_db(msa_dir: str, seed: int = 42) -> List[bytes]:
    """The test fixture: 4 clusters x 3 alleles x 400 bp (index it at
    k31 s20 w100). Writes the MSAs and returns the ungapped alleles."""
    clusters = make_clusters(
        np.random.default_rng(seed), 4, alleles=(3, 3), mean_alleles=3,
        length=(400, 400), max_div=0.03,
    )
    write_msa_dir(clusters, msa_dir)
    return alleles_of(clusters)


def write_fastq(reads: Sequence[bytes], path: str, prefix: str = "r") -> None:
    with open(path, "wb") as fh:
        for i, s in enumerate(reads):
            fh.write(b"@%s%d\n%s\n+\n%s\n" % (prefix.encode(), i, s, b"I" * len(s)))
