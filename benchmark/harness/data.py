"""The benchmark's inputs: a synthetic clustered ARG database, fixed by the
configuration, and read sets drawn from `--seed` in fixed amounts.

`make_clusters` is a frozen copy of the port's `synth.make_clusters`, so a
later change to the port cannot move the database: at `db_seed` 0 and 583
clusters it is the database `chip_smoke.py` runs. The reads are drawn here
so that a seed moves read positions, strands and error sites but never the
amount of work: every seed gives the same number of reads per allele, the
same number of reverse complements, the same number of reads with each
count of substitutions, the same number with an N, and the same length.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

_ACGT = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _COMP[_a] = _b

# the database keys of a configuration file (everything else is the index
# settings, the thread count and the documentation)
DB_KEYS = ("db_seed", "clusters", "alleles", "mean_alleles", "length",
           "max_div", "max_gaps")


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


def database(config: dict) -> List[List[Tuple[str, bytes]]]:
    """The configuration's clusters, from its own `db_seed`."""
    return make_clusters(
        np.random.default_rng(int(config["db_seed"])),
        int(config["clusters"]),
        alleles=tuple(config["alleles"]),
        mean_alleles=float(config["mean_alleles"]),
        length=tuple(config["length"]),
        max_div=float(config["max_div"]),
        max_gaps=int(config["max_gaps"]),
    )


def write_msa_dir(clusters, out_dir: str) -> None:
    """One aligned FASTA `cluster-N.msa` a cluster, the layout `index` reads."""
    os.makedirs(out_dir, exist_ok=True)
    for c, rows in enumerate(clusters):
        with open(os.path.join(out_dir, f"cluster-{c}.msa"), "wb") as fh:
            for name, seq in rows:
                fh.write(b">%s\n%s\n" % (name.encode(), seq))


def alleles_of(clusters) -> List[bytes]:
    """Ungapped allele sequences, in cluster then allele order."""
    return [seq.replace(b"-", b"") for rows in clusters for _n, seq in rows]


def allele_names(clusters) -> List[str]:
    return [name for rows in clusters for name, _seq in rows]


def _spread(total: int, n: int, order: np.ndarray) -> np.ndarray:
    """`total` split over n slots as evenly as it goes, the remainder one
    each to the first slots of `order`."""
    counts = np.full(n, total // n, np.int64)
    counts[order[: total % n]] += 1
    return counts


def substitution_profile(n_reads: int, length: int, rate: float) -> Dict[int, int]:
    """{substitutions: reads} for `n_reads` reads that each carry a
    `rate` per base: the binomial's expected counts, rounded, the rest of
    the reads carrying none. The same for every seed."""
    prof = {}
    left = n_reads
    for j in range(1, length + 1):
        c = int(round(n_reads * math.comb(length, j) * rate**j
                      * (1 - rate) ** (length - j)))
        if c == 0 and j > 3:
            break
        c = min(c, left)
        if c:
            prof[j] = c
            left -= c
    return prof


def plan(traffic: dict, n_alleles: int, fixed: np.ndarray) -> dict:
    """What a traffic mix asks for, worked out without the seed: reads of
    each allele, and how many reads are reverse complemented, carry j
    substitutions, carry an N, or are background."""
    n_arg = int(traffic["arg_reads"])
    return {
        "n_reads": int(traffic["reads"]),
        "n_arg": n_arg,
        "length": int(traffic["length"]),
        "per_allele": _spread(n_arg, n_alleles, fixed),
        "n_rc": int(round(n_arg * float(traffic["rc_share"]))),
        "subs": substitution_profile(
            int(round(n_arg * float(traffic["sub_share"]))),
            int(traffic["length"]), float(traffic["sub_rate"])),
        "n_n": int(round(n_arg * float(traffic["n_share"]))),
    }


def sample(traffic: dict, clusters, seed: int, fixed_seed: int):
    """The reads of a traffic mix for `seed`: (u8 bases [n, L], names,
    origin allele per read or -1 for background). Which alleles take the
    remainder of the even spread is fixed by `fixed_seed` (the
    configuration's); everything the seed draws is a position: which read
    is which kind, where it starts, where its errors sit."""
    alleles = alleles_of(clusters)
    names = allele_names(clusters)
    fixed = np.random.default_rng(fixed_seed).permutation(len(alleles))
    p = plan(traffic, len(alleles), fixed)
    L, n, n_arg = p["length"], p["n_reads"], p["n_arg"]
    rng = np.random.default_rng(seed)
    al_len = np.array([len(a) for a in alleles], np.int64)
    if (al_len < L).any():
        raise ValueError(f"an allele is shorter than the reads ({L} bp)")
    pad = np.full((len(alleles), int(al_len.max())), ord("N"), np.uint8)
    for i, a in enumerate(alleles):
        pad[i, : len(a)] = np.frombuffer(a, np.uint8)

    which = np.repeat(np.arange(len(alleles)), p["per_allele"])
    which = which[rng.permutation(n_arg)]
    starts = (rng.random(n_arg) * (al_len[which] - L + 1)).astype(np.int64)
    reads = pad[which[:, None], starts[:, None] + np.arange(L)[None, :]]

    # the kinds, each a fixed number of reads chosen by the seed; a
    # substitution never lands on a read's N, so the counts stay exact
    n_pos = np.full(n_arg, -1, np.int64)
    n_rows = rng.permutation(n_arg)[: p["n_n"]]
    n_pos[n_rows] = rng.integers(0, L, p["n_n"])
    sub_reads = rng.permutation(n_arg)
    at = 0
    for j, cnt in sorted(p["subs"].items()):
        rows = sub_reads[at : at + cnt]
        at += cnt
        keys = rng.random((cnt, L))
        has_n = n_pos[rows] >= 0
        keys[np.flatnonzero(has_n), n_pos[rows][has_n]] = 2.0
        pos = np.argsort(keys, axis=1)[:, :j]
        r = rows[:, None]
        old = np.searchsorted(_ACGT, reads[r, pos])
        reads[r, pos] = _ACGT[(old + rng.integers(1, 4, (cnt, j))) % 4]
    reads[n_rows, n_pos[n_rows]] = ord("N")
    rc = np.zeros(n_arg, bool)
    rc[rng.permutation(n_arg)[: p["n_rc"]]] = True
    reads[rc] = _COMP[reads[rc][:, ::-1]]

    read_names = [
        b"%d_0_%d_%d_%d_0_0_0_0_%s" % (i, s, s + L - 1, L, names[w].encode())
        for i, (w, s) in enumerate(zip(which.tolist(), starts.tolist()))
    ]
    origin = which
    n_bg = n - n_arg
    if n_bg:
        bg = _ACGT[rng.integers(0, 4, (n_bg, L))]
        reads = np.concatenate([reads, bg])
        read_names += [b"bg%d" % i for i in range(n_bg)]
        origin = np.concatenate([which, np.full(n_bg, -1, np.int64)])
        order = rng.permutation(n)
        reads, origin = reads[order], origin[order]
        read_names = [read_names[i] for i in order.tolist()]
    return reads, read_names, origin


def write_fastq(reads: np.ndarray, names: Sequence[bytes], path: str) -> int:
    """Reads of one length as FASTQ (quality 'I'); returns the bytes."""
    L = reads.shape[1]
    qual = b"I" * L
    parts = []
    for name, seq in zip(names, reads):
        parts.append(b"@%s\n%s\n+\n%s\n" % (name, seq.tobytes(), qual))
    data = b"".join(parts)
    with open(path, "wb") as fh:
        fh.write(data)
    return len(data)
