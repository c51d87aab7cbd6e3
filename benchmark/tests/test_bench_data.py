"""The generators: the database belongs to the configuration, the reads to
the seed, and no seed changes how much of each kind of work there is."""

import json
from typing import Dict, Sequence

import numpy as np
import pytest

from conftest import BENCH
from harness import data

COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    COMP[_a] = _b

SEEDS = [0, 1, 7, 42, 1000, 2**31 - 1, 2**31 + 5, 123456789, 987654321, 5555,
         31337, 2**32 + 17]


def kind_counts(reads: np.ndarray, names: Sequence[bytes], origin: np.ndarray,
                clusters) -> dict:
    """Counts of each kind of read, worked out from the reads themselves:
    per allele, reverse complemented, substitutions per read, with an N,
    background. The tests hold them equal across seeds."""
    alleles = data.alleles_of(clusters)
    arg = np.flatnonzero(origin >= 0)
    per_allele = np.bincount(origin[arg], minlength=len(alleles))
    rc = 0
    subs: Dict[int, int] = {}
    n_n = 0
    for i in arg.tolist():
        f = names[i].split(b"_")
        start = int(f[2])
        ref = np.frombuffer(alleles[origin[i]], np.uint8)[start : start + reads.shape[1]]
        r = reads[i]
        d_fwd = int((r != ref).sum())
        rr = COMP[r[::-1]]
        d_rc = int((rr != ref).sum())
        if d_rc < d_fwd:
            rc += 1
            r = rr
        has_n = bool((r == ord("N")).any())
        n_n += has_n
        j = int(((r != ref) & (r != ord("N"))).sum())
        if j:
            subs[j] = subs.get(j, 0) + 1
    return {"per_allele": per_allele.tolist(), "rc": rc, "subs": subs,
            "n": n_n, "background": int((origin < 0).sum()),
            "length": int(reads.shape[1])}


def _cfg(clusters=30):
    cfg = json.loads((BENCH / "configs" / "argannot90_w150_s20.json").read_text())
    cfg["clusters"] = clusters
    return cfg


def test_database_is_the_configurations():
    a = data.database(_cfg())
    b = data.database(_cfg())
    assert a == b
    cfg = _cfg()
    cfg["db_seed"] = 1
    assert data.database(cfg) != a


def test_reads_are_the_seeds(tmp_path):
    clusters = data.database(_cfg())
    mix = json.loads((BENCH / "traffic" / "dense.json").read_text())
    mix.update(reads=2000, arg_reads=2000)
    r1 = data.sample(mix, clusters, 99, 0)
    r2 = data.sample(mix, clusters, 99, 0)
    assert np.array_equal(r1[0], r2[0]) and r1[1] == r2[1]
    data.write_fastq(r1[0], r1[1], str(tmp_path / "a.fq"))
    data.write_fastq(r2[0], r2[1], str(tmp_path / "b.fq"))
    assert (tmp_path / "a.fq").read_bytes() == (tmp_path / "b.fq").read_bytes()
    r3 = data.sample(mix, clusters, 100, 0)
    assert not np.array_equal(r1[0], r3[0])


@pytest.mark.parametrize("mix_name", ["dense", "dense100", "metagenome"])
def test_same_work_for_every_seed(mix_name):
    """For a dozen seeds, each mix (its shares, at 6,000 reads) gives the
    same reads per allele, reverse complements, substitutions per read,
    reads with an N and background reads."""
    clusters = data.database(_cfg())
    mix = json.loads((BENCH / "traffic" / f"{mix_name}.json").read_text())
    scale = 6000 / mix["reads"]
    mix.update(reads=6000, arg_reads=max(int(mix["arg_reads"] * scale), 400))
    counts = [kind_counts(*data.sample(mix, clusters, s, 0), clusters) for s in SEEDS]
    assert all(c == counts[0] for c in counts[1:])
    c = counts[0]
    assert c["rc"] == round(mix["arg_reads"] * mix["rc_share"])
    assert c["n"] == round(mix["arg_reads"] * mix["n_share"])
    assert sum(c["per_allele"]) == mix["arg_reads"]
    assert max(c["per_allele"]) - min(c["per_allele"]) <= 1
    assert c["background"] == mix["reads"] - mix["arg_reads"]


def test_substitution_profile():
    prof = data.substitution_profile(30000, 150, 0.005)
    assert prof[1] == round(30000 * 150 * 0.005 * 0.995**149)
    assert sum(prof.values()) < 30000
