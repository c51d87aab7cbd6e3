"""The port's copies of ops/minhash.py and io/seqio.py against groot_tpu's.

The same seeded inputs go through both packages: KHF and KMV sketches and
their similarities, run_minhash (KMV zero padding), the Bloom filter's bits,
and the read helpers (base_check, rev_complement, qual_trim, deep_copy).
Everything is exact: the sketches are integers and the helpers bytes."""

import numpy as np
import pytest

from groot_tpu.io import seqio as ref_seqio
from groot_tpu.io.fastx import FastqRead as RefRead
from groot_tpu.ops import minhash as ref_minhash
from groot_tpu_torch.io import seqio
from groot_tpu_torch.io.fastx import FastqRead
from groot_tpu_torch.ops import minhash


def _seq(rng, n, n_frac=0.02):
    s = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    s[rng.random(n) < n_frac] = ord("N")
    return s.tobytes()


@pytest.mark.parametrize("seed,k,s,n", [(0, 7, 10, 30), (1, 21, 16, 120),
                                        (2, 31, 21, 400)])
def test_sketches_match_reference(seed, k, s, n):
    rng = np.random.default_rng(seed)
    a, b = _seq(rng, n), _seq(rng, n)
    for kind in ("KHFsketch", "KMVsketch"):
        mine = [getattr(minhash, kind)(k, s) for _ in range(2)]
        ref = [getattr(ref_minhash, kind)(k, s) for _ in range(2)]
        for m, r, seq in zip(mine, ref, (a, b)):
            m.add_sequence(seq)
            r.add_sequence(seq)
            np.testing.assert_array_equal(m.get_sketch(), r.get_sketch())
        assert mine[0].get_similarity(mine[1]) == ref[0].get_similarity(ref[1])
    for kmv in (False, True):
        np.testing.assert_array_equal(
            minhash.run_minhash(a[: k + 3], k, s, kmv=kmv),
            ref_minhash.run_minhash(a[: k + 3], k, s, kmv=kmv),
        )
    with pytest.raises(ValueError):
        minhash.KHFsketch(k, s).add_sequence(a[: k - 1])


@pytest.mark.parametrize("seed", [0, 1])
def test_bloom_filter_matches_reference(seed):
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 2**62, 500).tolist()
    mine, ref = minhash.BloomFilter(12), ref_minhash.BloomFilter(12)
    for v in values:
        mine.add(v)
        ref.add(v)
    np.testing.assert_array_equal(mine.bits, ref.bits)
    probes = rng.integers(0, 2**62, 200).tolist() + values[:50]
    assert [mine.check(v) for v in probes] == [ref.check(v) for v in probes]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seqio_helpers_match_reference(seed):
    rng = np.random.default_rng(seed)
    raw = bytes(rng.integers(32, 127, 64).astype(np.uint8))
    assert seqio.base_check(raw) == ref_seqio.base_check(raw)
    for _ in range(20):
        n = int(rng.integers(1, 60))
        seq = _seq(rng, n, 0.1)
        qual = bytes(rng.integers(33, 74, n).astype(np.uint8))
        mine = FastqRead(id=b"@r", seq=seq, qual=qual)
        ref = RefRead(id=b"@r", seq=seq, qual=qual)
        cp = seqio.deep_copy(mine)
        seqio.rev_complement(mine)
        ref_seqio.rev_complement(ref)
        assert (mine.seq, mine.qual, mine.rc) == (ref.seq, ref.qual, ref.rc)
        assert cp.seq == seq and not cp.rc
        min_qual = int(rng.integers(5, 35))
        seqio.qual_trim(mine, min_qual)
        ref_seqio.qual_trim(ref, min_qual)
        assert (mine.seq, mine.qual) == (ref.seq, ref.qual)
