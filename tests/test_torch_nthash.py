"""The port's KHF sketch (groot_tpu_torch.ops) against the reference's.

The plain PyTorch version must equal the numpy golden
(groot_tpu.ops.nthash.khf_sketch_np_batch) and the Pallas kernel run in
interpret mode, bit for bit (the CUDA kernel is held to the plain version
in test_torch_kernels.py)."""

import numpy as np
import pytest
import torch

from groot_tpu.io import native
from groot_tpu.ops import nthash as ref_nthash
from groot_tpu.ops import u64
from groot_tpu.ops.pallas_sketch import khf_sketch_pallas
from groot_tpu_torch.ops import nthash
from groot_tpu_torch.ops.sketch import KHF_SKETCH, khf_sketch, sketch_reads_u64

SHAPES = [(31, 20), (51, 30), (31, 128)]


def _batch(seed, B, L, lo):
    """Ragged reads with N bases; positions past each length are N."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    lens = rng.integers(lo, L + 1, size=B).astype(np.int32)
    codes[rng.random((B, L)) < 0.02] = 4
    for i in range(B):
        codes[i, lens[i] :] = 4
    lens[:2] = (lo - 1, 5)  # rows with too few (or no) k-mers
    return codes, lens


def _sketch(codes, lens, k, s):
    out = nthash.khf_sketch_torch(
        torch.from_numpy(codes), torch.from_numpy(lens), k, s
    )
    return out.numpy().view(np.uint64)


@pytest.mark.parametrize("k,s", SHAPES)
def test_khf_sketch_torch_matches_np_batch(k, s):
    codes, lens = _batch(1, 64, 150, k)
    expect = ref_nthash.khf_sketch_np_batch(codes, lens, k, s)
    assert (_sketch(codes, lens, k, s) == expect).all()


@pytest.mark.parametrize("k,s", SHAPES)
def test_khf_sketch_torch_matches_pallas_interpret(k, s):
    codes, lens = _batch(2, 16, 256, 100)
    hi, lo = khf_sketch_pallas(codes, lens, k, s, interpret=True)
    expect = u64.to_np(np.asarray(hi), np.asarray(lo))
    assert (_sketch(codes, lens, k, s) == expect).all()


@pytest.mark.parametrize("s", [65, 128, 256])
def test_khf_sketch_wrapper_any_s_matches_pallas_interpret(s):
    """The wrapper takes any s (the kernel runs more than 64 slots in
    groups of at most 64): at s = 65, 128 and 256 its output equals the
    Pallas kernel's in interpret mode, bit for bit."""
    codes, lens = _batch(7, 8, 200, 40)
    got = khf_sketch(torch.from_numpy(codes), torch.from_numpy(lens), 31, s)
    hi, lo = khf_sketch_pallas(codes, lens, 31, s, interpret=True)
    assert got.shape == (8, s)
    assert (got.numpy().view(np.uint64) == u64.to_np(np.asarray(hi), np.asarray(lo))).all()


@pytest.mark.parametrize("k,s", SHAPES)
def test_khf_sketch_long_reads_match_np_batch(k, s):
    """Contig-length rows (FASTA input): past 30k bases, with lengths on and
    around the CUDA kernel's 1024-k-mer tile edges."""
    codes, lens = _batch(6, 4, 33_000, k)
    lens[:] = (33_000, 1024 + k - 1, 2048 + k, 31_000)
    got = sketch_reads_u64(codes, lens, k, s, "cpu")
    assert (got == ref_nthash.khf_sketch_np_batch(codes, lens, k, s)).all()


@pytest.mark.parametrize("k,s", SHAPES)
def test_khf_sketch_reverse_complement_canonical(k, s):
    rng = np.random.default_rng(3)
    L = 120
    codes = rng.integers(0, 4, size=(8, L)).astype(np.uint8)
    rc = nthash.RC_CODE_NP[codes][:, ::-1].copy()
    lens = np.full(8, L, np.int32)
    fwd = _sketch(codes, lens, k, s)
    assert (fwd == _sketch(rc, lens, k, s)).all()
    for i in range(8):
        assert (fwd[i] == nthash.khf_sketch_np(codes[i], k, s)).all()


@pytest.mark.parametrize("L", [1500, 33_000])
@pytest.mark.parametrize("k", [31, 33, 51, 64, 65, 97, 1024])
def test_prefix_xor_identity_matches_direct_and_reference(k, L):
    """The CUDA sketch's hash (canonical_hashes_prefix_np walks its chunks,
    carries and ring) equals the direct O(k) formula and the reference's
    JAX canonical_hashes; k = 64 and 65 wrap the rotates, k = 33 and 97 need
    the next ring size (k + 32 = 65, 129), k = 1,024 is the kernel's
    limit and a 33 kb read walks ~1,000 chunks."""
    rng = np.random.default_rng(k + L)
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    codes[rng.random(L) < 0.01] = 4
    got = nthash.canonical_hashes_prefix_np(codes, k)
    assert got.shape == (L - k + 1,)
    assert (got == nthash.canonical_hashes_np(codes, k)).all()
    hi, lo = ref_nthash.canonical_hashes(codes, k)
    assert (got == u64.to_np(np.asarray(hi), np.asarray(lo))).all()


def test_sketch_wrapper_cpu_and_native():
    k, s = 31, 20
    codes, lens = _batch(4, 32, 150, k)
    before = KHF_SKETCH.launches
    got = sketch_reads_u64(codes, lens, k, s, "cpu")
    assert KHF_SKETCH.launches == before  # the CPU path launches nothing
    assert (got == ref_nthash.khf_sketch_np_batch(codes, lens, k, s)).all()
    nat = native.sketch(codes, lens, k, s)
    if nat is not None:
        assert (got == nat).all()
    with pytest.raises(TypeError):
        khf_sketch(torch.from_numpy(codes).long(), torch.from_numpy(lens), k, s)
    with pytest.raises(TypeError):
        khf_sketch(torch.from_numpy(codes), torch.from_numpy(lens).long(), k, s)
    with pytest.raises(ValueError):
        khf_sketch(torch.from_numpy(codes), torch.from_numpy(lens), 1025, s)

