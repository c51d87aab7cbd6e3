"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it runs on the machine with the card (which
has none): `python -m pytest tests/test_torch_kernels.py -m cuda`. The
card tests skip themselves where torch.cuda.is_available() is false; the
registry test runs everywhere."""

import os
import re

import numpy as np
import pytest
import torch

from groot_tpu.align.batch_host import WindowTables
from groot_tpu.config import Info
from groot_tpu.io.fastx import FastqRead
from groot_tpu_torch import _build, synth
from groot_tpu_torch.align import device_join as dj
from groot_tpu_torch.index.lshe import ContainmentIndex
from groot_tpu_torch.io import bam as bamio
from groot_tpu_torch.ops import nthash
from groot_tpu_torch.ops.sketch import KHF_SKETCH, khf_sketch
from groot_tpu_torch.pipeline.align_pipeline import _compute_hits, _make_batch
from groot_tpu_torch.pipeline.index_pipeline import run_index

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, S, W = 31, 20, 100


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_kernel_registry_names_sources_and_replaced_functions():
    """Every kernel names its CUDA source and the TPU/XLA function it
    replaces, by a file:line that holds that function."""
    want = {
        "khf_sketch": "def khf_sketch_pallas",
        "read_hash": "def _read_hash_fn",
        "seed_scan": "def seed_scan",
    }
    assert set(_build.KERNELS) == set(want)
    for name, kern in _build.KERNELS.items():
        src = open(os.path.join(REPO, kern.source)).read()
        assert re.search(rf'extern "C" int {kern.symbol}\(', src)
        path, line = kern.replaces.rsplit(":", 1)
        lines = open(os.path.join(REPO, path)).read().splitlines()
        assert lines[int(line) - 1].lstrip().startswith(want[name]), kern.replaces


@pytest.mark.cuda
@pytest.mark.parametrize("k,s,L", [(31, 20, 150), (51, 30, 100)])
def test_khf_sketch_kernel_matches_plain(cuda, k, s, L):
    rng = np.random.default_rng(5)
    B = 4096
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.02] = 4
    lens = rng.integers(k - 2, L + 1, size=B).astype(np.int32)
    c, v = torch.from_numpy(codes).to(cuda), torch.from_numpy(lens).to(cuda)
    before = KHF_SKETCH.launches
    got = khf_sketch(c, v, k, s)
    torch.cuda.synchronize()
    assert KHF_SKETCH.launches == before + 1
    assert torch.equal(got, nthash.khf_sketch_torch(c, v, k, s))
    assert (got.cpu().numpy().view(np.uint64)
            == nthash.khf_sketch_np_batch(codes, lens, k, s)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k,s", [(31, 20), (51, 30)])
def test_khf_sketch_kernel_long_reads(cuda, k, s):
    """Rows past 30k bases (FASTA contigs) launch with the kernel's fixed
    shared memory, including lengths on the 1024-k-mer tile edges."""
    rng = np.random.default_rng(6)
    B, L = 16, 40_000
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.02] = 4
    lens = rng.integers(k, L + 1, size=B).astype(np.int32)
    lens[:5] = (L, 1024 + k - 1, 1024 + k, 2048 + k - 1, k - 1)
    c, v = torch.from_numpy(codes).to(cuda), torch.from_numpy(lens).to(cuda)
    got = khf_sketch(c, v, k, s)
    torch.cuda.synchronize()
    assert torch.equal(got, nthash.khf_sketch_torch(c, v, k, s))
    assert (got.cpu().numpy().view(np.uint64)
            == nthash.khf_sketch_np_batch(codes, lens, k, s)).all()


@pytest.mark.cuda
def test_phase_a_kernels_match_plain(cuda, tmp_path):
    alleles = synth.tiny_db(str(tmp_path / "msa"))
    run_index(Info(kmer_size=K, sketch_size=S, window_size=W,
                   index_dir=str(tmp_path / "idx")), str(tmp_path / "msa"))
    info = Info.load(str(tmp_path / "idx" / "groot.gg"))
    index = ContainmentIndex.load(str(tmp_path / "idx" / "groot.lshe"))
    info.attach_db(index)
    tables = WindowTables(index, info.store)
    al = dj.DeviceJoinAligner(
        info.store, bamio.build_references(info.store), device=cuda
    )
    al.attach_tables(tables, index, K)
    seqs = synth.sample_reads(
        np.random.default_rng(11), alleles, 300,
        lengths=(60, 100, 150, 190), n_frac=0.05, tail_frac=0.3,
    )
    batch = _make_batch([
        FastqRead(id=b"@t%d" % i, seq=s, qual=b"I" * len(s))
        for i, s in enumerate(seqs)
    ])
    kc = (batch.lengths - K + 1).astype(np.int32)
    rows, wins, combo_start = _compute_hits(
        info, batch, kc, K, S, 0.99, tables, cuda
    )
    st = al.phase_a_rows(batch, rows, wins, combo_start)
    codes, lens, rpow32, rinv32, rows_t, sx = al.phase_a_inputs(batch, st)
    args = (codes, lens, rpow32, rinv32, K, sx["WPH"])
    PH = dj.read_hashes(*args)
    for a, b in zip(PH, dj.read_hashes_torch(*args)):
        assert torch.equal(a, b)
    kw = dict(D1=sx["D1"], k=K, n_offs=sx["n_offs"])
    got = dj.seed_scan(al._dev, *PH, *rows_t, **kw)
    want = dj.seed_scan_torch(al._dev, *PH, *rows_t, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ((got & 0xFF) < 255).sum() > 10
