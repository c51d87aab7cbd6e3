"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it runs on the machine with the card (which
has none): `python -m pytest tests/test_torch_kernels.py -m cuda`. The
card tests skip themselves where torch.cuda.is_available() is false; the
registry test runs everywhere."""

import copy
import os
import re

import numpy as np
import pytest
import torch

from groot_tpu.align.batch_host import WindowTables
from groot_tpu.config import Info
from groot_tpu.io.fastx import FastqRead
from groot_tpu.graph.grootgraph import GrootGraph
from groot_tpu.io import native
from groot_tpu.io.msa2gfa import msa_to_gfa
from groot_tpu_torch import _build, synth
from groot_tpu_torch.align import device_join as dj
from groot_tpu_torch.em import em
from groot_tpu_torch.index import window
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
        "window_sketch": "def window_sketches",
        "em_batched": "def _run_em_batched",
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
                   index_dir=str(tmp_path / "idx")), str(tmp_path / "msa"), "cpu")
    info = Info.load(str(tmp_path / "idx" / "groot.gg"))
    index = ContainmentIndex.load(str(tmp_path / "idx" / "groot.lshe"))
    info.attach_db(index)
    tables = WindowTables(index, info.store)
    al = dj.DeviceJoinAligner(
        info.store, bamio.build_references(info.store), device=cuda
    )
    al.attach_tables(tables, index, K)
    seqs, _which, _starts = synth.sample_reads(
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


def _window_rows(rng, L: int):
    """Ragged rows with Ns up to L bases, rows whose window counts sit on
    the kernel's 1,024-window tile edges, and rows with constant and copied
    stretches so that runs of identical sketches cross tile edges."""
    lens = [L, L - 1, 1023 + 150, 1024 + 150, 1025 + 150, 2048 + 149, 150,
            149, 2700, 2600]
    lens += rng.integers(100, L + 1, size=22).tolist()
    codes = rng.integers(0, 4, size=(len(lens), L)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.005] = 4
    for i, n in enumerate(lens):
        codes[i, n:] = 4
        if n >= 2600:
            codes[i, 1000:1300] = codes[i, 0]
            codes[i, 1900:2150] = 2
            codes[i, 400:700] = codes[i, 1500:1800]
    return codes, np.array(lens, np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("k,s,w,L", [(31, 20, 150, 3000), (31, 16, 100, 3000),
                                     (7, 16, 40, 3000), (31, 20, 150, 40_000)])
def test_window_sketch_kernel_matches_plain_and_native(cuda, k, s, w, L):
    assert _build.native_runtime()
    codes, lens = _window_rows(np.random.default_rng(L + k), L)
    c, v = torch.from_numpy(codes).to(cuda), torch.from_numpy(lens).to(cuda)
    before = window.WINDOW_SKETCH.launches
    got = window.window_run_starts(c, v, k, s, w)
    torch.cuda.synchronize()
    assert window.WINDOW_SKETCH.launches == before + 1
    plain = window.window_run_starts_torch(c, v, k, s, w)
    for a, b in zip(got, plain):
        assert torch.equal(a.long(), b.long())
    want = native.window_sketch(codes, lens.astype(np.int64), k, s, w)
    rows, cols, sk, counts = (t.cpu().numpy() for t in got)
    np.testing.assert_array_equal(rows, want[0])
    np.testing.assert_array_equal(cols, want[1])
    np.testing.assert_array_equal(sk.view(np.uint64), want[2])
    np.testing.assert_array_equal(counts, want[3])


@pytest.mark.cuda
def test_index_on_card_equals_cpu(cuda, tmp_path):
    synth.tiny_db(str(tmp_path / "msa"))
    for dev in ("cpu", "cuda"):
        run_index(Info(kmer_size=K, sketch_size=S, window_size=W,
                       index_dir=str(tmp_path / dev)), str(tmp_path / "msa"), dev)
    a = ContainmentIndex.load(str(tmp_path / "cuda" / "groot.lshe"))
    b = ContainmentIndex.load(str(tmp_path / "cpu" / "groot.lshe"))
    assert a.window_keys == b.window_keys
    for name, arr in b.soa.items():
        np.testing.assert_array_equal(a.soa[name], arr, err_msg=name)


def _em_batch(seed: int, G: int = 40, E: int = 300, Pn: int = 12):
    """A padded EM batch: graphs of 1..Pn paths, ecs of 1..n paths, some
    counts 0, some ecs padding."""
    rng = np.random.default_rng(seed)
    n_paths = rng.integers(1, Pn + 1, size=G).astype(np.int32)
    membership = np.zeros((G, E, Pn), np.float32)
    counts = np.zeros((G, E), np.float32)
    for g in range(G):
        n_ec = int(rng.integers(5, E + 1))
        for e in range(n_ec):
            k = int(rng.integers(1, n_paths[g] + 1))
            membership[g, e, rng.choice(n_paths[g], size=k, replace=False)] = 1
        counts[g, :n_ec] = rng.integers(0, 300, size=n_ec) / rng.integers(
            20, 200, size=n_ec
        )
        counts[g, rng.random(E) < 0.1] = 0
    return (torch.from_numpy(membership), torch.from_numpy(counts),
            torch.from_numpy(n_paths))


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [(50, 10000), (10, 40)])
def test_em_kernel_matches_plain(cuda, iters):
    args = [t.to(cuda) for t in _em_batch(7)]
    before = em.EM_BATCHED.launches
    it, alpha = em.em_batched(*args, *iters)
    torch.cuda.synchronize()
    assert em.EM_BATCHED.launches == before + 1
    it_p, alpha_p = em.run_em_batched_torch(*args, *iters)
    assert torch.equal(it, it_p)
    assert bool((it > iters[0]).all())
    tol = 1e-5 * alpha_p.abs().clamp(min=1.0)
    assert bool(((alpha - alpha_p).abs() <= tol).all())


@pytest.mark.cuda
def test_em_on_graphs_card_equals_cpu(cuda):
    rng = np.random.default_rng(5)
    graphs = []
    for gid in range(6):
        base = rng.integers(0, 4, size=400)
        rows = []
        for v in range(int(rng.integers(2, 6))):
            seq = base.copy()
            pos = rng.integers(0, 400, size=5)
            seq[pos] = (seq[pos] + 1 + v) % 4
            rows.append((f"g{gid}~~~a{v}", "".join("ACGT"[b] for b in seq)))
        g = GrootGraph.from_gfa(msa_to_gfa(rows, drop_consensus=False), gid)
        for node in g.sorted_nodes:
            node.kmer_freq = float(rng.integers(0, 500))
        graphs.append(g)
    out = {}
    for dev in ("cpu", "cuda"):
        gs = copy.deepcopy(graphs)
        em.run_em_on_graphs(gs, 50, 10000, dev)
        out[dev] = gs
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.em_iterations == b.em_iterations
        for pid, x in b.alpha.items():
            assert abs(a.alpha[pid] - x) <= 1e-5 * max(1.0, abs(x))
