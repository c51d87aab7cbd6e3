"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it runs on a machine with a card and no JAX:
`python -m pytest tests/test_torch_kernels.py -m cuda --noconftest`
(tests/conftest.py imports JAX). The
card tests skip themselves where torch.cuda.is_available() is false; the
registry test runs everywhere."""

import copy
import os
import re

import numpy as np
import pytest
import torch

from groot_tpu_torch import _build, synth
from groot_tpu_torch.align import aligner
from groot_tpu_torch.align import device_cascade as dc
from groot_tpu_torch.align import device_join as dj
from groot_tpu_torch.align.batch_host import WindowTables
from groot_tpu_torch.config import Info
from groot_tpu_torch.em import em
from groot_tpu_torch.graph.grootgraph import GrootGraph
from groot_tpu_torch.index import lshe, window
from groot_tpu_torch.index.lshe import ContainmentIndex
from groot_tpu_torch.io import bam as bamio
from groot_tpu_torch.io import native
from groot_tpu_torch.io.fastx import FastqRead
from groot_tpu_torch.io.msa2gfa import msa_to_gfa
from groot_tpu_torch.ops import nthash
from groot_tpu_torch.ops.sketch import KHF_SKETCH, khf_sketch
from groot_tpu_torch.parallel import device_index as pdi
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
        "lsh_query": "def _query_device",
        "weight_scatter": "def align_step",
        "pair_cascade": "def _pair_cascade",
        "match_bits": "def _match_bits",
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
@pytest.mark.parametrize("k,s,L,B", [
    (31, 20, 150, 2048),    # the main path's batch
    (31, 20, 150, 1001),    # B not a multiple of the 8 reads a block
    (31, 20, 150, 100),     # fewer reads than SMs: a read a block
    (64, 20, 300, 517),     # the rotates wrap at 64 ...
    (65, 20, 300, 517),     # ... and past it
    (33, 20, 160, 256),     # k + 32 = 65: the next ring size
    (1024, 20, 3000, 40),   # the longest k: one 32 KB ring a block
    (31, 1, 150, 300),      # one slot
    (31, 8, 150, 77),       # the edges of each register-array size
    (31, 9, 150, 77),
    (31, 33, 150, 77),
    (31, 64, 150, 300),     # the most slots: two a lane
    (31, 20, 40_000, 64),   # contigs: 8 warps share a read
    (65, 64, 5_000, 33),    # a shared read, two slots a lane
    (51, 30, 1_024, 100),   # the shortest shared reads, most with idle warps
    (31, 65, 150, 300),     # past 64 slots: two groups (33 + 32)
    (31, 128, 150, 2048),   # two groups of 64, the main path's batch
    (31, 256, 150, 517),    # four groups
    (31, 128, 40_000, 16),  # groups of a shared read
    (51, 200, 1_024, 50),   # four groups of 50, shared reads
])
def test_khf_sketch_kernel_shapes(cuda, k, s, L, B):
    """The kernel equals the plain version and the numpy golden: rows with
    too few k-mers (valid_len 0, < k, = k), valid_len = L and past it,
    all-N rows and codes above 4 (N)."""
    rng = np.random.default_rng(k * 1000 + s + B)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.02] = 4
    codes[rng.random((B, L)) < 0.002] = 200
    codes[1] = 4
    lens = rng.integers(k, L + 1, size=B).astype(np.int32)
    lens[:6] = (0, L, k - 1, k, L, L + 5)
    c, v = torch.from_numpy(codes).to(cuda), torch.from_numpy(lens).to(cuda)
    before = KHF_SKETCH.launches
    got = khf_sketch(c, v, k, s)
    torch.cuda.synchronize()
    assert KHF_SKETCH.launches == before + 1
    assert torch.equal(got, nthash.khf_sketch_torch(c, v, k, s))
    want = nthash.khf_sketch_np_batch(np.minimum(codes, 4), np.minimum(lens, L), k, s)
    assert (got.cpu().numpy().view(np.uint64) == want).all()
    assert (want[[0, 2]] == np.uint64(2**64 - 1)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,k,WPH", [
    (1765, 160, 31, 194),   # the main path's batch
    (13, 150, 31, 194),     # B not a multiple of the 8 reads a block, L of 32
    (517, 192, 31, 194),    # L = MAXL
    (64, 101, 51, 194),     # L not a multiple of 4: the codes staged bytewise
    (9, 33, 33, 194),       # one anchor a read
    (40, 700, 31, 701),     # past 512 bases: rows read back from device memory
])
def test_read_hash_kernel_matches_plain(cuda, B, L, k, WPH):
    """Every output equals the plain version's: lengths 0, below k, k and
    L, N bases, and codes above 4, which count as N."""
    rng = np.random.default_rng(B + L)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.02] = 4
    codes[rng.random((B, L)) < 0.005] = 77
    lens = rng.integers(1, L + 1, size=B).astype(np.int32)
    lens[:4] = (0, k - 1, L, k)
    tabs = rng.integers(-2**31, 2**31, size=(2, L + 2)).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda) for x in (codes, lens, tabs[0], tabs[1])]
    before = dj.READ_HASH.launches
    got = dj.read_hashes(*args, k, WPH)
    torch.cuda.synchronize()
    assert dj.READ_HASH.launches == before + 1
    want = dj.read_hashes_torch(args[0].clamp(max=4), *args[1:], k, WPH)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrappers_take_no_plain_route_off_the_cpu():
    """Only a CPU tensor takes the plain version: other devices raise, and
    the card raises where there is none."""
    codes = torch.zeros((4, 40), dtype=torch.uint8, device="meta")
    lens = torch.zeros(4, dtype=torch.int32, device="meta")
    tab = torch.zeros(42, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        khf_sketch(codes, lens, K, S)
    with pytest.raises(ValueError, match="no kernel"):
        dj.read_hashes(codes, lens, tab, tab, K, 194)
    if not torch.cuda.is_available():
        from groot_tpu_torch.ops.sketch import sketch_reads_u64

        with pytest.raises((RuntimeError, AssertionError)):
            sketch_reads_u64(np.zeros((4, 40), np.uint8), np.full(4, 40, np.int32),
                             K, S, "cuda")


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


def _edge_rows(al, n_reads: int, L: int, rng):
    """Seed-scan rows of every shape on each of the aligner's path rows:
    seeds from before the path's start (base < 0) to past its end, so
    overhangs of every length up to KA = 192 on terminal-free paths and path
    remainders shorter than the read; on the last path, rows whose words lie
    past the end of the flat table; stage-1 bounds from 0 to past D1; read
    lengths from 1 (<= k) to L."""
    parts = []
    for prow in range(al.R):
        plen = int(al.path_len[prow])
        base = np.unique(np.concatenate(
            [plen - np.arange(0, 200, 3), [plen + 3, -4, 0, plen // 2]]))
        n = len(base)
        parts.append(np.stack([
            rng.integers(0, n_reads, n), np.full(n, prow), base,
            rng.choice([0, 3, 40, 191, 250], n),
            rng.choice([1, K - 1, K, K + 1, 100, L - 1, L], n),
        ]))
    return np.concatenate(parts, axis=1).astype(np.int32)


def _scan_case(tmp_path, device, L: int):
    """A seed-scan call at the main path's shapes (k = 31, D1 = 192, reads
    up to L) on a small database whose alleles (140-420 bp) are partly
    shorter than the reads: the rows of a batch of reads (half of them flush
    with an allele's end) and _edge_rows. Returns (tables, PH, rows, kw)."""
    clusters = synth.make_clusters(np.random.default_rng(L), 5, alleles=(2, 4),
                                   length=(140, 420), max_div=0.03)
    synth.write_msa_dir(clusters, str(tmp_path / "msa"))
    run_index(Info(kmer_size=K, sketch_size=S, window_size=W,
                   index_dir=str(tmp_path / "idx")), str(tmp_path / "msa"), "cpu")
    info = Info.load(str(tmp_path / "idx" / "groot.gg"))
    index = ContainmentIndex.load(str(tmp_path / "idx" / "groot.lshe"))
    info.attach_db(index)
    tables = WindowTables(index, info.store)
    al = dj.DeviceJoinAligner(info.store, bamio.build_references(info.store),
                              device=device)
    al.attach_tables(tables, index, K)
    seqs, _which, _starts = synth.sample_reads(
        np.random.default_rng(L + 1), synth.alleles_of(clusters), 400,
        lengths=(L, L - 9, 60, 100), n_frac=0.05, tail_frac=0.5)
    seqs[0] = (seqs[0] * 2)[:L]  # one read of L bases sets the batch width
    batch = _make_batch([FastqRead(id=b"@t%d" % i, seq=s, qual=b"I" * len(s))
                         for i, s in enumerate(seqs)])
    kc = (batch.lengths - K + 1).astype(np.int32)
    rows, wins, combo_start = _compute_hits(info, batch, kc, K, S, 0.99, tables,
                                            device)
    st = al.phase_a_rows(batch, rows, wins, combo_start)
    codes, lens, rpow32, rinv32, _rows_t, sx = al.phase_a_inputs(batch, st)
    assert codes.shape[1] == L
    PH = dj.read_hashes(codes, lens, rpow32, rinv32, K, sx["WPH"])
    extra = _edge_rows(al, len(codes), L, np.random.default_rng(L + 2))
    rows_np = np.concatenate([st["rows_np"], extra], axis=1)
    rows_t = torch.from_numpy(rows_np).to(device)
    return al._dev, PH, rows_t, dict(D1=192, k=K, n_offs=sx["n_offs"])


@pytest.mark.cuda
@pytest.mark.parametrize("L", [160, 192])
def test_seed_scan_kernel_row_shapes(cuda, tmp_path, L):
    """The seed-scan kernel is bit-equal to its plain version, in one
    launch, on every row shape: lb <= k, sb below and past D1, paths and
    path remainders shorter than the read, rows at the end of the flat
    table, overhangs up to KA = 192 on terminal-free paths, reads of up to
    MAXL = 192 bases; and it finds stage-1, overhang and clip hits."""
    tables, PH, rows_t, kw = _scan_case(tmp_path, cuda, L)
    before = dj.SEED_SCAN.launches
    got = dj.seed_scan(tables, *PH, *rows_t, **kw)
    torch.cuda.synchronize()
    assert dj.SEED_SCAN.launches == before + 1
    want = dj.seed_scan_torch(tables, *PH, *rows_t, **kw)
    assert torch.equal(got, want)
    assert ((got & 0xFF) < 255).sum() > 10 and ((got >> 16) != 0).sum() > 10


@pytest.mark.cuda
@pytest.mark.parametrize("k,D1", [(31, 192), (31, 254), (5, 254), (2, 192)])
def test_seed_scan_kernel_random_tables(cuda, k, D1):
    """On random tables of 0/1 hashes (so chains, overhangs and clips hit
    often) the kernel is bit-equal to its plain version: ladders of at most
    the 8 anchors a lane holds (k = 31) and longer ones (k = 5, 2), whose
    further words each lane reads after the first 8; D1 up to 254, so rows
    of up to 8 passes of a warp's lanes."""
    rng = np.random.default_rng(k * 1000 + D1)
    R, U, L, Nr = 40, 300, 192, 4000
    plen = rng.integers(50, 600, R)
    start = np.concatenate([[0], np.cumsum(plen)[:-1]])
    dev = {
        "ah32": rng.integers(0, 2, int(plen.sum()) + 7), "pe2": rng.integers(0, 2, (R, dj.KA)),
        "ph_start": start, "path_len": plen, "tfree": rng.random(R) < 0.7, "rinv1": 1,
    }
    tables = dj._tables_to(dev, cuda)
    WPH, Lh = dj.KA + 2, L + 1 - k
    PH = [torch.from_numpy(x.astype(np.int32)).to(cuda) for x in (
        rng.integers(0, 3, (U, WPH)), rng.integers(0, 3, (U, WPH)),
        rng.integers(0, 2, (U, Lh)), rng.integers(0, 2, (U, Lh)))]
    prow = rng.integers(0, R, Nr)
    rows = np.stack([rng.integers(0, U, Nr), prow,
                     rng.integers(-5, plen[prow] + 6), rng.integers(0, 300, Nr),
                     rng.integers(1, L + 1, Nr)]).astype(np.int32)
    rows_t = torch.from_numpy(rows).to(cuda)
    kw = dict(D1=D1, k=k, n_offs=len(dj._offsets(L, k)))
    got = dj.seed_scan(tables, *PH, *rows_t, **kw)
    want = dj.seed_scan_torch(tables, *PH, *rows_t, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ((got & 0xFF) < 255).sum() > 100 and ((got >> 16) != 0).sum() > 100


def _window_rows(rng, L: int, w: int, tw: int):
    """Ragged rows with Ns up to L bases: rows whose window counts sit on
    the kernel's tile edges (tw windows) and one past them, rows of exactly
    w bases, shorter than w and empty, an all-N row, and rows with constant
    and copied stretches so that runs of identical sketches cross tile
    edges."""
    lens = [L, L - 1, w, w - 1, 0, 2700, 2600]
    lens += [n * tw + d + w - 1 for n in (1, 2, 4) for d in (-1, 0, 1)]
    lens = [n for n in lens if n <= L]
    lens += rng.integers(100, L + 1, size=22).tolist()
    codes = rng.integers(0, 4, size=(len(lens), L)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.005] = 4
    codes[len(lens) - 1] = 4  # all N
    for i, n in enumerate(lens):
        codes[i, n:] = 4
        if n >= 2600:
            codes[i, 1000:1300] = codes[i, 0]
            codes[i, 1900:2150] = 2
            codes[i, 400:700] = codes[i, 1500:1800]
    return codes, np.array(lens, np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("k,s,w,L", [(31, 20, 150, 3000), (31, 16, 100, 3000),
                                     (7, 16, 40, 3000), (31, 20, 150, 40_000),
                                     (31, 20, 31, 3000), (7, 3, 7, 3000),
                                     (31, 64, 150, 3000), (15, 200, 400, 3000),
                                     (31, 128, 150, 3000), (31, 1024, 150, 3000)])
def test_window_sketch_kernel_matches_plain_and_native(cuda, k, s, w, L):
    """m = 1 (w = k), an s that takes a narrower tile (s = 64, 128 and
    200), s = 1,024, where no tile holds every slot (the slots run in
    groups), every tile edge, short, empty and all-N rows."""
    assert _build.native_runtime()
    tw = window.tile_width(k, s, w, cuda)[0]
    codes, lens = _window_rows(np.random.default_rng(L + k + s), L, w, tw)
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
@pytest.mark.parametrize("k,s,w", [(31, 20, 150), (31, 64, 150), (15, 200, 400),
                                   (7, 1, 7)])
def test_window_tile_width_fits_shared_memory(cuda, k, s, w):
    """The kernel's tile: one of its widths, never wider as s grows, all s
    slots at once; at s = 2,000, which no tile holds, slot groups of fewer
    slots, with which the kernel equals its plain version and the native
    runtime."""
    tw, sg = window.tile_width(k, s, w, cuda)
    assert tw in (512, 256, 128, 64, 32) and sg == s
    assert tw <= window.tile_width(k, min(s, 20), w, cuda)[0]
    tw, sg = window.tile_width(k, 2000, w, cuda)
    assert tw in (512, 256, 128, 64, 32) and 1 <= sg < 2000
    codes, lens = _window_rows(np.random.default_rng(s), 2 * tw + w + 50, w, tw)
    c, v = torch.from_numpy(codes).to(cuda), torch.from_numpy(lens).to(cuda)
    got = window.window_run_starts(c, v, k, 2000, w)
    torch.cuda.synchronize()
    for a, b in zip(got, window.window_run_starts_torch(c, v, k, 2000, w)):
        assert torch.equal(a.long(), b.long())
    want = native.window_sketch(codes, lens.astype(np.int64), k, 2000, w)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy().view(b.dtype), b)


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
@pytest.mark.parametrize("n_paths,E,iters", [
    ([1] * 8, 300, (50, 10000)),              # one path: alpha 1 at once
    (list(range(1, 13)) * 3, 4000, (50, 10000)),  # masks, 32 warps a graph
    ([32, 17, 5, 32, 2], 2000, (50, 10000)),  # the widest mask route
    ([33, 12, 1, 32, 40, 0], 500, (50, 10000)),  # both routes in one batch
    ([100, 40, 3, 64], 1500, (50, 10000)),    # CSR, group widths 8 and 16
    ([12] * 6, 300, (10, 40)),                # graphs hit max_iterations
    ([5], 4000, (50, 10000)),                 # G = 1
])
def test_em_kernel_routes_match_plain(cuda, n_paths, E, iters):
    """Both routes of the EM kernel (masks up to 32 path lanes, CSR past
    them) give the plain version's iteration counts and its alphas within
    1e-5 of max(1, |alpha|), in one launch; the first graph of a batch of
    several has every count 0, and an empty graph (no paths) rides along."""
    m, c, n = synth.em_batch(len(n_paths) * 7 + E, n_paths, E)
    if len(n_paths) > 1:
        c[0] = 0.0
    args = [torch.from_numpy(x).to(cuda) for x in (m, c, n)]
    width = em.em_layout(*args)["width"]
    before = em.EM_BATCHED.launches
    it, alpha = em.em_batched(*args, *iters)
    torch.cuda.synchronize()
    assert em.EM_BATCHED.launches == before + 1
    it_p, alpha_p = em.run_em_batched_torch(*args, *iters)
    assert torch.equal(it, it_p)
    if iters[1] == 40:
        assert bool((it[1:] == 40).all())
    if max(n_paths) > 32:
        assert bool((width > 32).any()) and bool((width <= 32).any())
    tol = 1e-5 * alpha_p.abs().clamp(min=1.0)
    assert bool(((alpha - alpha_p).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("n_paths", [[3, 7, 2], [3, 40, 33]])
def test_em_kernel_large_batches_match_plain(cuda, n_paths, seed):
    """E = 30,000: graphs of more than 27,008 live ecs read their masks
    and counts from device memory (the mask route), or, on the CSR route,
    stage only their counts, quotients and alphas or, where even those
    pass the shared memory (seed 1), keep them in the scratch, beside a
    graph of 100 live ecs staged as before, in one launch: the launch plan
    stays within the card's shared memory and sizes a scratch exactly when
    the CSR graph's words pass it; the plain version's iteration counts,
    its alphas within 1e-5 of max(1, |alpha|)."""
    m, c, n = synth.em_batch(seed, n_paths, 30_000, zero_frac=0.02, min_fill=0.95)
    c[2, 100:] = 0.0
    args = [torch.from_numpy(x).to(cuda) for x in (m, c, n)]
    lay = em.em_layout(*args)
    n_live, width = lay["n_live"].long(), lay["width"].long()
    assert int(n_live[:2].min()) > 27_008 and int(n_live[2]) <= 100
    G, E, Pn = m.shape
    least = int(torch.where(width > em.MASK_LANES, 2 * n_live + 2 * width, 0).max())
    words = _build.card_query(cuda, "groot_em_smem_words", E, least, 0)
    assert 4 * 32 * 32 <= words <= _build.smem_optin(cuda) // 4 < 2 * int(n_live[:2].min()) + 4 * 32 * 32
    nbytes = _build.card_query(cuda, "groot_em_scratch_bytes", G, E, Pn, least, 0)
    assert nbytes == (4 * G * (E + 2 * Pn) if least > words else 0)
    assert (nbytes > 0) == (Pn > em.MASK_LANES and seed == 1)
    before = em.EM_BATCHED.launches
    it, alpha = em.em_batched(*args, 10, 3000)
    torch.cuda.synchronize()
    assert em.EM_BATCHED.launches == before + 1
    it_p, alpha_p = em.run_em_batched_torch(*args, 10, 3000)
    assert torch.equal(it, it_p)
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


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units in the last place between two float32
    tensors (NaN against NaN counts 0)."""
    ia = a.view(torch.int32).long()
    ib = b.view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    d = (ia - ib).abs()
    d[torch.isnan(a) & torch.isnan(b)] = 0
    return int(d.max()) if d.numel() else 0


def _lsh_tables(seed: int, N: int = 6000, s: int = 20):
    """Window sketches over a 4-value alphabet (every band collides with
    hundreds of windows: the M cap and the duplicate mask are busy), six
    windows with unique slots (a query equal to one finds it in every band:
    all but one candidate are duplicates) and four copies of one window
    (a full-sketch bucket of 4). Returns (sketches u64, {K: (sorted band
    signatures u32 [L, N], window ids)})."""
    rng = np.random.default_rng(seed)
    sk = rng.integers(1, 5, size=(N, s)).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    sk[:6] = rng.integers(1 << 40, 1 << 62, size=(6, s)).astype(np.uint64)
    sk[10:13] = sk[9]
    tabs = {}
    for Kb in (1, 2, s):
        sig = lshe._mix_bands_np(sk, Kb)
        order = np.argsort(sig, axis=0, kind="stable")
        tabs[Kb] = (np.take_along_axis(sig, order, axis=0).T.copy(),
                    order.T.astype(np.int32).copy())
    return sk, tabs


def _lsh_queries(rng, sk, B: int = 512):
    """Queries: copies of index windows with some slots changed (so eq
    spans 0..s), the unique windows, sketches found nowhere, and k-mer
    counts over 1..200 (the containment boundary at t = 0.97 for every eq)
    plus rows of no k-mer (length-0 padding)."""
    N, s = sk.shape
    q = sk[rng.integers(0, N, size=B)].copy()
    flip = rng.random((B, s)) < rng.random((B, 1)) * 0.3
    q[flip] = rng.integers(1, 1 << 62, size=int(flip.sum())).astype(np.uint64)
    q[:6] = sk[:6]
    q[6:12] = rng.integers(1 << 40, 1 << 62, size=(6, s)).astype(np.uint64)
    q[12] = sk[9]
    kc = rng.integers(1, 201, size=B).astype(np.int32)
    kc[12] = 50
    kc[-4:] = (0, -30, 0, -30)
    return q, kc


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["K1", "K2", "full"])
def test_lsh_query_kernel_matches_plain(cuda, mode):
    rng = np.random.default_rng(21)
    sk, tabs = _lsh_tables(21)
    q, kc = _lsh_queries(rng, sk)
    Kb = {"K1": 1, "K2": 2, "full": S}[mode]
    sigs, idx = tabs[Kb]
    if mode == "full":
        M, qmax = 4, pdi.max_keep_q(120.0, 0.97)
    else:
        M, qmax = lshe.MAX_PER_BAND, None
    args = [torch.from_numpy(x).to(cuda) for x in (
        q.view(np.int64), kc, sk.view(np.int64), sigs.view(np.int32), idx)]
    kw = dict(K=Kb, M=M, domain_size=120, threshold=0.97, qmax=qmax)
    before = lshe.LSH_QUERY.launches
    win, contain = lshe.query_device(*args, **kw)
    torch.cuda.synchronize()
    assert lshe.LSH_QUERY.launches == before + 1
    win_p, contain_p = lshe.query_device_torch(*args, **kw)
    assert win.shape == (len(q), (S // Kb) * M)
    assert torch.equal(win, win_p)
    assert _ulps(contain, contain_p) <= 1
    w = win.cpu().numpy()
    assert (w[-4:] < 0).all() and (w[6:12] < 0).all()  # padding, no hit
    assert (w >= 0).sum() > (20 if mode == "full" else len(q))
    if mode == "full":  # the bucket of four equal windows
        assert sorted(w[12].tolist()) == [9, 10, 11, 12]
    if mode == "K1":  # C = 480: the cap and the duplicate mask at full width
        assert (w[:6] >= 0).sum(axis=1).max() <= 1


def _lsh_edge_case(case: str, mode: str):
    """A table and queries at the search's edges: N = 1 or 33 windows; a
    bucket of 30 equal windows (more than M) whose band-0 signature sorts
    last; s = 64, K = 1, M = 64 for C = 4,096; s = 128 (the read's sketch
    staged past 64 slots); s = 256, K = 1 for C = 6,144 (the global
    route: sort buffers in scratch). The queries hold copies of
    table windows (some slots changed), keys below and above every
    signature of band 0, random sketches and rows of no k-mer."""
    rng = np.random.default_rng(len(case) + len(mode))
    N, s = {"N1": (1, 20), "N33": (33, 20), "tail": (500, 20), "C4096": (3000, 64),
            "S128": (3000, 128), "C6144": (3000, 256)}[case]
    Kb = {"full": s, "K1": 1, "K2": 2}[mode]
    sk = rng.integers(1 << 40, 1 << 62, size=(N, s)).astype(np.uint64)
    if case in ("C4096", "S128", "C6144"):  # a 4-value alphabet: busy buckets
        sk = rng.integers(1, 5, size=(N, s)).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    if case == "tail":
        last = int(np.argmax(lshe._mix_bands_np(sk, Kb)[:, 0]))
        sk[rng.choice(np.delete(np.arange(N), last), 29, replace=False)] = sk[last]
    sig = lshe._mix_bands_np(sk, Kb)
    order = np.argsort(sig, axis=0, kind="stable")
    sigs = np.take_along_axis(sig, order, axis=0).T.copy()
    idx = order.T.astype(np.int32).copy()
    cand = rng.integers(1, 1 << 62, size=(20_000, s)).astype(np.uint64)
    csig = lshe._mix_bands_np(cand, Kb)[:, 0]
    below = cand[csig < sigs[0, 0]][:8]
    above = cand[csig > sigs[0, -1]][:8]
    q = sk[rng.integers(0, N, size=64)].copy()
    flip = rng.random(q.shape) < rng.random((len(q), 1)) * 0.3
    q[flip] = rng.integers(1, 1 << 62, size=int(flip.sum())).astype(np.uint64)
    q[0] = sk[order[-1, 0]]
    q = np.concatenate([q, below, above, cand[-8:], sk[:4]])
    kc = rng.integers(1, 201, size=len(q)).astype(np.int32)
    kc[-4:] = (0, -3, 0, 50)
    return q, kc, sk, sigs, idx, Kb


@pytest.mark.cuda
@pytest.mark.parametrize("case,mode", [
    ("N1", "full"), ("N1", "K2"), ("N33", "full"), ("N33", "K1"),
    ("tail", "full"), ("tail", "K2"), ("C4096", "K1"), ("S128", "K1"),
    ("S128", "K2"), ("S128", "full"), ("C6144", "K1"),
])
def test_lsh_query_kernel_table_edges(cuda, case, mode):
    q, kc, sk, sigs, idx, Kb = _lsh_edge_case(case, mode)
    s = sk.shape[1]
    M = 4 if mode == "full" else (64 if case == "C4096" else lshe.MAX_PER_BAND)
    qmax = pdi.max_keep_q(120.0, 0.97) if mode == "full" else None
    args = [torch.from_numpy(x).to(cuda) for x in (
        q.view(np.int64), kc, sk.view(np.int64), sigs.view(np.int32), idx)]
    kw = dict(K=Kb, M=M, domain_size=120, threshold=0.97, qmax=qmax)
    before = lshe.LSH_QUERY.launches
    win, contain = lshe.query_device(*args, **kw)
    torch.cuda.synchronize()
    assert lshe.LSH_QUERY.launches == before + 1
    win_p, contain_p = lshe.query_device_torch(*args, **kw)
    assert win.shape == (len(q), (s // Kb) * M)
    assert torch.equal(win, win_p)
    assert _ulps(contain, contain_p) <= 1
    assert (win >= 0).any()
    if case == "C4096":
        assert win.shape[1] == 4096
    if case == "C6144":
        assert win.shape[1] == 6144
        assert lshe.query_scratch_bytes(len(q), s, s // Kb, M, cuda) > 0


def _weight_inputs(seed: int, B: int = 700, C: int = 96, N: int = 3000,
                   Cn: int = 7, num_nodes: int = 5000, num_graphs: int = 40,
                   keep: float = 0.05):
    rng = np.random.default_rng(seed)
    win = np.where(rng.random((B, C)) < keep,
                   rng.integers(0, N, size=(B, C)), -1).astype(np.int32)
    win[::7] = -1  # rows with no kept slot
    kc = rng.integers(1, 160, size=B).astype(np.int32)
    ncnt = rng.integers(1, Cn + 1, size=N)
    nodes = np.where(np.arange(Cn)[None, :] < ncnt[:, None],
                     rng.integers(0, num_nodes, size=(N, Cn)), -1).astype(np.int32)
    coeff = (rng.random((N, Cn)) * 3).astype(np.float32)
    coeff[ncnt == 1, 0] = 1.0
    multi = ncnt > 1
    gids = rng.integers(0, num_graphs, size=N).astype(np.int32)
    return (win, kc, nodes, coeff, multi, gids), num_nodes, num_graphs


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [100_000, 1_500, 1])
def test_weight_scatter_kernel_matches_plain(cuda, budget):
    arrays, nn, ng = _weight_inputs(22)
    args = [torch.from_numpy(x).to(cuda) for x in arrays]
    before = pdi.WEIGHT_SCATTER.launches
    nw, gk, mapped, dropped = pdi.weight_scatter(*args, nn, ng, budget)
    torch.cuda.synchronize()
    assert pdi.WEIGHT_SCATTER.launches == before + 1
    nw_p, gk_p, mapped_p, dropped_p = pdi.weight_scatter_torch(*args, nn, ng, budget)
    n_kept = int((arrays[0] >= 0).sum())
    assert int(dropped) == int(dropped_p) == max(n_kept - budget, 0)
    assert torch.equal(mapped, mapped_p) and torch.equal(gk, gk_p)
    torch.testing.assert_close(nw, nw_p, rtol=1e-5, atol=0)
    assert float(nw.sum()) > 0 or budget == 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    "t99",          # the main path at t = 0.99: B = 2,048, C = 3, Cn = 85
    "many-tiles",   # B = 2,048, C = 240: 480 tiles of 1,024 slots
    "budget-cut",   # C = 240, a budget that ends inside a tile
    "none-kept",    # an all -1 win
])
def test_weight_scatter_kernel_at_main_path_shapes(cuda, shape):
    """Two launches, outputs equal to the plain version (node weights
    within rtol 1e-5: the atomics sum in another order)."""
    C, keep = (3, 0.3) if shape == "t99" else (240, 0.02)
    arrays, nn, ng = _weight_inputs(23, B=2048, C=C, N=20_000, Cn=85,
                                    num_nodes=135_992, num_graphs=583, keep=keep)
    if shape == "none-kept":
        arrays[0][:] = -1
    n_kept = int((arrays[0] >= 0).sum())
    budget = n_kept // 2 + 7 if shape == "budget-cut" else 8 * 2048
    args = [torch.from_numpy(x).to(cuda) for x in arrays]
    before = pdi.WEIGHT_SCATTER.launches
    got = pdi.weight_scatter(*args, nn, ng, budget)
    torch.cuda.synchronize()
    assert pdi.WEIGHT_SCATTER.launches == before + 1
    want = pdi.weight_scatter_torch(*args, nn, ng, budget)
    for j in (1, 2, 3):
        assert torch.equal(got[j], want[j]), j
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    assert int(got[3]) == max(n_kept - budget, 0)
    assert (n_kept == 0) == (float(got[0].abs().sum()) == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [0.99, 0.97])
def test_align_step_on_card_matches_plain_and_shards(cuda, tmp_path, t):
    alleles = synth.tiny_db(str(tmp_path / "msa"))
    run_index(Info(kmer_size=K, sketch_size=S, window_size=W,
                   index_dir=str(tmp_path / "idx")), str(tmp_path / "msa"), "cpu")
    info = Info.load(str(tmp_path / "idx" / "groot.gg"))
    index = ContainmentIndex.load(str(tmp_path / "idx" / "groot.lshe"))
    dev = pdi.DeviceIndex.build(index, info.store, K, t, device=cuda)
    reads, _w, _s = synth.sample_reads(np.random.default_rng(4), alleles, 301,
                                       lengths=(80, 100, 101, 130))
    codes = np.full((len(reads), 160), 4, np.uint8)
    lens = np.array([len(r) for r in reads], np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = nthash.ASCII_TO_CODE[np.frombuffer(r, np.uint8)]
    c, v = torch.from_numpy(codes).to(cuda), torch.from_numpy(lens).to(cuda)
    for full in (False, True):
        got = pdi.align_step(dev, c, v, threshold=t, full_equality=full)
        want = pdi.align_step_torch(dev, c, v, threshold=t, full_equality=full)
        torch.cuda.synchronize()
        for j in (0, 3, 4, 5):
            assert torch.equal(got[j], want[j]), j
        assert _ulps(got[1], want[1]) <= 1
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
        assert int(got[4].sum()) > 100
    base = pdi.make_sharded_align_step(dev, t)(codes, lens)
    two = pdi.make_sharded_align_step(dev, t, devices=[cuda, cuda])(codes, lens)
    for j in (0, 3, 4, 5):
        assert torch.equal(two[j], base[j]), j
    torch.testing.assert_close(two[2], base[2], rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(seed=0), dict(seed=1, Gs=2, P=20, Pb=32, Lb=256, Lr=64, C=20, Nb=40),
    dict(seed=2, Gs=2, P=40, Pb=64, Lb=224, Lr=32, C=16, Nb=30, pad_pairs=0,
         pad_probes=0),
    dict(seed=3, Lb=192, Lr=64, short=True),
    dict(seed=5, Gs=4, P=14, Pb=16, Lb=1024, Lr=160, C=200, Nb=64),
    dict(seed=6, n_run=40),                  # both strands found
    dict(seed=7, rev_frac=1.0),              # reverse only
    dict(seed=11, twins=True, C=30),         # stage-2 ties
    dict(seed=9, max_probes=40),             # more than 32 probes a pair
    dict(seed=10, P=200, Pb=256, Lb=192, Lr=32, C=8, Nb=24),  # Pb = 256
])
def test_pair_cascade_kernel_matches_plain(cuda, case):
    """Every row, pads included, equals the plain version on the card: reads
    with N and read_len < Lr, terminal-free rows, pairs without probes,
    stage-2 winners past the first probe, reads past the last window, both
    strands found (the forward wins), reverse-only reads, stage-2 ties (the
    lowest probe row wins), more than 32 probes a pair, Pb = 256."""
    arrays, _n_real = synth.cascade_case(**case)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    before = dc.PAIR_CASCADE.launches
    got = dc.pair_cascade(*args)
    torch.cuda.synchronize()
    assert dc.PAIR_CASCADE.launches == before + 1
    want = dc.pair_cascade_torch(*args)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), dc.pair_cascade_torch(*(torch.from_numpy(a)
                                                          for a in arrays)))
    assert int(got[:, 0].sum()) > 0


@pytest.mark.cuda
def test_cascade_aligner_on_card_matches_cpu(cuda, tmp_path):
    """align_read_batch on the card (the kernel) equals the CPU's (the plain
    version): records, mappings weighted and node weights."""
    alleles = synth.tiny_db(str(tmp_path / "msa"))
    run_index(Info(kmer_size=K, sketch_size=S, window_size=W,
                   index_dir=str(tmp_path / "idx")), str(tmp_path / "msa"), "cpu")
    info = Info.load(str(tmp_path / "idx" / "groot.gg"))
    index = ContainmentIndex.load(str(tmp_path / "idx" / "groot.lshe"))
    seqs, _which, _starts = synth.sample_reads(
        np.random.default_rng(3), alleles, 300, lengths=(60, 100, 150),
        n_frac=0.05, tail_frac=0.2,
    )
    reads = [FastqRead(id=b"@c%d" % i, seq=s, qual=b"I" * len(s))
             for i, s in enumerate(seqs)]
    batch = _make_batch(reads)
    kc = (batch.lengths - K + 1).astype(np.int32)
    q64 = khf_sketch(torch.from_numpy(batch.codes).to(cuda),
                     torch.from_numpy(batch.lengths).to(cuda), K, S)
    hits = index.query_batch(q64.cpu().numpy().view(np.uint64), kc, 0.99)
    per_graph = {}
    for read, res, n in zip(reads, hits, kc):
        for gid, keys in res.items():
            per_graph.setdefault(gid, []).append((read, keys, float(n)))
    out = {}
    for dev in (cuda, "cpu"):
        store = copy.deepcopy(info.store)
        al = dc.DeviceAligner(store, device=dev)
        before = dc.PAIR_CASCADE.launches
        recs = [vars(r) for gid in sorted(per_graph)
                for records, _n in al.align_read_batch(store[gid], per_graph[gid])
                for r in records]
        launched = dc.PAIR_CASCADE.launches - before
        w = [n.kmer_freq for _g, g in sorted(store.items()) for n in g.sorted_nodes]
        out[str(dev)] = (recs, w, launched)
    assert out["cuda"][2] > 0 and out["cpu"][2] == 0
    assert out["cuda"][0] == out["cpu"][0] and len(out["cpu"][0]) > 50
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-12)


MATCH_BITS_CASES = [
    dict(seed=1),                                     # Lr 45, W 156: neither a multiple of 32
    dict(seed=2, P=1, Lp=97, K=30, Lr=32),            # one path row
    dict(seed=3, P=5, Lp=287, K=24, Lr=32),           # W = 256, a multiple of 32
    dict(seed=5, P=2, Lp=120, K=20, Lr=1),            # one-column variants: eff 1 and 0
    dict(seed=6, P=3, Lp=300, K=30, Lr=64, n_run=80),  # a run of path Ns
    dict(seed=7, P=2, Lp=70, K=16, Lr=70),            # W = 1
    dict(seed=8, P=3, Lp=200, K=40, Lr=33, n_frac=0.2, zero_frac=0.3,
         pad_frac=0.3),                               # many Ns, eff 0 and -1
    dict(seed=9, P=7, Lp=1660, K=1200, Lr=160, pad=160),  # the main path: 200 reads, 7 rows
    dict(seed=10, P=24, Lp=3160, K=3000, Lr=160, pad=160, n_frac=0.001),  # a wide graph
    dict(seed=11, P=2, Lp=9000, K=40, Lr=160, pad=160),  # W32 > 256: a variant a block
    dict(seed=12, P=2, Lp=1000, K=400, Lr=1000),     # W = 1, long variants: few a block
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MATCH_BITS_CASES)
def test_match_bits_kernel_matches_plain(cuda, case):
    """Bit for bit the plain version's, on the card and on the CPU: N in
    paths and reads, Lr and W not multiples of 32, P = 1, eff 0 and -1,
    W = 1, the main path's widths and a wide graph."""
    arrays = synth.match_bits_case(**case)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    before = aligner.MATCH_BITS.launches
    got = aligner.match_bits(*args)
    torch.cuda.synchronize()
    assert aligner.MATCH_BITS.launches == before + 1
    got = got.view(torch.int32).cpu()
    assert torch.equal(got, aligner.match_bits_torch(*args).view(torch.int32).cpu())
    assert torch.equal(got, aligner.match_bits_torch(
        *(torch.from_numpy(a) for a in arrays)).view(torch.int32))
    assert bool(got.any())


@pytest.mark.cuda
def test_host_aligner_on_card_matches_cpu(cuda, tmp_path):
    """The `host` engine's align_read_batch on the card (the match-bits
    kernel) equals the CPU's (the plain version): records, mappings
    weighted and node weights."""
    alleles = synth.tiny_db(str(tmp_path / "msa"))
    run_index(Info(kmer_size=K, sketch_size=S, window_size=W,
                   index_dir=str(tmp_path / "idx")), str(tmp_path / "msa"), "cpu")
    info = Info.load(str(tmp_path / "idx" / "groot.gg"))
    index = ContainmentIndex.load(str(tmp_path / "idx" / "groot.lshe"))
    seqs, _which, _starts = synth.sample_reads(
        np.random.default_rng(4), alleles, 300, lengths=(60, 100, 150),
        n_frac=0.05, tail_frac=0.2,
    )
    reads = [FastqRead(id=b"@h%d" % i, seq=s, qual=b"I" * len(s))
             for i, s in enumerate(seqs)]
    batch = _make_batch(reads)
    kc = (batch.lengths - K + 1).astype(np.int32)
    q64 = khf_sketch(torch.from_numpy(batch.codes).to(cuda),
                     torch.from_numpy(batch.lengths).to(cuda), K, S)
    hits = index.query_batch(q64.cpu().numpy().view(np.uint64), kc, 0.99)
    per_graph = {}
    for read, res, n in zip(reads, hits, kc):
        for gid, keys in res.items():
            per_graph.setdefault(gid, []).append((read, keys, float(n)))
    out = {}
    for dev in (cuda, "cpu"):
        store = copy.deepcopy(info.store)
        al = aligner.GraphAligner(store, device=dev)
        before = aligner.MATCH_BITS.launches
        recs = [vars(r) for gid in sorted(per_graph)
                for records, _n in al.align_read_batch(store[gid], per_graph[gid])
                for r in records]
        launched = aligner.MATCH_BITS.launches - before
        w = [n.kmer_freq for _g, g in sorted(store.items()) for n in g.sorted_nodes]
        out[str(dev)] = (recs, w, launched)
    assert out["cuda"][2] == len(per_graph) and out["cpu"][2] == 0
    assert out["cuda"][0] == out["cpu"][0] and len(out["cpu"][0]) > 50
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-12)


MATCH_BITS_BATCH_CASES = [
    dict(seed=1),                                       # 6 graphs, reads 20-150 bp
    dict(seed=2, read_len=(20, 24, 31)),                # every read under 32 bp
    dict(seed=3, n_graphs=500, rows=(1, 6), n_reads=2048, per_graph=(1, 8)),  # the main path
    dict(seed=4, n_graphs=2, rows=(1, 3), row_len=(39_000, 41_000), n_reads=24),  # 40 kb rows
    dict(seed=5, n_graphs=40, rows=(1, 24), per_graph=(1, 60), n_frac=0.1),  # wide graphs, Ns
]


# the shared route's limit that sends every block of a match-bits launch to
# the global route: no block fits 0 bytes
GLOBAL_ROUTE = 0


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [None, (64, 3), "global"])
@pytest.mark.parametrize("case", MATCH_BITS_BATCH_CASES)
def test_match_bits_batch_kernel_matches_plain(cuda, case, layout, monkeypatch):
    """One launch for a batch of graphs, bit for bit the plain version's
    (on the card and on the CPU): mixed read lengths, rows of unequal
    length, reads in several graphs, 40 kb rows split into chunks, the main
    path's ~500 graphs; a layout of 3-word chunks and small groups; and
    every block on the global route (planes and codes in scratch slices)."""
    if layout not in (None, "global"):
        monkeypatch.setattr(aligner, "ITEMS_PER_BLOCK", layout[0])
        monkeypatch.setattr(aligner, "MAX_BLOCK_WORDS", layout[1])
    args = synth.match_bits_batch_case(**case)
    rows = torch.from_numpy(args[0]).to(cuda)
    before = aligner.MATCH_BITS.launches
    got, off = aligner.match_bits_batch(
        rows, *args[1:], shared_limit=GLOBAL_ROUTE if layout == "global" else None)
    torch.cuda.synchronize()
    assert aligner.MATCH_BITS.launches == before + 1
    got = got.view(torch.int32).cpu()
    dev_args = [torch.from_numpy(a).to(cuda) for a in args[:-1]]
    assert torch.equal(got, aligner.match_bits_batch_torch(*dev_args, args[-1])
                       .view(torch.int32).cpu())
    assert torch.equal(got, aligner.match_bits_batch_torch(
        *(torch.from_numpy(a) for a in args[:-1]), args[-1]).view(torch.int32))
    assert got.numel() == off[-1] and bool(got.any())


@pytest.mark.cuda
def test_match_bits_kernel_raises_when_a_block_does_not_fit(cuda):
    """A 200 kb variant on a 200 kb row (the shape whose planes and reads
    once passed the card's opt-in shared memory and raised): its block
    takes the global route, and the bits equal the plain version's (an
    all-N row: every offset matches)."""
    Lr = 200_000
    path = torch.full((1, Lr + 10), 4, dtype=torch.uint8, device=cuda)
    var = torch.zeros((1, Lr), dtype=torch.uint8, device=cuda)
    var_len = torch.full((1,), Lr, dtype=torch.int32, device=cuda)
    ls = aligner.staged_bases(np.array([[0, 1, 0, 1, 11]]), Lr, np.array([Lr]),
                              np.array([0]), np.array([Lr + 10]))
    limit = aligner.match_limits(str(cuda))[0]
    assert aligner.work_table(np.array([[0, 1, 0, 1, 11]]), 1, ls, aligner.ITEMS_PER_BLOCK,
                              aligner.MAX_BLOCK_WORDS, limit)[2] == 0  # global
    got = aligner.match_bits(path, var, var_len)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), aligner.match_bits_torch(path, var, var_len)
                       .view(torch.int32))
    assert int(got.view(torch.int32)[0, 0, 0]) == (1 << 11) - 1


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["shared", "global"])
def test_match_bits_batch_long_reads_match_plain(cuda, route):
    """Reads of 100 kb and 200 kb (a row's tail, then random bases) among
    20-150 bp reads on rows of 300-1,500 bp, in one launch: bit for bit the
    plain version's on the card, each segment staging its longest read cut
    to its longest row + 1 (the shared route), and every block on the
    global route; the long reads match where their row's tail lies."""
    args = synth.match_bits_batch_case(6, n_graphs=6, n_reads=30,
                                       long_reads=(100_000, 200_000))
    rows = torch.from_numpy(args[0]).to(cuda)
    before = aligner.MATCH_BITS.launches
    got, off = aligner.match_bits_batch(
        rows, *args[1:], shared_limit=GLOBAL_ROUTE if route == "global" else None)
    torch.cuda.synchronize()
    assert aligner.MATCH_BITS.launches == before + 1
    got = got.view(torch.int32).cpu()
    dev_args = [torch.from_numpy(a).to(cuda) for a in args[:-1]]
    want = aligner.match_bits_batch_torch(*dev_args, args[-1]).view(torch.int32).cpu()
    assert torch.equal(got, want) and got.numel() == off[-1]
    segs, pairs, R = args[-1], args[5], len(args[4])
    for s, (p0, n, _r0, n_rows, W) in enumerate(segs.tolist()):
        for i, r in enumerate(pairs[p0:p0 + n].tolist()):
            if r >= R - 2:  # a long read: some variant matches at its tail
                W32 = -(-W // 32)
                per = 6 * n_rows * W32
                assert bool(got[off[s] + i * per:off[s] + (i + 1) * per].any())


@pytest.mark.cuda
def test_host_aligner_graph_batches_one_launch(cuda, tmp_path):
    """`align_graph_batches` on the card launches the kernel once for all
    the graphs of a batch and equals the CPU's: records, mappings weighted,
    node weights."""
    alleles = synth.tiny_db(str(tmp_path / "msa"))
    run_index(Info(kmer_size=K, sketch_size=S, window_size=W,
                   index_dir=str(tmp_path / "idx")), str(tmp_path / "msa"), "cpu")
    info = Info.load(str(tmp_path / "idx" / "groot.gg"))
    index = ContainmentIndex.load(str(tmp_path / "idx" / "groot.lshe"))
    seqs, _which, _starts = synth.sample_reads(
        np.random.default_rng(7), alleles, 300, lengths=(25, 60, 100, 150),
        n_frac=0.05, tail_frac=0.2,
    )
    reads = [FastqRead(id=b"@b%d" % i, seq=s, qual=b"I" * len(s))
             for i, s in enumerate(seqs)]
    batch = _make_batch(reads)
    kc = (batch.lengths - K + 1).astype(np.int32)
    q64 = khf_sketch(torch.from_numpy(batch.codes).to(cuda),
                     torch.from_numpy(batch.lengths).to(cuda), K, S)
    hits = index.query_batch(q64.cpu().numpy().view(np.uint64), kc, 0.99)
    per_graph = {}
    for read, res, n in zip(reads, hits, kc):
        for gid, keys in res.items():
            per_graph.setdefault(gid, []).append((read, keys, float(n)))
    assert len(per_graph) > 1
    out = {}
    for dev in (cuda, "cpu"):
        store = copy.deepcopy(info.store)
        al = aligner.GraphAligner(store, device=dev)
        before = aligner.MATCH_BITS.launches
        res = al.align_graph_batches(per_graph)
        launched = aligner.MATCH_BITS.launches - before
        recs = [vars(r) for gid in per_graph for records, _n in res[gid] for r in records]
        w = [n.kmer_freq for _g, g in sorted(store.items()) for n in g.sorted_nodes]
        out[str(dev)] = (recs, w, launched)
    assert out["cuda"][2] == 1 and out["cpu"][2] == 0
    assert out["cuda"][0] == out["cpu"][0] and len(out["cpu"][0]) > 50
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-12)
