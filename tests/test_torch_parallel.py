"""The port's multi-device data plane against groot_tpu.parallel.

The fused align step (plain versions of its three kernels) equals the
reference's jitted-free `align_step` on the same index tables, in both
modes; the sharded step over two CPU devices equals the unsharded step and
the reference's shard_map over the 8-device virtual mesh (tests/conftest.py);
the N-process run (torch.distributed, gloo) equals the single-process
step and the host replay; the device engine's sharded seed scan equals the
unsharded one and the reference's mesh engine; and run_align with the seed
scan on two CPU shards equals the reference's run_align on its mesh.
Inputs are made from seeds with numpy."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from groot_tpu.align.device_join import DeviceJoinAligner as RefAligner
from groot_tpu.config import AlignCmd as RefAlignCmd
from groot_tpu.config import Info as RefInfo
from groot_tpu.index.lshe import ContainmentIndex as RefIndex
from groot_tpu.io import bam as ref_bamio
from groot_tpu.parallel import device_index as rdi
from groot_tpu.parallel.mesh import make_mesh
from groot_tpu.parallel.mesh import pad_batch_for_mesh as ref_pad
from groot_tpu.pipeline import align_pipeline as ref_pipeline
from groot_tpu.pipeline.index_pipeline import run_index as ref_run_index
from groot_tpu_torch import synth
from groot_tpu_torch.align import device_join as dj
from groot_tpu_torch.align.batch_host import WindowTables
from groot_tpu_torch.config import AlignCmd, Info
from groot_tpu_torch.index.lshe import ContainmentIndex
from groot_tpu_torch.io import bam as bamio
from groot_tpu_torch.io.fastx import FastqRead
from groot_tpu_torch.ops.nthash import ASCII_TO_CODE
from groot_tpu_torch.parallel import device_index as pdi
from groot_tpu_torch.parallel.mesh import data_devices, pad_batch_for_mesh
from groot_tpu_torch.pipeline import align_pipeline
from groot_tpu_torch.pipeline.index_pipeline import run_index

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, S, W = 31, 20, 100
CPU2 = [torch.device("cpu"), torch.device("cpu")]


@pytest.fixture(scope="module")
def tiny():
    """The reference's tiny index and DeviceIndex, the port's copy of its
    tables, and a seeded batch: reads of 60-130 bp (k-mer counts around
    the full-equality cutoff qmax = 71 at t = 0.99), reads of k bases and a
    length-0 padding row."""
    info, index = graft._tiny_index()
    ref = rdi.DeviceIndex.build(index, info.store, info.kmer_size, 0.99)
    port = pdi.device_index_from_jax(
        {f: (np.asarray(v) if hasattr(v, "shape") else v)
         for f, v in vars(ref).items()}, "cpu",
    )
    alleles = [s for g in info.store.values() for s in g.graph2seqs().values()]
    reads, _w, _s = synth.sample_reads(
        np.random.default_rng(3), alleles, 90,
        lengths=(60, 100, 101, 102, 103, 130), n_frac=0.05,
    )
    reads += [alleles[0][:K], alleles[1][5 : 5 + K]]
    L = 160
    codes = np.full((len(reads) + 1, L), 4, np.uint8)
    lens = np.zeros(len(reads) + 1, np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = ASCII_TO_CODE[np.frombuffer(r, np.uint8)]
        lens[i] = len(r)
    return info, index, ref, port, codes, lens


def _ref_kwargs(ref, t, full):
    return dict(
        k=ref.k, s=ref.s, band_k=ref.band_k,
        num_window_kmers=ref.num_window_kmers, num_nodes=ref.num_nodes,
        num_graphs=ref.num_graphs, threshold=t, full_equality=full, cf=ref.cf,
    )


def _hit_sets(win):
    return [set(r[r >= 0].tolist()) for r in np.asarray(win)]


@pytest.mark.parametrize(
    "full,t,budget",
    [(False, 0.99, 0), (False, 0.97, 0), (True, 0.99, 0), (True, 0.97, 0),
     (False, 0.97, 40)],
)
def test_align_step_torch_matches_jax(tiny, full, t, budget):
    info, index, ref, port, codes, lens = tiny
    want = [np.asarray(x) for x in rdi.align_step(
        ref.tree(), codes, lens, pair_budget=budget, **_ref_kwargs(ref, t, full)
    )]
    got = [x.numpy() for x in pdi.align_step_torch(
        port, torch.from_numpy(codes), torch.from_numpy(lens), threshold=t,
        full_equality=full, pair_budget=budget,
    )]
    np.testing.assert_array_equal(got[0], want[0])           # win_idx
    np.testing.assert_array_equal(got[1], want[1])           # contain, f32
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)   # node weights
    np.testing.assert_array_equal(got[3], want[3])           # graph k-mers
    np.testing.assert_array_equal(got[4], want[4])           # mapped
    assert int(got[5]) == int(want[5])                       # dropped
    assert got[4].sum() > 20 and not got[4][-1]              # padding row
    if budget:
        assert int(got[5]) > 0
    # the step on the CPU is the plain version
    plain = pdi.align_step(port, torch.from_numpy(codes), torch.from_numpy(lens),
                           threshold=t, full_equality=full, pair_budget=budget)
    for a, b in zip(plain, got):
        np.testing.assert_array_equal(a.numpy(), b)


def test_full_equality_cutoff_at_qmax(tiny):
    """qmax is the reference's float64 bound: reads of 101 bp (71 k-mers)
    keep their all-slot-equal windows at t = 0.99, reads of 102 bp don't."""
    info, index, ref, port, codes, lens = tiny
    assert pdi.max_keep_q(70.0, 0.99) == rdi._max_keep_q(70.0, 0.99) == 71
    win, _c, _nw, _gk, mapped, _d = pdi.align_step_torch(
        port, torch.from_numpy(codes), torch.from_numpy(lens), threshold=0.99,
        full_equality=True,
    )
    assert mapped.numpy()[lens == 101].any()
    assert not mapped.numpy()[lens >= 102].any()


def test_sharded_step_matches_unsharded_and_jax_mesh(tiny):
    info, index, ref, port, codes, lens = tiny
    base = pdi.make_sharded_align_step(port, 0.99)(codes, lens)
    got = pdi.make_sharded_align_step(port, 0.99, devices=CPU2)(codes, lens)
    # the batch (93 rows) is odd: the second shard ends in a padding row
    assert len(codes) % 2 == 1
    for a, b in zip(got, base):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)
    np.testing.assert_array_equal(got[0].numpy(), base[0].numpy())
    np.testing.assert_array_equal(got[3].numpy(), base[3].numpy())
    # the reference: shard_map over the 8-device virtual mesh
    step = rdi.make_sharded_align_step(make_mesh(8), ref, threshold=0.99)
    codes_p, lens_p, B = ref_pad(codes, lens, 8)
    want = [np.asarray(x) for x in step(ref.tree(), codes_p, lens_p)]
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    assert int(got[5]) == int(want[5]) == 0
    assert _hit_sets(got[0]) == _hit_sets(want[0][:B])
    np.testing.assert_array_equal(got[4].numpy(), want[4][:B])


def test_mode_choice_matches_host_query(tiny):
    """The per-batch mode is the host query's full-equality condition,
    padding rows left out, and agrees with the reference's step."""
    info, index, ref, port, codes, lens = tiny
    d = float(port.num_window_kmers)
    for t in (0.99, 0.97, 0.9):
        real = lens[lens > 0]
        want = index.full_equality_applies(real - K + 1, t)
        got = pdi.full_equality_mode(pdi.local_qmin(lens, K), S, d, t)
        assert got == want, t
    # padding only: the reference's qmin of 1, the banded mode
    assert pdi.local_qmin(np.zeros(4, np.int32), K) == np.inf
    assert not pdi.full_equality_mode(np.inf, S, d, 0.99)
    assert pdi.full_equality_mode(70.0, S, d, 0.99)


def test_mesh_helpers_match_reference():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(13, 40)).astype(np.uint8)
    lens = rng.integers(30, 41, size=13).astype(np.int32)
    for n in (1, 2, 8):
        got, want = pad_batch_for_mesh(codes, lens, n), ref_pad(codes, lens, n)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert data_devices(3, "cpu") == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):
            data_devices(1, "cuda")


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """The port's and the reference's index of synth.tiny_db, and reads."""
    tmp = tmp_path_factory.mktemp("par")
    alleles = synth.tiny_db(str(tmp / "msa"))
    run_index(Info(kmer_size=K, sketch_size=S, window_size=W,
                   index_dir=str(tmp / "port")), str(tmp / "msa"), "cpu")
    ref_run_index(RefInfo(kmer_size=K, sketch_size=S, window_size=W,
                       index_dir=str(tmp / "ref")), str(tmp / "msa"))
    return tmp, alleles


def test_device_index_build_matches_jax(indexes):
    tmp, _alleles = indexes
    out = {}
    for name, Index, cfg in (("port", ContainmentIndex, Info),
                             ("ref", RefIndex, RefInfo)):
        info = cfg.load(str(tmp / name / "groot.gg"))
        out[name] = (info, Index.load(str(tmp / name / "groot.lshe")))
    info, index = out["port"]
    got = pdi.DeviceIndex.build(index, info.store, K, 0.97, device="cpu")
    ref = rdi.DeviceIndex.build(out["ref"][1], out["ref"][0].store, K, 0.97)
    want = pdi.device_index_from_jax(
        {f: (np.asarray(v) if hasattr(v, "shape") else v)
         for f, v in vars(ref).items()}, "cpu",
    )
    for f in ("k", "s", "band_k", "num_window_kmers", "cf", "num_nodes",
              "num_graphs"):
        assert getattr(got, f) == getattr(want, f), f
    for f in pdi._TENSORS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    np.testing.assert_array_equal(got.node_table, want.node_table)
    # hi/lo joined: the u64 sketches are the index's own
    assert (got.sketches.numpy().view(np.uint64) == index.sketches).all()
    assert got.band_k == 2 and got.cf >= 1 and bool(got.win_multi.any())


def test_device_join_sharded_scan_matches_unsharded_and_jax_mesh(indexes):
    tmp, alleles = indexes
    info = Info.load(str(tmp / "port" / "groot.gg"))
    index = ContainmentIndex.load(str(tmp / "port" / "groot.lshe"))
    info.attach_db(index)
    refs = bamio.build_references(info.store)
    tables = WindowTables(index, info.store)
    one = dj.DeviceJoinAligner(info.store, refs, device="cpu")
    one.attach_tables(tables, index, K)
    two = dj.DeviceJoinAligner(info.store, refs, device="cpu", devices=CPU2)
    two.attach_tables(tables, index, K)
    seqs, _w, _s = synth.sample_reads(
        np.random.default_rng(11), alleles, 160,
        lengths=(60, 100, 130, 150, 190), n_frac=0.05, tail_frac=0.3,
    )
    batch = align_pipeline._make_batch([
        FastqRead(id=b"@t%d" % i, seq=s, qual=b"I" * len(s))
        for i, s in enumerate(seqs)
    ])
    kc = (batch.lengths - K + 1).astype(np.int32)
    rows, wins, combo_start = align_pipeline._compute_hits(
        info, batch, kc, K, S, 0.99, tables, "cpu"
    )
    st = one.phase_a_rows(batch, rows, wins, combo_start)
    codes, lens, rpow32, rinv32, rows_t, sx = one.phase_a_inputs(batch, st)
    assert rows_t.shape[1] % 2 == 1  # a ragged last shard
    PH = dj.read_hashes(codes, lens, rpow32, rinv32, K, sx["WPH"])
    got = two.scan_rows(PH, rows_t, sx)
    base = one.scan_rows(PH, rows_t, sx)
    assert torch.equal(got, base)
    assert ((got.numpy() & 0xFF) < 255).sum() > 10
    # the reference's engine with its seed scan shard_mapped over the mesh
    ref = RefAligner(info.store, refs, mesh=make_mesh(8))
    ref.attach_tables(tables, index, K)
    handles = ref.submit_pairs(batch, rows, wins, combo_start)
    ref.fetch_pairs(handles)
    calls = handles[0]["calls"]
    np.testing.assert_array_equal(
        np.concatenate([rp for rp, _p, _b, _o in calls]), st["r_pair"]
    )
    want = np.concatenate([o[: len(rp)] for rp, _p, _b, o in calls])
    np.testing.assert_array_equal(got.numpy(), want)
    # the whole engine: submit -> fetch -> collect on two shards
    h = two.submit_pairs(batch, rows, wins, combo_start)
    np.testing.assert_array_equal(h[0]["calls"][0][3].numpy(), want)


def _align(pkg, index_dir, fq, bam):
    """One device-engine align run: (stats, node weights, BAM keys, pruned
    paths)."""
    if pkg == "port":
        Index, bam_mod, pipe, kw = ContainmentIndex, bamio, align_pipeline, {"device": "cpu"}
        cfg, cmd = Info, AlignCmd
    else:
        Index, bam_mod, pipe, kw = RefIndex, ref_bamio, ref_pipeline, {}
        cfg, cmd = RefInfo, RefAlignCmd
    os.environ["GROOT_ENGINE"] = "device"
    try:
        info = cfg.load(os.path.join(index_dir, "groot.gg"))
        info.attach_db(Index.load(os.path.join(index_dir, "groot.lshe")))
        info.index_dir = index_dir
        info.containment_threshold = 0.99
        info.sketch = cmd(min_kmer_coverage=0.5)
        with open(bam, "wb") as fh:
            writer = bam_mod.BamWriter(fh, bam_mod.build_references(info.store))
            stats = pipe.run_align(info, [fq], bam_writer=writer,
                                   batch_size=64, **kw)
            writer.close()
    finally:
        os.environ.pop("GROOT_ENGINE", None)
    weights = np.array([n.kmer_freq for _g, g in sorted(info.store.items())
                        for n in g.sorted_nodes])
    _refs, recs = bam_mod.read_bam(bam)
    keys = sorted((r.name, r.ref_id, r.pos, r.flag, r.seq_len, tuple(r.cigar))
                  for r in recs)
    return stats, weights, keys, pipe.prune_graphs(info, 0.5)


def test_run_align_on_two_cpu_shards_matches_jax_mesh(indexes, monkeypatch):
    """run_align's device engine with the seed scan sharded over two CPU
    devices equals the reference's run_align, whose seed scan shard_maps
    over the 8-device virtual mesh (compare graft._run_align_on_mesh)."""
    tmp, alleles = indexes
    reads, _w, _s = synth.sample_reads(
        np.random.default_rng(9), alleles, 150, lengths=(80, 100, 150),
        n_frac=0.05, tail_frac=0.2,
    )
    fq = str(tmp / "shard.fq")
    synth.write_fastq(reads, fq)
    shards = []
    real_scan = dj.seed_scan

    def counted(tables, *a, **kw):
        shards.append(a[4].shape[0])
        return real_scan(tables, *a, **kw)

    monkeypatch.setattr(align_pipeline, "shard_devices", lambda dev: CPU2)
    monkeypatch.setattr(dj, "seed_scan", counted)
    got = _align("port", str(tmp / "port"), fq, str(tmp / "p.bam"))
    assert len(shards) >= 2 and len(shards) % 2 == 0
    want = _align("ref", str(tmp / "ref"), fq, str(tmp / "r.bam"))
    for f in ("received", "mapped", "multimapped", "alignment_count",
              "total_kmers"):
        assert getattr(got[0], f) == getattr(want[0], f), f
    assert got[0].alignment_count > 20
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    assert got[2] == want[2]
    assert got[3] == want[3] and got[3]


def test_nproc_two_gloo_ranks_match_single_process_and_host():
    """Two ranks (gloo, file:// store, explicit timeouts) merge tallies
    equal to the single-process step and the host replay."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    res = subprocess.run(
        [sys.executable, "-m", "groot_tpu_torch.parallel.nproc", "--nproc",
         "2", "--backend", "gloo", "--device", "cpu", "--timeout", "120"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240,
    )
    last = (res.stdout.strip().splitlines() or [""])[-1]
    assert res.returncode == 0 and last.startswith("OK"), (last, res.stderr[-2000:])
    assert "procs=2" in last and "batches=3" in last
