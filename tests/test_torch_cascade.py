"""The port's cascade engine (align.device_cascade) against groot_tpu's.

`pair_cascade_torch` (the plain version the CPU runs) equals the
reference's jitted `_pair_cascade` exactly on every real pair row of seeded
inputs: reads with N, read_len < Lr, terminal-free rows, pairs with no
contained nodes, pad pairs and pad probes, stage-2 winners past the first
probe, and a width where reads reach past the last window (the clipped
lookups). The port's DeviceAligner gives the reference's records and
weights on synthetic graphs, and cascade_from_jax carries the reference's
stacks and ranks over array for array. The kernel is held to the plain
version on the card (tests/test_torch_kernels.py)."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groot_tpu.align.batch_host import WindowTables as RefTables
from groot_tpu.align.device_cascade import DeviceAligner as RefAligner
from groot_tpu.align.device_cascade import _pair_cascade as ref_pair_cascade
from groot_tpu_torch import synth
from groot_tpu_torch.align import device_cascade as dc
from groot_tpu_torch.align.batch_host import WindowTables
from groot_tpu_torch.config import Info
from groot_tpu_torch.index.lshe import ContainmentIndex
from groot_tpu_torch.ops.sketch import sketch_reads_u64
from groot_tpu_torch.pipeline.align_pipeline import _make_batch
from groot_tpu_torch.pipeline.index_pipeline import run_index
from groot_tpu_torch.io.fastx import FastqRead

K, S, W = 31, 20, 100


CASES = {
    "small": dict(seed=0),
    "wide": dict(seed=1, Gs=2, P=20, Pb=32, Lb=256, Lr=64, C=20, Nb=40),
    "many-rows": dict(seed=2, Gs=2, P=40, Pb=64, Lb=224, Lr=32, C=16, Nb=30,
                      pad_pairs=0, pad_probes=0),
    "past-last-window": dict(seed=3, Lb=192, Lr=64, short=True),
    "no-pads": dict(seed=4, pad_pairs=0, pad_probes=0, C=30),
    "both-strands": dict(seed=6, n_run=40),
    "reverse-only": dict(seed=7, rev_frac=1.0),
    "stage2-ties": dict(seed=11, twins=True, C=30),
    "many-probes": dict(seed=9, max_probes=40),
    "rows-256": dict(seed=10, P=200, Pb=256, Lb=192, Lr=32, C=8, Nb=24),
}
_RC = np.array([3, 2, 1, 0, 4], np.uint8)


def _ref(arrays):
    return np.asarray(ref_pair_cascade(*(jnp.asarray(a) for a in arrays)))


def _port(arrays):
    return dc.pair_cascade(*(torch.from_numpy(a) for a in arrays)).numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_pair_cascade_torch_matches_jax(name):
    arrays, n_real = synth.cascade_case(**CASES[name])
    want = _ref(arrays)
    got = _port(arrays)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got[:n_real], want[:n_real])


def test_cases_cover_the_cascade():
    """Every stage wins somewhere, some pairs fail, some stage-2 winners are
    not the pair's first probe, and the clipped lookups are reached."""
    stages, late_winner, unfound = set(), 0, 0
    for name, kw in CASES.items():
        arrays, n_real = synth.cascade_case(**kw)
        out = _port(arrays)[:n_real]
        probe_pair, probe_node = arrays[13], arrays[14]
        for p, row in enumerate(out):
            if not row[0]:
                unfound += 1
                assert row[3] == 4 and row[7] == 1 and row[2] == 1
                continue
            stages.add(int(row[3]))
            if row[3] == 2:
                mine = probe_node[probe_pair == p]
                late_winner += int(row[4] != mine[0])
    assert stages == {1, 2, 3, 4}
    assert late_winner > 0 and unfound > 0
    arrays, _n = synth.cascade_case(**CASES["past-last-window"])
    W = arrays[0].shape[2] - arrays[6].shape[1] + 1
    assert (arrays[3] > W).any()


def _twin_ties(arrays, out):
    """Stage-2 winners with another probe of the pair at the same rank on a
    node of the same rows and length (a tie the lowest probe row wins)."""
    npos, nlen, g_idx, pair_combo = arrays[1], arrays[2], arrays[5], arrays[8]
    probe_pair, probe_node, probe_rank = arrays[13], arrays[14], arrays[15]
    ties = 0
    for p in np.flatnonzero(out[:, 3] == 2):
        g, w = g_idx[pair_combo[p]], out[p, 4]
        qs = np.flatnonzero(probe_pair == p)
        first = qs[probe_node[qs] == w][0]
        ties += sum(int(probe_node[q] != w and probe_rank[q] == probe_rank[first]
                        and np.array_equal(npos[g, probe_node[q]], npos[g, w])
                        and nlen[g, probe_node[q]] == nlen[g, w]) for q in qs)
    return ties


def test_new_cases_reach_their_edges():
    """both-strands: pairs that the forward strand finds in either read
    orientation (so both strands match); reverse-only: every hit on the
    reverse strand; stage2-ties: stage-2 winners with a tied twin probe;
    many-probes: a stage-2 winner among more than 32 probes; rows-256: hits
    over 256 path rows."""
    def run(name, flip=False):
        arrays, n = synth.cascade_case(**CASES[name])
        if flip:  # every read reverse complemented
            arrays = list(arrays)
            codes = arrays[6].copy()
            for c, ln in enumerate(arrays[7]):
                codes[c, :ln] = _RC[codes[c, :ln]][::-1]
            arrays[6] = codes
        return arrays, _port(arrays)[:n]

    _a, out = run("both-strands")
    _a, out_rc = run("both-strands", flip=True)
    fwd = (out[:, 0] == 1) & (out[:, 2] == 0)
    assert (fwd & (out_rc[:, 0] == 1) & (out_rc[:, 2] == 0)).sum() > 5
    _a, out = run("reverse-only")
    assert out[:, 0].sum() > 3 and (out[out[:, 0] == 1, 2] == 1).all()
    arrays, out = run("stage2-ties")
    assert _twin_ties(arrays, out) > 0
    arrays, out = run("many-probes")
    cnt = np.bincount(arrays[13], minlength=len(arrays[8]))[: len(out)]
    assert ((out[:, 3] == 2) & (out[:, 0] == 1) & (cnt > 32)).any()
    arrays, out = run("rows-256")
    assert arrays[0].shape[1] == 256 and out[:, 0].sum() > 0


def _query_items(info, reads):
    """Per graph, [(read, mappings, kmer count)] from the port's index."""
    batch = _make_batch(reads)
    kc = (batch.lengths - K + 1).astype(np.int32)
    q64 = sketch_reads_u64(batch.codes, batch.lengths, K, S, "cpu")
    per_graph = {}
    for read, res, n in zip(reads, info.db.query_batch(q64, kc, 0.99), kc):
        for gid, keys in res.items():
            per_graph.setdefault(gid, []).append((read, keys, float(n)))
    return per_graph


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cascade")
    alleles = synth.tiny_db(str(tmp / "msa"))
    run_index(Info(kmer_size=K, sketch_size=S, window_size=W,
                   index_dir=str(tmp / "idx")), str(tmp / "msa"), "cpu")
    info = Info.load(str(tmp / "idx" / "groot.gg"))
    info.attach_db(ContainmentIndex.load(str(tmp / "idx" / "groot.lshe")))
    seqs, _which, _starts = synth.sample_reads(
        np.random.default_rng(3), alleles, 200, lengths=(60, 100, 150),
        n_frac=0.05, tail_frac=0.2,
    )
    reads = [FastqRead(id=b"@c%d" % i, seq=s, qual=b"I" * len(s))
             for i, s in enumerate(seqs)]
    return info, reads


def _rec(r):
    return (r.name, r.graph_id, r.path_id, r.pos, r.seq, r.qual, r.start_clip,
            r.end_clip, r.reverse, r.secondary)


def test_align_read_batch_matches_jax(tiny):
    info, reads = tiny
    per_graph = _query_items(info, reads)
    assert sum(len(v) for v in per_graph.values()) > 60
    out = {}
    for pkg in ("port", "ref"):
        store = copy.deepcopy(info.store)
        al = (dc.DeviceAligner(store, device="cpu") if pkg == "port"
              else RefAligner(store))
        recs, weighted = [], []
        for gid in sorted(per_graph):
            for records, n in al.align_read_batch(store[gid], per_graph[gid]):
                recs += [_rec(r) for r in records]
                weighted.append(n)
        w = np.array([n.kmer_freq for _g, g in sorted(store.items())
                      for n in g.sorted_nodes])
        kt = [g.kmer_total for _g, g in sorted(store.items())]
        out[pkg] = (recs, weighted, w, kt)
    assert len(out["port"][0]) > 20
    assert out["port"][0] == out["ref"][0]
    assert out["port"][1] == out["ref"][1]
    np.testing.assert_allclose(out["port"][2], out["ref"][2], rtol=1e-6)
    np.testing.assert_allclose(out["port"][3], out["ref"][3], rtol=1e-6)


def test_cascade_from_jax_matches_port_arrays(tiny):
    info, _reads = tiny
    port = dc.DeviceAligner(info.store, device="cpu")
    port.attach_tables(WindowTables(info.db, info.store))
    ref = RefAligner(info.store)
    ref.attach_tables(RefTables(info.db, info.store))
    got = dc.cascade_from_jax(ref, "cpu")
    assert sorted(got["stacks"]) == sorted(port._stacks)
    for sig, tensors in got["stacks"].items():
        mine = port._stacks[sig].tensors()
        assert len(tensors) == len(mine) == 5
        for a, b in zip(tensors, mine):
            assert a.dtype == b.dtype and torch.equal(a, b)
    for f in ("w_sig", "w_slot", "w_seed_rank", "cn_rank", "probe_cnt"):
        np.testing.assert_array_equal(got[f], getattr(port, f), err_msg=f)


def test_cascade_aligner_needs_a_card_by_default(tiny):
    info, _reads = tiny
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        dc.DeviceAligner(info.store)
