"""The whole of a run on the CPU at a tiny size: the port against the plain
reference, the control, and the faults planted under the timed path, each
of which has to come out not correct."""

import time

import numpy as np
import pytest

from conftest import TINY_CELL
from harness import cell, data, judge, reference


def _run(tiny, tmp_path, seed=1234567890123):
    manifest, cache = tiny
    return cell.run(manifest, TINY_CELL, seed, 0.0, False, time.time(), device="cpu",
                    cache=cache, tmp=str(tmp_path))


def test_port_agrees_with_reference(tiny, tmp_path):
    result, numbers, forbidden = _run(tiny, tmp_path)
    assert forbidden == []
    assert result["correct"], numbers
    assert set(result["metrics"]) == {"reads_per_s", "host_peak_gib", "setup_s"}
    assert result["attempted"] == 3000


def _index_dir(cache):
    return next(p for p in (cache / "index").iterdir() if p.is_dir()
                and not p.name.endswith((".msa", ".building")))


def _reference_in_place(tiny, **kw):
    """The reference, and the reference put in the program's place with
    `kw` (the control's float32 weights)."""
    manifest, cache = tiny
    cfg = manifest.config("tiny_w150")
    clusters = data.database(cfg)
    reads, names, _o = data.sample(manifest.traffic("tiny"), clusters, 77, 0)
    ix = reference.Index(str(_index_dir(cache)))
    want = reference.align(ix, reads, names, 0.99, 1.0, 0.97)
    got = reference.align(ix, reads, names, 0.99, 1.0, 0.97, **kw)
    return want, got


def test_control_fails(tiny, tmp_path):
    """float32 weights, the precision below the configuration's float64,
    read above the weight limit."""
    _run(tiny, tmp_path)  # the index
    want, got = _reference_in_place(tiny, weight_dtype=np.float32)
    gap = judge.weight_gap(got.weights, want.weights)
    assert gap > judge.LIMITS["weight_gap"], gap
    assert got.records == want.records


def _break(monkeypatch, fault):
    from groot_tpu_torch.align import batch_host
    from groot_tpu_torch.pipeline import align_pipeline

    if fault == "state_unchanged":
        monkeypatch.setattr(batch_host.WeightAccumulator, "flush", lambda self, store: None)
    elif fault == "half_batch":
        raw = align_pipeline._compute_hits

        def half(info, batch, kmer_counts, k, s, t, tables, *rest):
            rows, wins, _c = raw(info, batch, kmer_counts, k, s, t, tables, *rest)
            keep = rows < batch.n_valid // 2
            return batch_host.sort_hits(tables, rows[keep], wins[keep])
        monkeypatch.setattr(align_pipeline, "_compute_hits", half)
    elif fault == "answer_altered":
        raw = align_pipeline._RecSink.write_raw

        def altered(self, data, count):
            b = bytearray(bytes(data))
            b[8] ^= 1  # the first record's position
            raw(self, bytes(b), count)
        monkeypatch.setattr(align_pipeline._RecSink, "write_raw", altered)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_broken_program_is_not_correct(tiny, tmp_path, monkeypatch, fault):
    _run(tiny, tmp_path)  # the index, before the program is broken
    _break(monkeypatch, fault)
    result, numbers, _f = _run(tiny, tmp_path)
    print(fault, numbers)
    assert not result["correct"], numbers


def _table(graph, node, off, span, sketches, ptr, seg, val):
    """{(graph, node, offset, sketch): (span, contained nodes, tallies)}."""
    return {(int(graph[i]), int(node[i]), int(off[i]), sketches[i].tobytes()):
            (int(span[i]), seg[ptr[i]:ptr[i + 1]].tolist(), val[ptr[i]:ptr[i + 1]].tolist())
            for i in range(len(graph))}


def test_window_table_equals_program_index(tiny, tmp_path):
    """The reference's own window table is the one the program's index
    holds: every window, span and tally."""
    import pickle

    _run(tiny, tmp_path)  # the index
    idx = _index_dir(tiny[1])
    with open(idx / "groot.lshe", "rb") as fh:
        soa = pickle.load(fh)["soa"]
    ix = reference.Index(str(idx))
    want = _table(soa["w_graph"], soa["w_node"], soa["w_off"], soa["w_merge_span"],
                  soa["sketches"], soa["cn_ptr"], soa["cn_seg"], soa["cn_val"])
    got = _table(ix.w_graph, ix.w_node, ix.w_off, ix.w_span, ix.sketches, ix.cn_ptr,
                 ix.cn_seg, ix.cn_val)
    assert len(got) == len(ix.w_graph) == len(soa["w_graph"])
    assert got == want


@pytest.mark.parametrize("fault", ["windows_dropped", "containment_off"])
def test_broken_index_is_not_correct(tiny, tmp_path, fault):
    """An index whose builder lost half the windows, or mis-set the
    containment tallies, makes the run not correct: the reference works
    the window table out for itself."""
    from groot_tpu_torch.index.lshe import ContainmentIndex

    _run(tiny, tmp_path)  # the index
    path = _index_dir(tiny[1]) / "groot.lshe"
    sidecar = path.with_name("groot.align")  # derived from the index by a pass
    saved = path.read_bytes()
    sidecar.unlink()
    try:
        index = ContainmentIndex.load(str(path))
        if fault == "windows_dropped":
            index.soa["sketches"][::2, 0] ^= np.uint64(1)
            index._tables = None  # the band tables follow the sketches
        else:
            index.soa["cn_val"] *= 2.0
        index.dump(str(path))
        result, numbers, _f = _run(tiny, tmp_path)
    finally:
        path.write_bytes(saved)
        sidecar.unlink(missing_ok=True)
    print(fault, numbers)
    assert not result["correct"], numbers
