"""The groot.align sidecar holds the device engine's set-up tables.

A device aligner that maps its tables from the sidecar equals one that
derived them, array for array and tensor for tensor; every kind of stale
sidecar is derived again and rewritten, and the next call loads it; the
segmented per-window reduce equals the formula it replaced; and two aligns
on one index, the first writing the tables and the second loading them,
give the same result."""

import os
import shutil
import struct

import numpy as np
import pytest
import torch

from groot_tpu_torch import synth
from groot_tpu_torch.align import device_join as dj
from groot_tpu_torch.align.batch_host import WindowTables
from groot_tpu_torch.align.hash_join import HashAligner
from groot_tpu_torch.config import AlignCmd, Info
from groot_tpu_torch.index.lshe import ContainmentIndex
from groot_tpu_torch.io import bam as bamio
from groot_tpu_torch.pipeline import align_pipeline
from groot_tpu_torch.pipeline.index_pipeline import run_index

K, S, W = 31, 20, 100
SIDECAR = "groot.align"
# set-up attributes that every call derives from the host arrays
CHEAP = ("_ghasN", "_rowpos_shift", "_d1", "_dev_ok", "_tail_bloom_mask")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """An index made by `index` (its sidecar holds every table), the reads
    of the database, and an aligner that built every table itself."""
    tmp = tmp_path_factory.mktemp("sidecar")
    alleles = synth.tiny_db(str(tmp / "msa"))
    run_index(Info(kmer_size=K, sketch_size=S, window_size=W,
                   index_dir=str(tmp / "idx")), str(tmp / "msa"), "cpu")
    reads, _which, _starts = synth.sample_reads(
        np.random.default_rng(3), alleles, 160,
        lengths=(31, 60, 100, 150, 192, 200), n_frac=0.05, tail_frac=0.2,
    )
    fq = str(tmp / "reads.fq")
    synth.write_fastq(reads, fq)
    info, refs = _load(str(tmp / "idx"))
    built_here = dj.DeviceJoinAligner(info.store, refs, device="cpu")
    built_here.attach_tables(WindowTables(info.db, info.store), info.db, K)
    return tmp, fq, built_here


def _load(index_dir):
    info = Info.load(os.path.join(index_dir, "groot.gg"))
    info.attach_db(ContainmentIndex.load(os.path.join(index_dir, "groot.lshe")))
    info.index_dir = index_dir
    return info, bamio.build_references(info.store)


def _index_copy(built, tmp_path):
    """A copy of the built index, with the sidecar `index` wrote."""
    dst = str(tmp_path / "idx")
    shutil.copytree(str(built[0] / "idx"), dst)
    return dst


def _make(index_dir):
    """The device engine's set-up as an align call makes it."""
    info, refs = _load(index_dir)
    return align_pipeline._make_aligner(
        "device", info, torch.device("cpu"), refs
    )[0]


def _entries(path):
    side = HashAligner._map_sidecar(path)
    assert side is not None
    return side


def _patch(path, name, fn):
    """Overwrite sidecar entry `name` in place with fn(its values)."""
    side = _entries(path)
    arr = np.array(HashAligner._side_get(side, name))
    _blob, base, meta = side
    off = meta[name][2]
    side[0].close()
    new = np.ascontiguousarray(fn(arr), dtype=arr.dtype)
    assert new.shape == arr.shape
    with open(path, "r+b") as fh:
        fh.seek(base + off)
        fh.write(new.tobytes())


def _assert_same_tables(got, want):
    for name in HashAligner._ARRAYS + dj.DeviceJoinAligner._DEV_ARRAYS + CHEAP:
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in HashAligner._WT_ARRAYS:
        np.testing.assert_array_equal(
            getattr(got.tables, name), getattr(want.tables, name), err_msg=name
        )
    assert got._dev.keys() == want._dev.keys()
    for name, v in want._dev.items():
        if torch.is_tensor(v):
            assert torch.equal(got._dev[name], v), name
        else:
            assert got._dev[name] == v, name


def _hash_written(path):
    """The sidecar as the hash engine writes it: no device tables."""
    info, refs = _load(os.path.dirname(path))
    al = HashAligner(info.store, refs)
    al.attach_tables(WindowTables(info.db, info.store), info.db, K)
    al.save_arrays(path)


@pytest.mark.parametrize("path", ["index", "derive", "load"])
def test_loaded_tables_equal_derived(built, tmp_path, path):
    """(a) The first device call after `index` maps every table from the
    sidecar `index` wrote; on a sidecar without the device tables the call
    derives them and writes them, and the next maps them. Each equals an
    aligner that built every table itself."""
    idx = _index_copy(built, tmp_path)
    if path != "index":
        _hash_written(os.path.join(idx, SIDECAR))
        first = _make(idx)
        assert first.stage_times["setup_derived"] == 1
    got = first if path == "derive" else _make(idx)
    assert got.stage_times["setup_derived"] == (1 if path == "derive" else 0)
    _assert_same_tables(got, built[2])
    if path != "derive":
        for name in dj.DeviceJoinAligner._DEV_ARRAYS:
            assert not getattr(got, name).flags.writeable, name  # mapped


def _stale_fingerprint(path):
    _patch(path, "_fingerprint", lambda a: a + np.array([1, 0, 0, 0]))


def _stale_k(path):
    """A sidecar written for the same index at k + 2."""
    info, refs = _load(os.path.dirname(path))
    al = dj.DeviceJoinAligner(info.store, refs, device="cpu")
    al.attach_tables(WindowTables(info.db, info.store), info.db, K + 2)
    al.save_arrays(path)


def _old_magic(path):
    with open(path, "r+b") as fh:
        fh.write(b"GROOTALN2\x00")


def _other_constant(path):
    _patch(path, "_scalars", lambda a: np.concatenate([a[:-1], a[-1:] - 1]))


@pytest.mark.parametrize("stale", [
    _stale_fingerprint, _stale_k, _old_magic, _hash_written, _other_constant,
], ids=["fingerprint", "k_plus_2", "GROOTALN2", "no_device_tables",
        "constant"])
def test_stale_sidecar_is_derived_and_rewritten(built, tmp_path, stale):
    """(b) Whatever makes the sidecar stale, the call derives the tables,
    rewrites the file in the current format with them, and the next call
    loads it."""
    idx = _index_copy(built, tmp_path)
    path = os.path.join(idx, SIDECAR)
    stale(path)
    before = os.stat(path).st_ino
    al = _make(idx)
    assert al.stage_times["setup_derived"] == 1
    assert os.stat(path).st_ino != before  # replaced whole
    with open(path, "rb") as fh:
        assert fh.read(10) == HashAligner._SIDE_MAGIC
    _blob, _base, meta = _entries(path)
    assert all("dev" + n in meta for n in dj.DeviceJoinAligner._DEV_ARRAYS)
    again = _make(idx)
    assert again.stage_times["setup_derived"] == 0
    _assert_same_tables(again, built[2])
    assert not [f for f in os.listdir(idx) if f.endswith(".tmp")]


def test_changed_tail_mix_makes_sidecar_stale(built, tmp_path, monkeypatch):
    """The stored path-tail hashes hold TAIL_MIX, and the query keys take it
    from the code: a sidecar written under another TAIL_MIX is stale, is
    derived under the new one and rewritten, and the next call loads it."""
    idx = _index_copy(built, tmp_path)
    monkeypatch.setattr(dj, "TAIL_MIX", dj.TAIL_MIX ^ np.uint64(1))
    al = _make(idx)
    assert al.stage_times["setup_derived"] == 1
    assert not np.array_equal(al._tail_hash, built[2]._tail_hash)
    assert _make(idx).stage_times["setup_derived"] == 0
    monkeypatch.undo()
    back = _make(idx)
    assert back.stage_times["setup_derived"] == 1
    _assert_same_tables(back, built[2])


def _w_tail_min_searchsorted(node_tail, cn_ptr, cn_grow):
    """The formula the segmented reduce replaced: each entry's window by a
    binary search over the CSR pointers, then an unbuffered minimum."""
    n_ent = len(cn_grow)
    went = np.searchsorted(cn_ptr, np.arange(n_ent), side="right") - 1
    wmin = np.full(len(cn_ptr) - 1, dj.INF40, np.int64)
    np.minimum.at(wmin, went, node_tail[cn_grow])
    return wmin


def _csr_case(rng, n_nodes, cnt):
    cn_ptr = np.concatenate(([0], np.cumsum(cnt))).astype(np.int64)
    cn_grow = rng.integers(0, n_nodes, int(cn_ptr[-1])).astype(np.int64)
    return cn_ptr, cn_grow


@pytest.mark.parametrize("case", ["index", "no_terminal_free_graph",
                                  "single_node_windows", "random"])
def test_window_tail_min_equals_searchsorted_formula(built, case):
    """(c) window_tail_min equals the searchsorted + minimum.at formula on
    the index, on a graph with no terminal-free row (all its nodes INF40),
    on windows of one node each, and on random CSRs with empty windows."""
    rng = np.random.default_rng(7)
    al = built[2]
    if case == "index":
        t = al.tables
        owner, prow, pos = al._expand_rows(
            np.arange(len(al.node_len), dtype=np.int64)
        )
        dist = np.where(al.tfree[prow],
                        al.path_len[prow].astype(np.int64) - pos, dj.INF40)
        node_tail = np.full(len(al.node_len), dj.INF40, np.int64)
        np.minimum.at(node_tail, owner, dist)
        cases = [(node_tail, t.cn_ptr, t.cn_grow)]
    elif case == "no_terminal_free_graph":
        node_tail = rng.integers(0, 500, 300).astype(np.int64)
        node_tail[100:200] = dj.INF40  # one graph's nodes, none near an end
        cn_ptr, cn_grow = _csr_case(rng, 300, rng.integers(0, 4, 120))
        half = len(cn_grow) // 2  # the later windows hold only its nodes
        cn_grow[half:] = rng.integers(100, 200, len(cn_grow) - half)
        cases = [(node_tail, cn_ptr, cn_grow)]
    elif case == "single_node_windows":
        node_tail = rng.integers(0, 500, 50).astype(np.int64)
        cases = [(node_tail, *_csr_case(rng, 50, np.ones(80, np.int64)))]
    else:
        cases = []
        for n_win in (1, 2, 17, 400):
            node_tail = np.where(rng.random(60) < 0.3, dj.INF40,
                                 rng.integers(0, 300, 60)).astype(np.int64)
            cnt = rng.integers(0, 5, n_win)
            cnt[0] = 0  # an empty first window
            cases.append((node_tail, *_csr_case(rng, 60, cnt)))
        cases.append((np.zeros(4, np.int64), np.zeros(4, np.int64),
                      np.zeros(0, np.int64)))  # no entries at all
    for node_tail, cn_ptr, cn_grow in cases:
        got = dj.window_tail_min(node_tail, cn_ptr, cn_grow)
        want = _w_tail_min_searchsorted(node_tail, cn_ptr, cn_grow)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    if case == "index":
        np.testing.assert_array_equal(al._w_tail_min, want)


def _run(index_dir, fq, bam, engine="device"):
    os.environ["GROOT_ENGINE"] = engine
    try:
        info, refs = _load(index_dir)
        info.containment_threshold = 0.99
        info.sketch = AlignCmd(min_kmer_coverage=0.5)
        with open(bam, "wb") as fh:
            writer = bamio.BamWriter(fh, refs)
            stats = align_pipeline.run_align(info, [fq], bam_writer=writer,
                                             batch_size=64, device="cpu")
            writer.close()
    finally:
        os.environ.pop("GROOT_ENGINE", None)
    weights = np.array([n.kmer_freq for _g, g in sorted(info.store.items())
                        for n in g.sorted_nodes])
    _refs, records = bamio.read_bam(bam)
    keys = sorted((r.name, r.ref_id, r.pos, r.flag, r.seq_len, tuple(r.cigar))
                  for r in records)
    counts = (stats.received, stats.mapped, stats.multimapped,
              stats.alignment_count)
    return stats, counts, weights, keys


@pytest.mark.parametrize("second", ["device", "hash"])
def test_align_twice_on_one_index(built, tmp_path, second):
    """(d) Two aligns on one index whose sidecar the hash engine wrote: the
    first derives the device tables and writes them, the second (device)
    loads them, or (hash) ignores them and leaves the file as it is. Stats,
    records and node weights are equal."""
    idx = _index_copy(built, tmp_path)
    _hash_written(os.path.join(idx, SIDECAR))
    fq = built[1]
    s1, c1, w1, k1 = _run(idx, fq, str(tmp_path / "a.bam"))
    assert s1.stage_times["setup_derived"] == 1
    ino = os.stat(os.path.join(idx, SIDECAR)).st_ino
    s2, c2, w2, k2 = _run(idx, fq, str(tmp_path / "b.bam"), second)
    if second == "device":
        assert s2.stage_times["setup_derived"] == 0
    assert os.stat(os.path.join(idx, SIDECAR)).st_ino == ino
    assert c1 == c2 and c1[1] > 0 and c1[3] > 20
    # the pool threads' tallies merge in the order they finish, so the
    # float64 weights of any two runs may part in the last bits
    np.testing.assert_allclose(w1, w2, rtol=1e-12, atol=0)
    assert k1 == k2


def test_sidecar_header_is_64_byte_aligned(built, tmp_path):
    """Every array of a written sidecar starts on a 64-byte boundary of the
    file, so the mapped views are aligned."""
    path = os.path.join(_index_copy(built, tmp_path), SIDECAR)
    blob, base, meta = _entries(path)
    with open(path, "rb") as fh:
        fh.seek(len(HashAligner._SIDE_MAGIC))
        (hlen,) = struct.unpack("<q", fh.read(8))
    assert base == len(HashAligner._SIDE_MAGIC) + 8 + hlen and base % 64 == 0
    assert all(off % 64 == 0 for _dt, _shape, off in meta.values())
    blob.close()


def test_derived_tables_equal_loop_formulas(built):
    """The flat derivations equal the per-row and unbuffered forms they
    replaced: the phase-A window and path-tail hashes row by row, the
    window row counts by np.add.at."""
    al = built[2]
    k, t = al.k, al.tables
    ah = np.zeros(len(al.ph), np.uint64)
    pe = np.zeros((al.R, dj.KA), np.uint64)
    ka = np.arange(dj.KA, dtype=np.int64)
    with np.errstate(over="ignore"):
        for r in range(al.R):
            plen, s = int(al.path_len[r]), int(al.ph_start[r])
            n = plen - k + 1
            if n > 0:
                pos = np.arange(n, dtype=np.int64)
                ah[s : s + n] = (al.ph[s + pos + k] - al.ph[s + pos]) * al.rinv[pos]
            wv = (plen - ka)[plen - ka >= 0]
            pe[r, : len(wv)] = (al.ph[s + plen] - al.ph[s + wv]) * al.rinv[wv]
    np.testing.assert_array_equal(al._ah32, ah.astype(np.uint32).view(np.int32))
    np.testing.assert_array_equal(al._pe2, pe.astype(np.uint32).view(np.int32))
    wr_cnt = np.zeros(t.num_windows, np.int64)
    owner, _prow, _pos = al._expand_rows(t.w_seed_grow)
    np.add.at(wr_cnt, owner, 1)
    np.testing.assert_array_equal(al._wr_cnt, wr_cnt)
