"""The port end to end against groot_tpu on a synthetic database.

`index` gives the same window sketches and band tables; on ~200 reads of
mixed length (60-200 bp, reverse complements, Ns, reads over the device's
192 bp limit and reads of k or k+1 bases for the host residue) each port
engine equals the reference engine: stats, node weights, order-canonical
BAM records, pruned paths and report rows. The CLI runs index -> align ->
report on the CPU, the package never imports JAX or groot_tpu, and each
package reads the other's groot.gg."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from groot_tpu.config import AlignCmd as RefAlignCmd
from groot_tpu.config import Info as RefInfo
from groot_tpu.index.lshe import ContainmentIndex as RefIndex
from groot_tpu.io import bam as ref_bamio
from groot_tpu.pipeline import align_pipeline as ref_pipeline
from groot_tpu.pipeline.index_pipeline import run_index as ref_run_index
from groot_tpu.report import pileup as ref_pileup
from groot_tpu_torch import cli, synth
from groot_tpu_torch.config import AlignCmd, Info
from groot_tpu_torch.index.lshe import ContainmentIndex
from groot_tpu_torch.io import bam as bamio
from groot_tpu_torch.pipeline import align_pipeline
from groot_tpu_torch.pipeline.index_pipeline import run_index
from groot_tpu_torch.report import pileup

K, S, W = 31, 20, 100
MIN_COV = 0.5   # prune cutoff: keeps some paths of the sparse read set
REPORT_COV = 0.3
LENGTHS = (31, 32, 60, 80, 100, 100, 120, 150, 150, 170, 192, 200)


def _data(tmp, s: int):
    """The synthetic database indexed at k31 w100 and sketch size s by both
    packages (port/, ref/) and ~200 reads of it: (tmp, the FASTQ)."""
    msa = str(tmp / "msa")
    alleles = synth.tiny_db(msa)
    run_index(Info(kmer_size=K, sketch_size=s, window_size=W,
                   index_dir=str(tmp / "port")), msa, "cpu")
    ref_run_index(RefInfo(kmer_size=K, sketch_size=s, window_size=W,
                       index_dir=str(tmp / "ref")), msa)
    reads, _which, _starts = synth.sample_reads(
        np.random.default_rng(5), alleles, 200, lengths=LENGTHS,
        n_frac=0.05, tail_frac=0.2,
    )
    fq = str(tmp / "reads.fq")
    synth.write_fastq(reads, fq)
    return tmp, fq


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return _data(tmp_path_factory.mktemp("pipe"), S)


@pytest.fixture(scope="module")
def data_s128(tmp_path_factory):
    """The same database and reads at sketch size 128: past the 64 slots of
    a khf_sketch warp's registers (the kernel runs slot groups there)."""
    return _data(tmp_path_factory.mktemp("pipe128"), 128)


def _bam_key_set(read_bam, path):
    _refs, records = read_bam(path)
    return sorted(
        (r.name, r.ref_id, r.pos, r.flag, r.seq_len, tuple(r.cigar))
        for r in records
    )


def _align(pkg, index_dir, fq, bam, engine):
    """One align run through `pkg` ("port"/"ref"): (stats, node weights,
    BAM keys, pruned paths, report rows)."""
    if pkg == "port":
        Index, bam_mod, pipe, rep = ContainmentIndex, bamio, align_pipeline, pileup
        cfg, cmd, kw = Info, AlignCmd, {"device": "cpu"}
    else:
        Index, bam_mod, pipe, rep = RefIndex, ref_bamio, ref_pipeline, ref_pileup
        cfg, cmd, kw = RefInfo, RefAlignCmd, {}
    os.environ["GROOT_ENGINE"] = engine
    try:
        info = cfg.load(os.path.join(index_dir, "groot.gg"))
        info.attach_db(Index.load(os.path.join(index_dir, "groot.lshe")))
        info.index_dir = index_dir
        info.containment_threshold = 0.99
        info.sketch = cmd(min_kmer_coverage=MIN_COV)
        with open(bam, "wb") as fh:
            writer = bam_mod.BamWriter(fh, bam_mod.build_references(info.store))
            stats = pipe.run_align(info, [fq], bam_writer=writer,
                                   batch_size=128, **kw)
            writer.close()
    finally:
        os.environ.pop("GROOT_ENGINE", None)
    weights = np.array([
        n.kmer_freq for _g, g in sorted(info.store.items())
        for n in g.sorted_nodes
    ])
    kept = pipe.prune_graphs(info, MIN_COV)
    rows = rep.format_report(rep.report_from_bam(bam, coverage_cutoff=REPORT_COV))
    return stats, weights, _bam_key_set(bam_mod.read_bam, bam), kept, rows


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_run_index_matches_reference(data, route, tmp_path, monkeypatch):
    """Both window-sketch routes of the port's index (the native runtime,
    and the numpy golden it uses where the runtime is absent) write the
    reference's index."""
    tmp, _fq = data
    port_dir = tmp / "port"
    if route == "numpy":
        from groot_tpu_torch.io import native

        monkeypatch.setattr(native, "window_sketch", lambda *a: None)
        port_dir = tmp_path / "np"
        synth.tiny_db(str(tmp_path / "msa"))
        run_index(Info(kmer_size=K, sketch_size=S, window_size=W,
                       index_dir=str(port_dir)), str(tmp_path / "msa"), "cpu")
    port = ContainmentIndex.load(str(port_dir / "groot.lshe"))
    ref = RefIndex.load(str(tmp / "ref" / "groot.lshe"))
    assert port.window_keys == ref.window_keys
    for name, arr in ref.soa.items():
        np.testing.assert_array_equal(port.soa[name], arr, err_msg=name)
    assert sorted(port._tables) == sorted(ref._tables)
    for Kb, tab in ref._tables.items():
        for name in ("sorted_sigs", "idx"):
            np.testing.assert_array_equal(port._tables[Kb][name], tab[name])
    p_info = RefInfo.load(str(port_dir / "groot.gg"))
    r_info = RefInfo.load(str(tmp / "ref" / "groot.gg"))
    assert sorted(p_info.store) == sorted(r_info.store)


@pytest.mark.parametrize(
    "port_engine,ref_engine",
    [("device", "device"), ("hash", "hash"), ("host", "hash"),
     ("cascade", "cascade")],
)
def test_engine_matches_reference(data, port_engine, ref_engine):
    _same_as_reference(data, port_engine, ref_engine)


@pytest.mark.parametrize(
    "port_engine,ref_engine",
    [("device", "device"), ("hash", "hash"), ("host", "hash"),
     ("cascade", "cascade")],
)
def test_engine_matches_reference_at_s128(data_s128, port_engine, ref_engine):
    """Sketch size 128 (the reference's own verify drive uses 30; any s is a
    setting users can pick): every engine equals the reference on all five
    counts, as at s = 20."""
    _same_as_reference(data_s128, port_engine, ref_engine)


def _same_as_reference(data, port_engine, ref_engine):
    """The port's `port_engine` run equals the reference's `ref_engine`
    run: stats, node weights, BAM records, pruned paths, report rows."""
    tmp, fq = data
    got = _align("port", str(tmp / "port"), fq,
                 str(tmp / f"p-{port_engine}.bam"), port_engine)
    want = _align("ref", str(tmp / "ref"), fq,
                  str(tmp / f"r-{ref_engine}.bam"), ref_engine)
    s_got, s_want = got[0], want[0]
    for f in ("received", "mapped", "multimapped", "alignment_count",
              "total_kmers"):
        assert getattr(s_got, f) == getattr(s_want, f), f
    assert s_got.alignment_count > 20
    assert got[1] == pytest.approx(want[1], rel=1e-6)
    assert got[2] == want[2]
    assert got[3] == want[3] and len(got[3]) > 0
    assert got[4] == want[4] and got[4]


def test_host_engine_one_match_volume_call_per_batch(data, monkeypatch):
    """The `host` engine computes a batch's match volumes, every graph its
    reads touch, in one `match_bits_batch` call: as many calls as batches
    that map a read (the run's 200 reads in batches of 128: two)."""
    from groot_tpu_torch.align import aligner

    calls, batches = [], []
    wrapper, per_batch = aligner.match_bits_batch, aligner.GraphAligner.align_graph_batches

    def count_calls(*a, **kw):
        calls.append(len(a[-1]))  # the segments: one a graph
        return wrapper(*a, **kw)

    def count_batches(self, per_graph):
        batches.append(len(per_graph))
        return per_batch(self, per_graph)

    monkeypatch.setattr(aligner, "match_bits_batch", count_calls)
    monkeypatch.setattr(aligner.GraphAligner, "align_graph_batches", count_batches)
    tmp, fq = data
    stats = _align("port", str(tmp / "port"), fq, str(tmp / "p-calls.bam"), "host")[0]
    assert stats.mapped > 0 and stats.alignment_count > 20
    assert len(calls) == sum(n > 0 for n in batches) == 2
    assert calls == [n for n in batches if n] and max(calls) > 1


def test_device_engine_stage_times(data):
    """The device engine's stage_times split its host tail: drain A, a part
    of reduce_s, has its own key, and the combos that verification sends to
    the host cascade are counted under that name. The launch thread's
    waits, the ingest prep, the aligner's set-up and the host tail's CPU
    seconds are counted too; the tail is never more on a CPU than its wall
    time, and no unread counter is left."""
    tmp, fq = data
    stats = _align("port", str(tmp / "port"), fq, str(tmp / "p-times.bam"),
                   "device")[0]
    st = stats.stage_times
    assert 0 <= st["drainA_s"] <= st["reduce_s"]
    assert st["verify_fb_combos"] == 0 and "stage2_combos" not in st
    assert st["combos"] > 0
    for key in ("wait_ingest_s", "wait_tail_s", "tail_cpu_s", "prep_s",
                "aligner_setup_s"):
        assert st[key] >= 0, key
    assert st["prep_s"] > 0 and st["aligner_setup_s"] > 0
    tail = st["reduce_s"] + st["verify_emit_s"] + st["residue_s"]
    assert st["tail_cpu_s"] <= tail + 1e-3
    assert not [k for k in st if k.startswith("s2_") or k == "h2d_bytes"]


def test_match_bits_leaves_tf32_flag_as_it_was(monkeypatch):
    """_match_bits runs its conv with cuDNN's TF32 off and gives the flag
    back as the caller had it, whichever that was."""
    from groot_tpu_torch.align import aligner

    seen = []
    conv = torch.nn.functional.conv1d

    def spy(*a, **kw):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv(*a, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv1d", spy)
    path = torch.ones((2, 40, 5))  # all N: every offset matches
    kern = torch.zeros((3, 8, 5))
    kern[:, :, 0] = 1.0
    eff = torch.full((3,), 8)
    prev = torch.backends.cudnn.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            bits = aligner._match_bits(path, kern, eff)
            assert torch.backends.cudnn.allow_tf32 is flag
            assert bits.shape == (3, 2, 2) and (bits[:, :, 0] == 0xFFFFFFFF).all()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert seen == [False, False]


def test_cli_index_align_report_cpu(data, tmp_path, capsys):
    _tmp, fq = data
    msa = str(tmp_path / "msa")
    synth.tiny_db(msa)
    idx, bam = str(tmp_path / "idx"), str(tmp_path / "out.bam")
    log = ["--log", str(tmp_path / "groot.log"), "--device", "cpu"]
    assert cli.main(["index", "-m", msa, "-i", idx, "-k", "31", "-s", "20",
                     "-w", "100", *log]) == 0
    assert cli.main(["align", "-i", idx, "-f", fq, "-c", str(MIN_COV), "-g",
                     str(tmp_path / "graphs"), "--bamOut", bam, *log]) == 0
    capsys.readouterr()
    assert cli.main(["report", "--bamFile", bam, "-c", str(REPORT_COV), *log]) == 0
    rows = capsys.readouterr().out
    assert rows and all(len(r.split("\t")) == 4 for r in rows.splitlines())
    assert os.listdir(tmp_path / "graphs")


def test_cli_device_cuda_raises_without_gpu(data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    tmp, fq = data
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["align", "-i", str(tmp / "port"), "-f", fq, "--bamOut",
                  str(tmp_path / "x.bam"), "--log", str(tmp_path / "l.log"),
                  "-g", str(tmp_path / "g"), "--device", "cuda"])


@pytest.mark.parametrize("pooled", [True, False])
def test_hash_engine_device_query_runs_on_the_command_device(
        data, pooled, monkeypatch):
    """GROOT_ENGINE=hash GROOT_DEVICE_QUERY=1: the capped device query of
    the host-sketched batches gets the align command's device (a CUDA
    device here, stood in for by the CPU query), in the pooled and the
    sequential loop, as the reference's query forces its device kernel."""
    tmp, fq = data
    seen = []
    real = ContainmentIndex._query_batch_np_dev

    def spy(self, q64, sizes, t, device):
        seen.append(torch.device(device))
        return real(self, q64, sizes, t, "cpu")

    monkeypatch.setattr(ContainmentIndex, "_query_batch_np_dev", spy)
    monkeypatch.setattr(align_pipeline, "resolve_device", torch.device)
    if not pooled:
        monkeypatch.setattr(align_pipeline.native, "available", lambda: False)
    monkeypatch.setenv("GROOT_ENGINE", "hash")
    monkeypatch.setenv("GROOT_DEVICE_QUERY", "1")
    info = Info.load(str(tmp / "port" / "groot.gg"))
    info.attach_db(ContainmentIndex.load(str(tmp / "port" / "groot.lshe")))
    info.index_dir = str(tmp / "port")
    info.containment_threshold = 0.99
    info.sketch = AlignCmd(min_kmer_coverage=MIN_COV)
    stats = align_pipeline.run_align(info, [fq], bam_writer=None,
                                     batch_size=128, device="cuda")
    assert stats.mapped > 0
    assert len(seen) == -(-stats.received // 128)
    assert all(d.type == "cuda" for d in seen), seen


@pytest.mark.parametrize("engine,exc", [("bogus", ValueError)])
def test_unported_engines_raise(engine, exc, monkeypatch):
    monkeypatch.setenv("GROOT_ENGINE", engine)
    with pytest.raises(exc):
        align_pipeline.select_engine()


_NO_JAX = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "groot_tpu")
for m in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[m]

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import groot_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    groot_tpu_torch.__path__, "groot_tpu_torch.")]
for n in names:
    importlib.import_module(n)
# the commands' lazy imports: get (refused before any download) and help
from groot_tpu_torch import cli
try:
    cli.main(["get", "-d", "nope", "--log", ""])
except ValueError:
    pass
cli.build_parser().format_help()
# a groot.gg written by groot_tpu
from groot_tpu_torch.config import Info
from groot_tpu_torch.graph.grootgraph import GrootGraph
info = Info.load(sys.argv[1])
assert info.store and all(isinstance(g, GrootGraph) for g in info.store.values())
print("MODULES", len(names))
print("GRAPHS", len(info.store))
print("BLOCKED", " ".join(sorted(
    m for m in sys.modules if m.split(".")[0] in BLOCKED)) or "-")
"""


def test_port_never_imports_jax(data):
    """With jax and groot_tpu blocked, every port module imports, the CLI
    builds its help, and a groot_tpu-written groot.gg loads."""
    tmp, _fq = data
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX, str(tmp / "ref" / "groot.gg")],
        cwd=repo, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    lines = dict(l.split(" ", 1) for l in res.stdout.splitlines() if " " in l)
    assert int(lines["MODULES"]) >= 34
    assert int(lines["GRAPHS"]) > 0
    assert lines["BLOCKED"] == "-"


def _store_state(store):
    """A graph store as plain data (types dropped), for comparing stores
    across the two packages."""
    out = {}
    for gid, g in store.items():
        d = dict(vars(g))
        d["sorted_nodes"] = [dict(vars(n)) for n in g.sorted_nodes]
        out[gid] = d
    return out


def test_reference_loads_port_groot_gg(data):
    """groot_tpu's Info.load reads a port-written groot.gg (the reference's
    class names) with a store equal to its own index's; the port reads it
    back too."""
    from groot_tpu.graph.grootgraph import GrootGraph as RefGraph

    from groot_tpu_torch.graph.grootgraph import GrootGraph

    tmp, _fq = data
    port = RefInfo.load(str(tmp / "port" / "groot.gg"))
    ref = RefInfo.load(str(tmp / "ref" / "groot.gg"))
    assert all(type(g) is RefGraph for g in port.store.values())
    assert type(port.sketch) is RefAlignCmd
    assert _store_state(port.store) == _store_state(ref.store)
    assert (port.kmer_size, port.sketch_size, port.window_size) == (K, S, W)
    back = Info.load(str(tmp / "port" / "groot.gg"))
    assert all(type(g) is GrootGraph for g in back.store.values())
    assert _store_state(back.store) == _store_state(ref.store)


def test_groot_gg_rewrites_only_class_names(data, tmp_path):
    """The port's groot.gg writer renames classes, not data: a string that
    spells a class of either package comes back as it was in both
    packages; a class of the port with no reference name is refused."""
    import pickle

    from groot_tpu_torch.io.fastx import FastqRead

    tmp, _fq = data
    info = Info.load(str(tmp / "port" / "groot.gg"))
    text = "cgroot_tpu_torch.config\nInfo\n|cgroot_tpu.config\nInfo\n"
    info.index_dir = text
    path = str(tmp_path / "groot.gg")
    info.dump(path)
    for load in (Info.load, RefInfo.load):
        back = load(path)
        assert back.index_dir == text
        assert back.kmer_size == K and len(back.store) == len(info.store)
    info.index_dir = FastqRead(id=b"@r", seq=b"ACGT", qual=b"IIII")
    with pytest.raises(pickle.PicklingError):
        info.dump(path)
