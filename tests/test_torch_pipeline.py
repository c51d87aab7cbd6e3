"""The port end to end against groot_tpu on a synthetic database.

`index` gives the same window sketches and band tables; on ~200 reads of
mixed length (60-200 bp, reverse complements, Ns, reads over the device's
192 bp limit and reads of k or k+1 bases for the host residue) each port
engine equals the reference engine: stats, node weights, order-canonical
BAM records, pruned paths and report rows. The CLI runs index -> align ->
report on the CPU, and the package never imports JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from groot_tpu.config import AlignCmd, Info
from groot_tpu.index.lshe import ContainmentIndex as RefIndex
from groot_tpu.io import bam as ref_bamio
from groot_tpu.pipeline import align_pipeline as ref_pipeline
from groot_tpu.pipeline.index_pipeline import run_index as ref_run_index
from groot_tpu.report import pileup as ref_pileup
from groot_tpu_torch import cli, synth
from groot_tpu_torch.index.lshe import ContainmentIndex
from groot_tpu_torch.io import bam as bamio
from groot_tpu_torch.pipeline import align_pipeline
from groot_tpu_torch.pipeline.index_pipeline import run_index
from groot_tpu_torch.report import pileup

K, S, W = 31, 20, 100
MIN_COV = 0.5   # prune cutoff: keeps some paths of the sparse read set
REPORT_COV = 0.3
LENGTHS = (31, 32, 60, 80, 100, 100, 120, 150, 150, 170, 192, 200)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    msa = str(tmp / "msa")
    alleles = synth.tiny_db(msa)
    for name, fn in (("port", run_index), ("ref", ref_run_index)):
        fn(Info(kmer_size=K, sketch_size=S, window_size=W,
                index_dir=str(tmp / name)), msa)
    reads = synth.sample_reads(
        np.random.default_rng(5), alleles, 200, lengths=LENGTHS,
        n_frac=0.05, tail_frac=0.2,
    )
    fq = str(tmp / "reads.fq")
    synth.write_fastq(reads, fq)
    return tmp, fq


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
        kw = {"device": "cpu"}
    else:
        Index, bam_mod, pipe, rep = RefIndex, ref_bamio, ref_pipeline, ref_pileup
        kw = {}
    os.environ["GROOT_ENGINE"] = engine
    try:
        info = Info.load(os.path.join(index_dir, "groot.gg"))
        info.attach_db(Index.load(os.path.join(index_dir, "groot.lshe")))
        info.index_dir = index_dir
        info.containment_threshold = 0.99
        info.sketch = AlignCmd(min_kmer_coverage=MIN_COV)
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
        from groot_tpu.io import native

        monkeypatch.setattr(native, "window_sketch", lambda *a: None)
        port_dir = tmp_path / "np"
        synth.tiny_db(str(tmp_path / "msa"))
        run_index(Info(kmer_size=K, sketch_size=S, window_size=W,
                       index_dir=str(port_dir)), str(tmp_path / "msa"))
    port = ContainmentIndex.load(str(port_dir / "groot.lshe"))
    ref = RefIndex.load(str(tmp / "ref" / "groot.lshe"))
    assert port.window_keys == ref.window_keys
    for name, arr in ref.soa.items():
        np.testing.assert_array_equal(port.soa[name], arr, err_msg=name)
    assert sorted(port._tables) == sorted(ref._tables)
    for Kb, tab in ref._tables.items():
        for name in ("sorted_sigs", "idx"):
            np.testing.assert_array_equal(port._tables[Kb][name], tab[name])
    p_info = Info.load(str(port_dir / "groot.gg"))
    r_info = Info.load(str(tmp / "ref" / "groot.gg"))
    assert sorted(p_info.store) == sorted(r_info.store)


@pytest.mark.parametrize(
    "port_engine,ref_engine",
    [("device", "device"), ("hash", "hash"), ("host", "hash")],
)
def test_engine_matches_reference(data, port_engine, ref_engine):
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


@pytest.mark.parametrize("engine,exc", [("cascade", NotImplementedError),
                                        ("bogus", ValueError)])
def test_unported_engines_raise(engine, exc, monkeypatch):
    monkeypatch.setenv("GROOT_ENGINE", engine)
    with pytest.raises(exc):
        align_pipeline.select_engine()


ALLOWED = {
    "groot_tpu", "groot_tpu.version", "groot_tpu.config", "groot_tpu.hostmem",
    "groot_tpu.graph", "groot_tpu.graph.grootgraph", "groot_tpu.io",
    "groot_tpu.io.gfa", "groot_tpu.io.msa2gfa", "groot_tpu.io.fastx",
    "groot_tpu.io.native", "groot_tpu.align", "groot_tpu.align.batch_host",
}

_NO_JAX = r"""
import importlib, pkgutil, sys
for m in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]:
    del sys.modules[m]

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax is blocked: " + name)
        return None

sys.meta_path.insert(0, BlockJax())
import groot_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    groot_tpu_torch.__path__, "groot_tpu_torch.")]
for n in names:
    importlib.import_module(n)
print("MODULES", len(names))
print("GROOT_TPU", " ".join(sorted(
    m for m in sys.modules if m.split(".")[0] == "groot_tpu")))
"""


def test_port_never_imports_jax():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX], cwd=repo, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    lines = dict(l.split(" ", 1) for l in res.stdout.splitlines() if " " in l)
    assert int(lines["MODULES"]) >= 15
    assert set(lines["GROOT_TPU"].split()) <= ALLOWED
