"""The port's get / haplotype / accuracy / iamgroot commands and --profiling,
against groot_tpu on a synthetic database.

The port indexes the tiny database, aligns bbmap-named reads on the CPU
and saves the weighted graphs; its `haplotype` then calls the same alleles
with the same EM iteration counts and abundances (rtol 1e-5) as the
reference's load_weighted_gfas + find_haplotypes on the same GFA files, and
its accuracy harness reads the BAM exactly as the reference's does."""

import glob
import os
import subprocess
import sys
from dataclasses import astuple

import numpy as np
import pytest
import torch

from groot_tpu.config import HaploCmd, Info
from groot_tpu.pipeline import haplotype as ref_haplotype
from groot_tpu.report import accuracy as ref_accuracy
from groot_tpu_torch import cli, synth
from groot_tpu_torch.pipeline import haplotype
from groot_tpu_torch.report import accuracy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_READS = 600
HAPLO = dict(cutoff=0.05, min_iterations=50, max_iterations=10000)


@pytest.fixture(scope="module")
def aligned(tmp_path_factory):
    """(work dir, graph dir, BAM) of the port's CPU index -> align run."""
    tmp = tmp_path_factory.mktemp("cmds")
    clusters = synth.tiny_clusters()
    synth.write_msa_dir(clusters, str(tmp / "msa"))
    reads, which, starts = synth.sample_reads(
        np.random.default_rng(8), synth.alleles_of(clusters), N_READS,
        lengths=(90, 100), sub_frac=0.0, n_frac=0.0,
    )
    names = synth.allele_names(clusters)
    fq = str(tmp / "reads.fq")
    synth.write_fastq(reads, fq, origins=([names[i] for i in which], starts))
    log = ["--log", str(tmp / "groot.log"), "--device", "cpu"]
    idx, graphs, bam = str(tmp / "idx"), str(tmp / "graphs"), str(tmp / "out.bam")
    assert cli.main(["index", "-m", str(tmp / "msa"), "-i", idx, "-k", "31",
                     "-s", "20", "-w", "100", *log]) == 0
    assert cli.main(["align", "-i", idx, "-f", fq, "-c", "1", "-g", graphs,
                     "--bamOut", bam, *log]) == 0
    return tmp, graphs, bam


def _haplotypes(mod, gfas, device=None):
    info = Info()
    info.haplotype = HaploCmd(**HAPLO)
    graphs = mod.load_weighted_gfas(info, gfas)
    kw = {} if device is None else {"device": device}
    found = mod.find_haplotypes(info, graphs, **kw)
    return found, graphs


def test_haplotype_matches_reference(aligned, tmp_path, capsys):
    _tmp, graph_dir, _bam = aligned
    gfas = sorted(glob.glob(os.path.join(graph_dir, "*.gfa")))
    assert len(gfas) >= 2
    found, graphs = _haplotypes(haplotype, gfas, "cpu")
    ref_found, ref_graphs = _haplotypes(ref_haplotype, gfas)
    assert found == ref_found and found
    for g, r in zip(graphs, ref_graphs):
        assert g.em_iterations == r.em_iterations
        assert sorted(g.abundances) == sorted(r.abundances)
        for pid, a in r.abundances.items():
            assert g.abundances[pid] == pytest.approx(a, rel=1e-5)
    out = tmp_path / "haplo"
    capsys.readouterr()
    assert cli.main(["haplotype", "-g", graph_dir, "-o", str(out), "--device",
                     "cpu", "--log", str(tmp_path / "h.log")]) == 0
    assert capsys.readouterr().out.split() == found
    rows = (out / "haplotypes.tsv").read_text().splitlines()
    assert sorted(r.split("\t")[0] for r in rows) == sorted(found)


def test_accuracy_matches_reference(aligned, capsys):
    tmp, _graphs, bam = aligned
    got = accuracy.evaluate_bam(bam, N_READS)
    assert astuple(got) == astuple(ref_accuracy.evaluate_bam(bam, N_READS))
    assert got.aligned > N_READS // 2
    assert got.aligned - got.misaligned > 0  # origins parsed from the names
    store = Info.load(str(tmp / "idx" / "groot.gg")).store
    assert accuracy.misaligned_breakdown(bam, store) == (
        ref_accuracy.misaligned_breakdown(bam, store)
    )
    capsys.readouterr()
    assert cli.main(["accuracy", "--bamFile", bam, "--numReads", str(N_READS),
                     "-i", str(tmp / "idx"), "--log", str(tmp / "a.log")]) == 0
    out = capsys.readouterr().out
    assert out.startswith(got.format())
    assert "misaligned breakdown" in out


@pytest.mark.parametrize("database,match", [("arg-annot", "md5sum mismatch"),
                                            ("nope", "unrecognised database")])
def test_get_refuses_bad_databases(tmp_path, database, match):
    src = tmp_path / "src"
    src.mkdir()
    (src / "arg-annot.90.tar").write_bytes(b"corrupt")
    with pytest.raises(ValueError, match=match):
        cli.main(["get", "-d", database, "--source", str(src), "-o",
                  str(tmp_path / "out"), "--log", str(tmp_path / "g.log")])


def test_help_lists_every_command():
    out = subprocess.run(
        [sys.executable, "-m", "groot_tpu_torch.cli", "--help"], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    for cmd in ("get", "index", "align", "report", "haplotype", "accuracy",
                "version", "iamgroot"):
        assert cmd in out.stdout


def test_iamgroot_and_version(capsys):
    assert cli.main(["iamgroot"]) == 0
    assert "I am Groot" in capsys.readouterr().out
    assert cli.main(["version"]) == 0
    assert capsys.readouterr().out.strip() == "1.1.2"


@pytest.mark.parametrize("cmd", ["index", "haplotype"])
def test_device_cuda_raises_without_card(aligned, tmp_path, cmd):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    tmp, graph_dir, _bam = aligned
    argv = {
        "index": ["index", "-m", str(tmp / "msa"), "-i", str(tmp_path / "i")],
        "haplotype": ["haplotype", "-g", graph_dir, "-o", str(tmp_path / "h")],
    }[cmd]
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([*argv, "--device", "cuda", "--log", str(tmp_path / "l.log")])


def test_profiling_writes_a_trace(aligned, tmp_path, monkeypatch, capsys):
    _tmp, _graphs, bam = aligned
    monkeypatch.chdir(tmp_path)
    assert cli.main(["report", "--bamFile", bam, "--profiling",
                     "--log", str(tmp_path / "r.log")]) == 0
    traces = glob.glob(os.path.join(tmp_path, "groot-profile", "*.json"))
    assert traces and os.path.getsize(traces[0]) > 0
