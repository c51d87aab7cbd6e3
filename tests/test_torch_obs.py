"""The span recorder (groot_tpu_torch.obs) on the device engine's align
pipeline, on the CPU: one batch id from ingest to replay, the same answer
with the recorder on and off, nothing recorded while off, GC pauses, and
the CLI's --profiling span file."""

import gc
import json
import os

import numpy as np
import pytest

from groot_tpu_torch import cli, obs, synth
from groot_tpu_torch.config import AlignCmd, Info
from groot_tpu_torch.index.lshe import ContainmentIndex
from groot_tpu_torch.io import bam as bamio
from groot_tpu_torch.pipeline import align_pipeline
from groot_tpu_torch.pipeline.index_pipeline import run_index

BATCH = 64
PER_BATCH = ("ingest.prep", "phase_a.submit", "phase_a.fetch", "tail.collect",
             "launch.replay")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The port's index of the tiny database and 300 of its reads."""
    tmp = tmp_path_factory.mktemp("obs")
    alleles = synth.tiny_db(str(tmp / "msa"))
    run_index(Info(kmer_size=31, sketch_size=20, window_size=100,
                   index_dir=str(tmp / "idx")), str(tmp / "msa"), "cpu")
    reads, _which, _starts = synth.sample_reads(
        np.random.default_rng(11), alleles, 300, lengths=(100, 120, 150),
        n_frac=0.0,
    )
    fq = str(tmp / "reads.fq")
    synth.write_fastq(reads, fq)
    return str(tmp / "idx"), fq


def _align(data, tmp_path, traced):
    """The device engine on the CPU: (stats, node weights, BAM records,
    spans or None)."""
    index_dir, fq = data
    info = Info.load(os.path.join(index_dir, "groot.gg"))
    info.attach_db(ContainmentIndex.load(os.path.join(index_dir, "groot.lshe")))
    info.index_dir = index_dir
    info.containment_threshold = 0.99
    info.num_proc = 2
    info.sketch = AlignCmd(min_kmer_coverage=0.5)
    bam = str(tmp_path / f"traced{int(traced)}.bam")
    os.environ["GROOT_ENGINE"] = "device"
    if traced:
        obs.start()
    try:
        with open(bam, "wb") as fh:
            writer = bamio.BamWriter(fh, bamio.build_references(info.store))
            stats = align_pipeline.run_align(info, [fq], bam_writer=writer,
                                             batch_size=BATCH, device="cpu")
            writer.close()
    finally:
        spans = obs.stop() if traced else None
        os.environ.pop("GROOT_ENGINE", None)
    weights = np.array([n.kmer_freq for _g, g in sorted(info.store.items())
                        for n in g.sorted_nodes])
    _refs, records = bamio.read_bam(bam)
    recs = sorted((r.name, r.ref_id, r.pos, r.flag, tuple(r.cigar)) for r in records)
    return stats, weights, recs, spans


def test_one_batch_id_from_ingest_to_replay(data, tmp_path):
    stats, _w, _r, spans = _align(data, tmp_path, True)
    n_batches = -(-stats.received // BATCH)
    assert n_batches >= 4
    for seq in range(n_batches):
        mine = sorted((s for s in spans if s[1] == seq), key=lambda s: s[3])
        got = [s[0] for s in mine if s[0] in PER_BATCH]
        assert got == list(PER_BATCH), (seq, got)
        assert all(s[3] <= s[4] and s[5] >= 0 for s in mine)
    # the launch thread's spans lie inside align.run, on its thread
    (run,) = [s for s in spans if s[0] == "align.run"]
    launch = {s[2] for s in spans if s[0] == "phase_a.submit"}
    assert launch == {run[2]}
    for s in spans:
        if s[0] in ("align.setup", "launch.wait_ingest", "launch.wait_tail",
                    "launch.replay", "align.flush", "phase_a.fetch"):
            assert s[2] == run[2] and run[3] <= s[3] <= s[4] <= run[4], s
    assert len([s for s in spans if s[0] == "align.setup"]) == 1
    assert {s[1] for s in spans if s[0] == "launch.wait_tail"} == set(range(n_batches))


def test_recorder_changes_no_answer(data, tmp_path):
    off = _align(data, tmp_path, False)
    on = _align(data, tmp_path, True)
    assert vars(off[0]) | {"stage_times": 0} == vars(on[0]) | {"stage_times": 0}
    # each pool thread sums its own weights and the threads take batches in
    # the order the scheduler gives, so sums may differ in the last bit
    np.testing.assert_allclose(off[1], on[1], rtol=1e-13, atol=0)
    assert off[2] == on[2] and len(off[2]) > 0


def test_recorder_off_records_nothing(data, tmp_path):
    assert not obs.on()
    assert obs.span("x", 3) is obs.span("y") is obs.NULL
    _align(data, tmp_path, False)
    assert not obs.on() and obs.stop() == []


def test_gc_pause_is_a_span():
    obs.start()
    try:
        gc.collect()
    finally:
        spans = obs.stop()
    pauses = [s for s in spans if s[0] == "gc"]
    assert pauses and all(s[3] <= s[4] for s in pauses)
    assert obs.gc.callbacks.count(obs._gc) == 0


def test_timer_counts_while_off():
    with obs.Timer("t", cpu=True) as tm:
        sum(range(10000))
    assert tm.s > 0 and 0 <= tm.cpu_s and not obs.on()


def test_profiling_writes_spans(data, tmp_path, monkeypatch):
    """--profiling writes the program's spans beside the torch trace, with
    the marker that pairs their clock with the profiler's."""
    index_dir, fq = data
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("GROOT_ENGINE", "device")
    assert cli.main(["align", "-i", index_dir, "-f", fq, "-c", "0.5", "-p", "2",
                     "-g", str(tmp_path / "g"), "--bamOut", str(tmp_path / "o.bam"),
                     "--batchSize", str(BATCH), "--device", "cpu", "--profiling",
                     "--log", str(tmp_path / "a.log")]) == 0
    doc = json.loads((tmp_path / "groot-profile" / "groot-spans.json").read_text())
    events = doc["traceEvents"]
    marker = events[0]
    assert marker["name"] == cli.MARKER and marker["args"]["profiler_us"] is not None
    assert marker["ts"] == marker["args"]["perf_counter_ns"] / 1e3
    names = {e["name"] for e in events}
    assert {"align.run", "align.setup", *PER_BATCH} <= names
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert not obs.on()
