"""The system under test: groot_tpu_torch's `index`, and what one `align`
+ `report` command does once its index is loaded.

The index is built once a checkout by the program's own command line on the
card, as a user builds it, into a directory keyed by the configuration and a
hash of the program's sources; later runs load it. A pass is the timed
entry: `run_align` on the `device` engine writing BAM, the node weights as
`cli.align` reads them, `prune_graphs` at -c, and the report rows as
`cli.cmd_report` makes them through `report/pileup.py`. Before each pass
the store is put back to its state after loading; that is harness work and
lies outside the pass's clock.
"""

from __future__ import annotations

import hashlib
import io
import os
import pickle
import resource
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

PACKAGE = "groot_tpu_torch"
INDEX_KEYS = ("k", "s", "w")


def source_hash(root: Path) -> str:
    """A hash of the program's sources: the package and its native runtime."""
    h = hashlib.sha256()
    files = sorted(p for p in (root / PACKAGE).rglob("*")
                   if p.suffix in (".py", ".cu", ".cuh") and "_build" not in p.parts)
    files.append(root / "native" / "grootio.cpp")
    for p in files:
        if p.exists():
            h.update(str(p.relative_to(root)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def index_dir(cache: Path, name: str, config: dict, root: Path) -> Path:
    """Where the configuration's index lives in this checkout."""
    from .data import DB_KEYS

    h = hashlib.sha256(repr(sorted((k, config[k]) for k in DB_KEYS + INDEX_KEYS)).encode())
    h.update(source_hash(root).encode())
    return cache / "index" / f"{name}-{h.hexdigest()[:16]}"


def build_index(root: Path, msa: str, out: Path, config: dict, device: str) -> float:
    """`python -m groot_tpu_torch.cli index` into `out` (built beside it,
    then moved into place); returns its seconds."""
    tmp = out.with_name(out.name + ".building")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    cmd = [sys.executable, "-m", f"{PACKAGE}.cli", "index", "-m", msa, "-i", str(tmp),
           "-k", str(config["k"]), "-s", str(config["s"]), "-w", str(config["w"]),
           "-p", str(config["processors"]), "--device", device,
           "--log", str(tmp / "index.log")]
    env = dict(os.environ, PYTHONPATH=str(root))
    t0 = time.perf_counter()
    subprocess.run(cmd, cwd=str(root), env=env, check=True)
    dt = time.perf_counter() - t0
    os.replace(tmp, out)
    return dt


class PassOut:
    """One pass: its seconds, the seconds of prune + report, the stats, the
    program's stage counters, the node weights, the BAM bytes, the pruned
    paths and the report rows, and the process's CPU seconds over it."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class Program:
    """The program with its index loaded, ready to run passes."""

    def __init__(self, index: Path, config: dict, device: str):
        self.index = index
        self.config = config
        self.device = device
        self.info = None
        self._store = None

    def load(self) -> float:
        """Load the index as `cli.align` does; returns its seconds."""
        from groot_tpu_torch.config import AlignCmd, Info
        from groot_tpu_torch.index.lshe import ContainmentIndex

        os.environ["GROOT_ENGINE"] = str(self.config["engine"])
        t0 = time.perf_counter()
        info = Info.load(str(self.index / "groot.gg"))
        info.index_dir = str(self.index)
        info.attach_db(ContainmentIndex.load(str(self.index / "groot.lshe")))
        dt = time.perf_counter() - t0
        info.num_proc = int(self.config["processors"])
        info.containment_threshold = float(self.config["t"])
        info.sketch = AlignCmd(min_kmer_coverage=float(self.config["c"]))
        self.info = info
        self._store = pickle.dumps(info.store, protocol=pickle.HIGHEST_PROTOCOL)
        return dt

    def restore(self) -> None:
        self.info.store = pickle.loads(self._store)

    def one_pass(self, fastq: str) -> PassOut:
        from groot_tpu_torch.io import bam as bamio
        from groot_tpu_torch.pipeline.align_pipeline import prune_graphs, run_align
        from groot_tpu_torch.report.pileup import format_report, report_from_bam

        info = self.info
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter_ns()
        buf = io.BytesIO()
        writer = bamio.BamWriter(buf, bamio.build_references(info.store))
        stats = run_align(info, [fastq], bam_writer=writer,
                          batch_size=int(self.config["batch_size"]), device=self.device)
        writer.close()
        weights = np.array([n.kmer_freq for _gid, g in sorted(info.store.items())
                            for n in g.sorted_nodes], dtype=np.float64)
        t1 = time.perf_counter_ns()
        kept = prune_graphs(info, float(self.config["c"]))
        bam = buf.getvalue()
        rows = report_from_bam(None, coverage_cutoff=float(self.config["cov_cutoff"]),
                               fh=io.BytesIO(bam))
        format_report(rows)
        t2 = time.perf_counter_ns()
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        return PassOut(
            t0=t0, t1=t2, seconds=(t2 - t0) / 1e9, report_s=(t2 - t1) / 1e9,
            stats={"received": stats.received, "mapped": stats.mapped,
                   "multimapped": stats.multimapped,
                   "alignment_count": stats.alignment_count},
            stage_times=dict(stats.stage_times), weights=weights, bam=bam,
            kept=list(kept), rows=[(a.arg, a.count, a.length, a.cigar) for a in rows],
            user_s=ru1.ru_utime - ru0.ru_utime, sys_s=ru1.ru_stime - ru0.ru_stime,
        )


def instrument(spans, shapes: dict) -> None:
    """The traced run's wrappers: spans around ingest (sketch, query, hit
    sort), phase A submit and fetch, and the host tail; the launch shapes
    of the sketch and seed-scan kernels."""
    from groot_tpu_torch.align import device_join
    from groot_tpu_torch.pipeline import align_pipeline

    def sketch_shape(a, kw, out):
        codes, lens, k, s = a[0], a[1], a[2], a[3]
        lens = np.asarray(lens, np.int64)
        shapes.setdefault("khf_sketch", []).append(
            (int(codes.shape[0]), int(codes.shape[1]), int(s), int(lens.sum()),
             int(np.clip(lens - k + 1, 0, None).sum())))

    def scan_shape(a, kw, out):
        shapes.setdefault("seed_scan", []).append(
            (int(a[5].shape[0]), int(a[1].shape[0]), int(kw["n_offs"])))

    spans.wrap(align_pipeline, "_compute_hits", "ingest")
    spans.wrap(align_pipeline, "sketch_reads_u64", "ingest.sketch", sketch_shape)
    spans.wrap(device_join, "seed_scan", "phase_a.scan", scan_shape)
    spans.wrap(device_join.DeviceJoinAligner, "submit_pairs", "phase_a.submit")
    spans.wrap(device_join.DeviceJoinAligner, "fetch_pairs", "phase_a.fetch")
    spans.wrap(device_join.DeviceJoinAligner, "collect_pairs", "host_tail")
