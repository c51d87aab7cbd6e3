"""The groot_tpu_torch command line: get / index / align / report /
haplotype / accuracy / version / iamgroot.

Counterpart of groot_tpu/cli.py with the same commands and flags, plus
`--device {cuda,cpu}` (default cuda): where the port's kernels run (the
window sketch of `index`, the read sketch and phase A of `align`, the EM of
`haplotype`). `--device cuda` with no usable card raises; `cpu` runs their
plain PyTorch versions, and the native host runtime where the reference
runs it. `--profiling` writes a torch.profiler trace to ./groot-profile,
and beside it groot-spans.json: the align pipeline's spans (`obs`) as
Chrome-trace `X` events, timed in microseconds of time.perf_counter, and one
`groot.marker` event whose args pair that clock (`perf_counter_ns`) with
the profiler's (`profiler_us`, as torch.profiler's events() read it) at the
instant of the `groot.marker` annotation in the torch trace. Shifting every
span by the difference between the two `groot.marker` timestamps puts it on
the torch trace's timeline.

Run as `python -m groot_tpu_torch.cli ...`.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import logging
import os
import sys
import time
from dataclasses import dataclass
from typing import List

import numpy as np

from . import obs
from .version import get_version

log = logging.getLogger("groot")


def _setup_logging(log_file: str) -> None:
    handlers = []
    if log_file:
        handlers.append(logging.FileHandler(log_file))
    else:
        handlers.append(logging.StreamHandler(sys.stderr))
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(message)s", handlers=handlers,
        force=True,
    )


PROFILE_DIR = "./groot-profile"
MARKER = "groot.marker"


@contextlib.contextmanager
def _profiled(args):
    """A torch.profiler trace of the command into PROFILE_DIR when
    --profiling is set (the reference writes a jax.profiler trace there),
    and the spans the program recorded meanwhile in groot-spans.json."""
    if not args.profiling:
        yield
        return
    import torch
    from torch.profiler import (
        ProfilerActivity, profile, record_function, tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(
        activities=activities, on_trace_ready=tensorboard_trace_handler(PROFILE_DIR)
    )
    obs.start()
    try:
        with prof:
            with record_function(MARKER):
                marker_ns = time.perf_counter_ns()
            yield
    finally:
        spans = obs.stop()
    marker = next((e for e in prof.events() if e.name == MARKER), None)
    _write_spans(
        os.path.join(PROFILE_DIR, "groot-spans.json"), spans, marker_ns,
        None if marker is None else marker.time_range.start,
    )


def _write_spans(path, spans, marker_ns, profiler_us) -> None:
    """obs spans as Chrome-trace X events on perf_counter microseconds,
    with the marker event that ties them to the profiler's clock."""
    pid = os.getpid()
    events = [{
        "name": MARKER, "ph": "X", "ts": marker_ns / 1e3, "dur": 0, "pid": pid,
        "tid": 0, "args": {"perf_counter_ns": marker_ns, "profiler_us": profiler_us},
    }]
    for name, batch, tid, t0, t1, cpu in spans:
        events.append({
            "name": name, "ph": "X", "ts": t0 / 1e3, "dur": (t1 - t0) / 1e3,
            "pid": pid, "tid": tid, "args": {"batch": batch, "cpu_us": cpu / 1e3},
        })
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump({"traceEvents": events}, fh)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="groot-tpu-torch",
        description=(
            "annotate Antibiotic Resistance Genes (ARGs) from metagenomes "
            "using variation graphs — the PyTorch/CUDA port of groot_tpu"
        ),
    )
    p.add_argument("--version", action="version", version=get_version())
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_globals(sp):
        sp.add_argument("-i", "--indexDir", default="", help="index directory")
        sp.add_argument("--log", default="groot.log", help="log file ('' = stderr)")
        sp.add_argument(
            "-p", "--processors", type=int, default=os.cpu_count() or 1
        )
        sp.add_argument("--profiling", action="store_true")
        sp.add_argument(
            "--batchSize", type=int, default=2048, help="reads per device batch"
        )
        sp.add_argument(
            "--device", choices=("cuda", "cpu"), default="cuda",
            help="where the kernels run (cpu: their plain PyTorch versions)",
        )

    g = sub.add_parser("get", help="download a pre-clustered ARG database")
    g.add_argument("-d", "--database", required=True)
    g.add_argument("--identity", default="90")
    g.add_argument("-o", "--out", default=".")
    g.add_argument(
        "--source", default=None, help="local dir/file holding the db tarball"
    )
    add_globals(g)

    i = sub.add_parser(
        "index", help="convert clustered reference sequences to variation graphs and index them"
    )
    i.add_argument("-m", "--msaDir", required=True)
    i.add_argument("-k", "--kmerSize", type=int, default=31)
    i.add_argument("-s", "--sketchSize", type=int, default=21)
    i.add_argument("-w", "--windowSize", type=int, default=100)
    i.add_argument("-x", "--numPart", type=int, default=8)
    i.add_argument("-y", "--maxK", type=int, default=4)
    i.add_argument("--maxSketchSpan", type=int, default=30)
    add_globals(i)

    a = sub.add_parser(
        "align", help="sketch reads, seed against the index, weight graphs and align"
    )
    a.add_argument("-f", "--fastq", action="append", default=[])
    a.add_argument("--fasta", action="store_true")
    a.add_argument("--noAlign", action="store_true")
    a.add_argument("-t", "--contThresh", type=float, default=0.99)
    a.add_argument("-c", "--minKmerCov", type=float, default=1.0)
    a.add_argument(
        "-g",
        "--graphDir",
        default="./groot-graphs-" + time.strftime("%Y%m%d%H%M%S"),
    )
    a.add_argument("--bamOut", default="", help="BAM output file (default STDOUT)")
    add_globals(a)

    r = sub.add_parser("report", help="generate a resistome profile from a BAM")
    r.add_argument("--bamFile", default="")
    r.add_argument("-c", "--covCutoff", type=float, default=0.97)
    r.add_argument("--lowCov", action="store_true")
    add_globals(r)

    h = sub.add_parser("haplotype", help="call haplotypes from weighted GFAs via EM")
    h.add_argument("-g", "--graphDir", default="", help="dir of groot-graph-*.gfa")
    h.add_argument("--gfa", action="append", default=[], help="explicit GFA file(s)")
    h.add_argument("--cutoff", type=float, default=0.05)
    h.add_argument("--minIterations", type=int, default=50)
    h.add_argument("--maxIterations", type=int, default=10000)
    h.add_argument("-o", "--out", default="groot-haplotypes")
    add_globals(h)

    acc = sub.add_parser(
        "accuracy", help="evaluate a BAM of simulated reads (bbmap-style names)"
    )
    acc.add_argument("--bamFile", required=True)
    acc.add_argument("--numReads", type=int, required=True)
    add_globals(acc)  # -i/--indexDir enables the misaligned breakdown

    v = sub.add_parser("version", help="print the version")
    add_globals(v)
    e = sub.add_parser("iamgroot", help="I AM GROOT!")
    add_globals(e)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "version":
        print(get_version())
        return 0
    if args.cmd == "iamgroot":
        print(IAMGROOT)
        return 0
    _setup_logging(args.log)
    log.info("i am groot (version %s)", get_version())
    with _profiled(args):
        return COMMANDS[args.cmd](args)


# ---------------------------------------------------------------------------
def cmd_get(args) -> int:
    from .get import get_database

    path = get_database(args.database, args.identity, args.out, args.source)
    log.info("database extracted to %s", path)
    print(path)
    return 0


def cmd_index(args) -> int:
    from .config import Info

    from .pipeline.index_pipeline import run_index

    if not args.indexDir:
        print("please specify a directory for the index files (--indexDir)")
        return 1
    start = time.time()
    log.info("starting the index subcommand")
    log.info("\tprocessors: %d", args.processors)
    log.info("\tk-mer size: %d", args.kmerSize)
    log.info("\tsketch size: %d", args.sketchSize)
    log.info("\tgraph window size: %d", args.windowSize)
    log.info("\tnum. partitions: %d", args.numPart)
    log.info("\tmax. K: %d", args.maxK)
    log.info("\tmax. sketch span: %d", args.maxSketchSpan)
    info = Info(
        kmer_size=args.kmerSize,
        sketch_size=args.sketchSize,
        window_size=args.windowSize,
        num_part=args.numPart,
        max_k=args.maxK,
        max_sketch_span=args.maxSketchSpan,
        index_dir=args.indexDir,
        num_proc=args.processors,
        profiling=args.profiling,
    )
    run_index(info, args.msaDir, args.device)
    log.info("finished in %.2fs", time.time() - start)
    return 0


@dataclass
class AlignResult:
    stats: object               # pipeline.align_pipeline.AlignStats
    node_weights: np.ndarray    # kmer_freq of every node, before pruning
    kept_paths: List[str]       # paths left after pruning


def align(args) -> AlignResult:
    """The `align` command: load the index, align, prune, save graphs."""
    from .config import AlignCmd, Info

    from .index.lshe import ContainmentIndex
    from .io import bam as bamio
    from .pipeline.align_pipeline import prune_graphs, run_align, save_graphs

    start = time.time()
    log.info("starting the sketch subcommand")
    log.info("\tminimum k-mer coverage: %.0f", args.minKmerCov)
    for f in args.fastq:
        log.info("\tinput file: %s", f)
    log.info("loading the index information...")
    info = Info.load(os.path.join(args.indexDir, "groot.gg"))
    if info.version != get_version():
        raise SystemExit(
            "the groot index was created with a different version of groot "
            f"(you are currently using version {get_version()})"
        )
    log.info("\tk-mer size: %d", info.kmer_size)
    log.info("\tsketch size: %d", info.sketch_size)
    log.info("\twindow size used in indexing: %d", info.window_size)
    log.info("loading the graphs...")
    log.info("\tnumber of variation graphs: %d", len(info.store))
    log.info("rebuilding the LSH Ensemble...")
    # the index may have been moved since it was built: the groot.align
    # sidecar cache lives wherever the index now is
    info.index_dir = args.indexDir
    info.attach_db(
        ContainmentIndex.load(os.path.join(args.indexDir, "groot.lshe"))
    )
    info.num_proc = args.processors
    info.containment_threshold = args.contThresh
    info.sketch = AlignCmd(
        fasta=args.fasta,
        min_kmer_coverage=args.minKmerCov,
        no_exact_align=args.noAlign,
        bam_out=args.bamOut,
    )
    log.info("\tcontainment threshold: %.2f", info.containment_threshold)
    if args.noAlign:
        log.info("\tprevent exact alignments and using approximated mapping only")

    writer = None
    fh = None
    if not args.noAlign:
        refs = bamio.build_references(info.store)
        fh = open(args.bamOut, "wb") if args.bamOut else sys.stdout.buffer
        writer = bamio.BamWriter(fh, refs)
    stats = run_align(
        info, args.fastq, bam_writer=writer, batch_size=args.batchSize,
        device=args.device,
    )
    if writer is not None:
        writer.close()
        if args.bamOut:
            fh.close()
    weights = np.array(
        [
            n.kmer_freq
            for _gid, g in sorted(info.store.items())
            for n in g.sorted_nodes
        ],
        dtype=np.float64,
    )
    kept = prune_graphs(info, args.minKmerCov)
    save_graphs(info, args.graphDir, stats.total_kmers)
    log.info("finished in %.2fs", time.time() - start)
    return AlignResult(stats, weights, kept)


def cmd_align(args) -> int:
    if not args.indexDir:
        print("please specify a directory with the index files (--indexDir)")
        return 1
    align(args)
    return 0


def cmd_report(args) -> int:
    from .report.pileup import format_report, report_from_bam

    log.info("starting the report subcommand")
    log.info("\tcoverage cutoff: %.2f", args.covCutoff)
    cov = 0.97 if args.lowCov else args.covCutoff  # lowCov overrides -c
    annotations = report_from_bam(
        args.bamFile or None, coverage_cutoff=cov, low_cov=args.lowCov
    )
    sys.stdout.write(format_report(annotations))
    log.info("finished")
    return 0


def cmd_haplotype(args) -> int:
    from .config import HaploCmd, Info

    from .pipeline.haplotype import find_haplotypes, load_weighted_gfas

    start = time.time()
    log.info("starting the haplotype subcommand")
    gfas = list(args.gfa)
    if args.graphDir:
        gfas.extend(sorted(glob.glob(os.path.join(args.graphDir, "*.gfa"))))
    if not gfas:
        print("no GFA files supplied (use -g/--gfa)")
        return 1
    info = Info()
    info.haplotype = HaploCmd(
        cutoff=args.cutoff,
        min_iterations=args.minIterations,
        max_iterations=args.maxIterations,
        haplo_dir=args.out,
    )
    graphs = load_weighted_gfas(info, gfas)
    found = find_haplotypes(info, graphs, args.device)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "haplotypes.tsv"), "w") as fh:
        for g in info.store.values():
            for pid in sorted(g.paths):
                fh.write(
                    f"{g.paths[pid]}\t{g.abundances.get(pid, 0.0):.6f}\n"
                )
    for path in found:
        print(path)
    log.info("finished in %.2fs", time.time() - start)
    return 0


def cmd_accuracy(args) -> int:
    from .report.accuracy import evaluate_bam

    stats = evaluate_bam(args.bamFile, args.numReads)
    sys.stdout.write(stats.format())
    if args.indexDir:
        # cluster-membership decomposition of the "incorrectly aligned"
        # bin: needs the graph store for path -> cluster membership
        from .config import Info

        from .report.accuracy import misaligned_breakdown

        info = Info.load(os.path.join(args.indexDir, "groot.gg"))
        bd = misaligned_breakdown(args.bamFile, info.store)
        sys.stdout.write(
            "misaligned breakdown: "
            f"{bd['same_cluster']} same-cluster paralog multimap, "
            f"{bd['cross_cluster']} cross-cluster, "
            f"{bd['mangled_correct']} correct-but-name-mangled, "
            f"{bd['origin_unknown']} origin unknown\n"
        )
    return 0


COMMANDS = {
    "get": cmd_get,
    "index": cmd_index,
    "align": cmd_align,
    "report": cmd_report,
    "haplotype": cmd_haplotype,
    "accuracy": cmd_accuracy,
}

IAMGROOT = r"""
           _____                toots!
          /     \          ..=====..
         | () () |        //  groot \\
          \  ^  /        ||  is here ||
           |||||          \\._____..//
           |||||             |_|_|
  I am Groot. (CUDA edition)
"""


if __name__ == "__main__":
    sys.exit(main())
