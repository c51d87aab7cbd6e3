"""N-process run of the sharded align step under torch.distributed.

    python -m groot_tpu_torch.parallel.nproc --nproc N \\
        --backend {gloo,nccl} --device {cpu,cuda} \\
        [--index DIR --reads FQ] [--seed 0] [--timeout 300]

Counterpart of tools/nproc_dryrun.py. The parent process spawns N worker
processes, which start one process group through a file:// store in a
temporary directory (no TCP port, so runs in parallel never collide) with
an explicit timeout. Each rank builds (from synth.tiny_clusters, seeded) or
loads (--index, --reads) the same index and reads, and for every batch
(2,048 reads; 128 of the 301 seeded ones) runs
make_sharded_align_step(group=...) at t = 0.99 on its contiguous share of
the batch (padded to a multiple of N): node weights, graph k-mers and
dropped pairs are merged with all_reduce(SUM). Rank 0 sums the merged
tallies over the batches in float64 and compares them with the
single-process step over the whole batches and with the host replay (the
native host query plus WeightAccumulator.add_pairs): node weights at rtol
2e-5 (f32 sums in another order), graph k-mers equal, no dropped pairs.

The last line printed is `OK ...` or `FAIL ...`; the exit code is 0 only
for OK. A worker that dies, or a run past --timeout, is a FAIL.
"""

from __future__ import annotations

import argparse
import datetime
import multiprocessing as mp
import os
import sys
import tempfile
import time
from typing import List, Tuple

import numpy as np

from .._build import resolve_device

RTOL = 2e-5
THRESHOLD = 0.99  # groot's default: the full-equality mode, no per-band cap
N_TINY_READS = 301  # three batches of 128, the last one odd


def _tiny_inputs(work: str, seed: int, n_reads: int):
    """The seeded tiny database, indexed on the CPU, and reads from it."""
    from ..config import Info

    from .. import synth
    from ..ops.nthash import ASCII_TO_CODE
    from ..pipeline.index_pipeline import build_graphs, find_msa_files, sketch_and_index

    msa = os.path.join(work, "msa")
    clusters = synth.tiny_clusters(seed + 42)
    synth.write_msa_dir(clusters, msa)
    info = Info(kmer_size=31, sketch_size=20, window_size=100)
    index = sketch_and_index(info, build_graphs(info, find_msa_files(msa)), "cpu")
    index.prepare()
    reads, _which, _starts = synth.sample_reads(
        np.random.default_rng(seed), synth.alleles_of(clusters), n_reads,
        lengths=(80, 100, 120), n_frac=0.05,
    )
    L = 128
    codes = np.full((len(reads), L), 4, np.uint8)
    lens = np.array([len(r) for r in reads], np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = ASCII_TO_CODE[np.frombuffer(r, np.uint8)]
    return info, index, codes, lens


def _batches(args, work: str) -> Tuple[object, object, List[Tuple[np.ndarray, np.ndarray]]]:
    """(info, index, [(codes, lengths), ...]) — the same on every rank."""
    if args.index:
        from ..config import Info

        from ..index.lshe import ContainmentIndex
        from ..pipeline.align_pipeline import DEFAULT_BATCH, batch_reads_native

        info = Info.load(os.path.join(args.index, "groot.gg"))
        index = ContainmentIndex.load(os.path.join(args.index, "groot.lshe"))
        info.attach_db(index)
        batches = [
            (np.array(b.codes), np.asarray(b.lengths, np.int32))
            for b in batch_reads_native([args.reads], DEFAULT_BATCH)
        ]
        return info, index, batches
    info, index, codes, lens = _tiny_inputs(work, args.seed, N_TINY_READS)
    batches = [(codes[i : i + 128], lens[i : i + 128])
               for i in range(0, len(codes), 128)]
    return info, index, batches


def _host_replay(info, index, batches, threshold: float):
    """Node weights and graph k-mers (by graph id) of the native host
    query's hits, weighted by WeightAccumulator.add_pairs (float64)."""
    from ..align.batch_host import WeightAccumulator, WindowTables
    from ..io import native

    from ..ops import nthash

    k, s = info.kmer_size, index.sketch_size
    tables = WindowTables(index, info.store)
    acc = WeightAccumulator(tables)
    for codes, lens in batches:
        kc = (lens - k + 1).astype(np.int32)
        q64 = native.sketch(codes, lens, k, s)
        if q64 is None:
            q64 = nthash.khf_sketch_np_batch(codes, lens, k, s)
        rows, wins = index.query_batch_np(q64, kc, threshold, device="cpu")
        acc.add_pairs(wins, kc[rows].astype(np.float64))
    graph_k = np.zeros(len(info.store))  # graph_kt is over the indexed graphs
    graph_k[tables.graph_ids] = acc.graph_kt
    return acc.node_w, graph_k


def _worker(rank: int, n: int, init: str, args, out_path: str) -> None:
    import torch
    import torch.distributed as dist

    from .._build import native_runtime
    from .device_index import DeviceIndex, make_sharded_align_step
    from .mesh import pad_batch_for_mesh

    native_runtime()
    dev = torch.device("cpu")
    if args.device == "cuda":  # one card per rank where there are enough
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        args.backend, init_method=init, world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=args.timeout),
    )
    try:
        with tempfile.TemporaryDirectory() as work:
            info, index, batches = _batches(args, work)
            di = DeviceIndex.build(index, info.store, info.kmer_size,
                                   THRESHOLD, device=dev)
            step = make_sharded_align_step(di, THRESHOLD, group=dist.group.WORLD)
            nw = np.zeros(di.num_nodes)
            gk = np.zeros(di.num_graphs)
            dropped = 0
            t0 = time.time()
            for codes, lens in batches:
                codes_p, lens_p, _B = pad_batch_for_mesh(codes, lens, n)
                per = len(codes_p) // n
                part = slice(rank * per, (rank + 1) * per)
                _w, _c, bnw, bgk, _m, bd = step(codes_p[part], lens_p[part])
                nw += bnw.cpu().numpy()
                gk += bgk.cpu().numpy()
                dropped += int(bd)
            dt = time.time() - t0
            if rank == 0:
                line = _compare(info, index, di, batches, nw, gk, dropped, args, n, dt)
                with open(out_path, "w") as fh:
                    fh.write(line + "\n")
    finally:
        dist.destroy_process_group()


def _compare(info, index, di, batches, nw, gk, dropped, args, n, dt) -> str:
    """Rank 0: the merged tallies against the single-process step and the
    host replay."""
    from .device_index import make_sharded_align_step

    single = make_sharded_align_step(di, THRESHOLD)
    snw = np.zeros(di.num_nodes)
    sgk = np.zeros(di.num_graphs)
    sdrop = 0
    for codes, lens in batches:
        _w, _c, bnw, bgk, _m, bd = single(codes, lens)
        snw += bnw.cpu().numpy()
        sgk += bgk.cpu().numpy()
        sdrop += int(bd)
    hnw, hgk = _host_replay(info, index, batches, THRESHOLD)
    reads = sum(len(c) for c, _l in batches)
    bad = []
    for name, a, b in (("single", snw, sgk), ("host", hnw, hgk)):
        if not np.allclose(nw, a, rtol=RTOL, atol=0):
            bad.append(f"node_weights!={name} (max |d| {np.abs(nw - a).max():.6g})")
        if not np.array_equal(gk, b):
            bad.append(f"graph_kmers!={name} (max |d| {np.abs(gk - b).max():.6g})")
    if dropped or sdrop:
        bad.append(f"dropped pairs {dropped}/{sdrop}")
    if not nw.sum() > 0:
        bad.append("no node weight")
    what = (f"procs={n} backend={args.backend} device={args.device} "
            f"batches={len(batches)} reads={reads} node_mass={nw.sum():.6f} "
            f"graph_kmers={gk.sum():.0f} step_s={dt:.3f}")
    return ("FAIL " + "; ".join(bad) + " " + what) if bad else "OK " + what


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--index", help="index directory (groot.gg, groot.lshe)")
    ap.add_argument("--reads", help="FASTQ (with --index)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    if bool(args.index) != bool(args.reads):
        ap.error("--index and --reads go together")
    if args.nproc < 1:
        ap.error("--nproc must be >= 1")
    if args.backend == "nccl" and args.device != "cuda":
        ap.error("--backend nccl needs --device cuda")
    resolve_device(args.device)  # "cuda" without a card raises here
    # the workers' target by its module path (not __main__ under -m)
    from groot_tpu_torch.parallel.nproc import _worker as target

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        out = os.path.join(tmp, "result")
        procs = [
            ctx.Process(target=target, args=(r, args.nproc, init, args, out))
            for r in range(args.nproc)
        ]
        for p in procs:
            p.start()
        deadline = time.time() + args.timeout
        for p in procs:
            p.join(max(deadline - time.time(), 0.0))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
        for p in procs:
            p.join(10)
        line = ""
        if os.path.exists(out):
            with open(out) as fh:
                line = fh.read().strip()
    if alive:
        line = f"FAIL timeout after {args.timeout:.0f}s ({len(alive)} ranks alive)"
    elif any(p.exitcode != 0 for p in procs):
        codes = [p.exitcode for p in procs]
        line = f"FAIL a worker died (exit codes {codes}) {line}".rstrip()
    elif not line:
        line = "FAIL rank 0 wrote no result"
    print(line, flush=True)
    return 0 if line.startswith("OK") else 1


if __name__ == "__main__":
    sys.exit(main())
