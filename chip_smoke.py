#!/usr/bin/env python3
"""Smoke run of groot_tpu_torch (the PyTorch + CUDA port) on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases, any failure exits non-zero:
  1. preflight: torch/CUDA/nvcc/triton versions, the card's name and power
     limit, and the native host runtime (which must load);
  2. build: nvcc compiles groot_tpu_torch/csrc/*.cu for sm_90a;
  3. kernel parity: each kernel bit-equal to its plain PyTorch version on
     the card — the KHF sketch at the main path's batch (B=2048 k31 s20
     L150), at B=4096 (k31 s20 L150 and k51 s30 L100) and on 40 kb contigs,
     also against the native sketcher and the numpy golden; the read-hash
     and seed-scan kernels on the rows of one real batch of phase 4 — each
     timed beside its plain version with CUDA events;
  4. end to end: a synthetic clustered ARG database at the scale of
     arg-annot.90 (583 clusters, ~1,700 alleles, 500-1,500 bp, <= 10%
     divergent) indexed at w150 k31 s20 by `groot_tpu_torch.cli index`, and
     120,000 ARG-dense 150 bp reads aligned by the CLI's `align` on the
     device engine (--device cuda), then by the host `hash` engine; the two
     must agree on stats, node weights, BAM records, pruned paths and the
     report, and every kernel must have launched during the device run;
  5. trace: the device run once more under torch.profiler, for the card's
     busy share of the align wall time and each kernel's device time.
The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches, errors and times.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

try:
    import torch
except ImportError:  # pragma: no cover - no torch, no run
    torch = None

HERE = os.path.dirname(os.path.abspath(__file__))
K, S, W = 31, 20, 150
N_CLUSTERS = 583
N_READS = 120_000


def _say(*a) -> None:
    print(*a, flush=True)


def _check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def _max_abs_err(a: np.ndarray, b: np.ndarray) -> float:
    """Largest |a - b| over the elements, in exact integer arithmetic."""
    bad = np.flatnonzero(a.reshape(-1) != b.reshape(-1))
    if not len(bad):
        return 0.0
    av, bv = a.reshape(-1)[bad].tolist(), b.reshape(-1)[bad].tolist()
    return float(max(abs(int(x) - int(y)) for x, y in zip(av, bv)))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _time_ms(fn, dev, iters: int = 20) -> float:
    """Mean milliseconds per call after warm-up: CUDA events on the card
    (a host clock elsewhere, for rehearsals only)."""
    for _ in range(2):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
def preflight() -> str:
    if torch is None or not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (torch.cuda.is_available() is false)")
    sys.path.insert(0, HERE)
    from groot_tpu.io import native

    from groot_tpu_torch import _build

    _say(f"torch {torch.__version__} cuda {torch.version.cuda}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True)
    _say("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    try:
        from importlib.metadata import version

        _say("triton", version("triton"))
    except Exception as e:  # the port uses no Triton; report what is there
        _say("triton not installed:", e)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    _say(smi)
    t0 = time.time()
    ok = _build.native_runtime()
    _say(f"groot_tpu.io.native.available(): {ok} {native._LIB_PATH} "
         f"({time.time() - t0:.1f}s, a g++ build included when the "
         f"committed library does not load)")
    if not ok:
        raise RuntimeError("the native host runtime did not load")
    return smi


def build() -> float:
    from groot_tpu_torch import _build

    t0 = time.time()
    so = _build.build()
    _build.library()
    dt = time.time() - t0
    _say(f"build: {so.name} in {dt:.1f}s")
    return dt


def sketch_parity(seed: int, dev) -> dict:
    """KHF-sketch kernel vs its plain version (and the host goldens). The
    first shape is the main path's batch; its times go into the summary."""
    from groot_tpu.io import native

    from groot_tpu_torch.ops import nthash
    from groot_tpu_torch.ops.sketch import khf_sketch
    from groot_tpu_torch.pipeline.align_pipeline import DEFAULT_BATCH

    rng = np.random.default_rng(seed)
    err, res = 0.0, []
    shapes = ((31, 20, 150, DEFAULT_BATCH), (31, 20, 150, 4096),
              (51, 30, 100, 4096), (31, 20, 40_000, 64))
    for k, s, L, B in shapes:
        codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
        codes[rng.random((B, L)) < 0.01] = 4
        lens = rng.integers(k - 2, L + 1, size=B).astype(np.int32)
        for i in range(B):
            codes[i, lens[i]:] = 4
        c = torch.from_numpy(codes).to(dev)
        v = torch.from_numpy(lens).to(dev)
        got = khf_sketch(c, v, k, s)
        plain = nthash.khf_sketch_torch(c, v, k, s)
        _sync(dev)
        g = got.cpu().numpy().view(np.uint64)
        checks = {
            "plain": plain.cpu().numpy().view(np.uint64),
            "native": native.sketch(codes, lens, k, s),
            "numpy": nthash.khf_sketch_np_batch(codes, lens, k, s),
        }
        for name, want in checks.items():
            e = _max_abs_err(g, want)
            _check(e == 0.0, f"sketch k{k} s{s} L{L}: kernel != {name}")
        err = max(err, _max_abs_err(g, checks["plain"]))
        ms = _time_ms(lambda: khf_sketch(c, v, k, s), dev)
        pms = _time_ms(lambda: nthash.khf_sketch_torch(c, v, k, s), dev, 5)
        _say(f"khf_sketch k{k} s{s} L{L} B{B}: equal to plain/native/numpy; "
             f"kernel {ms:.4f} ms, plain {pms:.4f} ms")
        res.append((ms, pms))
    ms, pms = res[0]  # the main path's shape
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms}


def make_data(work: str, seed: int) -> str:
    """Synthetic database + ARG-dense reads; returns the FASTQ path."""
    from groot_tpu_torch import synth

    rng = np.random.default_rng(seed)
    t0 = time.time()
    clusters = synth.make_clusters(rng, N_CLUSTERS)
    synth.write_msa_dir(clusters, os.path.join(work, "msa"))
    alleles = synth.alleles_of(clusters)
    reads = synth.sample_reads(rng, alleles, N_READS)
    fq = os.path.join(work, "reads.fq")
    synth.write_fastq(reads, fq)
    _say(f"data: {len(clusters)} clusters, {len(alleles)} alleles, "
         f"{len(reads)} reads of 150 bp ({time.time() - t0:.1f}s)")
    return fq


def build_index(work: str, dev) -> None:
    from groot_tpu_torch import cli
    from groot_tpu_torch.index.lshe import ContainmentIndex

    t0 = time.time()
    rc = cli.main([
        "index", "-m", os.path.join(work, "msa"), "-i", os.path.join(work, "idx"),
        "-w", str(W), "-k", str(K), "-s", str(S),
        "--log", os.path.join(work, "index.log"), "--device", dev.type,
    ])
    _check(rc == 0, "index failed")
    dt = time.time() - t0
    n = len(ContainmentIndex.load(os.path.join(work, "idx", "groot.lshe")).sketches)
    _say(f"index: {n} window sketches in {dt:.2f}s")


def phase_a_parity(work: str, fq: str, dev) -> dict:
    """Read-hash and seed-scan kernels vs their plain versions on the rows
    of the first batch of the end-to-end reads."""
    from groot_tpu.align.batch_host import WindowTables
    from groot_tpu.config import Info

    from groot_tpu_torch.align import device_join as dj
    from groot_tpu_torch.index.lshe import ContainmentIndex
    from groot_tpu_torch.io import bam as bamio
    from groot_tpu_torch.pipeline import align_pipeline as ap

    idx = os.path.join(work, "idx")
    info = Info.load(os.path.join(idx, "groot.gg"))
    index = ContainmentIndex.load(os.path.join(idx, "groot.lshe"))
    info.attach_db(index)
    al = dj.DeviceJoinAligner(
        info.store, bamio.build_references(info.store), device=dev
    )
    tables = al.try_load(index, os.path.join(idx, "groot.align"), K)
    if tables is None:
        tables = WindowTables(index, info.store)
        al.attach_tables(tables, index, K)
    _check(al._dev_ok, "index outside the device cascade envelope")
    batch = next(ap.batch_reads_native([fq], ap.DEFAULT_BATCH))
    kc = (batch.lengths - K + 1).astype(np.int32)
    rows, wins, combo_start = ap._compute_hits(
        info, batch, kc, K, S, 0.99, tables, dev
    )
    st = al.phase_a_rows(batch, rows, wins, combo_start)
    codes, lens, rpow32, rinv32, rows_t, sx = al.phase_a_inputs(batch, st)
    args = (codes, lens, rpow32, rinv32, K, sx["WPH"])
    PH = dj.read_hashes(*args)
    PHp = dj.read_hashes_torch(*args)
    _sync(dev)
    rh_err = max(
        _max_abs_err(a.cpu().numpy(), b.cpu().numpy()) for a, b in zip(PH, PHp)
    )
    _check(rh_err == 0.0, "read_hash kernel != plain")
    kw = dict(D1=sx["D1"], k=K, n_offs=sx["n_offs"])
    out = dj.seed_scan(al._dev, *PH, *rows_t, **kw)
    outp = dj.seed_scan_torch(al._dev, *PH, *rows_t, **kw)
    _sync(dev)
    ss_err = _max_abs_err(out.cpu().numpy(), outp.cpu().numpy())
    _check(ss_err == 0.0, "seed_scan kernel != plain")
    hits = int(((out & 0xFF) < 255).sum())
    rh = {"max_abs_err": rh_err,
          "ms": _time_ms(lambda: dj.read_hashes(*args), dev),
          "plain_ms": _time_ms(lambda: dj.read_hashes_torch(*args), dev, 5)}
    ss = {"max_abs_err": ss_err,
          "ms": _time_ms(lambda: dj.seed_scan(al._dev, *PH, *rows_t, **kw), dev),
          "plain_ms": _time_ms(
              lambda: dj.seed_scan_torch(al._dev, *PH, *rows_t, **kw), dev, 5)}
    _say(f"phase A on one batch: {len(codes)} mapped reads, "
         f"{rows_t.shape[1]} rows ({hits} stage-1 hits), D1 {sx['D1']}; "
         f"read_hash kernel {rh['ms']:.4f} ms plain {rh['plain_ms']:.4f} ms; "
         f"seed_scan kernel {ss['ms']:.4f} ms plain {ss['plain_ms']:.4f} ms")
    return {"read_hash": rh, "seed_scan": ss}


def align_and_report(work: str, fq: str, engine: str, device: str):
    """The CLI's align command, then its report; returns (result, rows,
    seconds)."""
    from groot_tpu_torch import cli

    bam = os.path.join(work, f"{engine}.bam")
    log = os.path.join(work, f"{engine}.log")
    args = cli.build_parser().parse_args([
        "align", "-i", os.path.join(work, "idx"), "-f", fq, "-c", "1",
        "-g", os.path.join(work, f"graphs-{engine}"), "--bamOut", bam,
        "--log", log, "--device", device,
    ])
    cli._setup_logging(log)
    os.environ["GROOT_ENGINE"] = engine
    try:
        t0 = time.time()
        res = cli.align(args)
        dt = time.time() - t0
    finally:
        os.environ.pop("GROOT_ENGINE", None)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["report", "--bamFile", bam, "--log", log])
    _check(rc == 0, "report failed")
    return res, bam, out.getvalue(), dt


def traced_device_run(work: str, fq: str, dev, untraced_s: float) -> None:
    """The device-engine align once more under torch.profiler: the card's
    busy share of the align command's wall time (the union of the device
    intervals of every kernel and copy) and each port kernel's device
    time. Prints "not measured" when the profiler records no device
    activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _res, _bam, _rows, dt = align_and_report(work, fq, "device", dev.type)
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    if not spans:
        _say("trace: device busy share not measured (no device events)")
        return
    busy_us, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy_us += cur_e - cur_s
    per_kernel = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name in ("khf_sketch", "read_hash", "seed_scan"):
            if f"{name}_kernel" in e.name:
                n, us = per_kernel.get(name, (0, 0.0))
                per_kernel[name] = (n + 1, us + e.time_range.elapsed_us())
    _say(f"trace: align {dt:.2f}s under the profiler (untraced {untraced_s:.2f}s); "
         f"device busy {busy_us / 1e6:.4f}s = {100 * busy_us / 1e6 / dt:.3f}% "
         f"of the align wall time over {len(spans)} device events")
    _say("trace: port kernels (launches, device ms):", json.dumps(
        {k: [n, round(us / 1e3, 4)] for k, (n, us) in sorted(per_kernel.items())}))


def _bam_keys(path):
    from groot_tpu_torch.io import bam as bamio

    _refs, recs = bamio.read_bam(path)
    return sorted(
        (r.name, r.ref_id, r.pos, r.flag, r.seq_len, tuple(r.cigar)) for r in recs
    )


def end_to_end(work: str, fq: str, dev) -> dict:
    from groot_tpu_torch import _build

    _build.reset_counts()
    res, dev_bam, dev_rows, dev_s = align_and_report(work, fq, "device", dev.type)
    launches = {name: k.launches for name, k in _build.KERNELS.items()}
    st = res.stats
    _say(f"device run: {st.received} reads, {st.mapped} mapped, "
         f"{st.alignment_count} alignments in {dev_s:.2f}s = "
         f"{st.received / dev_s:.0f} reads/s (align command, setup included)")
    _say("device stage_times:", json.dumps(
        {k: round(v, 4) for k, v in sorted(st.stage_times.items())}))
    _say("launches in the device run:", json.dumps(launches))
    for name, n in launches.items():
        _check(n > 0, f"kernel {name} was not launched on the main path")

    host, host_bam, host_rows, host_s = align_and_report(work, fq, "hash", "cpu")
    _say(f"hash run: {host_s:.2f}s = {host.stats.received / host_s:.0f} reads/s")
    for f in ("received", "mapped", "multimapped", "alignment_count", "total_kmers"):
        a, b = getattr(st, f), getattr(host.stats, f)
        _check(a == b, f"stats.{f}: device {a} != hash {b}")
    np.testing.assert_allclose(res.node_weights, host.node_weights, rtol=1e-6)
    _check(_bam_keys(dev_bam) == _bam_keys(host_bam), "BAM records differ")
    _check(res.kept_paths == host.kept_paths, "pruned paths differ")
    _check(dev_rows == host_rows, "report rows differ")
    _check(st.alignment_count > 0 and dev_rows.strip(), "nothing aligned")
    _say(f"device == hash: stats, {len(res.node_weights)} node weights, "
         f"{st.alignment_count} BAM records, {len(res.kept_paths)} kept paths, "
         f"{len(dev_rows.splitlines())} report rows")
    return launches, dev_s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    smi = preflight()
    dev = torch.device("cuda")
    build()
    kernels = {"khf_sketch": sketch_parity(args.seed, dev)}
    work = tempfile.mkdtemp(prefix=".chip_smoke-", dir=HERE)
    try:
        fq = make_data(work, args.seed)
        build_index(work, dev)
        kernels.update(phase_a_parity(work, fq, dev))
        launches, dev_s = end_to_end(work, fq, dev)
        traced_device_run(work, fq, dev, dev_s)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    from groot_tpu_torch import _build

    rows = []
    for name, k in _build.KERNELS.items():
        m = kernels[name]
        rows.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"],
        })
    _say(smi)
    _say(json.dumps({"kernels": rows}))
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
