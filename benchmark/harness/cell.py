"""One run of one cell: set-up, a warm-up pass, whole passes until the
window's seconds are spent, then the reference and the comparison.

Set-up writes the cell's sample to TMPDIR (or, without one, to the
checkout's `benchmark/.cache/tmp`), builds the configuration's
index if this checkout has none, loads it (`index_load_s`) and runs one
whole pass, so the heap, the pinned buffers and the caches reach their
steady state. The window runs passes back to back; before each the store
is restored and the garbage collector run, outside the pass's clock. The
reference runs after the window, once the device peak has been read and
the program's state freed.
"""

from __future__ import annotations

import gc
import json
import os
import resource
import sys
import time
from pathlib import Path


from . import data, judge, program, reference, trace
from .manifest import Manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "groot_tpu")
KERNELS = {"khf_sketch": "khf_sketch_kernel", "seed_scan": "seed_scan_kernel"}


def loaded_forbidden():
    """Modules loaded in this process whose top-level name is one of
    FORBIDDEN, compared whole (groot_tpu_torch is not groot_tpu)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def say(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def tmp_dir(cache: Path, tmp: str = None) -> str:
    """Where a run writes its sample: `tmp`, else TMPDIR, else the cache."""
    tmp = tmp or os.environ.get("TMPDIR") or str(Path(cache) / "tmp")
    os.makedirs(tmp, exist_ok=True)
    return tmp


def load_program(manifest: Manifest, config: str, cfg: dict, clusters, cache: Path,
                 device: str):
    """The configuration's index, built if this checkout has none, and the
    program with it loaded: (index dir, program, seconds of the load)."""
    idx = program.index_dir(cache, config, cfg, manifest.root)
    if not idx.exists():
        msa = idx.with_name(idx.name + ".msa")
        data.write_msa_dir(clusters, str(msa))
        dt = program.build_index(manifest.root, str(msa), idx, cfg, device)
        say(f"index built in {dt:.3f} s into {idx}")
    prog = program.Program(idx, cfg, device)
    return idx, prog, prog.load()


def run(manifest: Manifest, name: str, seed: int, seconds: float, traced: bool,
        t_start: float, device: str = "cuda", cache: Path = None, tmp: str = None):
    """Returns (result line without `correct`'s checks applied, numbers)."""
    cell = manifest.cell(name)
    cfg = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    cache = Path(cache or manifest.bench / ".cache")
    tmp = tmp_dir(cache, tmp)

    clusters = data.database(cfg)
    reads, names, _origin = data.sample(traffic, clusters, seed, int(cfg["db_seed"]))
    n_reads = len(reads)
    fq = os.path.join(tmp, f"bench-{name}-{os.getpid()}.fq")
    data.write_fastq(reads, names, fq)
    del reads, names, _origin
    try:
        return _run(manifest, cell, cfg, clusters, fq, n_reads, seed, seconds, traced,
                    t_start, device, cache, traffic)
    finally:
        os.unlink(fq)


def _run(manifest, cell, cfg, clusters, fq, n_reads, seed, seconds, traced, t_start,
         device, cache, traffic):
    name = cell["name"]
    idx, prog, index_load_s = load_program(manifest, cell["config"], cfg, clusters, cache,
                                           device)
    prog.restore()
    gc.collect()
    warm = prog.one_pass(fq)
    say(f"warm-up pass: {warm.seconds:.3f} s, stats {warm.stats}")
    del warm

    spans = trace.Spans()
    shapes: dict = {}
    if traced:
        program.instrument(spans, shapes)
    prof = trace.Profile() if traced else None
    setup_s = time.time() - t_start
    outs, digests, weights = [], [], []
    last = None
    gc_s = [0.0]
    gc_t0 = [0]

    def gc_clock(phase, _info):
        if phase == "start":
            gc_t0[0] = time.perf_counter_ns()
        else:
            gc_s[0] += (time.perf_counter_ns() - gc_t0[0]) / 1e9

    gc.callbacks.append(gc_clock)
    if prof is not None:
        prof.__enter__()
    try:
        t_window = time.perf_counter()
        while not outs or time.perf_counter() - t_window < seconds:
            last = None
            prog.restore()
            gc.collect()
            gc_s[0] = 0.0
            out = prog.one_pass(fq)
            out.gc_s = gc_s[0]
            digests.append(judge.digest(out))
            weights.append(out.weights)
            spans.add("pass.align", out.t0, out.t1 - int(out.report_s * 1e9))
            spans.add("pass.report", out.t1 - int(out.report_s * 1e9), out.t1)
            outs.append({k: getattr(out, k) for k in
                         ("t0", "t1", "seconds", "report_s", "stage_times", "user_s",
                          "sys_s", "gc_s", "stats")})
            last = out
    finally:
        gc.callbacks.remove(gc_clock)
        if prof is not None:
            prof.__exit__(None, None, None)
        spans.restore()

    host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    import torch

    on_card = device == "cuda"
    dev_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0)) if on_card else 0,
    }
    reduced = None
    if prof is not None:
        reduced = prof.reduce([(o["t0"], o["t1"]) for o in outs], spans, KERNELS)
        if reduced is not None:
            dev_info["busy_s"] = reduced["busy_s"]
            dev_info["window_s"] = reduced["window_s"]
        del prof
    ctx = {
        "reads": n_reads * len(outs),
        "passes": outs,
        "setup_s": setup_s,
        "host_peak_bytes": host_peak,
        "index_load_s": index_load_s,
        "spans": spans,
        "shapes": shapes,
        "trace": reduced,
        "kind": dev_info["kind"],
    }
    wanted = manifest.per_layer(name) if traced else manifest.end_to_end(name)
    metrics = {}
    for m in wanted:
        v = manifest.reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    forbidden = loaded_forbidden()

    # the program's state goes before the reference runs
    prog.info = None
    prog._store = None
    del prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ix = reference.Index(str(idx))
    faults = reference.check_index(ix, clusters, cfg)
    reads, names, _o = data.sample(traffic, clusters, seed, int(cfg["db_seed"]))
    ref = reference.align(ix, reads, names, float(cfg["t"]), float(cfg["c"]),
                          float(cfg["cov_cutoff"]))
    numbers = judge.compare_pass(last, digests, weights, ref, faults, ix.refs)
    say("passes (s, user s, sys s, gc s, host tail s): " + json.dumps(
        [[round(o[k], 3) for k in ("seconds", "user_s", "sys_s", "gc_s")]
         + [round(o["stage_times"].get("reduce_s", 0.0), 3)] for o in outs]))
    say(f"passes (s): {[round(o['seconds'], 4) for o in outs]}; setup {setup_s:.3f} s; "
        f"reference {time.perf_counter() - t_ref:.3f} s; stats {last.stats}, "
        f"reference stats {ref.stats}")
    result = {
        "correct": judge.verdict(numbers) and not forbidden,
        "attempted": n_reads * len(outs),
        "failed": 0,
        "metrics": metrics,
        "device": dev_info,
    }
    if reduced is not None:
        result["breakdown"] = reduced["breakdown"]
    return result, numbers, forbidden
