#!/usr/bin/env python3
"""Smoke run of groot_tpu_torch (the PyTorch + CUDA port) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--baseline-csrc DIR]

Phases, any failure exits non-zero:
  1. preflight: torch/CUDA/nvcc/triton versions, the card's name and power
     limit, and the native host runtime (which must load);
  2. build: nvcc compiles groot_tpu_torch/csrc/*.cu for sm_90a;
  3. sketch parity: the KHF-sketch kernel bit-equal to its plain PyTorch
     version, the native sketcher and the numpy golden at the main path's
     batch (B=2048 k31 s20 L150), at B=4096 (k31 s20 L150 and k51 s30 L100)
     and on 40 kb contigs, timed beside its plain version with CUDA events;
  4. index: a synthetic clustered ARG database at the scale of arg-annot.90
     (583 clusters, ~1,700 alleles, 500-1,500 bp, <= 10% divergent) indexed
     at w150 k31 s20 by `groot_tpu_torch.cli index --device cuda` (the
     window-sketch kernel) and again on the CPU (the native runtime): the
     two indexes must be equal array for array; then the kernel bit-equal
     to its plain version and to the native runtime on the database's path
     rows, and timed;
  5. align: 120,000 ARG-dense 150 bp reads (named as bbmap's randomreads
     names them) aligned by the CLI's `align` on the device engine (--device
     cuda), then by the host `hash` engine; the two must agree on stats,
     node weights, BAM records, pruned paths and the report. The read-hash
     and seed-scan kernels are held against their plain versions on the
     rows of one real batch, and timed;
  5b. cascade: the same align on the `cascade` engine (GROOT_ENGINE=cascade,
     --device cuda: the pair-cascade kernel) must equal the hash run of
     phase 5 in the same five ways; then the kernel is held against its
     plain version on the inputs of the largest chunk of the first batch,
     and both are timed;
  5c. host: the same align on the `host` engine (GROOT_ENGINE=host,
     --device cuda: one match-bits launch a read batch for every graph it
     touches) must equal the hash run of phase 5 in the same five ways,
     with at most one launch a batch, and the host clock of the match
     volumes, the cascade and the rest is printed; then ONE launch on the
     whole first batch is held against the plain version, bit for bit, at
     every graph, and against the kernel's loop walked in torch; the
     launch, the plain version and cuDNN's conv1d on the same one-hots
     summed over the batch's graphs (the library call) are timed;
  6. haplotype: `haplotype --device cuda` (the EM kernel) and `--device
     cpu` on the device run's graphs call the same alleles; the kernel
     gives its plain version's iteration counts (on the card and on the
     CPU) and alphas within 1e-5 relative, and is timed; the batch's shapes
     and the slowest graph's rounds and microseconds a round are printed;
  7. accuracy: the `accuracy` command scores the device run's BAM;
  8. data plane: the fused align step (parallel.device_index: KHF-sketch,
     LSH-query and weight-scatter kernels) over all the reads in batches of
     2,048 on a DeviceIndex of phase 4's index, at t = 0.99 (the
     full-equality mode: tallies and each read's hits equal the host
     replay) and t = 0.97 (the banded mode, at most 24 windows per band:
     tallies equal the host replay of the step's own hits, and the host
     hits the cap drops are counted); on the first batch the LSH-query and
     weight-scatter kernels against their plain versions, timed; the
     GROOT_DEVICE_QUERY=1 route of the index query against the plain
     device query; the sharded step over [cuda:0, cuda:0] against the
     unsharded one;
  9. processes: `python -m groot_tpu_torch.parallel.nproc` on phase 4's
     index and reads, with 2 gloo ranks and with 1 NCCL rank on the card
     (NCCL refuses two ranks on one card), each must print OK;
  10. trace: index, align (device, cascade and host engines), haplotype and the
     data-plane step on the card once more under torch.profiler, for the
     card's busy share of each run's wall time and each kernel's device
     time; each kernel's traced launches beside its wrapper's count for the
     same run, where a launch the trace lacks must be one of the kernel
     records the profiler lost (a runtime launch call with no record);
  11. the main path at sketch size 128 (past the 64 slots a khf_sketch warp
     keeps in registers): phase 4's database indexed at w150 k31 s128 by
     `index --device cuda` and by the native CPU route (the two indexes
     must be equal), the 120,000 reads aligned by the device, cascade and
     hash engines, the host engine on the first 20,000 (with a hash run on
     the same reads), each equal to its hash run on the five counts, the
     device run once more under torch.profiler (the card's busy share, as
     phase 10), and the data-plane step at t = 0.97, each path's kernels
     counted from 0 before it; the device and hash runs here and in phase
     5 print the host clock of their index load and LSH queries;
  12. routes: each kernel route that a size past the shared memory takes
     (khf_sketch at s = 65, 128 and 256; lsh_query at s = 128 and at
     C = 6,144, its global route; window_sketch at s = 1,024, in slot
     groups; match_bits with 100 kb and 200 kb reads among 150 bp reads,
     on the shared route and with every block on the global route;
     em_batched at E = 30,000, seeds 1-3) held against its plain version
     (bit for bit; EM: iterations equal, alphas within 1e-5 of max(1,
     |alpha|)) and timed; the kernels line carries them under `routes`.
With --baseline-csrc DIR (an earlier groot_tpu_torch/csrc, e.g. written
out with git show), DIR's khf_sketch, read_hash, seed_scan, window_sketch,
em_batched, lsh_query and match_bits kernels are built into their own
library and timed beside this version's at the same inputs (match_bits
with the earlier 8-column segment table and work table, lsh_query and
em_batched without the scratch argument, window_sketch without the slot
group; equal outputs required; for
em_batched equal iteration counts and alphas within 1e-5 of max(1, |alpha|),
as summation orders may differ; for lsh_query contain within 1 ulp;
`baseline_ms`, `baseline_device_ms`, and for lsh_query at t = 0.97 the
banded mode's `banded_timed_device_ms`, `banded_baseline_device_ms`).
Every kernel must launch in the run of its command or path (4, 5, 5b, 5c, 6,
8 and 11), counted from 0 just before it. The last line is {"ok": true, "device":
{...}}; the line before it lists the kernels with their launches, errors,
times (`ms`: CUDA events over back-to-back calls, the Python wrapper
included; `device_ms`: the device time a launch in phase 10's traces, all
the entry point's device functions summed; `timed_device_ms`: the same at
the inputs `ms` is timed on, for every kernel), the least time the card
could take for the same work (`bound_ms`: the larger of the bytes the
function must move over 3.35 TB/s and its operations over 67 T op/s, the
H100's non-tensor rate; `bound_by` says which) and, where one PyTorch call
computes the same function, that call's time (`library_ms`, else null).
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


def _ulps(a, b) -> int:
    """Largest distance in units in the last place between two float32
    tensors (NaN against NaN counts 0)."""
    ia = a.view(torch.int32).long()
    ib = b.view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    d = (ia - ib).abs()
    d[torch.isnan(a) & torch.isnan(b)] = 0
    return int(d.max()) if d.numel() else 0


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


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores


def _bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take for work that moves `nbytes` and
    does `ops` scalar operations (each counted from this run's inputs)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "ops": int(ops)}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
def preflight() -> str:
    if torch is None or not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (torch.cuda.is_available() is false)")
    sys.path.insert(0, HERE)
    from groot_tpu_torch.io import native

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
    _say(f"io.native.available(): {ok} {native._lib._name if ok else None} "
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


def sketch_parity(seed: int, dev, base=None) -> dict:
    """KHF-sketch kernel vs its plain version (and the host goldens). The
    first shape is the main path's batch; its times go into the summary.
    With `base` (a _Baseline), the earlier kernel is timed beside it."""
    from groot_tpu_torch.io import native

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
        m = {"ms": _time_ms(lambda: khf_sketch(c, v, k, s), dev),
             "plain_ms": _time_ms(lambda: nthash.khf_sketch_torch(c, v, k, s), dev, 5),
             "timed_device_ms": _device_ms(lambda: khf_sketch(c, v, k, s), "khf_sketch")
             if dev.type == "cuda" else None}
        if base is not None:
            m.update(base.timed("khf_sketch", lambda: khf_sketch(c, v, k, s),
                                got, dev))
        _say(f"khf_sketch k{k} s{s} L{L} B{B}: equal to plain/native/numpy; "
             + _times_text(m))
        # bytes: the reads' bases (not the padding) and lengths in, the
        # sketches out; ops: per k-mer the canonical rolling hash (~8) and
        # s multiplicative slots (~4 each)
        n_kmer = int(np.clip(lens.astype(np.int64) - k + 1, 0, None).sum())
        res.append({**m, **_bound(int(lens.sum()) + lens.nbytes + B * s * 8,
                                  n_kmer * (8 + 4 * s))})
    return {"max_abs_err": err, **res[0]}  # the main path's shape


def _times_text(m: dict) -> str:
    """The times of a kernel's metrics dict, as one phrase."""
    text = (f"kernel {m['ms']:.4f} ms (device {m.get('timed_device_ms')} ms), "
            f"plain {m['plain_ms']:.4f} ms")
    if "baseline_ms" in m:
        text += (f"; the baseline kernel {m['baseline_ms']:.4f} ms (device "
                 f"{m['baseline_device_ms']} ms), agreeing with this one")
    return text


class _Baseline:
    """An earlier version of the kernels (its csrc directory, built into its
    own library), timed beside this version's at the same inputs in one
    run. A kernel whose C signature is unchanged runs through this
    version's wrapper with the earlier entry point swapped in; one whose
    signature changed has its earlier wrapper here (`window_sketch`).
    Launches made here are not part of any main-path count."""

    def __init__(self, csrc: str):
        import ctypes
        from pathlib import Path

        from groot_tpu_torch import _build

        src = Path(csrc).resolve()
        t0 = time.time()
        self.lib = ctypes.CDLL(str(_build.build(src, src / "_build")))
        # before groot_smem_optin came in, lsh_query and em_batched took no
        # scratch pointer (their last argument before the stream)
        self.no_scratch = not hasattr(self.lib, "groot_smem_optin")
        _say(f"baseline kernels from {csrc}: built in {time.time() - t0:.1f}s")

    # the earlier C signatures, device functions and wrappers of kernels
    # redesigned since: window_sketch took row offsets, a window scratch,
    # flags and tile counts, and ran three device functions; match_bits
    # took an 8-column segment table, one work table, the most plane words
    # and the most pairs a block (_earlier_match_layout)
    _ARGTYPES = {"window_sketch": ("P",) * 3 + ("I",) * 6 + ("I64",) + ("P",) * 7,
                 "match_bits": ("P",) * 5 + ("I",) + ("P",) * 4 + ("I",) * 4 + ("P",)}
    _FUNCS = {"window_sketch": ("window_sketch_kernel", "window_scan_kernel",
                                "window_compact_kernel")}
    # an argument this version's C signature added (its position) and the
    # entry point that came in with it: lsh_query's and em_batched's
    # scratch, window_sketch's slot group
    _ADDED = {"lsh_query": (17, "groot_smem_optin"),
              "em_batched": (21, "groot_smem_optin"),
              "window_sketch": (10, "groot_window_slot_group")}

    def earlier_signature(self, name: str) -> bool:
        """Whether the earlier library's entry point of `name` has the C
        signature in _ARGTYPES rather than this version's: window_sketch's
        changed where groot_window_tile_width came in, match_bits' where
        groot_smem_optin did."""
        if name == "window_sketch":
            return not hasattr(self.lib, "groot_window_tile_width")
        if name == "match_bits":
            return self.no_scratch
        return False

    def _entry(self, name: str, types=None):
        import ctypes

        from groot_tpu_torch import _build

        kern = _build.KERNELS[name]
        fn = getattr(self.lib, kern.symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(types or kern.argtypes) + [ctypes.c_void_p]
        return fn

    @contextlib.contextmanager
    def _swapped(self, name: str):
        """This version's wrapper of `name` launching the earlier kernel
        (an argument it did not take yet left out: _ADDED)."""
        from groot_tpu_torch import _build

        kern = _build.KERNELS[name]
        i, marker = self._ADDED.get(name, (None, None))
        if marker is not None and not hasattr(self.lib, marker):
            entry = self._entry(name, kern.argtypes[:i] + kern.argtypes[i + 1:])

            def fn(*a):  # a[-1] is the stream
                return entry(*a[:i], *a[i + 1:])
        else:
            fn = self._entry(name)
        saved, kern._fn = kern._fn, fn
        try:
            yield
        finally:
            kern._fn = saved

    def window_sketch(self, codes, lens, k: int, s: int, w: int):
        """The earlier window kernel (1,024-window tiles, a slot-major
        scratch of every window, then a compaction), with its wrapper."""
        from groot_tpu_torch import _build

        dev = codes.device
        R, L = codes.shape
        nw_row = (lens.long() - w + 1).clamp(min=0)
        cap = int(nw_row.sum())
        row_base = torch.cumsum(nw_row, 0) - nw_row
        n_tiles = -(-int(nw_row.max()) // 1024)
        sk_scratch = torch.empty((s, cap), dtype=torch.int64, device=dev)
        flags = torch.empty(cap, dtype=torch.uint8, device=dev)
        tile_cnt = torch.empty(R * n_tiles, dtype=torch.int32, device=dev)
        tile_off = torch.empty(R * n_tiles + 1, dtype=torch.int64, device=dev)
        out_row = torch.empty(cap, dtype=torch.int32, device=dev)
        out_col = torch.empty(cap, dtype=torch.int32, device=dev)
        out_sk = torch.empty((cap, s), dtype=torch.int64, device=dev)
        fn = self._entry("window_sketch",
                         [getattr(_build, t) for t in self._ARGTYPES["window_sketch"]])
        err = fn(codes.data_ptr(), lens.data_ptr(), row_base.data_ptr(), R, L, k,
                 s, w, n_tiles, cap,
                 *(t.data_ptr() for t in (sk_scratch, flags, tile_cnt, tile_off,
                                          out_row, out_col, out_sk)),
                 torch.cuda.current_stream(dev).cuda_stream)
        _check(err == 0, f"baseline window_sketch launch failed ({err})")
        M = int(tile_off[-1])
        row_off = tile_off[::n_tiles]
        return out_row[:M], out_col[:M], out_sk[:M], row_off[1:] - row_off[:-1]

    def match_bits(self, args, got, off, dev) -> dict:
        """The earlier match-bits kernel (before slot-sized staging: an
        8-column segment table, every block staging Lr bases a code row)
        on this version's batch arguments `args` (as match_bits_batch
        takes them), its layout made by _earlier_match_layout: its bits must
        equal this version's launch (`got`); its CUDA-event ms and device
        ms."""
        from groot_tpu_torch import _build
        from groot_tpu_torch.align import aligner

        entry = self._entry("match_bits", [getattr(_build, t)
                                           for t in self._ARGTYPES["match_bits"]])
        rows, row_off, row_len, reads, read_len, pairs, segs = args
        Lr = reads.shape[1]
        seg_tab, work, nws, pg_max = _earlier_match_layout(
            np.asarray(segs, np.int64), 6, Lr, aligner.ITEMS_PER_BLOCK,
            aligner.MAX_BLOCK_WORDS)
        dargs = [a.to(dev) if isinstance(a, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (row_off, row_len, reads, read_len, pairs, seg_tab,
                           off[:-1], work)]

        def fn():
            out = torch.empty(int(off[-1]), dtype=torch.int32, device=dev)
            err = entry(rows.data_ptr(), *(a.data_ptr() for a in dargs[:4]), Lr,
                        *(a.data_ptr() for a in dargs[4:]), len(work), 6, nws,
                        pg_max, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
            _check(err == 0, f"baseline match_bits launch failed ({err})")
            return out

        _check(torch.equal(fn(), got), "baseline match_bits != this version's kernel")
        return {"baseline_ms": _time_ms(fn, dev),
                "baseline_device_ms": _device_ms(fn, "match_bits")}

    def timed(self, name: str, fn, want, dev, same=None) -> dict:
        """`fn` calls this version's wrapper of kernel `name` (or, where the
        earlier C signature differs, the earlier wrapper here); run with the earlier
        kernel its outputs must equal `want` (this version's), or pass
        `same(got, want)` where summation orders may differ; then its
        CUDA-event and device times at the same inputs."""
        earlier = self.earlier_signature(name)
        if not earlier:
            plain_fn = fn

            def fn():
                with self._swapped(name):
                    return plain_fn()

        got = fn()
        _sync(dev)
        if same is None:
            pairs = zip(got, want) if isinstance(got, tuple) else ((got, want),)
            ok = all(torch.equal(a, b) for a, b in pairs)
        else:
            ok = same(got, want)
        _check(ok, f"baseline {name} != this version's kernel")
        return {"baseline_ms": _time_ms(fn, dev),
                "baseline_device_ms": _device_ms(
                    fn, name, self._FUNCS.get(name) if earlier else None)}


def _earlier_match_layout(segs, nvar: int, Lr: int, items: int, max_words: int):
    """The earlier match-bits kernel's launch layout (its work_table, as it
    was before the blocks staged a segment's own bases): the segment table
    int32 [S, 8], the work table, the most plane words a block reads (its
    words + ceil(Lr/32)) and the most pairs a block stages."""
    pair0, n, row0, n_rows, W = segs.T
    W32 = -(-W // 32)
    n_chunks = -(-W32 // max_words)
    WC = -(-W32 // np.maximum(n_chunks, 1))
    PG = np.maximum(np.minimum(items // (nvar * np.maximum(WC, 1)),
                               32 * 1024 // ((2 if nvar == 6 else 1) * Lr)), 1)
    n_groups = -(-n // PG)
    PG = -(-n // np.maximum(n_groups, 1))
    per = n_rows * n_groups * n_chunks
    seg = np.repeat(np.arange(len(segs)), per)
    local = np.arange(len(seg)) - np.repeat(np.cumsum(per) - per, per)
    chunk = local % n_chunks[seg]
    t = local // n_chunks[seg]
    work = np.stack([seg, t // n_groups[seg], t % n_groups[seg] * PG[seg],
                     chunk * WC[seg]], 1).astype(np.int32)
    seg_tab = np.stack([pair0, n, row0, n_rows, W, W32, PG, WC], 1).astype(np.int32)
    live = per > 0
    nws = int(WC[live].max()) + -(-Lr // 32) if live.any() else 1
    return seg_tab, work, nws, int(PG[live].max()) if live.any() else 1


S128_HOST_READS = 20_000  # the host engine's subset at s = 128


def s128_phase(work: str, fq: str, dev):
    """Phase 11: the main path at sketch size 128 (khf_sketch's slot
    groups; the query and the data plane past 64 slots): phase 4's
    database indexed at w150 k31 s128 by `index --device cuda` and again
    natively on the CPU (the two must be equal), the reads aligned by the
    device engine (once more under the profiler, for the card's busy
    share), the hash and cascade engines, and by the host
    engine and the hash engine on the first S128_HOST_READS reads (the
    host engine takes ~70 s for all 120,000 at s = 128, more than this
    phase may add to the run), each equal to its hash run on the five
    counts, the data-plane step at t = 0.97. Returns ({kernel: launches in
    its path's run}, the data plane's {kernel: metrics})."""
    _say("phase 11: the main path at s = 128")
    launches = build_index(work, dev, "idx128", 128)
    e2e, hash_run = end_to_end(work, fq, dev, "idx128")
    launches.update(e2e)
    _trace_run("align s=128", lambda: align_and_report(work, fq, "device", dev.type,
                                                       "idx128", "device-traced128"))
    launches.update(cascade_phase(work, fq, dev, hash_run, "idx128"))
    sub = os.path.join(work, "reads-host128.fq")
    with open(fq) as src, open(sub, "w") as dst:
        for _ in range(4 * S128_HOST_READS):
            dst.write(src.readline())
    host_sub = align_and_report(work, sub, "hash", "cpu", "idx128", "hash-sub128")
    launches.update(host_phase(work, sub, dev, (host_sub[0], host_sub[1], host_sub[2]),
                               "idx128"))
    plane_launches, plane_metrics, _fn = data_plane(work, fq, dev, idx="idx128",
                                                    thresholds=(0.97,))
    launches.update(plane_launches)
    return launches, plane_metrics


def _route(name: str, fn, plain_fn, same, dev, kernel: str, bound: dict,
           iters: int = 5, funcs=None) -> dict:
    """One kernel route against its plain version: `same(got, want)` must
    hold; the largest gap to it, absolute and relative to max(1, |plain|);
    the kernel's CUDA-event and device ms (its device functions `funcs`, by
    default KERNEL_FUNCS[kernel]), the plain version's ms."""
    got, want = fn(), plain_fn()
    _sync(dev)
    _check(same(got, want), f"{kernel} {name}: kernel != plain")
    pairs = list(zip(got, want) if isinstance(got, tuple) else ((got, want),))
    gaps = [(a.double() - b.double()).abs().nan_to_num(0.0) for a, b in pairs]
    err = max(float(g.max()) if g.numel() else 0.0 for g in gaps)
    rel = max(float((g / b.double().abs().clamp(min=1.0)).max()) if g.numel() else 0.0
              for g, (_a, b) in zip(gaps, pairs))
    m = {"route": name, "max_abs_err": err, "max_rel_err": rel,
         "ms": _time_ms(fn, dev, iters),
         "plain_ms": _time_ms(plain_fn, dev, 1),
         "device_ms": (_device_ms(fn, kernel, funcs, iters=iters)
                       if dev.type == "cuda" else None),
         "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}
    _say(f"{kernel} {name}: equal to plain (largest gap {err:.6g}, {rel:.3g} of "
         f"max(1, |plain|)); kernel {m['ms']:.4f} ms (device "
         f"{m['device_ms']} ms), plain {m['plain_ms']:.4f} ms, bound "
         f"{bound['bound_ms']:.6f} ms ({bound['bound_by']})")
    return m


def _lsh_route_case(rng, N: int, s: int, B: int = 2048):
    """Window sketches over a 4-value alphabet (busy buckets: many
    candidates a band) with their K = 1 band table, and B queries: copies
    of windows with some slots changed, k-mer counts 1..200."""
    from groot_tpu_torch.index import lshe

    sk = rng.integers(1, 5, size=(N, s)).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    sig = lshe._mix_bands_np(sk, 1)
    order = np.argsort(sig, axis=0, kind="stable")
    sigs = np.take_along_axis(sig, order, axis=0).T.copy()
    q = sk[rng.integers(0, N, size=B)].copy()
    flip = rng.random(q.shape) < rng.random((B, 1)) * 0.3
    q[flip] = rng.integers(1, 1 << 62, size=int(flip.sum())).astype(np.uint64)
    kc = rng.integers(1, 201, size=B).astype(np.int32)
    return q, kc, sk, sigs, order.T.astype(np.int32).copy()


def routes_phase(work: str, dev) -> dict:
    """Phase 12: each kernel route that a size past the shared memory
    takes, against its plain version, timed. Returns {kernel: [route
    metrics]}."""
    from groot_tpu_torch import synth
    from groot_tpu_torch.align import aligner
    from groot_tpu_torch.config import Info
    from groot_tpu_torch.em import em
    from groot_tpu_torch.graph.pack import pack_graph_paths
    from groot_tpu_torch.index import lshe, window
    from groot_tpu_torch.io import native
    from groot_tpu_torch.ops import nthash
    from groot_tpu_torch.ops.sketch import khf_sketch
    from groot_tpu_torch.pipeline.index_pipeline import build_graphs, find_msa_files

    _say("phase 12: kernel routes past the shared memory")
    rng = np.random.default_rng(12)
    routes = {}
    eq = lambda a, b: torch.equal(a, b)  # noqa: E731

    # khf_sketch: more than 64 slots, in groups of at most 64
    B, L = 2048, 150
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    lens = rng.integers(K - 2, L + 1, size=B).astype(np.int32)
    c, v = torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(dev)
    n_kmer = int(np.clip(lens.astype(np.int64) - K + 1, 0, None).sum())
    routes["khf_sketch"] = [
        _route(f"s={s} (groups of <= 64)", lambda s=s: khf_sketch(c, v, K, s),
               lambda s=s: nthash.khf_sketch_torch(c, v, K, s), eq, dev, "khf_sketch",
               _bound(int(lens.sum()) + lens.nbytes + B * s * 8, n_kmer * (8 + 4 * s)))
        for s in (65, 128, 256)]

    # lsh_query: s = 128 (shared route, C = 3,072) and s = 256 at K = 1
    # (C = 6,144: the global route)
    routes["lsh_query"] = []
    for s in (128, 256):
        q, kc, sk, sigs, idx = _lsh_route_case(rng, 6000, s)
        args = [torch.from_numpy(x).to(dev) for x in (
            q.view(np.int64), kc, sk.view(np.int64), sigs.view(np.int32), idx)]
        kw = dict(K=1, M=lshe.MAX_PER_BAND, domain_size=120, threshold=0.97)
        C = s * lshe.MAX_PER_BAND
        glob = (dev.type == "cuda"
                and lshe.query_scratch_bytes(B, s, s, lshe.MAX_PER_BAND, dev) > 0)
        # as phase 8 counts it: sketches and counts in, ids and
        # containments out, one lower-bound search a band, each real
        # candidate's id and sketch row once; ops: the band mix, the
        # searches, one compare a slot of a real candidate
        n_cand = _n_candidates(*args, **kw)
        search = s * max(len(sk), 2).bit_length()
        bound = _bound(_nbytes(args[0], args[1]) + 8 * B * C + 4 * B * search
                       + n_cand * (4 + 8 * s), B * (8 * s + search) + n_cand * s)
        routes["lsh_query"].append(_route(
            f"s={s} K=1 C={C} ({'global' if glob else 'shared'} route)",
            lambda: lshe.query_device(*args, **kw),
            lambda: lshe.query_device_torch(*args, **kw),
            lambda a, b: torch.equal(a[0], b[0]) and _ulps(a[1], b[1]) <= 1,
            dev, "lsh_query", bound))

    # window_sketch: s = 1,024 on 200 of the database's path rows, in
    # slot groups
    info = Info(kmer_size=K, sketch_size=1024, window_size=W)
    graphs = build_graphs(info, find_msa_files(os.path.join(work, "msa")))
    packs = [pack_graph_paths(g) for g in graphs if not g.masked][:80]
    _rows, wcodes, wlens = window.path_rows(packs)
    wcodes, wlens = wcodes[:200], wlens[:200]
    wc = torch.from_numpy(wcodes).to(dev)
    wv = torch.from_numpy(wlens.astype(np.int32)).to(dev)
    tw, sg = window.tile_width(K, 1024, W, dev) if dev.type == "cuda" else ("-", "-")
    got = window.window_run_starts(wc, wv, K, 1024, W)
    want = native.window_sketch(wcodes, wlens, K, 1024, W)
    for a, b in zip(got, want):
        _check(np.array_equal(a.cpu().numpy().view(b.dtype), b),
               "window_sketch s=1024: kernel != native")
    nw = int((wlens - W + 1).clip(min=0).sum())
    nk = int(np.clip(wlens.astype(np.int64) - K + 1, 0, None).sum())
    routes["window_sketch"] = [_route(
        f"s=1024 (tiles of {tw} windows, slot groups of {sg})",
        lambda: window.window_run_starts(wc, wv, K, 1024, W),
        lambda: window.window_run_starts_torch(wc, wv, K, 1024, W),
        lambda a, b: all(torch.equal(x.long(), y.long()) for x, y in zip(a, b)),
        dev, "window_sketch",
        _bound(int(wlens.sum()) + wlens.nbytes + len(got[0]) * (8 + 8 * 1024),
               nk * (8 + 4 * 1024) + nw * 1024 * 2), iters=3)]

    # match_bits: 100 kb and 200 kb reads among 20-150 bp reads, on the
    # shared route (each segment's staging cut to its rows) and with every
    # block on the global route
    margs = synth.match_bits_batch_case(6, n_graphs=6, n_reads=30,
                                        long_reads=(100_000, 200_000))
    rows = torch.from_numpy(margs[0]).to(dev)
    dargs = [torch.from_numpy(a).to(dev) for a in margs[:-1]]
    pfn = lambda: aligner.match_bits_batch_torch(*dargs, margs[-1]).view(torch.int32)  # noqa: E731
    sizes = margs[-1][:, 1] * 6 * margs[-1][:, 3] * -(-margs[-1][:, 4] // 32)
    mbound = _bound(int(margs[2].sum()) + int(margs[4].sum()) + 4 * len(margs[5])
                    + 4 * int(sizes.sum()), 0)
    # the global route: a shared-route limit of 0 bytes, which no block fits
    routes["match_bits"] = [_route(
        f"100 kb + 200 kb reads ({name} route)",
        lambda limit=limit: aligner.match_bits_batch(
            rows, *margs[1:], shared_limit=limit)[0].view(torch.int32),
        pfn, eq, dev, "match_bits", mbound, iters=3, funcs=funcs)
        for name, limit, funcs in (("shared", None, None),
                                   ("global", 0, ("match_bits_global_kernel",)))]

    # em_batched: E = 30,000, graphs of > 27,008 live ecs on both routes
    # beside one staged as before, at seeds 1-3
    def em_same(a, b):
        return torch.equal(a[0], b[0]) and bool(
            ((a[1] - b[1]).abs() <= 1e-5 * b[1].abs().clamp(min=1.0)).all())

    routes["em_batched"] = []
    for seed in (1, 2, 3):
        m, cn, n = synth.em_batch(seed, [3, 40, 33], 30_000, zero_frac=0.02,
                                  min_fill=0.95)
        cn[2, 100:] = 0.0
        eargs = [torch.from_numpy(x).to(dev) for x in (m, cn, n)]
        it = em.em_batched(*eargs, 10, 3000)[0]
        e_real = (m.sum(axis=2) > 0).sum(axis=1).astype(np.int64)
        p_real = n.astype(np.int64)
        ops = 4 * int((it.cpu().numpy().astype(np.int64) * e_real * p_real).sum())
        routes["em_batched"].append(_route(
            f"E=30000 seed {seed} (graphs past the shared memory)",
            lambda eargs=eargs: em.em_batched(*eargs, 10, 3000),
            lambda eargs=eargs: em.run_em_batched_torch(*eargs, 10, 3000), em_same,
            dev, "em_batched",
            _bound(4 * (int((e_real * p_real).sum()) + int(e_real.sum()) + 2 * len(n)
                        + int(p_real.sum())), ops), iters=3))
    return routes


def make_data(work: str, seed: int) -> str:
    """Synthetic database + ARG-dense reads; returns the FASTQ path."""
    from groot_tpu_torch import synth

    rng = np.random.default_rng(seed)
    t0 = time.time()
    clusters = synth.make_clusters(rng, N_CLUSTERS)
    synth.write_msa_dir(clusters, os.path.join(work, "msa"))
    alleles = synth.alleles_of(clusters)
    reads, which, starts = synth.sample_reads(rng, alleles, N_READS)
    names = synth.allele_names(clusters)
    fq = os.path.join(work, "reads.fq")
    synth.write_fastq(reads, fq, origins=([names[i] for i in which], starts))
    _say(f"data: {len(clusters)} clusters, {len(alleles)} alleles, "
         f"{len(reads)} reads of 150 bp ({time.time() - t0:.1f}s)")
    return fq


def _launches(names) -> dict:
    from groot_tpu_torch import _build

    counts = {n: _build.KERNELS[n].launches for n in names}
    _say("launches:", json.dumps(counts))
    for n, c in counts.items():
        _check(c > 0, f"kernel {n} was not launched on its command's path")
    return counts


def _index(work: str, out: str, device: str, s: int = S) -> float:
    from groot_tpu_torch import cli

    t0 = time.time()
    rc = cli.main([
        "index", "-m", os.path.join(work, "msa"), "-i", os.path.join(work, out),
        "-w", str(W), "-k", str(K), "-s", str(s),
        "--log", os.path.join(work, "index.log"), "--device", device,
    ])
    _check(rc == 0, f"index --device {device} failed")
    return time.time() - t0


def build_index(work: str, dev, idx: str = "idx", s: int = S) -> dict:
    """`index --device cuda` (the window-sketch kernel) at sketch size s
    into `idx`, then the native CPU route on the same MSAs: the two indexes
    must be equal."""
    from groot_tpu_torch import _build
    from groot_tpu_torch.index.lshe import ContainmentIndex

    _build.reset_counts()
    dt = _index(work, idx, dev.type, s)
    launches = _launches(["window_sketch"])
    cpu_dt = _index(work, f"{idx}-cpu", "cpu", s)
    a = ContainmentIndex.load(os.path.join(work, idx, "groot.lshe"))
    b = ContainmentIndex.load(os.path.join(work, f"{idx}-cpu", "groot.lshe"))
    _check(a.window_keys == b.window_keys, "index window keys differ")
    for name, arr in b.soa.items():
        _check(np.array_equal(a.soa[name], arr), f"index soa {name} differs")
    _say(f"index --device {dev.type} (s={s}): {len(a.sketches)} window sketches in "
         f"{dt:.2f}s; --device cpu (native) {cpu_dt:.2f}s; the two indexes "
         f"are equal ({len(b.soa)} arrays)")
    return launches


def window_parity(work: str, dev, base=None) -> dict:
    """The window-sketch kernel vs its plain version and the native runtime
    on every path row of the database, timed (with `base`, the earlier
    kernel timed beside it)."""
    from groot_tpu_torch.config import Info
    from groot_tpu_torch.io import native

    from groot_tpu_torch.graph.pack import pack_graph_paths
    from groot_tpu_torch.index import window
    from groot_tpu_torch.pipeline.index_pipeline import build_graphs, find_msa_files

    info = Info(kmer_size=K, sketch_size=S, window_size=W)
    graphs = build_graphs(info, find_msa_files(os.path.join(work, "msa")))
    packs = [pack_graph_paths(g) for g in graphs if not g.masked]
    _rows, codes, lens = window.path_rows(packs)
    c = torch.from_numpy(codes).to(dev)
    v = torch.from_numpy(lens.astype(np.int32)).to(dev)
    got = window.window_run_starts(c, v, K, S, W)
    plain = window.window_run_starts_torch(c, v, K, S, W)
    _sync(dev)
    got_np = [t.cpu().numpy() for t in got]
    for name, a, b in zip(("rows", "cols", "sketches", "row counts"), got_np,
                          (t.cpu().numpy() for t in plain)):
        _check(np.array_equal(a.astype(np.int64), b.astype(np.int64)),
               f"window_sketch {name}: kernel != plain")
    got_np[2] = got_np[2].view(np.uint64)
    err = _max_abs_err(got_np[2], plain[2].cpu().numpy().view(np.uint64))
    want = native.window_sketch(codes, lens, K, S, W)
    for name, a, b in zip(("rows", "cols", "sketches", "row counts"), got_np, want):
        _check(np.array_equal(a, b), f"window_sketch {name}: kernel != native")
    fn = lambda: window.window_run_starts(c, v, K, S, W)  # noqa: E731
    m = {"max_abs_err": err, "ms": _time_ms(fn, dev),
         "plain_ms": _time_ms(lambda: window.window_run_starts_torch(c, v, K, S, W),
                              dev, 5),
         "timed_device_ms": _device_ms(fn, "window_sketch")
         if dev.type == "cuda" else None}
    if base is not None:
        m.update(base.timed("window_sketch",
                            (lambda: base.window_sketch(c, v, K, S, W))
                            if base.earlier_signature("window_sketch") else fn,
                            got, dev))
    nw = int((lens - W + 1).clip(min=0).sum())
    # bytes: the rows' bases (not the padding) and lengths in, each run
    # start's row, column and S u64 minima out; ops: per k-mer the rolling
    # hash and S slots, per window and slot ~2 for the sliding minimum
    n_kmer = int(np.clip(lens.astype(np.int64) - K + 1, 0, None).sum())
    bound = _bound(int(lens.sum()) + lens.nbytes + len(got_np[0]) * (8 + 8 * S),
                   n_kmer * (8 + 4 * S) + nw * S * 2)
    tw = window.tile_width(K, S, W, dev)[0] if dev.type == "cuda" else "-"
    _say(f"window_sketch on {len(lens)} path rows (<= {codes.shape[1]} bp, "
         f"{nw} windows, {len(got_np[0])} run starts, tiles of {tw} "
         "windows): equal to plain/native; "
         + _times_text(m) + f"; bound {bound['bound_ms']:.6f} ms ({bound['bound_by']})")
    return {**m, **bound}


def phase_a_parity(work: str, fq: str, dev, base=None) -> dict:
    """Read-hash and seed-scan kernels vs their plain versions on the rows
    of the first batch of the end-to-end reads (with `base`, the earlier
    read-hash kernel timed beside this one)."""
    from groot_tpu_torch.align.batch_host import WindowTables
    from groot_tpu_torch.config import Info

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
    two = dj.DeviceJoinAligner(info.store, bamio.build_references(info.store),
                               device=dev, devices=[dev, dev])
    if two.try_load(index, os.path.join(idx, "groot.align"), K) is None:
        two.attach_tables(tables, index, K)
    sharded = two.scan_rows(PH, rows_t, sx)
    _sync(dev)
    _check(torch.equal(sharded, out), "seed_scan over [cuda, cuda] != unsharded")
    _say(f"seed_scan sharded over [{dev}, {dev}]: equal to the unsharded scan "
         f"on {rows_t.shape[1]} rows")
    hits = int(((out & 0xFF) < 255).sum())
    # stage-1 offsets each row admits: j <= sb, j < D1, room for the read
    rd_, prow_, rb_, sb_, lb_ = (t.long() for t in rows_t)
    plen_ = al._dev["path_len"][prow_].long()
    admitted = (torch.minimum(torch.minimum(sb_, torch.full_like(sb_, sx["D1"] - 1)),
                              plen_ - rb_ - lb_) + 1).clamp(min=0)
    # read_hash: the reads' bases, lengths and power tables in, the four
    # hash arrays out at each read's real positions (not the padding to
    # L and WPH); ~8 ops a base (prefix hashes of both strands, anchors)
    ln = lens.long()
    n_hash = 2 * int((ln + 1).sum()) + 2 * int((ln - K + 1).clamp(min=0).sum())
    rh = {"max_abs_err": rh_err,
          "ms": _time_ms(lambda: dj.read_hashes(*args), dev),
          "plain_ms": _time_ms(lambda: dj.read_hashes_torch(*args), dev, 5),
          "timed_device_ms": _device_ms(lambda: dj.read_hashes(*args), "read_hash")
          if dev.type == "cuda" else None,
          **_bound(int(ln.sum()) + _nbytes(lens) + 8 * int(ln.max()) + 4 * n_hash,
                   8 * int(ln.sum()))}
    if base is not None:
        rh.update(base.timed("read_hash", lambda: dj.read_hashes(*args), PH, dev))
    # seed_scan: the rows in, one word a row out, and at least one anchor
    # chain (n_offs + 1 words) per row and strand from the path table and
    # per read of the rows and strand from its anchor hashes
    n_rows = rows_t.shape[1]
    chain = 2 * n_rows * (sx["n_offs"] + 1)
    n_read = int(torch.unique(rows_t[0]).numel())
    ss = {"max_abs_err": ss_err,
          "ms": _time_ms(lambda: dj.seed_scan(al._dev, *PH, *rows_t, **kw), dev),
          "plain_ms": _time_ms(
              lambda: dj.seed_scan_torch(al._dev, *PH, *rows_t, **kw), dev, 5),
          "timed_device_ms": _device_ms(
              lambda: dj.seed_scan(al._dev, *PH, *rows_t, **kw), "seed_scan")
          if dev.type == "cuda" else None,
          **_bound(_nbytes(rows_t, out) + 4 * chain
                   + 4 * 2 * n_read * (sx["n_offs"] + 1), chain)}
    if base is not None:
        ss.update(base.timed("seed_scan",
                             lambda: dj.seed_scan(al._dev, *PH, *rows_t, **kw),
                             out, dev))
    _say(f"phase A on one batch: {len(codes)} mapped reads (L {codes.shape[1]}, "
         f"WPH {sx['WPH']}), {rows_t.shape[1]} rows ({hits} stage-1 hits, "
         f"{float(admitted.float().mean()):.2f} admitted offsets a row), D1 "
         f"{sx['D1']}, n_offs {sx['n_offs']}; read_hash {_times_text(rh)}; seed_scan {_times_text(ss)}")
    return {"read_hash": rh, "seed_scan": ss}


def align_and_report(work: str, fq: str, engine: str, device: str,
                     idx: str = "idx", tag: str = ""):
    """The CLI's align command on the index in `idx`, then its report,
    its files named by `tag`; returns (result, rows, seconds)."""
    from groot_tpu_torch import cli

    tag = tag or (engine if idx == "idx" else f"{engine}-{idx}")
    bam = os.path.join(work, f"{tag}.bam")
    log = os.path.join(work, f"{tag}.log")
    args = cli.build_parser().parse_args([
        "align", "-i", os.path.join(work, idx), "-f", fq, "-c", "1",
        "-g", os.path.join(work, f"graphs-{tag}"), "--bamOut", bam,
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


def _plane_batches(fq: str):
    from groot_tpu_torch.pipeline import align_pipeline as ap

    return [(np.array(b.codes), np.asarray(b.lengths, np.int32))
            for b in ap.batch_reads_native([fq], ap.DEFAULT_BATCH)]


def _host_hits(index, codes, lens, t):
    """The native host query's hits of a batch, as a set of (read, window)."""
    from groot_tpu_torch.io import native

    kc = (lens - K + 1).astype(np.int32)
    rows, wins = index.query_batch_np(native.sketch(codes, lens, K, index.sketch_size),
                                      kc, t, device="cpu")
    return set(zip(rows.tolist(), wins.tolist()))


def _query_args(di, codes, lens, t, dev):
    """The LSH query's inputs on the card for one batch, as align_step
    makes them (the mode is the batch's)."""
    from groot_tpu_torch.index.lshe import MAX_PER_BAND
    from groot_tpu_torch.ops.sketch import khf_sketch
    from groot_tpu_torch.parallel import device_index as pdi

    s = di.sketches.shape[1]
    c = torch.from_numpy(codes).to(dev)
    v = torch.from_numpy(lens).to(dev)
    q = khf_sketch(c, v, K, s)
    kc = (v - (K - 1)).to(torch.int32)
    full = pdi.full_equality_mode(pdi.local_qmin(lens, K), s,
                                  float(di.num_window_kmers), t)
    kw = dict(domain_size=di.num_window_kmers, threshold=t)
    if full:
        args = (q, kc, di.sketches, di.fsig_sorted[None], di.forder[None])
        kw.update(K=s, M=di.cf, qmax=pdi.max_keep_q(float(di.num_window_kmers), t))
    else:
        args = (q, kc, di.sketches, di.sorted_sigs, di.band_idx)
        kw.update(K=di.band_k, M=MAX_PER_BAND)
    return args, kw, full


def _n_candidates(q, kc, _sketches, sorted_sigs, band_idx, *, K, M, qmax=None,
                  **_kw) -> int:
    """The candidate windows the LSH query must score for a batch: per
    read, at most M table entries of each band whose signature equals the
    read's, counted once per read in the banded mode (as the query dedups
    them)."""
    from groot_tpu_torch.index.lshe import M32, mix_bands_torch

    sigs = mix_bands_torch(q, K)
    take = torch.arange(M, device=q.device)
    parts = []
    for b in range(sorted_sigs.shape[0]):
        row = sorted_sigs[b].long() & M32
        lo = torch.searchsorted(row, sigs[:, b].contiguous(), side="left")
        hi = torch.searchsorted(row, sigs[:, b].contiguous(), side="right")
        pos = lo[:, None] + take[None, :]
        parts.append(torch.where(pos < hi[:, None],
                                 band_idx[b][pos.clamp(max=row.numel() - 1)], -1))
    cands = torch.cat(parts, dim=1)
    if qmax is None:
        cands = torch.sort(cands, dim=1).values
        cands[:, 1:][cands[:, 1:] == cands[:, :-1]] = -1
    return int(((cands >= 0) & (kc[:, None] > 0)).sum())


def data_plane(work: str, fq: str, dev, base=None, idx: str = "idx",
               thresholds=(0.99, 0.97)):
    """The fused align step over every read at each threshold (t = 0.99
    and 0.97) on the index in `idx`, held to the host replay (its hits equal to the host
    query's where the batches take the full-equality mode); the LSH-query
    and weight-scatter kernels against their plain versions on the first
    batch (with `base`, the earlier LSH-query kernel timed beside this
    one); the GROOT_DEVICE_QUERY=1 route; the sharded step over [dev, dev].
    Returns (launches, {kernel: metrics}, a function that runs the step
    over the batches once, for the trace)."""
    from groot_tpu_torch.align.batch_host import WeightAccumulator, WindowTables
    from groot_tpu_torch.config import Info

    from groot_tpu_torch import _build
    from groot_tpu_torch.index import lshe
    from groot_tpu_torch.parallel import device_index as pdi

    idx = os.path.join(work, idx)
    info = Info.load(os.path.join(idx, "groot.gg"))
    index = lshe.ContainmentIndex.load(os.path.join(idx, "groot.lshe"))
    info.attach_db(index)
    s_idx = index.sketch_size
    tables = WindowTables(index, info.store)
    batches = _plane_batches(fq)
    n_reads = sum(len(c) for c, _l in batches)
    launches, metrics, steps = {}, {}, {}
    for t in thresholds:
        t0 = time.time()
        di = pdi.DeviceIndex.build(index, info.store, K, t, device=dev)
        _sync(dev)
        build_s = time.time() - t0
        step = steps[t] = pdi.make_sharded_align_step(di, t)
        modes = {pdi.full_equality_mode(pdi.local_qmin(l, K), s_idx,
                                        float(di.num_window_kmers), t)
                 for _c, l in batches}
        _build.reset_counts()
        t0 = time.time()
        outs = [step(c, l) for c, l in batches]
        _sync(dev)
        dt = time.time() - t0
        counts = {n: _build.KERNELS[n].launches
                  for n in ("khf_sketch", "lsh_query", "weight_scatter")}
        _say(f"data plane t={t} launches:", json.dumps(counts))
        for n, c in counts.items():
            _check(c > 0, f"kernel {n} was not launched by the data-plane step")
        if t == thresholds[0]:
            launches.update({n: counts[n] for n in ("lsh_query", "weight_scatter")})
        nw = np.zeros(di.num_nodes)
        gk = np.zeros(di.num_graphs)
        dropped = 0
        acc = WeightAccumulator(tables)
        cap_lost = extra = 0
        for (codes, lens), o in zip(batches, outs):
            win = o[0].cpu().numpy()
            nw += o[2].cpu().numpy()
            gk += o[3].cpu().numpy()
            dropped += int(o[5])
            rows, cols = np.nonzero(win >= 0)
            mine = set(zip(rows.tolist(), win[rows, cols].tolist()))
            host = _host_hits(index, codes, lens, t)
            if modes == {True}:
                _check(mine == host, f"t={t}: the step's hits != the host query's")
            cap_lost += len(host - mine)
            extra += len(mine - host)
            kc = (lens - K + 1).astype(np.float64)
            acc.add_pairs(win[rows, cols].astype(np.int64), kc[rows])
        _check(dropped == 0, f"t={t}: {dropped} pairs past the budget")
        np.testing.assert_allclose(nw, acc.node_w, rtol=2e-5, atol=0)
        host_gk = np.zeros(di.num_graphs)  # graph_kt is over the indexed graphs
        host_gk[tables.graph_ids] = acc.graph_kt
        _check(np.array_equal(gk, host_gk), f"t={t}: graph k-mers != host replay")
        what = "host query" if modes == {True} else "host replay of its own hits"
        _say(f"data plane s={s_idx} t={t}: DeviceIndex built in {build_s:.2f}s "
             f"(band K={di.band_k}, L={di.sorted_sigs.shape[0]}, cf={di.cf}); "
             f"{len(batches)} batches, {n_reads} reads, modes "
             f"{sorted('full' if m else 'banded' for m in modes)}, C="
             f"{outs[0][0].shape[1]}, in {dt:.3f}s = {n_reads / dt:.0f} reads/s; "
             f"{int(sum(int(o[4].sum()) for o in outs))} reads mapped; tallies "
             f"equal the {what} (node weights rtol 2e-5, max |d| "
             f"{np.abs(nw - acc.node_w).max():.6g}; graph k-mers equal); host "
             f"hits the cap drops: {cap_lost}; step hits the host query lacks: {extra}")

        # the two kernels against their plain versions on the first batch
        codes, lens = batches[0]
        qargs, qkw, full = _query_args(di, codes, lens, t, dev)
        win, con = lshe.query_device(*qargs, **qkw)
        win_p, con_p = lshe.query_device_torch(*qargs, **qkw)
        _sync(dev)
        _check(torch.equal(win, win_p), f"lsh_query t={t}: win_idx != plain")
        ulps = _ulps(con, con_p)
        _check(ulps <= 1, f"lsh_query t={t}: contain {ulps} ulps from plain")
        both = ~(torch.isnan(con) & torch.isnan(con_p))
        q_err = float((con - con_p)[both].abs().max())
        kc = qargs[1]
        wargs = (win, kc, di.win_nodes, di.win_coeff, di.win_multi, di.graph_ids,
                 di.num_nodes, di.num_graphs, 8 * len(lens))
        got = pdi.weight_scatter(*wargs)
        want = pdi.weight_scatter_torch(*wargs)
        _sync(dev)
        for j, name in ((1, "graph_kmers"), (2, "mapped"), (3, "dropped")):
            _check(torch.equal(got[j], want[j]), f"weight_scatter t={t}: {name} != plain")
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
        w_err = float((got[0] - want[0]).abs().max())
        # lsh_query: sketches and k-mer counts in, ids and containments
        # out, one lower-bound search of the u32 signatures a band (the
        # upper bound is not needed: a slot holds an id when its signature
        # equals the read's), and each real candidate's id and sketch row
        # (a slot the band lookup fills, not the padding of the C slots)
        # read once; ops: the band mix, the search and one compare a slot
        # of a real candidate
        B, Cq = win.shape
        n_band, n_sig = int(qargs[3].shape[0]), int(qargs[3].shape[-1])
        search = n_band * max(n_sig, 2).bit_length()
        n_cand = _n_candidates(*qargs, **qkw)
        q_bound = _bound(_nbytes(qargs[0], qargs[1], win, con)
                         + 4 * B * search + n_cand * (4 + 8 * s_idx),
                         B * (8 * s_idx + search) + n_cand * s_idx)
        # weight_scatter: the hit table and k-mer counts in, each kept
        # pair's live node slots (id and coefficient; not the padding of
        # the Cn slots), flag and graph, the tallies out; ops: a
        # multiply-add and an atomic a live slot. Its library counterpart:
        # index_add_ of the same contributions into the node weights.
        kept = win >= 0
        n_kept = int(kept.sum())
        r_k, c_k = torch.nonzero(kept, as_tuple=True)
        nodes = di.win_nodes[win[r_k, c_k].long()]
        vals = di.win_coeff[win[r_k, c_k].long()] * kc[r_k].float()[:, None]
        live = nodes >= 0
        n_live = int(live.sum())
        w_bound = _bound(_nbytes(win, kc, got[0], got[1], got[2]) + n_kept * 5
                         + n_live * 8, 2 * n_live)
        idx, val = nodes[live].long(), vals[live]
        acc_w = torch.zeros(di.num_nodes, dtype=torch.float32, device=dev)
        qfn = lambda: lshe.query_device(*qargs, **qkw)  # noqa: E731
        m = {
            "lsh_query": {
                "max_abs_err": q_err,
                "ms": _time_ms(qfn, dev),
                "plain_ms": _time_ms(lambda: lshe.query_device_torch(*qargs, **qkw), dev, 5),
                "timed_device_ms": _device_ms(qfn, "lsh_query")
                if dev.type == "cuda" else None,
                "library_ms": None, **q_bound},
            "weight_scatter": {
                "max_abs_err": w_err,
                "ms": _time_ms(lambda: pdi.weight_scatter(*wargs), dev),
                "plain_ms": _time_ms(lambda: pdi.weight_scatter_torch(*wargs), dev, 5),
                "library_ms": _time_ms(lambda: acc_w.index_add_(0, idx, val), dev),
                "timed_device_ms": _device_ms(lambda: pdi.weight_scatter(*wargs),
                                              "weight_scatter")
                if dev.type == "cuda" else None,
                **w_bound},
        }
        if base is not None:
            def same(got, want):  # ids equal, contain within 1 ulp
                return torch.equal(got[0], want[0]) and _ulps(got[1], want[1]) <= 1

            m["lsh_query"].update(base.timed(
                "lsh_query", qfn, (win, con),
                dev, same))
        _say(f"lsh_query t={t} ({'full' if full else 'banded'}, B={len(lens)}, C="
             f"{win.shape[1]}, bound {q_bound['bound_ms']:.6f} ms): win_idx equal "
             f"to plain, contain within {ulps} ulp (tolerance 1 ulp); "
             + _times_text(m["lsh_query"]))
        _say(f"weight_scatter t={t} ({int((win >= 0).sum())} kept pairs, Cn="
             f"{di.win_nodes.shape[1]}): equal to plain (node weights rtol 1e-5, "
             f"max |d| {w_err:.3g}); kernel {m['weight_scatter']['ms']:.4f} ms "
             f"(device {m['weight_scatter']['timed_device_ms']} ms), "
             f"plain {m['weight_scatter']['plain_ms']:.4f} ms, index_add_ "
             f"{m['weight_scatter']['library_ms']:.4f} ms")
        for name in m:
            prev = metrics.get(name)
            if prev is None:  # the JSON line carries t = 0.99, the default
                metrics[name] = m[name]
            else:
                prev["max_abs_err"] = max(prev["max_abs_err"], m[name]["max_abs_err"])
        # the banded mode's device times, beside the full mode's in its entry
        if t == 0.97:
            for key in ("timed_device_ms", "baseline_device_ms"):
                if key in m["lsh_query"]:
                    metrics["lsh_query"][f"banded_{key}"] = m["lsh_query"][key]

        # the sharded step over two shards of the one card
        one = step(codes, lens)
        two = pdi.make_sharded_align_step(di, t, devices=[dev, dev])(codes, lens)
        _sync(dev)
        for j, name in ((0, "win_idx"), (3, "graph_kmers"), (4, "mapped"), (5, "dropped")):
            _check(torch.equal(two[j], one[j]), f"sharded step t={t}: {name} differs")
        torch.testing.assert_close(two[2], one[2], rtol=1e-5, atol=0)
        _say(f"sharded step t={t} over [{dev}, {dev}] on {len(lens)} reads: "
             f"equal to the unsharded step")
        if t == 0.99:  # the step's time on one device and on two shards
            # (host arrays in, the H2D copies included); the merge's bound:
            # two shards' tallies read, one written, one add per slot
            shard2 = pdi.make_sharded_align_step(di, t, devices=[dev, dev])
            one_ms = _time_ms(lambda: step(codes, lens), dev, 5)
            two_ms = _time_ms(lambda: shard2(codes, lens), dev, 5)
            n_tally = di.num_nodes + di.num_graphs + len(lens) + 1
            merge = _bound(3 * 4 * n_tally, n_tally)
            _say(f"align step t={t} on {len(lens)} reads: one device {one_ms:.4f} "
                 f"ms, two shards {two_ms:.4f} ms; the merge of the tallies "
                 f"({n_tally} slots) bound {merge['bound_ms']:.6f} ms "
                 f"({merge['bound_by']})")

    # the GROOT_DEVICE_QUERY=1 route of the index query, banded at 0.97
    from groot_tpu_torch.io import native

    codes, lens = batches[0]
    q64 = native.sketch(codes, lens, K, s_idx)
    kcn = (lens - K + 1).astype(np.int32)
    os.environ["GROOT_DEVICE_QUERY"] = "1"
    try:
        rows, wins = index.query_batch_np(q64, kcn, 0.97, device=dev)
    finally:
        os.environ.pop("GROOT_DEVICE_QUERY", None)
    Kq = index.optimal_k(int(kcn.min()), 0.97)
    sigs, idxs = index._band_tensors(Kq, dev)
    win_p, _c = lshe.query_device_torch(
        torch.from_numpy(q64.view(np.int64)).to(dev), torch.from_numpy(kcn).to(dev),
        index.dev_tensors(dev)["sketches"], sigs, idxs, K=Kq,
        M=lshe.MAX_PER_BAND, domain_size=index.num_window_kmers, threshold=0.97)
    wp = win_p.cpu().numpy()
    r, c = np.nonzero(wp >= 0)
    mine = set(zip(rows.tolist(), wins.tolist()))
    _check(mine == set(zip(r.tolist(), wp[r, c].tolist())),
           "GROOT_DEVICE_QUERY=1 route != the plain device query")
    host = _host_hits(index, codes, lens, 0.97)
    _say(f"GROOT_DEVICE_QUERY=1 query at t=0.97 (K={Kq}) on {len(lens)} reads: "
         f"{len(mine)} hits, equal to the plain device query; host hits lost "
         f"to the {lshe.MAX_PER_BAND}-per-band cap: {len(host - mine)}")

    def trace_fn():
        for c, l in batches:
            steps[0.99](c, l)

    return launches, metrics, trace_fn


def nproc_phase(work: str, fq: str) -> None:
    """parallel.nproc on the index and reads: 2 gloo ranks on the card,
    then 1 NCCL rank; each must print OK."""
    for nproc, backend in ((2, "gloo"), (1, "nccl")):
        cmd = [sys.executable, "-m", "groot_tpu_torch.parallel.nproc",
               "--nproc", str(nproc), "--backend", backend, "--device", "cuda",
               "--index", os.path.join(work, "idx"), "--reads", fq,
               "--timeout", "300"]
        t0 = time.time()
        res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                             timeout=420)
        last = (res.stdout.strip().splitlines() or [""])[-1]
        _say(f"nproc {nproc} x {backend} ({time.time() - t0:.1f}s): {last}")
        _check(res.returncode == 0 and last.startswith("OK"),
               f"nproc {nproc} x {backend} failed: {res.stderr[-3000:]}")


# the device functions each kernel's entry point launches (trace names)
KERNEL_FUNCS = {
    "khf_sketch": ("khf_sketch_kernel",),
    "read_hash": ("read_hash_kernel",),
    "seed_scan": ("seed_scan_kernel",),
    "window_sketch": ("window_sketch_kernel",),
    "em_batched": ("em_batched_kernel",),
    "lsh_query": ("lsh_query_kernel",),
    "weight_scatter": ("weight_count_kernel", "weight_pairs_kernel"),
    "pair_cascade": ("pair_cascade_kernel",),
    "match_bits": ("match_bits_kernel", "match_bits_global_kernel"),
}


def _kernel_times(dev_events, table=None) -> dict:
    """{kernel: (launches, device us)} from a trace's device events: the
    device time of all the entry point's device functions (`table`, by
    default KERNEL_FUNCS), its launches counted by its first one (every
    call of the entry point runs it)."""
    per_kernel = {}
    for e in dev_events:
        for name, funcs in (table or KERNEL_FUNCS).items():
            hit = [f for f in funcs if f in e.name]
            if hit:
                n, us = per_kernel.get(name, (0, 0.0))
                per_kernel[name] = (n + (hit[0] == funcs[0]),
                                    us + e.time_range.elapsed_us())
    return per_kernel


def _device_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


# torch.profiler can lose the kernel records of the first launches of a
# session (seen on the H100 in every session after a long one: the runtime
# launch call is traced, the kernel's record is not). Each session first
# spins this many tiny kernels, which take that loss and are left out.
ABSORB = 32
ABSORB_KERNEL = "spin_kernel"  # the device function of torch.cuda._sleep


def _absorb() -> None:
    for _ in range(ABSORB):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def _device_ms(fn, name: str, funcs=None, iters: int = 20):
    """Device milliseconds a call of kernel `name` (its device functions,
    `funcs` or KERNEL_FUNCS[name], summed) over `iters` calls after
    warm-up, from a torch.profiler trace; None when the trace holds none
    of them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _attempt in range(2):  # a process's first session may record none
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _absorb()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        table = {name: funcs or KERNEL_FUNCS[name]}
        n, us = _kernel_times(_device_events(prof), table).get(name, (0, 0.0))
        if n:
            return us / 1e3 / n
    return None


def _traced(fn):
    """Run fn under torch.profiler: (wall s, busy s = the union of the
    device intervals of every kernel and copy, device events, {kernel:
    (launches, device us)}, {kernel: launches its wrapper counted}, {the
    trace's runtime launch calls, kernel records})."""
    from torch.profiler import ProfilerActivity, profile

    from groot_tpu_torch import _build

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _absorb()
        _build.reset_counts()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        dt = time.time() - t0
    counted = {n: k.launches for n, k in _build.KERNELS.items() if k.launches}
    events = prof.events()
    dev_events = [e for e in _device_events(prof) if ABSORB_KERNEL not in e.name]
    records = {
        "launch_calls": sum(e.device_type == torch.autograd.DeviceType.CPU
                            and "LaunchKernel" in e.name for e in events) - ABSORB,
        "kernel_records": sum(not e.name.startswith(("Memcpy", "Memset"))
                              for e in dev_events),
    }
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    busy_us = 0.0
    if spans:
        cur_s, cur_e = spans[0]
        for a, b in spans[1:]:
            if a > cur_e:
                busy_us += cur_e - cur_s
                cur_s, cur_e = a, b
            else:
                cur_e = max(cur_e, b)
        busy_us += cur_e - cur_s
    return dt, busy_us / 1e6, len(spans), _kernel_times(dev_events), counted, records


def _trace_run(cmd: str, fn):
    """`fn` under torch.profiler (_traced): prints the card's busy share of
    its wall time and each kernel's traced launches beside its wrapper's
    count, where a launch the trace lacks must be one of the kernel records
    the profiler lost; returns ({kernel: (launches, device us)}, {kernel:
    launches its wrapper counted}), both empty when the profiler records no
    device activity."""
    dt, busy, n_events, kern, counted, records = _traced(fn)
    if not n_events:
        _say(f"trace {cmd}: {dt:.2f}s; device busy share not measured "
             "(no device events)")
        return {}, {}
    _say(f"trace {cmd}: {dt:.2f}s under the profiler; device busy "
         f"{busy:.4f}s = {100 * busy / dt:.3f}% of the wall time over "
         f"{n_events} device events")
    # A launch the trace lacks must be one of the kernel records the
    # profiler lost (its runtime launch call is in the trace, the
    # kernel's record is not), never a launch the script miscounts.
    short = {k: counted.get(k, 0) - kern.get(k, (0, 0.0))[0]
             for k in sorted(set(kern) | set(counted))}
    lost = records["launch_calls"] - records["kernel_records"]
    _say(f"trace {cmd}: launches traced / counted by the wrappers: "
         + json.dumps({k: [kern.get(k, (0, 0.0))[0], counted.get(k, 0)]
                       for k in short})
         + f"; launch calls {records['launch_calls']}, kernel records "
         f"{records['kernel_records']}")
    _check(min(short.values(), default=0) >= 0 and lost >= sum(short.values()),
           f"trace {cmd}: the port's launches missing from the trace "
           f"({short}) exceed the kernel records it lost ({lost})")
    return kern, counted


def traced_runs(work: str, fq: str, dev, plane_fn) -> dict:
    """index, align (device, cascade and host engines), haplotype and the
    data-plane step (plane_fn) on the card once more, each under
    torch.profiler: the card's busy share of the run's wall time and each
    port kernel's device time. Returns {kernel: (launches, device us)}
    summed over the runs; prints "not measured" when the profiler records
    no device activity."""
    runs = {
        "index": lambda: _index(work, "idx-traced", dev.type),
        "align": lambda: align_and_report(work, fq, "device", dev.type),
        "align cascade": lambda: align_and_report(work, fq, "cascade", dev.type),
        "align host": lambda: align_and_report(work, fq, "host", dev.type),
        "haplotype": lambda: _haplotype(work, "haplo-traced", dev.type),
        "data plane": plane_fn,
    }
    per_kernel, ran = {}, {}
    for cmd, fn in runs.items():
        kern, counted = _trace_run(cmd, fn)
        for k, (n, us) in kern.items():
            n0, us0 = per_kernel.get(k, (0, 0.0))
            per_kernel[k] = (n0 + n, us0 + us)
        for k, n in counted.items():
            ran[k] = ran.get(k, 0) + n
    _say("trace: port kernels (launches traced, counted; device ms traced, "
         "device ms a launch):",
         json.dumps({k: [n, ran.get(k, 0), round(us / 1e3, 4),
                         round(us / 1e3 / max(n, 1), 6)]
                     for k, (n, us) in sorted(per_kernel.items())}))
    if per_kernel:
        _check(set(per_kernel) == set(KERNEL_FUNCS),
               f"trace: kernels missing from the trace: "
               f"{sorted(set(KERNEL_FUNCS) - set(per_kernel))}")
    return per_kernel


def _bam_keys(path):
    from groot_tpu_torch.io import bam as bamio

    _refs, recs = bamio.read_bam(path)
    return sorted(
        (r.name, r.ref_id, r.pos, r.flag, r.seq_len, tuple(r.cigar)) for r in recs
    )


@contextlib.contextmanager
def _clocked(owner, names, on_call=None):
    """Host clock spent in `owner`'s methods `names` while the block runs,
    {name: seconds} summed over every call and thread; on_call(name, args)
    after each call."""
    import threading

    spent = dict.fromkeys(names, 0.0)
    raw = {n: owner.__dict__[n] for n in names}
    lock = threading.Lock()

    def clock(name):
        orig = getattr(owner, name)  # a classmethod comes bound

        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return (orig if isinstance(raw[name], classmethod) else raw[name])(*a, **kw)
            finally:
                with lock:
                    spent[name] += time.perf_counter() - t0
                if on_call is not None:
                    on_call(name, a)
        return run

    for n in names:
        setattr(owner, n, clock(n))
    try:
        yield spent
    finally:
        for n, fn in raw.items():
            setattr(owner, n, fn)


def _index_clock(work: str, fq: str, engine: str, device: str, idx: str):
    """align_and_report with the host clock of its index load and its LSH
    queries (summed over the prep threads) printed."""
    from groot_tpu_torch.index.lshe import ContainmentIndex

    with _clocked(ContainmentIndex, ("load", "query_batch_np")) as spent:
        out = align_and_report(work, fq, engine, device, idx)
    _say(f"{engine} run host clock: index load {spent['load']:.2f}s, LSH "
         f"query {spent['query_batch_np']:.2f}s (summed over the prep threads) "
         f"of {out[3]:.2f}s")
    return out


def end_to_end(work: str, fq: str, dev, idx: str = "idx") -> dict:
    from groot_tpu_torch import _build

    _build.reset_counts()
    res, dev_bam, dev_rows, dev_s = _index_clock(work, fq, "device", dev.type, idx)
    launches = _launches(["khf_sketch", "read_hash", "seed_scan"])
    st = res.stats
    _say(f"device run: {st.received} reads, {st.mapped} mapped, "
         f"{st.alignment_count} alignments in {dev_s:.2f}s = "
         f"{st.received / dev_s:.0f} reads/s (align command, setup included)")
    _say("device stage_times:", json.dumps(
        {k: round(v, 4) for k, v in sorted(st.stage_times.items())}))

    host, host_bam, host_rows, host_s = _index_clock(work, fq, "hash", "cpu", idx)
    _say(f"hash run: {host_s:.2f}s = {host.stats.received / host_s:.0f} reads/s")
    hash_run = (host, host_bam, host_rows)
    _same_as_hash("device", res, dev_bam, dev_rows, hash_run)
    return launches, hash_run


def _same_as_hash(engine: str, res, bam: str, rows: str, hash_run) -> None:
    """An align run equals the hash engine's: stats, node weights (rtol
    1e-6), order-canonical BAM records, pruned paths and report rows."""
    host, host_bam, host_rows = hash_run
    st = res.stats
    for f in ("received", "mapped", "multimapped", "alignment_count", "total_kmers"):
        a, b = getattr(st, f), getattr(host.stats, f)
        _check(a == b, f"stats.{f}: {engine} {a} != hash {b}")
    np.testing.assert_allclose(res.node_weights, host.node_weights, rtol=1e-6)
    _check(_bam_keys(bam) == _bam_keys(host_bam), f"{engine}: BAM records differ")
    _check(res.kept_paths == host.kept_paths, f"{engine}: pruned paths differ")
    _check(rows == host_rows, f"{engine}: report rows differ")
    _check(st.alignment_count > 0 and rows.strip(), f"{engine}: nothing aligned")
    _say(f"{engine} == hash: stats, {len(res.node_weights)} node weights, "
         f"{st.alignment_count} BAM records, {len(res.kept_paths)} kept paths, "
         f"{len(rows.splitlines())} report rows")


def cascade_phase(work: str, fq: str, dev, hash_run, idx: str = "idx") -> dict:
    """`align --device cuda` on the cascade engine over the same reads and
    index: the pair-cascade kernel must launch, and the run must equal the
    hash run of phase 5."""
    from groot_tpu_torch import _build

    _build.reset_counts()
    res, bam, rows, dt = align_and_report(work, fq, "cascade", dev.type, idx)
    # the batch sketch and the cascade both launch on this path; the
    # summary line keeps the device run's sketch count
    launches = {"pair_cascade": _launches(["khf_sketch", "pair_cascade"])["pair_cascade"]}
    st = res.stats
    _say(f"cascade run: {st.received} reads, {st.mapped} mapped, "
         f"{st.alignment_count} alignments in {dt:.2f}s = "
         f"{st.received / dt:.0f} reads/s (align command, setup included)")
    _say("cascade stage_times:", json.dumps(
        {k: round(v, 4) for k, v in sorted(st.stage_times.items())}))
    _same_as_hash("cascade", res, bam, rows, hash_run)
    return launches


def host_phase(work: str, fq: str, dev, hash_run, idx: str = "idx") -> dict:
    """`align --device cuda` on the `host` engine (GROOT_ENGINE=host: one
    match-bits launch a read batch for every graph it touches) over the
    same reads and index: the kernel must launch, at most once a batch, and
    the run must equal the hash run of phase 5."""
    from groot_tpu_torch import _build
    from groot_tpu_torch.align.aligner import GraphAligner

    # host clock in the aligner's two stages, summed over the run, and the
    # batches that reached the aligner
    batches = []

    def count(name, a):
        if name == "align_graph_batches":
            batches.append(len(a[1]))

    _build.reset_counts()
    with _clocked(GraphAligner, ("align_graph_batches", "_match_volumes"),
                  count) as spent:
        res, bam, rows, dt = align_and_report(work, fq, "host", dev.type, idx)
    launches = {"match_bits": _launches(["khf_sketch", "match_bits"])["match_bits"]}
    n_mapping = sum(n > 0 for n in batches)
    _check(launches["match_bits"] <= n_mapping,
           f"match_bits launched {launches['match_bits']} times over {n_mapping} "
           "batches that map a read: more than once a batch")
    st = res.stats
    mb, agb = spent["_match_volumes"], spent["align_graph_batches"]
    _say(f"host run: {st.received} reads, {st.mapped} mapped, "
         f"{st.alignment_count} alignments in {dt:.2f}s = "
         f"{st.received / dt:.0f} reads/s (align command, setup included), "
         f"{launches['match_bits']} match_bits launches over {len(batches)} "
         f"batches ({n_mapping} that map a read; {sum(batches)} graph batches); "
         f"host clock: match volumes {mb:.2f}s (codes, copies, kernel, bits "
         f"back), weights + cascade + records {agb - mb:.2f}s, the rest of the "
         f"command (ingest, sketch, query, grouping, BAM) {dt - agb:.2f}s")
    _same_as_hash("host", res, bam, rows, hash_run)
    return launches


def _walk_ands(rows, row_off, row_len, reads, read_len, pairs, segs):
    """csrc/match_bits.cu's loop run in torch over every (variant, path row,
    word) of a batch (six variants a pair), in the output's order: (its
    bits, the ANDs its early exit leaves: per item the bases up to the one
    that leaves the word 0, or all of them). A path row is wildcard past its
    end, as the kernel's planes are."""
    from groot_tpu_torch.align import aligner

    dev = rows.device
    Lr = reads.shape[1]
    s = torch.as_tensor(segs, device=dev)
    pair0, n, row0, n_rows, W = s.unbind(1)
    W32 = (W + 31) // 32
    sizes = n * 6 * n_rows * W32
    seg = torch.repeat_interleave(torch.arange(len(s), device=dev), sizes)
    local = torch.arange(int(sizes.sum()), device=dev) - (torch.cumsum(sizes, 0) - sizes)[seg]
    w = local % W32[seg]
    t = local // W32[seg]
    p = t % n_rows[seg]
    t = t // n_rows[seg]
    v = t % 6
    row = row0[seg] + p
    vid = pairs.long()[pair0[seg] + t // 6] * 6 + v
    NW = int(W32.max()) + -(-Lr // 32) + 1
    x = torch.arange(NW * 32, device=dev)
    inside = x[None, :] < row_len.long()[:, None]
    c = torch.where(inside, rows[(row_off[:, None] + x[None, :]).clamp(max=len(rows) - 1)].long(), 4)
    preds = torch.stack([(c == b) | (c >= 4) for b in range(4)] + [c >= 4], 1)
    planes = (preds.view(len(row_len), 5, NW, 32).long()
              << torch.arange(32, device=dev)).sum(-1)             # [rows, 5, NW]
    var, var_len = aligner.variant_rows(reads, read_len)
    n_v = var_len.long()[vid]
    acc = torch.where((n_v >= 0) & (n_v <= Lr), 0xFFFFFFFF, 0)
    ands = torch.zeros((), dtype=torch.int64, device=dev)
    for j in range(Lr):
        live = (acc != 0) & (j < n_v)
        ands += live.sum()
        code = var[vid, j].long()
        lo = planes[row, code, w + (j >> 5)]
        hi = planes[row, code, w + (j >> 5) + 1]
        acc = torch.where(live, acc & ((((hi << 32) | lo) >> (j & 31)) & 0xFFFFFFFF), acc)
    rem = (W % 32)[seg]
    last = (w == W32[seg] - 1) & (rem > 0)
    acc = torch.where(last, acc & ((1 << rem) - 1), acc)
    return acc, int(ands)


def _all_device_ms(fn, iters: int = 20):
    """Device milliseconds a call of `fn`, every kernel and copy it runs
    summed, from a torch.profiler trace; None when it records none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _absorb()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in _device_events(prof)
             if ABSORB_KERNEL not in e.name)
    return us / 1e3 / iters if us else None


def match_bits_parity(work: str, fq: str, dev, base=None) -> dict:
    """The match-bits kernel against its plain version on the card, bit for
    bit, on the whole first batch of the reads (grouped per graph as the
    host engine groups them, the inputs as its aligner builds them): ONE
    launch for every graph, the plain version a graph at a time, and the
    kernel's loop walked in torch over the batch for its bits and ANDs;
    timed: the launch, the plain version, and cuDNN's conv1d on the same
    one-hots (exact_conv, the library call) summed over the per-graph calls
    (the largest graph's printed beside it). With `base`, the earlier
    kernel (its C signature in `_Baseline._ARGTYPES`) on the same batch,
    its bits equal."""
    from groot_tpu_torch import _build
    from groot_tpu_torch.align import aligner
    from groot_tpu_torch.config import Info
    from groot_tpu_torch.index.lshe import ContainmentIndex
    from groot_tpu_torch.ops.sketch import sketch_reads_u64
    from groot_tpu_torch.pipeline import align_pipeline as ap

    idx = os.path.join(work, "idx")
    info = Info.load(os.path.join(idx, "groot.gg"))
    info.attach_db(ContainmentIndex.load(os.path.join(idx, "groot.lshe")))
    batch = next(ap.batch_reads_native([fq], ap.DEFAULT_BATCH))
    kc = (batch.lengths - K + 1).astype(np.int32)
    q64 = sketch_reads_u64(batch.codes, batch.lengths, K, S, dev)
    per_graph = {}
    for i, res in enumerate(info.db.query_batch(q64, kc, 0.99)[: batch.n_valid]):
        read = batch.read(i)
        for gid in res:
            per_graph.setdefault(gid, []).append(read)
    ga = aligner.GraphAligner(info.store, device=dev)
    args = ga.match_batch_inputs([(ga.pack(info.store[g]), rs) for g, rs in per_graph.items()])
    rows, row_off, row_len, codes, lens, pairs, segs = args
    dev_args = [rows, row_off,
                *(torch.from_numpy(a).to(dev) for a in (row_len, codes, lens, pairs))]
    _build.reset_counts()
    got, off = aligner.match_bits_batch(*args)
    _sync(dev)
    _check(aligner.MATCH_BITS.launches == (1 if dev.type == "cuda" else 0),
           "match_bits: the batch took more than one launch")
    got = got.view(torch.int32)
    calls = []
    for s, seg in enumerate(segs):
        inputs = aligner.segment_inputs(*dev_args, seg, nvar=6)
        plain = aligner.match_bits_torch(*inputs).view(torch.int32).reshape(-1)
        _check(torch.equal(got[off[s]:off[s + 1]], plain),
               f"match_bits graph {list(per_graph)[s]}: kernel != plain")
        calls.append(inputs)
    walk, ands = _walk_ands(*dev_args, segs)
    _check(torch.equal(got.long() & 0xFFFFFFFF, walk),
           "match_bits: kernel != its loop walked in torch")
    one_hots = []
    for path, var, var_len in calls:
        live = torch.arange(var.shape[1], device=dev)[None, :] < var_len[:, None].long()
        kern = torch.nn.functional.one_hot(var.long().clamp(max=4), 5).float() * live[..., None]
        one_hots.append((aligner.path_onehot(path).permute(0, 2, 1).contiguous(),
                         kern.permute(0, 2, 1).contiguous()))
    big = max(range(len(segs)), key=lambda s: off[s + 1] - off[s])

    def conv_all():
        with aligner.exact_conv():
            return [torch.nn.functional.conv1d(p, k) for p, k in one_hots]

    def conv_big():
        with aligner.exact_conv():
            return torch.nn.functional.conv1d(*one_hots[big])

    kfn = lambda: aligner.match_bits_batch(*args)  # noqa: E731
    pfn = lambda: aligner.match_bits_batch_torch(*dev_args, segs)  # noqa: E731
    cuda = dev.type == "cuda"
    m = {"max_abs_err": 0.0, "ms": _time_ms(kfn, dev),
         "plain_ms": _time_ms(pfn, dev, 2), "library_ms": _time_ms(conv_all, dev, 5),
         "library_largest_ms": _time_ms(conv_big, dev),
         "timed_device_ms": _device_ms(kfn, "match_bits") if cuda else None,
         "plain_device_ms": _all_device_ms(pfn, 2) if cuda else None,
         "library_device_ms": _all_device_ms(conv_all, 5) if cuda else None}
    if base is not None:
        m.update(base.match_bits(args, got, off, dev))
    # bytes: each touched path row's real bases, each read's real bases,
    # the pair table and the output words; ops: one AND a (variant, row,
    # word, base) that the early exit leaves (this run's data; the count
    # without the exit and the conv's multiply-adds are printed beside it)
    touched = torch.cat([torch.arange(int(r0), int(r0 + n_r)) for _p, _n, r0, n_r, _w in segs])
    n_path = int(row_len[touched.numpy()].astype(np.int64).sum())
    bound = _bound(n_path + int(lens.sum()) + 4 * len(pairs) + 4 * got.numel(), ands)
    n_var = sum(int(vl.clamp(min=0).sum()) * p.shape[0] * -(-(p.shape[1] - v.shape[1] + 1) // 32)
                for p, v, vl in calls)
    full = _bound(0, n_var)
    conv_b = _bound(0, sum(2 * 5 * v.shape[1] * v.shape[0] * p.shape[0] * (p.shape[1] - v.shape[1] + 1)
                           for p, v, _vl in calls))
    bp, bv, _bl = calls[big]
    _say(f"match_bits on the first batch: {len(segs)} graphs, {len(pairs)} pairs of "
         f"{len(lens)} reads (Lr {codes.shape[1]}), {len(touched)} path rows, "
         f"{got.numel()} words in ONE launch, each graph bit-equal to plain and the "
         f"batch to the kernel's loop walked in torch ({ands} ANDs); the largest "
         f"graph {list(per_graph)[big]}: {bv.shape[0] // 6} reads x 6 variants, "
         f"{bp.shape[0]} rows of Lp {bp.shape[1]}; kernel {m['ms']:.4f} ms (device "
         f"{m['timed_device_ms']} ms), plain {m['plain_ms']:.4f} ms (device "
         f"{m['plain_device_ms']} ms), conv1d over the {len(segs)} graphs "
         f"{m['library_ms']:.4f} ms (device {m['library_device_ms']} ms), at the "
         f"largest graph alone {m['library_largest_ms']:.4f} ms; bound "
         f"{bound['bound_ms']:.6f} ms ({bound['bound_by']}: {bound['bytes']} bytes, "
         f"{ands} ops); without the early exit {full['bound_ms']:.6f} ms "
         f"({full['ops']} ANDs); the convs' {conv_b['ops']} flops "
         f"{conv_b['bound_ms']:.6f} ms"
         + (f"; the earlier kernel on the same batch: {m['baseline_ms']:.4f} ms, "
            f"device {m['baseline_device_ms']} ms, bits equal"
            if base is not None else ""))
    return {**m, **bound}


def cascade_parity(work: str, fq: str, dev) -> dict:
    """The pair-cascade kernel against its plain version on the card, on
    the inputs of the largest chunk of the first batch of the reads (as
    the cascade run packs it), both timed."""
    from groot_tpu_torch.align import device_cascade as dc
    from groot_tpu_torch.align.batch_host import WindowTables
    from groot_tpu_torch.config import Info
    from groot_tpu_torch.index.lshe import ContainmentIndex
    from groot_tpu_torch.pipeline import align_pipeline as ap

    idx = os.path.join(work, "idx")
    info = Info.load(os.path.join(idx, "groot.gg"))
    index = ContainmentIndex.load(os.path.join(idx, "groot.lshe"))
    info.attach_db(index)
    al = dc.DeviceAligner(info.store, device=dev)
    tables = WindowTables(index, info.store)
    al.attach_tables(tables)
    batch = next(ap.batch_reads_native([fq], ap.DEFAULT_BATCH))
    kc = (batch.lengths - K + 1).astype(np.int32)
    rows, wins, combo_start = ap._compute_hits(
        info, batch, kc, K, S, 0.99, tables, dev
    )
    chunks = list(al.pair_chunks(rows, wins, combo_start))
    stack, pair_cnt, chunk = max(
        chunks, key=lambda c: int(np.minimum(c[1][c[2]], al.P_CAP).sum()))
    arrays, meta = al.chunk_arrays(stack, batch, rows, wins, combo_start,
                                   pair_cnt, chunk)
    args = (*stack.tensors(),
            *(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays))
    got = dc.pair_cascade(*args)
    plain = dc.pair_cascade_torch(*args)
    _sync(dev)
    n = meta[3]
    g_np, p_np = got.cpu().numpy(), plain.cpu().numpy()
    err = _max_abs_err(g_np[:n], p_np[:n])
    _check(err == 0.0, "pair_cascade kernel != plain")
    _check(np.array_equal(g_np, p_np), "pair_cascade kernel != plain (pad rows)")
    ms = _time_ms(lambda: dc.pair_cascade(*args), dev)
    dms = (_device_ms(lambda: dc.pair_cascade(*args), "pair_cascade")
           if dev.type == "cuda" else None)
    pms = _time_ms(lambda: dc.pair_cascade_torch(*args), dev, 5)
    bound = _cascade_bound(stack, arrays, g_np[:n])
    C, Lr = arrays[1].shape
    Pb, Lb, _Nb = stack.sig
    st = np.bincount(g_np[:n, 3], minlength=5)[1:]
    _say(f"pair_cascade on the largest chunk of batch 1 ({len(chunks)} chunks; "
         f"C={C} combos, Lr={Lr}, Np={len(arrays[3])} pairs, Nq={len(arrays[8])} "
         f"probes, Pb={Pb}, Lb={Lb}; {int(g_np[:n, 0].sum())} found, stages 1-4 "
         f"{st.tolist()}): equal to plain on every row; kernel {ms:.4f} ms "
         f"(device {dms} ms), plain {pms:.4f} ms, bound {bound['bound_ms']:.6f} "
         f"ms ({bound['bound_by']}: {bound['bytes']} bytes, {bound['ops']} ops)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms, "library_ms": None,
            "timed_device_ms": dms, **bound}


def _union_len(keys, starts, ends) -> int:
    """Total length of the union of the half-open intervals [start, end)
    of each key."""
    keep = ends > starts
    keys, starts, ends = keys[keep], starts[keep], ends[keep]
    if not len(keys):
        return 0
    span = int(ends.max()) + 1
    s = keys * span + starts
    e = keys * span + ends
    o = np.argsort(s, kind="stable")
    s, e = s[o], e[o]
    reach = np.concatenate(([s[0]], np.maximum.accumulate(e)[:-1]))
    return int(np.clip(e - np.maximum(s, reach), 0, None).sum())


def _cascade_bound(stack, arrays, rows) -> dict:
    """The least work of one pair_cascade call, counted from what its
    inputs and its answer `rows` (the real pairs' packed rows) need:
    - the reads' real bases, each combo's slot and length, each real
      pair's five words, its packed row out;
    - the seed node rows of the pairs (their real path slots and the node
      length) and the path length and terminal flag of each path row they
      place;
    - the path bytes of the forward stage-1 scan: in each real path row of
      the pair, every position from the clamped base up to the last one
      the scan may try (for a pair found there, no further than its
      winning offset), and the read's length from the winning position in
      each winning row;
    - for a pair not found at forward stage 1, the probes that must be
      tried (all of them, or the winner alone for a forward stage-2 hit)
      and their node rows.
    Positions and probes of the later stages and of the reverse strand are
    left out, so this is below what the function needs. Ops: one compare a
    scanned position and one a base of each winning row."""
    from groot_tpu_torch.align import device_cascade as dc

    (g_idx, read_codes, read_len, pair_combo, _valid, seed_idx, seed_off,
     span_lim, probe_pair, probe_node, _rank) = arrays
    n = len(rows)
    Pb, Lb, _Nb = stack.sig
    Lr = read_codes.shape[1]
    hosts = stack.host
    npos = np.stack([h.node_pos for h in hosts]).astype(np.int64)
    nlen = np.stack([h.node_len for h in hosts]).astype(np.int64)
    plen = np.stack([h.path_len for h in hosts]).astype(np.int64)
    term = np.stack([h.terminal_free for h in hosts])
    W = Lb - Lr + 1
    Wp = -(-W // dc.DB) * dc.DB
    pc = pair_combo[:n]
    g = g_idx[pc].astype(np.int64)
    rl = read_len[pc].astype(np.int64)
    seed, off = seed_idx[:n].astype(np.int64), seed_off[:n].astype(np.int64)
    ss = npos[g, seed]                                       # [n, Pb]
    live = ss >= 0
    b1 = np.minimum(span_lim[:n], nlen[g, seed] - 1 - off)
    base = ss + off[:, None]
    lo = np.clip(base, 0, W - 1)
    hi = np.minimum(np.minimum(base + b1[:, None], Wp - 1), plen[g] - 1)
    hi = np.where(term[g], hi, np.minimum(hi, plen[g] - rl[:, None]))
    fwd1 = (rows[:, 2] == 0) & (rows[:, 3] == 1)
    j1 = (rows[:, 5] - off)[:, None]
    hi = np.where(fwd1[:, None], np.minimum(hi, base + j1), hi)
    key = g[:, None] * Pb + np.arange(Pb)[None, :]
    tried = live & (hi >= lo)
    won = live & fwd1[:, None] & (rows[:, 8:8 + Pb] != 0)
    x = base + j1
    keys = np.concatenate([key[tried], key[won]])
    path_bytes = _union_len(keys, np.concatenate([lo[tried], x[won]]),
                            np.concatenate([hi[tried] + 1, (x + rl[:, None])[won]]))
    n_ops = int((hi - lo + 1)[tried].sum()) + int((won * rl[:, None]).sum())

    # probes: all of a pair's where forward stage 1 and 2 found nothing,
    # the winning one for a forward stage-2 hit
    fwd2 = (rows[:, 2] == 0) & (rows[:, 3] == 2)
    real_q = probe_pair < n
    q_pair = probe_pair[real_q].astype(np.int64)
    q_node = probe_node[real_q].astype(np.int64)
    need_q = ~fwd1[q_pair] & (~fwd2[q_pair] | (q_node == rows[q_pair, 4]))
    nodes = np.unique(np.concatenate([
        g * (1 << 32) + seed, g[q_pair[need_q]] * (1 << 32) + q_node[need_q],
    ]))
    node_g, node_i = nodes >> 32, nodes & 0xFFFFFFFF
    node_bytes = 4 * (int((npos[node_g, node_i] >= 0).sum()) + len(nodes))
    n_rows = len(np.unique(key[live]))
    nbytes = (int(read_len.sum()) + 8 * len(g_idx) + n * (17 + (8 + Pb) * 4)
              + 12 * int(need_q.sum()) + node_bytes + 5 * n_rows + path_bytes)
    return _bound(nbytes, n_ops)


def _haplotype(work: str, out: str, device: str):
    """The CLI's haplotype command on the device run's graphs: (called
    alleles, {allele: abundance} from haplotypes.tsv, seconds)."""
    from groot_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([
            "haplotype", "-g", os.path.join(work, "graphs-device"), "-o",
            os.path.join(work, out), "--device", device,
            "--log", os.path.join(work, "haplotype.log"),
        ])
    dt = time.time() - t0
    _check(rc == 0, f"haplotype --device {device} failed")
    with open(os.path.join(work, out, "haplotypes.tsv")) as fh:
        tsv = {n: float(a) for n, a in (l.rstrip("\n").split("\t") for l in fh)}
    return buf.getvalue().split(), tsv, dt


def haplotype_phase(work: str, dev, base=None):
    """`haplotype --device cuda` (the EM kernel) vs `--device cpu`, then the
    kernel vs its plain version on the same graphs, its batch's shapes and
    its time a round of the slowest graph (with `base`, the earlier kernel
    timed beside it)."""
    import glob

    from groot_tpu_torch.config import HaploCmd, Info

    from groot_tpu_torch import _build
    from groot_tpu_torch.em import em
    from groot_tpu_torch.pipeline.haplotype import load_weighted_gfas

    _build.reset_counts()
    found, tsv, dt = _haplotype(work, "haplo-cuda", dev.type)
    launches = _launches(["em_batched"])
    cpu_found, cpu_tsv, cpu_dt = _haplotype(work, "haplo-cpu", "cpu")
    _check(found == cpu_found and found, "haplotype: called alleles differ")
    _check(sorted(tsv) == sorted(cpu_tsv), "haplotype: abundance rows differ")
    for name, a in cpu_tsv.items():  # 6 printed decimals: 1e-6 of rounding
        _check(abs(tsv[name] - a) <= 1e-5 * abs(a) + 1e-6,
               f"haplotype: abundance of {name}: {tsv[name]} vs {a}")

    info = Info()
    info.haplotype = HaploCmd()
    gfas = sorted(glob.glob(os.path.join(work, "graphs-device", "*.gfa")))
    graphs = load_weighted_gfas(info, gfas)
    for g in graphs:
        g.remove_dead_paths()  # as find_haplotypes does before the EM
    arrays = em.padded_batch(graphs)[:3]
    mi, ma = info.haplotype.min_iterations, info.haplotype.max_iterations
    args = [torch.from_numpy(x).to(dev) for x in arrays]
    it, alpha = em.em_batched(*args, mi, ma)
    it_p, alpha_p = em.run_em_batched_torch(*args, mi, ma)
    it_c, _alpha_c = em.run_em_batched_torch(
        *(torch.from_numpy(x) for x in arrays), mi, ma)
    _sync(dev)
    _check(torch.equal(it.cpu(), it_p.cpu()) and torch.equal(it.cpu(), it_c),
           "em_batched: iteration counts differ from the plain version")
    err = float((alpha - alpha_p).abs().max())
    rel = float(((alpha - alpha_p).abs() / alpha_p.abs().clamp(min=1.0)).max())
    _check(rel <= 1e-5, f"em_batched: alpha differs from the plain version "
           f"by {rel:.3g} of max(1, |alpha|)")
    m = {"max_abs_err": err,
         "ms": _time_ms(lambda: em.em_batched(*args, mi, ma), dev),
         "plain_ms": _time_ms(lambda: em.run_em_batched_torch(*args, mi, ma), dev, 5),
         "timed_device_ms": _device_ms(lambda: em.em_batched(*args, mi, ma),
                                       "em_batched")
         if dev.type == "cuda" else None}
    if base is not None:
        def same(got, want):  # summation orders differ: 1e-5 of max(1, |alpha|)
            return torch.equal(got[0], want[0]) and bool(
                ((got[1] - want[1]).abs()
                 <= 1e-5 * want[1].abs().clamp(min=1.0)).all())

        m.update(base.timed("em_batched", lambda: em.em_batched(*args, mi, ma),
                            (it, alpha), dev, same))
    G, E, Pn = arrays[0].shape
    lay = em.em_layout(*args)
    width, n_live = lay["width"].cpu().numpy(), lay["n_live"].cpu().numpy()
    it_np = it.cpu().numpy()
    slow = np.argsort(-it_np, kind="stable")[:5]
    rounds = int(it_np.max())
    dms = m["timed_device_ms"]
    _say(f"em_batched batch: G={G}, E={E} (live ecs <= {int(n_live.max())}), "
         f"P={Pn}, {int(arrays[0].sum())} membership nonzeros; "
         f"{int((width <= em.MASK_LANES).sum())} graphs on the mask route, "
         f"{int((width > em.MASK_LANES).sum())} on CSR; the five slowest graphs "
         + ", ".join(f"#{g}: {int(it_np[g])} rounds ({int(n_live[g])} live ecs, "
                     f"{int(arrays[2][g])} paths)" for g in slow)
         + (f"; {1e3 * dms / rounds:.3f} us a round of the slowest "
            f"({dms:.4f} ms / {rounds} rounds)" if dms else "")
         + (f"; the baseline kernel {1e3 * m['baseline_device_ms'] / rounds:.3f}"
            " us a round" if m.get("baseline_device_ms") else ""))
    # bytes: each graph's real (ec, path) membership cells, ec counts and
    # path count in, its iterations and its paths' alphas out (the padding
    # of the [G, E, P] batch is left out); ops: ~4 a real cell per round
    e_real = (arrays[0].sum(axis=2) > 0).sum(axis=1).astype(np.int64)
    p_real = arrays[2].astype(np.int64)
    ops = 4 * int((it.cpu().numpy().astype(np.int64) * e_real * p_real).sum())
    bound = _bound(4 * (int((e_real * p_real).sum()) + int(e_real.sum()) + G
                        + G + int(p_real.sum())), ops)
    _say(f"haplotype --device {dev.type}: {len(found)} alleles called in "
         f"{dt:.2f}s; --device cpu the same in {cpu_dt:.2f}s")
    _say(f"em_batched on {G} graphs (E <= {E}, P <= {Pn}, iterations "
         f"{int(it.min())}-{int(it.max())}): same iterations as plain (card "
         f"and CPU), max |alpha - plain| {err:.3g} = {rel:.3g} of max(1, "
         f"|alpha|); {_times_text(m)}")
    return launches, {**m, **bound}


def accuracy_phase(work: str) -> None:
    """The accuracy command on the device run's BAM (bbmap-named reads)."""
    from groot_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([
            "accuracy", "--bamFile", os.path.join(work, "device.bam"),
            "--numReads", str(N_READS), "-i", os.path.join(work, "idx"),
            "--log", os.path.join(work, "accuracy.log"),
        ])
    out = buf.getvalue()
    _check(rc == 0 and "aligned reads" in out, "accuracy failed")
    rates = [l for l in out.splitlines() if "%" in l]
    _check(len(rates) == 4, "accuracy: expected four rates")
    _say("accuracy of the device run:")
    for line in out.splitlines():
        _say("  " + line)
    _check(int(rates[0].split()[0]) > 0, "accuracy: no read aligned")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline-csrc", metavar="DIR",
                    help="an earlier version of groot_tpu_torch/csrc (e.g. from "
                    "git show): its khf_sketch, read_hash, seed_scan, "
                    "window_sketch, em_batched, lsh_query and match_bits "
                    "kernels are timed beside this version's")
    args = ap.parse_args(argv)
    smi = preflight()
    dev = torch.device("cuda")
    build()
    base = _Baseline(args.baseline_csrc) if args.baseline_csrc else None
    kernels = {"khf_sketch": sketch_parity(args.seed, dev, base)}
    work = tempfile.mkdtemp(prefix=".chip_smoke-", dir=HERE)
    try:
        fq = make_data(work, args.seed)
        launches = build_index(work, dev)
        kernels["window_sketch"] = window_parity(work, dev, base)
        kernels.update(phase_a_parity(work, fq, dev, base))
        e2e_launches, hash_run = end_to_end(work, fq, dev)
        launches.update(e2e_launches)
        launches.update(cascade_phase(work, fq, dev, hash_run))
        kernels["pair_cascade"] = cascade_parity(work, fq, dev)
        launches.update(host_phase(work, fq, dev, hash_run))
        kernels["match_bits"] = match_bits_parity(work, fq, dev, base)
        em_launches, kernels["em_batched"] = haplotype_phase(work, dev, base)
        launches.update(em_launches)
        accuracy_phase(work)
        plane_launches, plane_kernels, plane_fn = data_plane(work, fq, dev, base)
        launches.update(plane_launches)
        kernels.update(plane_kernels)
        nproc_phase(work, fq)
        traced = traced_runs(work, fq, dev, plane_fn)
        s128_launches, _s128_plane = s128_phase(work, fq, dev)
        routes = routes_phase(work, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    from groot_tpu_torch import _build

    _check(set(_build.KERNELS) == set(KERNEL_FUNCS), "a kernel is not registered")
    rows = []
    for name, k in _build.KERNELS.items():
        m = kernels[name]
        n, us = traced.get(name, (0, 0.0))
        rows.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            # the traced runs' device time a launch (all the entry point's
            # device functions), and at the timed shapes where measured
            "device_ms": us / 1e3 / n if n else None,
            "timed_device_ms": m.get("timed_device_ms"),
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m.get("library_ms"),
            # phase 11's launches at s = 128; phase 12's routes
            "s128_launches": s128_launches.get(name), "routes": routes.get(name, []),
            **{k: m[k] for k in ("baseline_ms", "baseline_device_ms",
                                 "banded_timed_device_ms",
                                 "banded_baseline_device_ms",
                                 "plain_device_ms", "library_device_ms",
                                 "library_largest_ms")
               if k in m},
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
