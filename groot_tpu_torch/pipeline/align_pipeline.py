"""The align pipeline: FASTQ -> sketch -> LSH seed -> weight -> align -> prune.

Counterpart of groot_tpu/pipeline/align_pipeline.py. Reference:
cmd/align.go:54-163 wiring DataStreamer -> FastqHandler -> FastqChecker ->
ReadMapper (boss/minions, src/pipeline/boss.go:108-242 and
graphminion.go:40-103) -> GraphPruner (sketch.go:378-430).

Reads stream from the host in padded uint8 batches. The engine comes from
GROOT_ENGINE (default `device`):

  device — ingest workers sketch each batch with the KHF-sketch kernel on
           `device` and query the LSH index on the host; the main thread
           launches the cascade's phase-A kernels (align.device_join; the
           seed scan sharded over every visible card when there are
           several) and copies their output back; a worker pool runs the
           host tail;
  hash   — the host hash-join cascade (align.hash_join), sketching with
           the native runtime;
  host   — the legacy per-Key aligner (align.aligner), its match volumes
           from the match-bits kernel on `device` (the plain one-hot conv on
           the CPU);
  cascade — the match-volume cascade (align.device_cascade): batches are
           sketched with the KHF-sketch kernel on `device`, every chunk of
           (read, mapping) pairs runs the pair-cascade kernel, and the host
           replays weights and builds records; one batch's cascade is
           collected while the next is sketched and submitted.

`device` is explicit: "cuda" with no card raises, nothing falls back to
the CPU. The reference's transport probe and tunnel-aware engine choice are
not ported.
"""

from __future__ import annotations

import logging
import math
import os
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from .._build import native_runtime, resolve_device
from ..align.aligner import GraphAligner
from ..align.batch_host import WeightAccumulator, WindowTables, sort_hits
from ..config import Info
from ..graph.grootgraph import Store
from ..io import native
from ..io import bam as bamio
from ..io.fastx import FastqRead, stream_fastq
from ..ops import nthash
from ..ops.sketch import sketch_reads_u64
from ..parallel.mesh import data_devices

log = logging.getLogger("groot")

DEFAULT_BATCH = 2048
PIPE_DEPTH = 2  # device-engine batches in flight between submit and fetch
GUNZIP_MAX_BYTES = 256 << 20
ENGINES = ("device", "hash", "host", "cascade")


def select_engine() -> str:
    """GROOT_ENGINE, default `device`."""
    engine = os.environ.get("GROOT_ENGINE", "").strip().lower() or "device"
    if engine not in ENGINES:
        raise ValueError(f"unknown GROOT_ENGINE: {engine}")
    return engine


class ReadBatch:
    """A padded uint8 code batch; FastqRead records materialise lazily (only
    mapped reads ever need their id/qual bytes). Native-path batches may be
    stitched from several scanner segments (``segs``); ``n_valid`` < n rows
    marks shape-stabilising padding appended by the pipeline."""

    def __init__(self, codes, lengths, reads=None, segs=None, n_valid=None,
                 shape=None):
        # codes may be None with `shape` set: the padded code matrix then
        # materialises lazily on first access — the native encode runs on
        # whichever worker thread first touches the batch instead of the
        # serial ingest thread (the metagenome mix is ingest-bound)
        self._codes = codes     # u8 [B, L] or None (lazy)
        self._shape = shape if codes is None else codes.shape
        self.lengths = lengths  # i32 [B]
        self.n_valid = self._shape[0] if n_valid is None else n_valid
        self._reads = reads
        self._segs = segs       # [(buf, (io, il, so, sl, qo, ql)), ...]
        if segs is not None:
            self._seg_ends_list = list(
                np.cumsum([len(s[1][0]) for s in segs])
            )

    @property
    def codes(self):
        c = self._codes
        if c is None:
            n_total, L = self._shape
            c = np.empty((n_total, L), np.uint8)
            base = 0
            for b, a in self._segs:
                n_seg = len(a[2])
                native.encode_batch(b, a[2], a[3], L, out=c[base : base + n_seg])
                base += n_seg
            self._codes = c
        return c

    @codes.setter
    def codes(self, value):
        self._codes = value
        self._shape = value.shape

    @property
    def n(self) -> int:
        return self._shape[0]

    def payloads(self, rows=None):
        """Concatenated (id, seq, qual) byte arrays + per-read offsets for
        bulk record emission: (id_cat, id_off, id_len, seq_cat, seq_off,
        seq_len, qual_cat, qual_off, qual_len). id excludes the leading
        '@'. With ``rows`` (sorted unique read indices) only those reads
        are gathered and the offset arrays align with ``rows`` — the
        winners of a batch can be a tiny fraction of it. The full variant
        is cached per batch."""
        if rows is None:
            p = getattr(self, "_payloads", None)
            if p is not None:
                return p
        cats = {0: [], 1: [], 2: []}
        offs = {0: [], 1: [], 2: []}
        lens = {0: [], 1: [], 2: []}
        if self._reads is not None:
            sel = (
                self._reads
                if rows is None
                else [self._reads[i] for i in rows.tolist()]
            )
            for r in sel:
                for j, field in enumerate((r.id[1:], r.seq, r.qual)):
                    cats[j].append(np.frombuffer(field, np.uint8))
                    lens[j].append(len(field))
            for j in range(3):
                ln = np.array(lens[j], np.int64)
                offs[j] = np.concatenate(([0], np.cumsum(ln[:-1])))
                lens[j] = ln
                cats[j] = (
                    np.concatenate(cats[j]) if cats[j] else np.empty(0, np.uint8)
                )
        else:
            use_native = native.available()
            base = 0
            for buf, (io_, il, so, sl, qo, ql) in self._segs:
                n_seg = len(io_)
                if rows is not None:
                    lo = np.searchsorted(rows, base)
                    hi = np.searchsorted(rows, base + n_seg)
                    local = rows[lo:hi] - base
                    if len(local) == 0:
                        base += n_seg
                        continue
                    io_, il = io_[local], il[local]
                    so, sl = so[local], sl[local]
                    qo, ql = qo[local], ql[local]
                base += n_seg
                arr = None if use_native else np.frombuffer(buf, np.uint8)
                for j, (o, l, skip) in enumerate(
                    ((io_, il, 1), (so, sl, 0), (qo, ql, 0))
                ):
                    l2 = (l - skip).astype(np.int64)
                    total = int(l2.sum())
                    starts = np.concatenate(([0], np.cumsum(l2[:-1])))
                    if use_native:
                        out = np.empty(total, np.uint8)
                        native.gather_bytes(buf, o + skip, l2, starts, out)
                        cats[j].append(out)
                    else:
                        own = np.repeat(np.arange(len(o)), l2)
                        loc = np.arange(total) - starts[own]
                        cats[j].append(arr[(o + skip)[own] + loc])
                    lens[j].append(l2)
            for j in range(3):
                ln = (
                    np.concatenate(lens[j]) if lens[j] else np.empty(0, np.int64)
                )
                offs[j] = np.concatenate(([0], np.cumsum(ln[:-1]))) if len(ln) else np.empty(0, np.int64)
                lens[j] = ln
                cats[j] = (
                    np.concatenate(cats[j]) if cats[j] else np.empty(0, np.uint8)
                )
        p = (
            cats[0], offs[0], lens[0],
            cats[1], offs[1], lens[1],
            cats[2], offs[2], lens[2],
        )
        if rows is None:
            self._payloads = p
        return p

    def read(self, i: int) -> FastqRead:
        if self._reads is not None:
            return self._reads[i]
        # bisect: one scalar lookup, no array round trip
        import bisect

        s = bisect.bisect_right(self._seg_ends_list, i)
        base = 0 if s == 0 else int(self._seg_ends_list[s - 1])
        b, (io_, il, so, sl, qo, ql) = self._segs[s]
        j = i - base
        # bytes() so memoryview-backed segments (mmap ingest) hand out
        # real bytes like the streaming path does
        return FastqRead(
            id=bytes(b[io_[j] : io_[j] + il[j]]),
            seq=bytes(b[so[j] : so[j] + sl[j]]),
            qual=bytes(b[qo[j] : qo[j] + ql[j]]),
        )


def batch_reads(
    read_iter: Iterator[FastqRead], batch_size: int = DEFAULT_BATCH
) -> Iterator[ReadBatch]:
    buf: List[FastqRead] = []
    for read in read_iter:
        buf.append(read)
        if len(buf) == batch_size:
            yield _make_batch(buf)
            buf = []
    if buf:
        yield _make_batch(buf)


def _make_batch(reads: List[FastqRead]) -> ReadBatch:
    lengths = np.array([len(r.seq) for r in reads], dtype=np.int32)
    # pad width: a multiple of 32 bases, as the reference batches
    L = int(math.ceil(max(int(lengths.max()), 32) / 32) * 32)
    codes = np.full((len(reads), L), 4, dtype=np.uint8)
    for i, r in enumerate(reads):
        codes[i, : lengths[i]] = nthash.ASCII_TO_CODE[
            np.frombuffer(r.seq, dtype=np.uint8)
        ]
    return ReadBatch(codes=codes, lengths=lengths, reads=reads)


def _batch_from_segs(segs) -> ReadBatch:
    max_len = max(int(s[1][3].max()) for s in segs)
    L = int(math.ceil(max(max_len, 32) / 32) * 32)
    n_total = sum(len(a[2]) for _, a in segs)
    lengths = np.concatenate([a[3] for _, a in segs]).astype(np.int32)
    # codes encode lazily on the first consumer thread (ReadBatch.codes)
    return ReadBatch(
        codes=None, lengths=lengths, segs=segs, shape=(n_total, L)
    )


def batch_reads_native(
    paths: List[str], batch_size: int = DEFAULT_BATCH
) -> Iterator[ReadBatch]:
    """Chunked FASTQ ingest through the native scanner (io.native): file ->
    record offsets -> padded code matrix, no per-read Python objects.
    Records carry over between scanner chunks (and input files) so every
    batch except the last is exactly batch_size — uniform device shapes."""
    import gzip

    chunk_bytes = max(batch_size * 512, 1 << 20)
    pend: List = []  # [(buf, (io, il, so, sl, qo, ql))]
    pend_n = 0

    def drain():
        nonlocal pend, pend_n
        while pend_n >= batch_size:
            segs, need = [], batch_size
            while need:
                buf, arrs = pend[0]
                cnt = len(arrs[0])
                if cnt <= need:
                    segs.append((buf, arrs))
                    pend.pop(0)
                    need -= cnt
                else:
                    segs.append((buf, tuple(a[:need] for a in arrs)))
                    pend[0] = (buf, tuple(a[need:] for a in arrs))
                    need = 0
            pend_n -= batch_size
            yield _batch_from_segs(segs)

    # whole-file native gunzip cutoff: a .gz at or below this compressed
    # size is inflated in one native call and scanned like a
    # plain file; larger inputs keep the bounded-memory streaming path
    gz_max = GUNZIP_MAX_BYTES

    for path in paths:
        mv = None
        if not path.endswith(".gz"):
            # plain files: mmap + zero-copy memoryview windows (no read()
            # copy, no leftover stitching — the window advances by the
            # scanner's consumed offset)
            import mmap as _mmap

            with open(path, "rb") as fh:
                try:
                    mm = _mmap.mmap(fh.fileno(), 0, access=_mmap.ACCESS_READ)
                    mv = memoryview(mm)
                except (ValueError, OSError):
                    mv = None  # empty file / unmappable: streaming loop
        elif 18 <= os.path.getsize(path) <= gz_max:
            import mmap as _mmap

            with open(path, "rb") as fh:
                try:
                    mm = _mmap.mmap(fh.fileno(), 0, access=_mmap.ACCESS_READ)
                except (ValueError, OSError):
                    mm = None
            if mm is not None:
                raw = native.gunzip(mm)
                mm.close()
                if raw is not None:
                    mv = memoryview(raw)
        if mv is not None:
            size = len(mv)
            pos = 0
            win = chunk_bytes
            while pos < size:
                sub = mv[pos : pos + win]
                io_, il, so, sl, qo, ql, consumed = (
                    native.parse_fastq_buffer(sub)
                )
                if len(io_) == 0:
                    if pos + win >= size:
                        break  # trailing garbage / partial record
                    win *= 2  # a record larger than the window
                    continue
                pend.append((sub, (io_, il, so, sl, qo, ql)))
                pend_n += len(io_)
                yield from drain()
                pos += consumed
            continue
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as fh:
            leftover = b""
            while True:
                chunk = fh.read(chunk_bytes)
                if not chunk and not leftover:
                    break
                buf = leftover + chunk
                io_, il, so, sl, qo, ql, consumed = native.parse_fastq_buffer(buf)
                if len(io_) == 0:
                    if not chunk:
                        break  # trailing garbage / partial record
                    leftover = buf
                    continue
                leftover = buf[consumed:]
                pend.append((buf, (io_, il, so, sl, qo, ql)))
                pend_n += len(io_)
                yield from drain()
                if not chunk:
                    break
    if pend_n:
        yield _batch_from_segs(pend)


def _prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Run an iterator on a worker thread (gzip decode + FASTQ parse +
    encode overlap with alignment; the ingest stages release the GIL).
    The pipeline-parallel analog of the reference's goroutine stages
    (src/pipeline/pipeline.go:36-45)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    SENTINEL = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(SENTINEL)
        except BaseException as e:  # propagate into the consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is SENTINEL:
            break
        if isinstance(item, BaseException):
            raise item
        yield item


@dataclass
class AlignStats:
    received: int = 0
    mapped: int = 0
    multimapped: int = 0
    alignment_count: int = 0
    total_kmers: int = 0
    # the device engine's per-stage seconds and counts (submit_s, drain_s,
    # reduce_s, wait_tail_s, ...), copied from its aligner at the end
    stage_times: Dict[str, float] = field(default_factory=dict)


def shard_devices(dev: torch.device) -> Optional[List[torch.device]]:
    """The devices the device engine's seed scan shards over: every visible
    card when `dev` is a card and there are several, else None (one
    device)."""
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        return data_devices(device="cuda")
    return None


def _make_aligner(engine: str, info: Info, dev: torch.device, references):
    """The engine's aligner and its flat window tables (None for `host`).
    The hash/device setup arrays come from the groot.align sidecar when it
    matches the index, else they are built (and the sidecar refreshed)."""
    if engine == "host":
        return GraphAligner(info.store, references, device=dev), None
    if engine == "cascade":
        from ..align.device_cascade import DeviceAligner

        aligner = DeviceAligner(info.store, references, device=dev)
        tables = WindowTables(info.db, info.store)
        aligner.attach_tables(tables)
        return aligner, tables
    if engine == "device":
        from ..align.device_join import DeviceJoinAligner

        devices = shard_devices(dev)
        if devices is not None:
            log.info("\tdevice cascade sharded over %d devices", len(devices))
        aligner = DeviceJoinAligner(
            info.store, references, device=dev, devices=devices
        )
    else:
        from ..align.hash_join import HashAligner

        aligner = HashAligner(info.store, references)
    index = info.db
    k = info.kmer_size
    cache = (
        os.path.join(info.index_dir, "groot.align") if info.index_dir else None
    )
    tables = None
    if cache and os.path.exists(cache):
        tables = aligner.try_load(index, cache, k)
    if tables is None:
        tables = WindowTables(index, info.store)
        aligner.attach_tables(tables, index, k)
        if cache:
            try:
                aligner.save_arrays(cache)
            except OSError:
                pass
    return aligner, tables


def run_align(
    info: Info,
    fastq: List[str],
    bam_writer: Optional["bamio.BamWriter"] = None,
    batch_size: int = DEFAULT_BATCH,
    device="cuda",
) -> AlignStats:
    """ReadMapper equivalent: map/weight/align every read. Returns stats."""
    with obs.span("align.run"):
        from ..hostmem import tune as _malloc_tune

        setup = obs.Timer("align.setup")
        _malloc_tune()  # keep batch buffers on the heap (see hostmem.py)
        native_runtime()
        dev = resolve_device(device)
        engine = select_engine()
        stats = AlignStats()
        k = info.kmer_size
        s = info.sketch_size
        t = info.containment_threshold
        no_align = info.sketch.no_exact_align

        aligner = None
        if no_align:
            tables = WindowTables(info.db, info.store)
        else:
            references = bamio.build_references(info.store)
            aligner, tables = _make_aligner(engine, info, dev, references)
        acc = WeightAccumulator(tables) if tables is not None else None
        # the hash engine sketches with the native runtime (slot-0
        # prescreened), as the reference does; the others sketch on
        # `device`. GROOT_DEVICE_QUERY=1 queries on `device` whatever the
        # engine.
        sketch_dev = None if engine == "hash" else dev

        # fast path: plain/gzip FASTQ files through the native scanner;
        # FASTA or STDIN fall back to the Python streamer
        use_native = (
            fastq
            and not info.sketch.fasta
            and all(not f.endswith((".fasta", ".fa", ".fna")) for f in fastq)
        )
        if use_native:
            batches = batch_reads_native(fastq, batch_size)
        else:
            batches = batch_reads(
                stream_fastq(fastq, fasta=info.sketch.fasta), batch_size
            )
        is_async = getattr(aligner, "prefers_async", False) and not no_align
        if is_async:
            # device engine: sketch + query + hit sort run on the ingest
            # workers, so the main thread only submits and fetches
            batches = _map_hits(
                batches, info, k, s, t, tables, batch_size, sketch_dev, dev,
                aligner._count,
            )
        batches = _prefetch(batches, depth=2)

        import time as _time

        t_start = _time.time()
        # pooled execution needs the native emit path (the sink collects
        # raw record bytes); without the runtime the numpy write_groups
        # route writes through the real BamWriter -> stay sequential
        use_pool = (
            not no_align
            and hasattr(aligner, "process_batch")
            and not is_async
            and native.available()
        )
        setup.stop()
        if is_async:
            aligner._count("aligner_setup_s", setup.s)
            raw_count, length_total = _run_align_device(
                info, batches, aligner, bam_writer, stats, k, s, t, tables,
                batch_size, t_start,
            )
        elif use_pool:
            raw_count, length_total = _run_align_pooled(
                info, batches, aligner, bam_writer, stats, k, s, t, tables,
                batch_size, t_start, dev,
            )
        else:
            raw_count, length_total = _run_align_sequential(
                info, batches, aligner, bam_writer, stats, k, s, t, tables,
                acc, batch_size, t_start, sketch_dev, dev,
            )

        if acc is not None:
            # apply deferred increment_subpath replay
            with obs.span("align.flush"):
                acc.flush(info.store)
        stats.stage_times = dict(getattr(aligner, "stage_times", {}))

        if raw_count == 0:
            raise ValueError("no fastq reads received")
        log.info("\tnumber of reads received from input: %d", raw_count)
        log.info("\tmean read length: %.0f", length_total / raw_count)
        if stats.received == 0:
            raise ValueError("no reads passed quality-based trimming")
        log.info("\tnumber of reads sketched: %d", stats.received)

        if stats.mapped == 0:
            log.info("no reads could be mapped to the reference graphs")
            info.store = {}
            return stats
        log.info("\ttotal number of unmapped reads: %d", stats.received - stats.mapped)
        log.info("\ttotal number of mapped reads: %d", stats.mapped)
        log.info("\t\tmapped to one graph: %d", stats.mapped - stats.multimapped)
        log.info("\t\tmapped to multiple graphs: %d", stats.multimapped)
        log.info("\ttotal number of exact alignments: %d", stats.alignment_count)

        for g in info.store.values():
            stats.total_kmers += int(g.kmer_total)
        log.info("processing graphs...")
        log.info(
            "\ttotal number of k-mers projected onto graphs: %d", stats.total_kmers
        )
        info.haplotype.total_kmers = stats.total_kmers
        return stats


def _workers(info) -> int:
    """Host-tail worker threads: -p/--processors, else one per core."""
    return max(int(getattr(info, "num_proc", 0) or os.cpu_count() or 2), 1)


def _run_align_device(
    info, batches, aligner, bam_writer, stats, k, s, t, tables,
    batch_size, t_start,
) -> Tuple[int, int]:
    """Device-engine pipeline (prefers_async aligners). Thread roles:
      * ingest workers (_map_hits via _prefetch): decode + sketch kernel +
        LSH query + hit sorting;
      * MAIN thread: phase-A launches (submit_pairs) and D2H copies
        (fetch_pairs);
      * worker pool: collect_pairs per batch (winner combine, stage-2
        routing, byte verify, BAM assembly, host-cascade residue) into
        per-batch record sinks, replayed in submission order.
    Up to `depth` batches are in flight on the device while earlier
    batches' host tails run on the pool — the boss/minion fan-out of the
    reference (boss.go:134-203) with the card as one more minion."""
    import collections
    import threading
    import time as _time
    from concurrent.futures import ThreadPoolExecutor

    depth = PIPE_DEPTH
    workers = _workers(info)
    accs: Dict[int, WeightAccumulator] = {}
    pool = ThreadPoolExecutor(max_workers=workers)

    def post(batch, handles, rows, wins, kc_read):
        tid = threading.get_ident()
        acc = accs.get(tid)
        if acc is None:
            accs[tid] = acc = WeightAccumulator(tables)
        st = AlignStats()
        sink = _RecSink() if bam_writer is not None else None
        aligner.collect_pairs(
            handles, batch, rows, wins, kc_read, acc, sink, st
        )
        return st, sink

    raw_count = 0
    length_total = 0
    done_count = 0
    pend: "collections.deque" = collections.deque()
    futs: "collections.deque" = collections.deque()

    def replay_one():
        nonlocal done_count
        fut, n_valid, seq = futs.popleft()
        with obs.Timer("launch.wait_tail", seq) as tm:
            st, sink = fut.result()
        aligner._count("wait_tail_s", tm.s)
        with obs.span("launch.replay", seq):
            if sink is not None:
                sink.replay(bam_writer)
        stats.alignment_count += st.alignment_count
        done_count += n_valid
        log.info(
            "\tprocessed %d reads (%.0f reads/s)",
            done_count,
            done_count / max(_time.time() - t_start, 1e-9),
        )

    def drain_oldest():
        batch, handles, rows, wins, kc_read = pend.popleft()
        aligner.fetch_pairs(handles)  # D2H on the main thread
        futs.append(
            (
                pool.submit(post, batch, handles, rows, wins, kc_read),
                batch.n_valid,
                batch.seq,
            )
        )
        while len(futs) > workers + 1:
            replay_one()

    batches = iter(batches)
    try:
        while True:
            tm = obs.Timer("launch.wait_ingest")
            batch = next(batches, None)
            tm.batch = getattr(batch, "seq", None)
            aligner._count("wait_ingest_s", tm.stop().s)
            if batch is None:
                break
            raw_count += batch.n_valid
            length_total += int(batch.lengths[: batch.n_valid].sum())
            pre = getattr(batch, "_hits", None)
            if pre is None:
                # _map_hits skips batches containing too-short reads so
                # the error surfaces here, like the other engines
                short = int(batch.lengths[: batch.n_valid].min())
                raise ValueError(
                    f"sequence length ({short}) is short than k-mer "
                    f"length ({k})"
                )
            rows, wins, combo_start = pre
            stats.received += batch.n_valid
            if len(rows):
                graphs_per_read = np.bincount(
                    rows[combo_start], minlength=batch.n_valid
                )
                stats.mapped += int((graphs_per_read > 0).sum())
                stats.multimapped += int((graphs_per_read > 1).sum())
            kc_read = (
                (batch.lengths - k + 1).astype(np.int32).astype(np.float64)
            )
            with obs.Timer("phase_a.submit", batch.seq) as tm:
                handles = aligner.submit_pairs(batch, rows, wins, combo_start)
            aligner._count("submit_s", tm.s)
            pend.append((batch, handles, rows, wins, kc_read))
            while len(pend) > depth:
                drain_oldest()
            while futs and futs[0][0].done():
                replay_one()
        while pend:
            drain_oldest()
        while futs:
            replay_one()
    finally:
        pool.shutdown(wait=True)
    for acc in accs.values():
        with obs.span("align.flush"):
            acc.flush(info.store)
    return raw_count, length_total


def _run_align_sequential(
    info, batches, aligner, bam_writer, stats, k, s, t, tables, acc,
    batch_size, t_start, sketch_dev, query_dev,
) -> Tuple[int, int]:
    """One batch at a time on the calling thread: the `host` and `cascade`
    engines, the `hash` engine without the native runtime, and --noAlign
    runs. For `cascade` the loop is one deep: batch i's chunks are
    collected after batch i+1 is sketched and submitted, so the card works
    while the host replays weights and builds records."""
    import time as _time

    raw_count = 0
    length_total = 0
    pending = None
    for batch in batches:
        raw_count += batch.n_valid
        length_total += int(batch.lengths[: batch.n_valid].sum())
        if batch.n < batch_size:
            _pad_batch(batch, batch_size, k)
        nxt = _process_batch(
            info, batch, aligner, bam_writer, stats, k, s, t, tables, acc,
            sketch_dev, query_dev,
        )
        if pending is not None:
            aligner.collect_pairs(*pending, acc, bam_writer, stats)
        pending = nxt
        log.info(
            "\tprocessed %d reads (%.0f reads/s)",
            raw_count,
            raw_count / max(_time.time() - t_start, 1e-9),
        )
    if pending is not None:
        aligner.collect_pairs(*pending, acc, bam_writer, stats)
    return raw_count, length_total


class _RecSink:
    """Per-batch BAM record collector for the pooled path: workers append
    pre-assembled record bytes (write_raw) or fallback AlignmentRecords
    (write); the main thread replays them onto the real writer in batch
    order, keeping the output deterministic."""

    def __init__(self):
        self.items: List = []

    def write_raw(self, data, count: int) -> None:
        self.items.append(("raw", data, count))

    def write(self, rec) -> None:
        self.items.append(("rec", rec, 1))

    def write_groups(self, *args) -> None:
        # numpy BAM assembly route (_emit_flat without the native
        # emitter): buffer the vectorized group arrays verbatim
        self.items.append(("groups", args, 0))

    def replay(self, bam_writer) -> None:
        if bam_writer is None:
            return
        for kind, item, count in self.items:
            if kind == "raw":
                bam_writer.write_raw(item, count)
            elif kind == "groups":
                bam_writer.write_groups(*item)
            else:
                bam_writer.write(item)


def _run_align_pooled(
    info, batches, aligner, bam_writer, stats, k, s, t, tables,
    batch_size, t_start, query_dev,
) -> Tuple[int, int]:
    """Two-worker batch pipeline for the hash-join aligner: the native
    sketch/query/join/cascade/emit calls release the GIL, so two batches
    process concurrently on the two host cores while the BGZF worker
    compresses and the ingest thread decodes — the boss/minion fan-out of
    the reference (boss.go:134-203) at batch granularity. BAM bytes and
    stats are collected per batch and merged in submission order."""
    import collections
    import threading
    import time as _time
    from concurrent.futures import ThreadPoolExecutor

    workers = _workers(info)
    accs: Dict[int, WeightAccumulator] = {}

    def work(batch):
        tid = threading.get_ident()
        acc = accs.get(tid)
        if acc is None:
            accs[tid] = acc = WeightAccumulator(tables)
        st = AlignStats()
        sink = _RecSink() if bam_writer is not None else None
        _process_batch(info, batch, aligner, sink, st, k, s, t, tables, acc,
                       query_dev=query_dev)
        return st, sink

    raw_count = 0
    length_total = 0
    done_count = 0
    pool = ThreadPoolExecutor(max_workers=workers)
    futures: "collections.deque" = collections.deque()

    def drain_one():
        nonlocal done_count
        st, sink = futures.popleft().result()
        if sink is not None:
            sink.replay(bam_writer)
        stats.received += st.received
        stats.mapped += st.mapped
        stats.multimapped += st.multimapped
        stats.alignment_count += st.alignment_count
        done_count += st.received
        log.info(
            "\tprocessed %d reads (%.0f reads/s)",
            done_count,
            done_count / max(_time.time() - t_start, 1e-9),
        )

    try:
        for batch in batches:
            raw_count += batch.n_valid
            length_total += int(batch.lengths[: batch.n_valid].sum())
            if batch.n < batch_size:
                _pad_batch(batch, batch_size, k)
            futures.append(pool.submit(work, batch))
            while len(futures) > workers or (
                futures and futures[0].done()
            ):
                drain_one()
        while futures:
            drain_one()
    finally:
        pool.shutdown(wait=True)
    for acc in accs.values():
        acc.flush(info.store)
    return raw_count, length_total


def _pad_batch(batch: ReadBatch, batch_size: int, k: int) -> None:
    """Pad the (final, partial) batch to the fixed batch_size so every
    batch has one shape; pad rows are all-N reads whose results are
    discarded (n_valid)."""
    n, L = batch.codes.shape
    codes = np.full((batch_size, L), 4, dtype=np.uint8)
    codes[:n] = batch.codes
    # pad length = the longest real read, NOT k: the LSH band config is
    # chosen from the batch-min k-mer count (lshe.query_batch), so a short
    # pad row would flip K for every real read in the batch
    lengths = np.full(batch_size, max(int(batch.lengths.max()), k), np.int32)
    lengths[:n] = batch.lengths
    batch.codes, batch.lengths, batch.n_valid = codes, lengths, n


def _prescreen_for(info, batch, kmer_counts, t):
    """slot-0 prescreen handle when the full-equality mode applies."""
    if info.db.full_equality_applies(kmer_counts[: batch.n_valid], t):
        return info.db.slot0_prescreen()
    return None


def _sketch_query(info, batch, kmer_counts, k, s, t, sketch_dev,
                  query_dev="cpu"):
    """Sketch a padded batch and query the index -> (rows, wins).
    sketch_dev None: native host sketch with the slot-0 prescreen (numpy
    golden without the runtime library); else the KHF-sketch kernel (or
    its plain version on the CPU) on that device, whose full sketches are
    queried with prescreened=False. `query_dev`, the command's device, is
    where GROOT_DEVICE_QUERY=1 runs the query of a host-sketched batch."""
    if sketch_dev is not None:
        q64 = sketch_reads_u64(batch.codes, batch.lengths, k, s, sketch_dev)
        return info.db.query_batch_np(
            q64, kmer_counts, t, prescreened=False, device=sketch_dev
        )
    prescreen = _prescreen_for(info, batch, kmer_counts, t)
    q64 = native.sketch(batch.codes, batch.lengths, k, s, prescreen=prescreen)
    if q64 is None:
        prescreen = None
        q64 = nthash.khf_sketch_np_batch(batch.codes, batch.lengths, k, s)
    return info.db.query_batch_np(
        q64, kmer_counts, t, prescreened=prescreen is not None,
        device=query_dev,
    )


def _compute_hits(info, batch, kmer_counts, k, s, t, tables, sketch_dev,
                  query_dev="cpu"):
    """sketch -> LSH query -> sorted hit list for one padded batch."""
    rows, wins = _sketch_query(
        info, batch, kmer_counts, k, s, t, sketch_dev, query_dev
    )
    keep = rows < batch.n_valid
    return sort_hits(tables, rows[keep], wins[keep])


def _map_hits(batches, info, k, s, t, tables, batch_size, sketch_dev,
              query_dev, count):
    """Ingest-side stage for the async device engine: number each batch
    (`seq`, the id its spans carry), pad it to the pipeline shape and
    attach its hit list, so the main thread only runs the cascade
    submit/fetch. The per-batch prep (pad + sketch + LSH query + hit sort)
    runs on a small ordered worker pool, its seconds counted as `prep_s`
    through `count`; the sketch kernel launches from those threads on the
    current stream."""
    import collections
    from concurrent.futures import ThreadPoolExecutor

    def prep(batch):
        with obs.Timer("ingest.prep", batch.seq) as tm:
            if batch.n < batch_size:
                _pad_batch(batch, batch_size, k)
            kmer_counts = (batch.lengths - k + 1).astype(np.int32)
            if not (batch.lengths[: batch.n_valid] < k).any():
                batch._hits = _compute_hits(
                    info, batch, kmer_counts, k, s, t, tables, sketch_dev,
                    query_dev,
                )
        count("prep_s", tm.s)
        return batch

    workers = min(os.cpu_count() or 2, 2)
    pool = ThreadPoolExecutor(max_workers=workers)
    futs: "collections.deque" = collections.deque()
    try:
        for seq, batch in enumerate(batches):
            batch.seq = seq
            futs.append(pool.submit(prep, batch))
            while len(futs) > workers:
                yield futs.popleft().result()
        while futs:
            yield futs.popleft().result()
    finally:
        pool.shutdown(wait=False)


def _process_batch(
    info, batch, aligner, bam_writer, stats, k, s, t, tables=None, acc=None,
    sketch_dev=None, query_dev="cpu",
) -> None:
    """Sketch, query and align one padded batch on the calling thread (the
    pooled and sequential loops; the device engine has its own). Returns
    the `cascade` engine's pending collect (calls, batch, rows, wins,
    kmer counts), else None."""
    if (batch.lengths[: batch.n_valid] < k).any():
        short = int(batch.lengths[: batch.n_valid].min())
        raise ValueError(
            f"sequence length ({short}) is short than k-mer length ({k})"
        )
    kmer_counts = (batch.lengths - k + 1).astype(np.int32)

    if tables is not None:
        # flat-hit path: per-hit bookkeeping is numpy (batch_host) plus the
        # hash-join cascade
        rows, wins, combo_start = _compute_hits(
            info, batch, kmer_counts, k, s, t, tables, sketch_dev, query_dev
        )
        stats.received += batch.n_valid
        if len(rows):
            graphs_per_read = np.bincount(
                rows[combo_start], minlength=batch.n_valid
            )
            stats.mapped += int((graphs_per_read > 0).sum())
            stats.multimapped += int((graphs_per_read > 1).sum())
        kc_read = kmer_counts.astype(np.float64)
        if info.sketch.no_exact_align:
            if len(rows):
                acc.add_pairs(wins, kc_read[rows])
            return None
        if not hasattr(aligner, "process_batch"):  # cascade: collect later
            calls = aligner.submit_pairs(batch, rows, wins, combo_start)
            return (calls, batch, rows, wins, kc_read)
        aligner.process_batch(
            batch, rows, wins, combo_start, kc_read, acc, bam_writer, stats
        )
        return None

    # `host` engine: per-read {graph: [Key]} hits, grouped per graph (the
    # per-graph minion queues of boss.go:122-131 become a batch dimension);
    # unmapped reads never materialise FastqRead objects
    q64 = sketch_reads_u64(batch.codes, batch.lengths, k, s, sketch_dev)
    results = info.db.query_batch(q64, kmer_counts, t)
    per_graph: Dict[int, List] = {}
    for i, res in enumerate(results[: batch.n_valid]):
        stats.received += 1
        if not res:
            continue
        stats.mapped += 1
        if len(res) > 1:
            stats.multimapped += 1
        read = batch.read(i)
        for graph_id, mappings in res.items():
            per_graph.setdefault(graph_id, []).append(
                (read, mappings, float(kmer_counts[i]))
            )
    # one match-volume call for the whole batch, then each graph's cascade
    for results in aligner.align_graph_batches(per_graph).values():
        for records, _n in results:
            stats.alignment_count += len(records)
            if bam_writer is not None:
                for rec in records:
                    bam_writer.write(rec)
    return None


def prune_graphs(info: Info, min_kmer_coverage: float) -> List[str]:
    """GraphPruner equivalent (sketch.go:378-430). Returns kept path names."""
    kept_paths: List[str] = []
    kept: Store = {}
    counter = 0
    for g in info.store.values():
        counter += 1
        if g.prune(min_kmer_coverage):
            g.groot_version = info.version
            kept[g.graph_id] = g
            log.info(
                "\tgraph %d has %d remaining paths after weighting and pruning",
                g.graph_id,
                len(g.paths),
            )
            for pid in sorted(g.paths):
                log.info("\t- [%s]", g.paths[pid])
                kept_paths.append(g.paths[pid])
    if counter == 0:
        return kept_paths
    log.info("\ttotal number of graphs pruned: %d", counter)
    if not kept:
        log.info("\tno graphs remaining after pruning")
        info.store = {}
        return kept_paths
    log.info("\ttotal number of graphs remaining: %d", len(kept))
    log.info("\ttotal number of possible haplotypes found: %d", len(kept_paths))
    info.store = kept
    return kept_paths


def save_graphs(info: Info, graph_dir: str, total_kmers: int) -> None:
    """Write surviving weighted graphs as GFA (cmd/align.go:153-161)."""
    if not info.store:
        return
    os.makedirs(graph_dir, exist_ok=True)
    log.info("saving graphs...")
    for graph_id in sorted(info.store):
        file_name = os.path.join(graph_dir, f"groot-graph-{graph_id}.gfa")
        info.store[graph_id].save_gfa(file_name, total_kmers)
