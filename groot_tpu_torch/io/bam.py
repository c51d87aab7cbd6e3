"""BAM/BGZF writing and reading (host side).

A copy of groot_tpu/io/bam.py whose record type is the port's
align.aligner.AlignmentRecord. Reference: the boss's BAM setup/writing (src/pipeline/boss.go:45-105,
225-241, via biogo/hts) and the report stage's reader
(src/reporting/reporting.go:33-87). Header layout mirrors the
reference: @HD VN:1.5, @SQ per graph path, @PG groot, @RG readsID.

BAM record order in the reference depends on goroutine interleaving; parity
is defined order-canonicalized (sort by qname/ref/pos/flags — SURVEY §7 hard
part 4). We emit records in deterministic batch order.
"""

from __future__ import annotations

import struct
import time
import zlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

from ..align.aligner import AlignmentRecord
from ..version import get_version

# SAM flags
FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100

CIGAR_OPS = "MIDNSHP=X"
SEQ_NIBBLES = "=ACMGRSVTWYHKDBN"
NIB = {c: i for i, c in enumerate(SEQ_NIBBLES)}

import numpy as _np
import numpy as np

# ascii byte -> 4-bit code LUT (unknown bases -> N=15)
_NIB_LUT = _np.full(256, 15, dtype=_np.uint8)
for _c, _i in NIB.items():
    _NIB_LUT[ord(_c)] = _i


def _pack_seq(seq: bytes) -> bytes:
    """4-bit pack a sequence (vectorized, no per-base Python loop)."""
    nib = _NIB_LUT[_np.frombuffer(seq, dtype=_np.uint8)]
    if len(nib) % 2:
        nib = _np.append(nib, 0)
    return ((nib[0::2] << 4) | nib[1::2]).tobytes()


@dataclass
class Reference:
    name: str
    length: int
    ref_id: int = -1
    path_id: int = -1


class References(dict):
    """{graphID: [Reference]} plus a (graphID, pathID) -> Reference lookup."""

    def __init__(self):
        super().__init__()
        self.by_path: Dict[Tuple[int, int], Reference] = {}


def build_references(store) -> References:
    """GetSAMrefs equivalent (graphio.go:141-154): per graph, one reference
    per path (name, ungapped length). Global ref_ids assigned in sorted
    (graphID, pathID) order — deterministic where the reference iterates Go
    maps."""
    refs = References()
    counter = 0
    for graph_id in sorted(store):
        graph = store[graph_id]
        lst = []
        for pid in sorted(graph.paths):
            ref = Reference(
                name=graph.paths[pid],
                length=graph.lengths[pid],
                ref_id=counter,
                path_id=pid,
            )
            lst.append(ref)
            refs.by_path[(graph_id, pid)] = ref
            counter += 1
        refs[graph_id] = lst
    return refs


def header_text(references: Dict[int, List[Reference]]) -> str:
    lines = ["@HD\tVN:1.5"]
    for graph_id in sorted(references):
        for ref in references[graph_id]:
            lines.append(f"@SQ\tSN:{ref.name}\tLN:{ref.length}")
    lines.append(
        f"@PG\tID:1\tPN:groot\tCL:groot align\tVN:{get_version()}"
    )
    stamp = time.strftime("%Y-%m-%dT%H:%M:%S")
    lines.append(
        "@RG\tID:readsID\tPG:groot align\tPL:illumina\tSM:sampleID"
        f"\tPI:1000\tDT:{stamp}"
    )
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# BGZF
# ---------------------------------------------------------------------------
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def _bgzf_block(data: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    bsize = len(comp) + 25 + 1  # header(12) + XLEN extra(6) + comp + crc(4) + isize(4)
    header = struct.pack(
        "<BBBBIBBHBBHH",
        0x1F, 0x8B, 0x08, 0x04,  # gzip magic, deflate, FEXTRA
        0, 0, 0xFF,              # mtime, xfl, os
        6,                       # XLEN
        0x42, 0x43, 2,           # 'B' 'C', subfield len
        bsize - 1,
    )
    footer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
    return header + comp + footer


class BgzfWriter:
    """BGZF writer: block runs compress on a small thread pool (zlib and the
    native deflate release the GIL) and a writer thread streams the results
    to the file IN SUBMISSION ORDER — the reference's BAM goroutine analog
    (boss.go:225-241) with elastic parallel compression. Block boundaries
    are deterministic (every 0xFF00 bytes), so output bytes are identical
    to a synchronous writer."""

    def __init__(self, fh, workers: int = 2):
        self.fh = fh
        self._parts: List[bytes] = []
        self._size = 0
        from ..io import native

        self._native = native.bgzf_many if native.available() else None
        import queue
        import threading
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._wq: "queue.Queue" = queue.Queue(maxsize=16)
        self._err = None
        self._writer = threading.Thread(target=self._write_loop, daemon=True)
        self._writer.start()

    def _write_loop(self):
        while True:
            fut = self._wq.get()
            if fut is None:
                return
            try:
                self.fh.write(fut.result())
            except BaseException as e:  # surfaced on the next write/close
                self._err = e
                return

    def _compress(self, data):
        """Compress one run of complete blocks; returns any buffer-protocol
        object (bytes or a uint8 array straight from the native call)."""
        if isinstance(data, list):
            data = b"".join(data)  # memoryview parts join zero-surprise
        if self._native is not None:
            out = self._native(data)
            if out is not None:
                return out
        return b"".join(
            _bgzf_block(data[o : o + 0xFF00])
            for o in range(0, len(data), 0xFF00)
        )

    def _put(self, item):
        """Submit a block run for compression and enqueue its future for
        the ordered writer; re-checks _err while blocked so a dead writer
        (e.g. ENOSPC) surfaces as an exception instead of a permanent
        hang on the full queue."""
        import queue

        fut = self._pool.submit(self._compress, item)
        while True:
            if self._err is not None:
                raise self._err
            try:
                self._wq.put(fut, timeout=0.2)
                return
            except queue.Full:
                continue

    def write(self, data: bytes):
        if self._err is not None:
            raise self._err
        self._parts.append(data)
        self._size += len(data)
        if self._size < 0xFF00:
            return
        # hand ALL complete blocks off as ONE compression job (block
        # boundaries stay deterministic: every 0xFF00 bytes)
        split = (self._size // 0xFF00) * 0xFF00
        if split == self._size:
            self._put(self._parts if len(self._parts) > 1 else self._parts[0])
            self._parts, self._size = [], 0
            return
        # split the last part so the tail stays on this side
        run, acc = [], 0
        for i, part in enumerate(self._parts):
            if acc + len(part) <= split:
                run.append(part)
                acc += len(part)
            else:
                cut = split - acc
                if cut:
                    run.append(part[:cut])
                tail_parts = [part[cut:]] + self._parts[i + 1 :]
                break
        self._put(run if len(run) > 1 else run[0])
        self._parts = [p for p in tail_parts if p]
        self._size -= split

    def close(self):
        if self._err is not None:
            raise self._err
        import queue

        if self._size:
            self._put(b"".join(self._parts))
            self._parts, self._size = [], 0
        while True:  # same guarded enqueue as _put (writer may have died)
            if self._err is not None:
                break
            try:
                self._wq.put(None, timeout=0.2)
                break
            except queue.Full:
                continue
        self._writer.join()
        self._pool.shutdown(wait=True)
        if self._err is not None:
            raise self._err
        self.fh.write(BGZF_EOF)
        self.fh.flush()


# ---------------------------------------------------------------------------
# BAM writer
# ---------------------------------------------------------------------------
def reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


class BamWriter:
    """Streams AlignmentRecords to a BAM file/stdout."""

    def __init__(self, fh, references: Dict[int, List[Reference]]):
        self.bgzf = BgzfWriter(fh)
        self.references = references
        self.count = 0
        self._payload_cache = (None, b"", b"")
        text = header_text(references).encode()
        flat: List[Reference] = []
        for graph_id in sorted(references):
            flat.extend(references[graph_id])
        payload = struct.pack("<4sI", b"BAM\x01", len(text)) + text
        payload += struct.pack("<I", len(flat))
        for ref in flat:
            name = ref.name.encode() + b"\x00"
            payload += struct.pack("<I", len(name)) + name
            payload += struct.pack("<I", ref.length)
        self.bgzf.write(payload)

    def write(self, rec: AlignmentRecord):
        ref = self.references.by_path[(rec.graph_id, rec.path_id)]
        name = rec.name.encode() + b"\x00"
        l_seq = len(rec.seq)
        # seq/qual payloads are shared across a read's records (one per
        # matching path) — memoise by seq identity; the cache keeps the
        # bytes object itself alive so an id() can never be reused by a
        # later allocation while the entry is live
        cached = self._payload_cache
        if cached[0] is rec.seq:
            seq_nib, qual = cached[1], cached[2]
        else:
            seq_nib = _pack_seq(rec.seq)
            if rec.qual:
                q = _np.frombuffer(rec.qual[:l_seq], dtype=_np.uint8)
                qual = (
                    _np.maximum(q.astype(_np.int16) - 33, 0)
                    .astype(_np.uint8)
                    .tobytes()
                    .ljust(l_seq, b"\x00")
                )
            else:
                qual = b"\xff" * l_seq
            self._payload_cache = (rec.seq, seq_nib, qual)
        cigar: List[Tuple[int, int]] = []
        if rec.start_clip:
            cigar.append((rec.start_clip, 5))  # H
        cigar.append((l_seq, 0))  # M
        if rec.end_clip:
            cigar.append((rec.end_clip, 5))
        flag = 0
        if rec.reverse:
            flag |= FLAG_REVERSE
        if rec.secondary:
            flag |= FLAG_SECONDARY
        end = rec.pos + l_seq
        data = struct.pack(
            "<iiBBHHHiiii",
            ref.ref_id,
            rec.pos,
            len(name),
            rec.mapq,
            reg2bin(rec.pos, end),
            len(cigar),
            flag,
            l_seq,
            -1,
            -1,
            0,
        )
        parts = [data, name]
        for ln, op in cigar:
            parts.append(struct.pack("<I", (ln << 4) | op))
        parts.append(seq_nib)
        parts.append(qual)
        body = b"".join(parts)
        self.bgzf.write(struct.pack("<I", len(body)) + body)
        self.count += 1

    def write_raw(self, data, count: int) -> None:
        """Append pre-assembled BAM record bytes (gio_emit_records). The
        bytes stay a zero-copy view all the way to compression: numpy
        output -> memoryview part -> native bgzf (which reads through the
        buffer protocol); the part list keeps the backing array alive."""
        if not isinstance(data, (bytes, memoryview)):
            data = memoryview(data)
        self.bgzf.write(data)
        self.count += count

    def write_groups(
        self,
        name_buf,               # u8 cat of group names (no NUL, no '@')
        name_off, name_lens,    # i64 [G] into name_buf (length excl NUL)
        seq_buf,                # u8 cat of oriented+clipped bases (ASCII)
        seq_off, seq_len,       # i64 [G]
        qual_buf,               # u8 cat, same layout as seq_buf
        has_q,                  # bool [G] (False -> QUAL = 0xFF fill)
        group_ptr,              # i64 [G+1] record span per group
        ref_ids,                # i32 [N] per record
        poss,                   # i64 [N] per record
        reverse,                # bool [G] per group
        start_clips,            # i16 [G]
        end_clips,              # i16 [G]
    ) -> None:
        """Vectorized bulk record emission: one buffer assembly for a whole
        batch of alignment records (records within a group share the read's
        name/SEQ/QUAL and differ only in ref/pos/secondary flag), in place
        of the per-record write() path — the reference's BAM writer is a goroutine
        draining a channel (boss.go:225-241); here the batch IS the unit."""
        G = len(name_off)
        N = int(group_ptr[-1])
        if N == 0:
            return
        group_of = np.repeat(np.arange(G), np.diff(group_ptr))
        name_len = np.asarray(name_lens, np.int64) + 1  # + NUL
        seq_len = np.asarray(seq_len, np.int64)
        nib_len = (seq_len + 1) // 2
        ncig = 1 + (start_clips > 0) + (end_clips > 0)  # [G]

        # --- per-group byte payloads -------------------------------------
        # NUL-terminated name cat (zeros left in the gaps are the NULs)
        nbuf = np.zeros(int(name_len.sum()), dtype=np.uint8)
        noff = np.concatenate(([0], np.cumsum(name_len[:-1])))
        own = np.repeat(np.arange(G), name_len - 1)
        starts = np.concatenate(([0], np.cumsum(name_len[:-1] - 1)))
        loc = np.arange(int((name_len - 1).sum())) - starts[own]
        nbuf[noff[own] + loc] = name_buf[
            np.asarray(name_off, np.int64)[own] + loc
        ]
        name_buf, name_off = nbuf, noff

        seq_off = np.asarray(seq_off, np.int64)
        nib_all = _NIB_LUT[seq_buf]
        # pack nibbles per group (group-local even/odd pairing); each
        # destination byte is written once per parity class
        nib_buf = np.zeros(int(nib_len.sum()), dtype=np.uint8)
        nib_off = np.concatenate(([0], np.cumsum(nib_len[:-1])))
        base_grp = np.repeat(np.arange(G), seq_len)
        base_loc = np.arange(int(seq_len.sum())) - seq_off[base_grp]
        dst = nib_off[base_grp] + (base_loc >> 1)
        hi_mask = (base_loc & 1) == 0
        src_idx = seq_off[base_grp] + base_loc
        nib_buf[dst[hi_mask]] = nib_all[src_idx[hi_mask]] << 4
        lo_dst = dst[~hi_mask]
        nib_buf[lo_dst] = nib_buf[lo_dst] | nib_all[src_idx[~hi_mask]]
        # qual (0xff when a group has none)
        qual_out = np.maximum(
            qual_buf.astype(np.int16) - 33, 0
        ).astype(np.uint8)
        noq = ~np.asarray(has_q, bool)
        if noq.any():
            qual_out[src_idx[noq[base_grp]]] = 0xFF
        qual_buf = qual_out

        # --- per-record geometry -----------------------------------------
        r_name_len = name_len[group_of]
        r_seq_len = seq_len[group_of]
        r_nib_len = nib_len[group_of]
        r_ncig = ncig[group_of]
        body = 32 + r_name_len + 4 * r_ncig + r_nib_len + r_seq_len
        block = 4 + body
        off = np.concatenate(([0], np.cumsum(block)))
        total = int(off[-1])
        buf = np.zeros(total, dtype=np.uint8)

        # secondary flag: all but the first record of a multi-record group
        first = np.zeros(N, dtype=bool)
        first[group_ptr[:-1][np.diff(group_ptr) > 0]] = True
        multi = (np.diff(group_ptr) > 1)[group_of]
        flags = np.where(reverse[group_of], FLAG_REVERSE, 0) | np.where(
            multi & ~first, FLAG_SECONDARY, 0
        )

        poss = np.asarray(poss, dtype=np.int64)
        ends = poss + r_seq_len
        # reg2bin vectorized (all levels, pick the deepest match)
        beg, en = poss, ends - 1
        bins = np.zeros(N, dtype=np.uint16)
        for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
            m = (beg >> shift) == (en >> shift)
            bins = np.where(m, (base + (beg >> shift)).astype(np.uint16), bins)

        hdr = np.zeros((N, 36), dtype=np.uint8)
        hv = hdr.view(np.uint32)
        hv[:, 0] = body.astype(np.uint32)
        hv[:, 1] = np.asarray(ref_ids, np.int64).astype(np.uint32)
        hv[:, 2] = poss.astype(np.uint32)
        hv[:, 3] = (
            r_name_len | (30 << 8) | (bins.astype(np.uint32) << 16)
        ).astype(np.uint32)
        hv[:, 4] = (r_ncig | (flags.astype(np.uint32) << 16)).astype(np.uint32)
        hv[:, 5] = r_seq_len.astype(np.uint32)
        hv[:, 6] = np.uint32(0xFFFFFFFF)  # next_refID = -1
        hv[:, 7] = np.uint32(0xFFFFFFFF)  # next_pos = -1
        hv[:, 8] = 0                      # tlen

        from ..io import native

        g_cs32 = start_clips[group_of].astype(np.uint32)
        g_ce32 = end_clips[group_of].astype(np.uint32)
        seq32 = r_seq_len.astype(np.uint32)
        # compact cigar rows: [H(cs)] M [H(ce)] shifted to the row start
        has_cs = g_cs32 > 0
        has_ce = g_ce32 > 0
        cigc = np.zeros((N, 3), dtype=np.uint32)
        cigc[:, 0] = np.where(has_cs, (g_cs32 << 4) | 5, (seq32 << 4))
        cigc[:, 1] = np.where(
            has_cs, (seq32 << 4), np.where(has_ce, (g_ce32 << 4) | 5, 0)
        )
        cigc[:, 2] = np.where(has_cs & has_ce, (g_ce32 << 4) | 5, 0)
        filled = native.bam_fill(
            off[:-1], hv, name_off[group_of], r_name_len, name_buf,
            cigc, r_ncig.astype(np.uint8),
            nib_off[group_of], r_nib_len, nib_buf,
            seq_off[group_of], r_seq_len, qual_buf,
            total,
        )
        if filled is not None:
            self.bgzf.write(filled.tobytes())
            self.count += N
            return

        idx36 = off[:-1, None] + np.arange(36)[None, :]
        buf[idx36.reshape(-1)] = hdr.reshape(-1)

        def scatter_var(dst_start, src_start, lens, src_buf):
            tot = int(lens.sum())
            if tot == 0:
                return
            own = np.repeat(np.arange(N), lens)
            starts = np.concatenate(([0], np.cumsum(lens[:-1])))
            loc = np.arange(tot) - starts[own]
            buf[dst_start[own] + loc] = src_buf[src_start[own] + loc]

        cur = off[:-1] + 36
        scatter_var(cur, name_off[group_of], r_name_len, name_buf)
        cur = cur + r_name_len

        # cigar: H(start) M H(end), little-endian u32 per op
        cig = np.zeros((N, 3), dtype=np.uint32)
        valid = np.zeros((N, 3), dtype=bool)
        g_cs = start_clips[group_of].astype(np.uint32)
        g_ce = end_clips[group_of].astype(np.uint32)
        cig[:, 0] = (g_cs << 4) | 5
        valid[:, 0] = g_cs > 0
        cig[:, 1] = (r_seq_len.astype(np.uint32) << 4) | 0
        valid[:, 1] = True
        cig[:, 2] = (g_ce << 4) | 5
        valid[:, 2] = g_ce > 0
        cig_src = cig[valid].view(np.uint8)  # row-major valid ops, LE bytes
        cig_start = np.concatenate(([0], np.cumsum(4 * r_ncig[:-1])))
        scatter_var(cur, cig_start, 4 * r_ncig, cig_src)
        cur = cur + 4 * r_ncig

        scatter_var(cur, nib_off[group_of], r_nib_len, nib_buf)
        cur = cur + r_nib_len
        scatter_var(cur, seq_off[group_of], r_seq_len, qual_buf)

        self.bgzf.write(buf.tobytes())
        self.count += N

    def close(self):
        self.bgzf.close()


# ---------------------------------------------------------------------------
# BAM reader (report stage)
# ---------------------------------------------------------------------------
@dataclass
class BamRecord:
    name: str
    ref_id: int
    pos: int
    mapq: int
    flag: int
    cigar: List[Tuple[int, int]]  # (len, op-index)
    seq_len: int

    @property
    def unmapped(self) -> bool:
        return self.flag == FLAG_UNMAPPED

    def aln_len(self) -> int:
        """Alignment length on the reference (biogo Record.Len): sum of
        M/D/N/=/X cigar ops."""
        total = 0
        for ln, op in self.cigar:
            if CIGAR_OPS[op] in "MDN=X":
                total += ln
        return total


def bgzf_decompress(raw, as_array: bool = False):
    """Decompress a BGZF stream by walking the BSIZE fields: one zlib
    inflate per block into a preallocated buffer. gzip.decompress degrades
    to O(n^2) on multi-member streams (it re-slices the remaining input per
    member); this walk is linear. Falls
    back to gzip.decompress for non-BGZF gzip input. ``raw`` may be bytes
    or an mmap; with as_array=True the native path returns a uint8 array
    (no copy-out) — callers must then treat the result as a buffer."""
    import gzip as _gzip

    if raw[:4] != b"\x1f\x8b\x08\x04":
        return _gzip.decompress(raw)
    n = len(raw)
    off = 0
    blocks: List[Tuple[int, int, int]] = []  # (comp_off, comp_len, isize)
    total = 0
    while off < n:
        if raw[off : off + 4] != b"\x1f\x8b\x08\x04" or off + 12 > n:
            return _gzip.decompress(raw)
        xlen = int.from_bytes(raw[off + 10 : off + 12], "little")
        xo = off + 12
        end_x = xo + xlen
        bsize = None
        while xo + 4 <= end_x:
            slen = int.from_bytes(raw[xo + 2 : xo + 4], "little")
            if raw[xo] == 0x42 and raw[xo + 1] == 0x43 and slen == 2:
                bsize = int.from_bytes(raw[xo + 4 : xo + 6], "little") + 1
            xo += 4 + slen
        if bsize is None or off + bsize > n or bsize < 12 + xlen + 8:
            return _gzip.decompress(raw)
        isize = int.from_bytes(raw[off + bsize - 4 : off + bsize], "little")
        comp_off = off + 12 + xlen
        blocks.append((comp_off, bsize - 12 - xlen - 8, isize))
        total += isize
        off += bsize
    from ..io import native as _native

    if blocks:
        import numpy as _np

        arr = _np.asarray(blocks, dtype=_np.int64)
        res = _native.inflate_blocks(
            raw, arr[:, 0], arr[:, 1], arr[:, 2], total
        )
        if res is not None:
            return res if as_array else res.tobytes()
    out = bytearray(total)
    mv = memoryview(raw)
    pos = 0
    for o, clen, isize in blocks:
        if isize:
            out[pos : pos + isize] = zlib.decompress(
                mv[o : o + clen], -15, isize
            )
            pos += isize
    return bytes(out)


def parse_bam_header(data) -> Tuple[List[Reference], int]:
    """Parse a decompressed BAM header (any bytes-like buffer); returns
    (refs, record offset)."""
    off = 0
    magic, l_text = struct.unpack_from("<4sI", data, off)
    if magic != b"BAM\x01":
        raise ValueError("not a BAM file")
    off += 8 + l_text
    (n_ref,) = struct.unpack_from("<I", data, off)
    off += 4
    refs: List[Reference] = []
    for i in range(n_ref):
        (l_name,) = struct.unpack_from("<I", data, off)
        off += 4
        name = bytes(data[off : off + l_name - 1]).decode()
        off += l_name
        (l_ref,) = struct.unpack_from("<I", data, off)
        off += 4
        refs.append(Reference(name=name, length=l_ref, ref_id=i))
    return refs, off


def read_bam(path_or_fh) -> Tuple[List[Reference], Iterator[BamRecord]]:
    if isinstance(path_or_fh, str):
        raw = open(path_or_fh, "rb").read()
    else:
        raw = path_or_fh.read()
    data = bgzf_decompress(raw)
    refs, off = parse_bam_header(data)

    def records():
        o = off
        while o < len(data):
            (block_size,) = struct.unpack_from("<I", data, o)
            o += 4
            (
                ref_id,
                pos,
                l_name,
                mapq,
                _bin,
                n_cigar,
                flag,
                l_seq,
                _nref,
                _npos,
                _tlen,
            ) = struct.unpack_from("<iiBBHHHiiii", data, o)
            p = o + 32
            name = data[p : p + l_name - 1].decode()
            p += l_name
            cigar = []
            for _ in range(n_cigar):
                (v,) = struct.unpack_from("<I", data, p)
                cigar.append((v >> 4, v & 0xF))
                p += 4
            o += block_size
            yield BamRecord(
                name=name,
                ref_id=ref_id,
                pos=pos,
                mapq=mapq,
                flag=flag,
                cigar=cigar,
                seq_len=l_seq,
            )

    return refs, records()
