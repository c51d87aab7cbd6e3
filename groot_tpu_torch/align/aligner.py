"""Exact graph alignment over match volumes (the `host` engine).

Counterpart of groot_tpu/align/aligner.py. Reference: GrootGraph.AlignRead
(src/graph/alignment.go) runs a hierarchical cascade per (read,
seed-mapping):

  1. exact alignment with seed offset shuffling 0..MergeSpan+WindowSize
  2. seed-node shuffling over the window's ContainedNodes, offsets 0..10
  3. hard-clip 1 base from the read start (MaxClip=1, alignment.go:16)
  4. hard-clip 1 base from the read end

where "exact alignment" is a recursive DFS over the variation graph matching
the read byte-for-byte ('N' in the graph matches anything). For the
block-structured DAGs groot builds from MSAs, a DFS traversal whose nodes
all belong to path p is a contiguous segment of p's linear sequence, so the
cascade becomes lookups into a boolean match volume

    M[r, p, o] = read r matches path p starting at offset o

computed for a whole read batch, every graph it touches, by ONE call of
`match_bits_batch` from u8 codes: the store's path rows stay on the
aligner's device from first use, each batch sends its reads' forward codes
and a pair table (graph, read) once, and the six variants of a pair (fwd |
rc) x (full | clip-start | clip-end) are derived where the bits are made.
On a card that is one launch of the match-bits kernel (csrc/match_bits.cu:
bit planes of each path row, ANDed along each read variant) and one copy
of the bits back into a pinned buffer; on the CPU its plain version
`match_bits_batch_torch`, which runs `match_bits_torch`, the reference's
one-hot cross-correlation (`_match_bits`), a graph at a time:

    count[r, p, o] = sum_j onehot5(read)[r, j, :] . onehot5(path)[p, o+j, :]
    M = (count == effective_read_len)

`match_bits` is the one-graph form with explicit variant rows, through the
same kernel.

Path 'N' and padding are wildcard rows (all ones), so graph Ns match
anything and matches may run past a path's end; those are kept only when the
path's terminal node has no out-edges (the dead-end partial traversal,
alignment.go:229).
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .._build import I, I64, Kernel, P, card_query, ptr, resolve_device
from ..graph.grootgraph import GrootGraph
from ..graph.pack import pack_graph_paths
from ..io.fastx import FastqRead
from ..ops.nthash import ASCII_TO_CODE, CODE_TO_ASCII, RC_CODE_NP

MAX_CLIP = 1  # alignment.go:16
NODE_SHUFFLES = 10  # alignment.go:52

MATCH_BITS = Kernel(
    "match_bits", "groot_match_bits",
    (P, P, P, P, P, I, P, P, P, P, I, I, I, I, I, I64, P, P),
    source="groot_tpu_torch/csrc/match_bits.cu",
    replaces="groot_tpu/align/aligner.py:121",
)
# a kernel block's share of a launch: (variant, word) items it aims at (the
# fastest of 128-2,048 at the host engine's batches, match_bits_timing.py),
# the most output words of one path row it covers (longer rows split) and
# the most bytes of reads it stages in shared memory
ITEMS_PER_BLOCK = 1024
MAX_BLOCK_WORDS = 1024
MAX_STAGED_BYTES = 32 * 1024


@dataclass
class AlignmentRecord:
    """One SAM/BAM alignment line (built by AlignRead, alignment.go:113-158)."""

    name: str
    graph_id: int
    path_id: int
    pos: int
    seq: bytes
    qual: bytes
    start_clip: int
    end_clip: int
    reverse: bool
    secondary: bool
    mapq: int = 30


class _GraphPack:
    """Per-graph static arrays for alignment."""

    def __init__(self, graph: GrootGraph):
        packed = pack_graph_paths(graph)
        self.packed = packed
        self.path_ids = packed.path_ids
        self.lengths = packed.lengths
        # node -> per-path start positions and membership
        self.node_pos: Dict[int, Dict[int, int]] = {}
        self.node_len: Dict[int, int] = {}
        for node in graph.sorted_nodes:
            self.node_pos[node.segment_id] = dict(node.position)
            self.node_len[node.segment_id] = len(node.sequence)
        # terminal-node-has-no-out-edges per path (dead-end partial case)
        self.terminal_free: Dict[int, bool] = {}
        for pid in self.path_ids:
            nodes = graph.path_nodes(pid)
            self.terminal_free[pid] = len(nodes[-1].out_edges) == 0 if nodes else False


def path_onehot(codes: torch.Tensor) -> torch.Tensor:
    """u8 path codes [P, L] -> float32 [P, L, 5] one-hots; an N or pad
    (code >= 4) is a wildcard row of all ones: it matches anything."""
    c = codes.long()
    wild = c >= 4
    return torch.stack([(c == b) | wild for b in range(4)] + [wild], dim=-1).float()


@contextlib.contextmanager
def exact_conv():
    """cuDNN's TF32 off for the block, then the caller's setting back: a
    match count is an exact integer below 2^24 in float32 only without
    TF32's 10-bit mantissa."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _match_bits(
    path_oh: torch.Tensor, kernels: torch.Tensor, eff_len: torch.Tensor
) -> np.ndarray:
    """path_oh [P, Lp, 5] f32; kernels [K, Lr, 5] f32; eff_len [K] int.
    Returns packed match bits u32 [K, P, ceil(W/32)] where W = Lp - Lr + 1
    and bit o of word w is the match at offset w*32+o. Counts are exact
    integers below 2^24 in float32, so TF32 stays off for the conv."""
    with exact_conv():
        counts = torch.nn.functional.conv1d(
            path_oh.permute(0, 2, 1), kernels.permute(0, 2, 1)
        )  # [P, K, W]
    match = (counts == eff_len.to(counts.dtype)[None, :, None]).permute(1, 0, 2)
    K, P, W = match.shape
    W32 = -(-W // 32)
    match = torch.nn.functional.pad(match, (0, W32 * 32 - W))
    shifts = torch.arange(32, device=match.device, dtype=torch.int64)
    words = (match.reshape(K, P, W32, 32).long() << shifts).sum(-1)
    return words.cpu().numpy().astype(np.uint32)


def match_bits_torch(path_codes: torch.Tensor, var_codes: torch.Tensor,
                     var_len: torch.Tensor) -> torch.Tensor:
    """The plain version of `match_bits`: the one-hots of the codes (a
    variant's rows at and past var_len zero, a read N its column 4), then
    the reference's correlation `_match_bits`, on the inputs' device."""
    dev = path_codes.device
    (P, Lp), (K, Lr) = path_codes.shape, var_codes.shape
    W32 = -(-(Lp - Lr + 1) // 32)
    if not (P and K):
        return torch.zeros((K, P, W32), dtype=torch.int32, device=dev).view(torch.uint32)
    live = torch.arange(Lr, device=dev)[None, :] < var_len[:, None].long()
    kern = torch.nn.functional.one_hot(var_codes.long().clamp(max=4), 5).float()
    bits = _match_bits(path_onehot(path_codes), kern * live[..., None], var_len)
    return torch.from_numpy(bits.view(np.int32)).to(dev).view(torch.uint32)


def match_bits(path_codes: torch.Tensor, var_codes: torch.Tensor,
               var_len: torch.Tensor) -> torch.Tensor:
    """Packed match volumes: u8 path codes [P, Lp] (pad = 4), u8 variant
    codes [K, Lr] (N = 4), int32 var_len [K] (the variant's real bases: 0
    matches at every offset, below 0 or above Lr never) -> u32 [K, P,
    ceil(W/32)], W = Lp - Lr + 1, bit o of word w the match at offset
    32w + o, as `_match_bits` gives it on the one-hots. A CPU tensor takes
    the plain version; a CUDA tensor launches the match-bits kernel, or
    raises."""
    if path_codes.dtype != torch.uint8 or path_codes.dim() != 2:
        raise TypeError(f"path_codes must be uint8 [P, Lp], got {path_codes.dtype} "
                        f"{tuple(path_codes.shape)}")
    if var_codes.dtype != torch.uint8 or var_codes.dim() != 2:
        raise TypeError(f"var_codes must be uint8 [K, Lr], got {var_codes.dtype} "
                        f"{tuple(var_codes.shape)}")
    (P, Lp), (K, Lr) = path_codes.shape, var_codes.shape
    if var_len.dtype != torch.int32 or var_len.shape != (K,):
        raise TypeError("var_len must be int32 [K]")
    dev = path_codes.device
    if var_codes.device != dev or var_len.device != dev:
        raise ValueError("path_codes, var_codes and var_len must be on one device")
    if not 1 <= Lr <= Lp:
        raise ValueError(f"variant width {Lr}: want 1 .. the path width {Lp}")
    # one segment: the rows as they are, each variant its own "read"
    bits, _off = match_bits_batch(
        path_codes.contiguous().view(-1), np.arange(P, dtype=np.int64) * Lp,
        np.full(P, Lp, np.int32), var_codes.contiguous(), var_len.contiguous(),
        np.arange(K, dtype=np.int32), [(0, K, 0, P, Lp - Lr + 1)], nvar=1)
    return bits.view(K, P, -(-(Lp - Lr + 1) // 32))


def variant_rows(reads: torch.Tensor, read_len: torch.Tensor):
    """The six variants of each read as the kernel derives them: u8 reads
    [R, Lr] (N = 4, the columns at and past read_len 4) and int32 read_len
    [R] (<= Lr) -> u8 variant codes [6R, Lr] and int32 var_len [6R], read r's
    variants at rows 6r .. 6r + 5: (fwd | rc) x (full | clip-start: read[1:]
    | clip-end: read[:len-1]), rc[j] = comp(read[len-1-j]) with N staying
    N; lengths len, len - 1, len - 1."""
    R, Lr = reads.shape
    dev = reads.device
    fwd = reads.long().clamp(max=4)
    n = read_len.long()[:, None]
    src = n - 1 - torch.arange(Lr, device=dev)[None, :]
    comp = torch.tensor([3, 2, 1, 0, 4], device=dev)
    rc = torch.where((src >= 0) & (src < Lr),
                     comp[fwd.gather(1, src.clamp(0, Lr - 1))], 4)
    var = torch.full((R, 2, 3, Lr), 4, dtype=torch.uint8, device=dev)
    for o, cs in enumerate((fwd, rc)):
        var[:, o, 0] = cs
        var[:, o, 1, :-1] = cs[:, 1:]
        var[:, o, 2] = cs  # its last real base lies past var_len
    var_len = torch.cat([n, n - 1, n - 1] * 2, 1)
    return var.reshape(R * 6, Lr), var_len.reshape(R * 6).int()


def segment_inputs(rows, row_off, row_len, reads, read_len, pairs, seg, nvar: int):
    """The one-graph `match_bits` inputs of segment `seg` = (first pair,
    pairs, first row, rows, W) of a `match_bits_batch` call (tensors on
    one device): path codes u8 [P, W - 1 + Lr] (a row's codes, N past its
    end), variant codes u8 [nvar * pairs, Lr] and var_len int32."""
    pair0, n, row0, n_rows, W = (int(v) for v in seg)
    dev = rows.device
    Lp = W - 1 + reads.shape[1]
    col = torch.arange(Lp, device=dev)[None, :]
    off = row_off[row0:row0 + n_rows].long()[:, None]
    live = col < row_len[row0:row0 + n_rows].long()[:, None]
    path = torch.full((n_rows, Lp), 4, dtype=torch.uint8, device=dev)
    path[live] = rows[(off + col)[live]]
    pr = pairs[pair0:pair0 + n].long()
    if nvar == 6:
        return (path, *variant_rows(reads[pr], read_len[pr]))
    return path, reads[pr], read_len[pr]


def match_bits_batch_torch(rows, row_off, row_len, reads, read_len, pairs,
                           segs, nvar: int = 6) -> torch.Tensor:
    """The plain version of `match_bits_batch` (its arguments as tensors on
    one device): `match_bits_torch` on each segment's `segment_inputs`,
    the bits of the segments one after another, u32."""
    out = [match_bits_torch(*segment_inputs(rows, row_off, row_len, reads,
                                            read_len, pairs, seg, nvar))
           .view(torch.int32).reshape(-1)
           for seg in np.asarray(segs, np.int64).reshape(-1, 5)]
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=rows.device).view(torch.uint32)
    return torch.cat(out).view(torch.uint32)


def _seg_max(values: np.ndarray, start: np.ndarray, count: np.ndarray) -> np.ndarray:
    """The largest of values[start:start + count] for each segment (0 where
    count is 0)."""
    out = np.zeros(len(start), np.int64)
    live = count > 0
    if live.any():
        c = count[live].astype(np.int64)
        first = np.cumsum(c) - c
        idx = np.repeat(start[live] - first, c) + np.arange(int(c.sum()))
        out[live] = np.maximum.reduceat(np.asarray(values, np.int64)[idx], first)
    return out


def staged_bases(segs: np.ndarray, Lr: int, read_len: np.ndarray,
                 pairs: np.ndarray, row_len: np.ndarray) -> np.ndarray:
    """The bases of each read code row a kernel block stages, per segment
    (int64 [S]): the batch's width Lr, cut to the segment's longest read
    and its longest path row + 1, at least 1. Past a row's end every
    position is a wildcard, so bases past a row's length + 1 (the + 1 for
    clip-start, whose bases start at the read's second) can never fail to
    match."""
    pair0, n, row0, n_rows, _W = segs.T
    longest_read = _seg_max(np.asarray(read_len)[np.asarray(pairs)], pair0, n)
    longest_row = _seg_max(row_len, row0, n_rows)
    return np.clip(np.minimum(longest_read, longest_row + 1), 1, Lr)


def work_table(segs: np.ndarray, nvar: int, ls: np.ndarray, items: int,
               max_words: int, limit: int):
    """The kernel's launch layout for segments `segs` (int64 [S, 5]: first
    pair, pairs, first row, rows, W) whose blocks stage `ls` bases of each
    read code row (`staged_bases`): one block a (segment, path row, group
    of pairs, chunk of at most `max_words` output words), groups and chunks
    balanced and sized to about `items` (variant, word) items a block and
    at most MAX_STAGED_BYTES of staged codes (or one pair). A block takes
    5 x 4 bytes of planes a word of its chunk + ceil(ls/32) and its staged
    codes; the segments whose blocks fit `limit` bytes of shared memory
    take the shared route, the others the global route (a scratch slice a
    block). Returns the segment table int32 [S, 9] (first pair, pairs,
    first row, rows, W, W32, pairs a block, words a block, ls), the work
    table int32 [blocks, 4] (segment, row within it, first pair, first
    word: the shared route's blocks first), the shared route's block
    count, the most bytes one of its blocks takes, and the global route's
    slice bytes (the most one of its blocks takes, a multiple of 16; 0
    when none)."""
    pair0, n, row0, n_rows, W = segs.T
    ls = np.asarray(ls, np.int64)
    W32 = -(-W // 32)
    n_chunks = -(-W32 // max_words)
    WC = -(-W32 // np.maximum(n_chunks, 1))
    nc = 2 if nvar == 6 else 1
    PG = np.maximum(np.minimum(items // (nvar * np.maximum(WC, 1)),
                               MAX_STAGED_BYTES // (nc * ls)), 1)
    n_groups = -(-n // PG)
    PG = -(-n // np.maximum(n_groups, 1))
    nbytes = 4 * 5 * (WC + -(-ls // 32)) + PG * nc * ls
    per = n_rows * n_groups * n_chunks
    live = per > 0
    shared = nbytes <= limit
    order = np.concatenate([np.flatnonzero(shared), np.flatnonzero(~shared)])
    seg = np.repeat(order, per[order])
    local = np.arange(len(seg)) - np.repeat(np.cumsum(per[order]) - per[order], per[order])
    chunk = local % n_chunks[seg]
    t = local // n_chunks[seg]
    work = np.stack([seg, t // n_groups[seg], t % n_groups[seg] * PG[seg],
                     chunk * WC[seg]], 1).astype(np.int32)
    seg_tab = np.stack([pair0, n, row0, n_rows, W, W32, PG, WC, ls], 1).astype(np.int32)
    n_shared = int(per[shared].sum())
    smem = int(nbytes[shared & live].max(initial=0))
    slice_bytes = -(-int(nbytes[~shared & live].max(initial=0)) // 16) * 16
    return seg_tab, work, n_shared, smem, slice_bytes


def _on_device(dev: torch.device, arrays):
    """numpy arrays -> tensors on `dev` (tensors pass through): on a card
    ONE pinned staging buffer and ONE host-to-device copy, each array a
    view at a 16-byte aligned offset of it."""
    if dev.type != "cuda":
        return [torch.as_tensor(a) for a in arrays]
    host = [a for a in arrays if isinstance(a, np.ndarray)]
    offs, n = [], 0
    for a in host:
        offs.append(n)
        n += -(-a.nbytes // 16) * 16
    stage = torch.empty(max(n, 16), dtype=torch.uint8, pin_memory=True)
    buf = stage.numpy()
    for a, o in zip(host, offs):
        buf[o:o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    moved = stage.to(dev, non_blocking=True)
    views = iter(moved[o:o + a.nbytes].view(torch.from_numpy(a[:0].copy()).dtype)
                 .view(a.shape) for a, o in zip(host, offs))
    return [next(views) if isinstance(a, np.ndarray) else a for a in arrays]


def match_bits_batch(rows, row_off, row_len, reads, read_len, pairs, segs,
                     nvar: int = 6, shared_limit: Optional[int] = None):
    """Packed match volumes of many graphs at once. The path rows: u8 codes
    `rows` (flat; its device is the call's), row r at row_off[r] (int64)
    with row_len[r] bases (int32), a position at or past its end a
    wildcard. The reads: u8 [R, Lr] (N = 4) and int32 read_len [R]; pairs:
    int32 read rows; segs: one (first pair, pairs, first row, rows, W) a
    graph. nvar 6 derives each pair's six variants (`variant_rows`; needs
    read_len <= Lr), nvar 1 takes the read itself with var_len = read_len
    (0 matches everywhere, below 0 or above Lr nowhere). Every argument but
    `rows` and `segs` may be a numpy array (copied to the device with the
    launch layout in one copy) or a tensor on rows' device. Returns u32
    bits (segment s: [pairs, nvar, rows, ceil(W/32)] at words out_off[s],
    bit b of word w the match at offset 32w + b, none at offsets >= W) on
    the device and out_off int64 [S + 1] on the host. A CPU `rows` takes
    the plain version; a CUDA one launches the match-bits kernel once, or
    raises. A segment whose blocks take more than `shared_limit` bytes of
    shared memory (default: what the card lets the kernel's blocks take)
    goes to the kernel's global route."""
    dev = rows.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    if rows.dtype != torch.uint8 or rows.dim() != 1:
        raise TypeError(f"rows must be flat uint8, got {rows.dtype} {tuple(rows.shape)}")
    if str(reads.dtype) not in ("uint8", "torch.uint8") or reads.ndim != 2:
        raise TypeError(f"reads must be uint8 [R, Lr], got {reads.dtype}")
    if nvar not in (1, 6):
        raise ValueError(f"nvar {nvar}: want 1 or 6")
    Lr = int(reads.shape[1])
    segs = np.asarray(segs, np.int64).reshape(-1, 5)
    if Lr < 1 or (segs[:, 4] < 1).any():
        raise ValueError("want reads of width >= 1 and every W >= 1")
    if nvar == 6 and isinstance(read_len, np.ndarray) and (read_len > Lr).any():
        raise ValueError(f"a read longer than the read width {Lr}")
    sizes = segs[:, 1] * nvar * segs[:, 3] * -(-segs[:, 4] // 32)
    out_off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    if dev.type == "cpu":
        return match_bits_batch_torch(
            rows, *_on_device(dev, [row_off, row_len, reads, read_len, pairs]),
            segs, nvar), out_off
    ls = staged_bases(segs, Lr, *(_host(a) for a in (read_len, pairs, row_len)))
    limit, max_slices = match_limits(str(dev))
    seg_tab, work, n_shared, smem, slice_bytes = work_table(
        segs, nvar, ls, ITEMS_PER_BLOCK, MAX_BLOCK_WORDS,
        limit if shared_limit is None else min(shared_limit, limit))
    args = _on_device(dev, [row_off, row_len, reads, read_len, pairs, seg_tab,
                            out_off[:-1], work])
    for a, dt in zip(args, (torch.int64, torch.int32, torch.uint8, torch.int32,
                            torch.int32)):
        if a.device != dev or a.dtype != dt or not a.is_contiguous():
            raise TypeError(f"want a contiguous {dt} on {dev}, got {a.dtype} on {a.device}")
    out = torch.empty(int(out_off[-1]), dtype=torch.int32, device=dev)
    n_global = len(work) - n_shared
    slices = min(n_global, max_slices)
    scratch = torch.empty(slices * slice_bytes, dtype=torch.uint8, device=dev)
    if len(work):
        MATCH_BITS.launch(dev, ptr(rows), *(ptr(a) for a in args[:4]), Lr,
                          *(ptr(a) for a in args[4:]), n_shared, n_global, nvar,
                          smem, slices, slice_bytes, ptr(scratch) if slices else None,
                          ptr(out))
    return out.view(torch.uint32), out_off


@functools.lru_cache(maxsize=None)
def match_limits(device: str) -> Tuple[int, int]:
    """(the shared memory a block of the kernel's shared route may take,
    the global route's blocks) on `device`, as csrc/match_bits.cu works
    them out."""
    return (card_query(device, "groot_match_bits_smem_limit"),
            card_query(device, "groot_match_bits_global_blocks"))


def _host(a) -> np.ndarray:
    """A numpy array, or a tensor's values copied to the host."""
    return a if isinstance(a, np.ndarray) else a.cpu().numpy()


class GraphAligner:
    """Batched exact aligner over all graphs in a store; the match volumes
    are computed on `device` ("cuda" without a card raises)."""

    def __init__(
        self, store: Dict[int, GrootGraph], references=None, device="cuda"
    ):
        self.store = store
        self.device = resolve_device(device)
        self._packs: Dict[int, _GraphPack] = {}
        self._rows = None  # the store's path rows on the device (first use)
        self._row_index: Dict[int, Tuple[int, int, int]] = {}
        self._pinned: Optional[torch.Tensor] = None  # bits back from a card

    def pack(self, graph: GrootGraph) -> _GraphPack:
        gp = self._packs.get(graph.graph_id)
        if gp is None:
            gp = _GraphPack(graph)
            self._packs[graph.graph_id] = gp
        return gp

    def path_rows(self):
        """(rows, row_off, row_len) of every graph of the store, made once,
        on first use: each path row's real bases, one after another
        (`match_bits_batch`'s path rows), the codes and offsets copied to
        the aligner's device once, the lengths kept on the host (the
        wrapper sizes its blocks by them and uploads them with each batch's
        layout); `_row_index[graph_id]` = (first row, rows, width L)."""
        if self._rows is None:
            codes, lens = [], []
            for gid in sorted(self.store):
                packed = self.pack(self.store[gid]).packed
                P, L = packed.codes.shape
                self._row_index[gid] = (sum(len(n) for n in lens), P, L)
                live = np.arange(L)[None, :] < packed.lengths[:, None]
                codes.append(packed.codes[live])
                lens.append(packed.lengths)
            lens = np.concatenate(lens or [np.zeros(0, np.int32)]).astype(np.int32)
            row_off = (np.cumsum(lens) - lens).astype(np.int64)
            flat = np.concatenate(codes or [np.zeros(0, np.uint8)])
            self._rows = (*_on_device(self.device, [flat, row_off]), lens)
        return self._rows

    # ------------------------------------------------------------------
    def align_read(
        self,
        graph: GrootGraph,
        read: FastqRead,
        mappings: List,
        kmer_count: float,
    ) -> Tuple[List[AlignmentRecord], int]:
        """Single-read convenience wrapper over align_read_batch."""
        out = self.align_read_batch(graph, [(read, mappings, kmer_count)])
        return out[0]

    def align_read_batch(
        self, graph: GrootGraph, items: List[Tuple[FastqRead, List, float]]
    ) -> List[Tuple[List[AlignmentRecord], int]]:
        """`align_graph_batches` for the reads seeded to one graph."""
        return self._align_graphs([(graph, items)])[0]

    def align_graph_batches(
        self, per_graph: Dict[int, List[Tuple[FastqRead, List, float]]]
    ) -> Dict[int, List[Tuple[List[AlignmentRecord], int]]]:
        """graphMinion semantics (graphminion.go:46-102) for a read batch,
        {graph_id: [(read, mappings, kmer count)]}: per graph, in the dict's
        order, and per read, in item order, weight then try to align each
        mapping (fwd then RC); the first successful mapping wins and later
        mappings are neither weighted nor aligned. One `match_bits_batch`
        call covers every graph x read x orientation x clip-variant; the
        cascade itself is host bit tests. Returns {graph_id: [(records,
        mappings weighted)]} in the same order."""
        groups = [(self.store[gid], items) for gid, items in per_graph.items()]
        return dict(zip(per_graph, self._align_graphs(groups)))

    def _align_graphs(self, groups):
        vols = self._match_volumes(
            [(self.pack(graph), [it[0] for it in items]) for graph, items in groups])
        return [self._align_items(graph, items, bits)
                for (graph, items), bits in zip(groups, vols)]

    def _align_items(self, graph, items, bits):
        gp = self.pack(graph)
        out: List[Tuple[List[AlignmentRecord], int]] = []
        for r, (read, mappings, kmer_count) in enumerate(items):
            Lr = len(read.seq)
            records: List[AlignmentRecord] = []
            weighted = 0
            for mapping in mappings:
                graph.increment_subpath(mapping.contained_nodes, kmer_count)
                weighted += 1
                hit = None
                for ori in (0, 1):
                    hit = self._cascade(gp, bits[r], ori, Lr, mapping)
                    if hit is not None:
                        records = self._build_records(graph, read, ori, Lr, hit)
                        break
                if hit is not None:
                    break
            out.append((records, weighted))
        return out

    # ------------------------------------------------------------------
    def match_batch_inputs(self, groups: List[Tuple[_GraphPack, List[FastqRead]]]):
        """The `match_bits_batch` arguments of a read batch, [(graph pack,
        reads)]: the store's path rows on the aligner's device
        (`path_rows`), each distinct read's forward codes once (u8 [R, Lr_b],
        Lr_b the longest read rounded up to a multiple of 32, at least 32)
        and lengths, the pair table (a read row a (group, read)) and a
        segment (first pair, pairs, first row, rows, W = L + 1) a group."""
        reads: List[FastqRead] = []
        at: Dict[int, int] = {}
        pairs: List[int] = []
        segs = []
        rows = self.path_rows()
        for gp, rs in groups:
            row0, n_rows, L = self._row_index[gp.packed.graph_id]
            segs.append((len(pairs), len(rs), row0, n_rows, L + 1))
            for r in rs:
                i = at.setdefault(id(r), len(reads))
                if i == len(reads):
                    reads.append(r)
                pairs.append(i)
        lens = np.fromiter((len(r.seq) for r in reads), np.int32, len(reads))
        Lr_b = -(-max(int(lens.max(initial=0)), 32) // 32) * 32
        codes = np.full((len(reads), Lr_b), 4, dtype=np.uint8)
        codes[np.arange(Lr_b)[None, :] < lens[:, None]] = ASCII_TO_CODE[
            np.frombuffer(b"".join(r.seq for r in reads), dtype=np.uint8)]
        return (*rows, codes, lens, np.asarray(pairs, np.int32),
                np.asarray(segs, np.int64).reshape(-1, 5))

    def _match_volumes(self, groups: List[Tuple[_GraphPack, List[FastqRead]]]):
        """Match volumes of a read batch, [(graph pack, reads)] -> per group
        bits u32 [R, 6, P, W32], from ONE `match_bits_batch` call on the
        aligner's device. On a card the bits come back by one copy into a
        pinned buffer the aligner keeps (grown as needed): the arrays
        returned are views of it, valid until the next call."""
        if not groups:
            return []
        args = self.match_batch_inputs(groups)
        segs = args[-1]
        bits, off = match_bits_batch(*args, nvar=6)
        words = self._to_host(bits.view(torch.int32))
        return [words[off[s]:off[s + 1]].reshape(int(n), 6, int(n_rows), -(-int(W) // 32))
                for s, (_p0, n, _r0, n_rows, W) in enumerate(segs)]

    def _to_host(self, bits: torch.Tensor) -> np.ndarray:
        """int32 bits -> a u32 numpy view: on a card one copy into the
        pinned buffer and a wait for it."""
        if bits.device.type != "cuda":
            return bits.numpy().view(np.uint32)
        n = bits.numel()
        if self._pinned is None or self._pinned.numel() < n:
            size = max(n, 2 * (0 if self._pinned is None else self._pinned.numel()))
            self._pinned = torch.empty(size, dtype=torch.int32, pin_memory=True)
        host = self._pinned[:n]
        host.copy_(bits, non_blocking=True)
        torch.cuda.current_stream(bits.device).synchronize()
        return host.numpy().view(np.uint32)

    # ------------------------------------------------------------------
    @staticmethod
    def _bit(bits: np.ndarray, variant: int, path_row: int, o: int) -> bool:
        return bool((bits[variant, path_row, o >> 5] >> (o & 31)) & 1)

    def _probe(
        self, gp: _GraphPack, bits, variant: int, eff_len: int, node: int, o_node: int
    ) -> Optional[Dict[int, int]]:
        """Try an exact alignment from `node` at in-node offset `o_node`.
        Returns {path_id: start_pos} for every matching path, or None."""
        if o_node >= gp.node_len.get(node, 0):
            return None  # dfsRecursive offset guard (alignment.go:199-201)
        matches: Dict[int, int] = {}
        pos_map = gp.node_pos.get(node, {})
        for row, pid in enumerate(gp.path_ids):
            if pid not in pos_map:
                continue
            start = pos_map[pid] + o_node
            plen = int(gp.lengths[row])
            if start >= plen:
                continue
            if not self._bit(bits, variant, row, start):
                continue
            if start + eff_len > plen and not gp.terminal_free[pid]:
                # overhang only allowed at a true dead end (alignment.go:229)
                continue
            matches[pid] = start
        return matches or None

    def _cascade(self, gp: _GraphPack, bits, ori: int, Lr: int, mapping):
        """The four-stage hierarchical alignment (alignment.go:34-103).
        Returns (ids->startPos, start_clip, end_clip) or None."""
        v_full = ori * 3 + 0
        v_start = ori * 3 + 1
        v_end = ori * 3 + 2
        seed = mapping.node
        offset = mapping.offset

        # 1. seed offset shuffling
        for shuffle in range(int(mapping.merge_span + mapping.window_size) + 1):
            hit = self._probe(gp, bits, v_full, Lr, seed, offset + shuffle)
            if hit:
                return (hit, 0, 0)
        # 2. seed node shuffling (deterministic ascending-node order where the
        # reference iterates a Go map randomly)
        for node in sorted(mapping.contained_nodes):
            for shuffle in range(NODE_SHUFFLES + 1):
                hit = self._probe(gp, bits, v_full, Lr, node, shuffle)
                if hit:
                    return (hit, 0, 0)
        # 3. hard clip read start (MaxClip=1)
        hit = self._probe(gp, bits, v_start, Lr - 1, seed, offset)
        if hit:
            return (hit, 1, 0)
        # 4. hard clip read end
        hit = self._probe(gp, bits, v_end, Lr - 1, seed, offset)
        if hit:
            return (hit, 0, 1)
        return None

    # ------------------------------------------------------------------
    def _build_records(
        self, graph: GrootGraph, read: FastqRead, ori: int, Lr: int, hit
    ) -> List[AlignmentRecord]:
        matches, start_clip, end_clip = hit
        seq = read.seq
        qual = read.qual
        if ori == 1:
            # record carries the reverse-complemented sequence + reversed
            # quals, like RevComplement before the RC attempt (seqio.go:120-133)
            codes = ASCII_TO_CODE[np.frombuffer(read.seq, np.uint8)]
            seq = CODE_TO_ASCII[RC_CODE_NP[codes][::-1]].tobytes()
            qual = read.qual[::-1]
        seq_len = Lr - start_clip - end_clip
        aligned = seq[start_clip : start_clip + seq_len]
        aligned_qual = qual[start_clip : start_clip + seq_len] if qual else b""
        records = []
        for i, pid in enumerate(sorted(matches)):
            records.append(
                AlignmentRecord(
                    name=read.id[1:].decode(),
                    graph_id=graph.graph_id,
                    path_id=pid,
                    pos=matches[pid],
                    seq=aligned,
                    qual=aligned_qual,
                    start_clip=start_clip,
                    end_clip=end_clip,
                    reverse=ori == 1,
                    secondary=len(matches) > 1 and i != 0,
                )
            )
        return records
