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

computed for a read batch by `match_bits` from u8 codes: on a card the
match-bits kernel (csrc/match_bits.cu: bit planes of each path row, ANDed
along each read variant), on the CPU its plain version `match_bits_torch`,
the reference's one-hot cross-correlation (`_match_bits`):

    count[r, p, o] = sum_j onehot5(read)[r, j, :] . onehot5(path)[p, o+j, :]
    M = (count == effective_read_len)

Path 'N' and padding are wildcard rows (all ones), so graph Ns match
anything and matches may run past a path's end; those are kept only when the
path's terminal node has no out-edges (the dead-end partial traversal,
alignment.go:229).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .._build import I, Kernel, P, ptr, resolve_device
from ..graph.grootgraph import GrootGraph
from ..graph.pack import pack_graph_paths
from ..io.fastx import FastqRead
from ..ops.nthash import ASCII_TO_CODE, CODE_TO_ASCII, RC_CODE_NP

MAX_CLIP = 1  # alignment.go:16
NODE_SHUFFLES = 10  # alignment.go:52

MATCH_BITS = Kernel(
    "match_bits", "groot_match_bits", (P, P, P, I, I, I, I, P),
    source="groot_tpu_torch/csrc/match_bits.cu",
    replaces="groot_tpu/align/aligner.py:121",
)


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
        self._codes_cache: Dict[int, np.ndarray] = {}

    def path_codes(self, extra_pad: int) -> np.ndarray:
        """u8 [P, L+extra_pad]: the path rows' codes, padded with N (4)."""
        padded = self._codes_cache.get(extra_pad)
        if padded is None:
            codes = self.packed.codes
            P, L = codes.shape
            padded = np.full((P, L + extra_pad), 4, dtype=np.uint8)
            padded[:, :L] = codes
            self._codes_cache[extra_pad] = padded
        return padded

    def onehot(self, extra_pad: int) -> np.ndarray:
        """[P, L+extra_pad, 5] float32 one-hot with wildcard N/pad rows."""
        return path_onehot(torch.from_numpy(self.path_codes(extra_pad))).numpy()


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
    if dev.type == "cpu":
        return match_bits_torch(path_codes, var_codes, var_len)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if P > 65535:
        raise ValueError(f"match_bits kernel: {P} path rows, at most 65,535")
    path_codes, var_codes, var_len = (
        t.contiguous() for t in (path_codes, var_codes, var_len))
    out = torch.empty((K, P, -(-(Lp - Lr + 1) // 32)), dtype=torch.int32, device=dev)
    if P and K:
        MATCH_BITS.launch(dev, ptr(path_codes), ptr(var_codes), ptr(var_len),
                          P, Lp, K, Lr, ptr(out))
    return out.view(torch.uint32)


class GraphAligner:
    """Batched exact aligner over all graphs in a store; the match volumes
    are computed on `device` ("cuda" without a card raises)."""

    def __init__(
        self, store: Dict[int, GrootGraph], references=None, device="cuda"
    ):
        self.store = store
        self.device = resolve_device(device)
        self._packs: Dict[int, _GraphPack] = {}

    def pack(self, graph: GrootGraph) -> _GraphPack:
        gp = self._packs.get(graph.graph_id)
        if gp is None:
            gp = _GraphPack(graph)
            self._packs[graph.graph_id] = gp
        return gp

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
        """graphMinion semantics (graphminion.go:46-102) for a batch of reads
        seeded to one graph: weight then try to align each mapping (fwd then
        RC); the first successful mapping wins and later mappings are neither
        weighted nor aligned. One correlation covers every read x
        orientation x clip-variant; the cascade itself is host bit tests."""
        gp = self.pack(graph)
        bits = self._batch_match_bits(gp, [it[0] for it in items])
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
    @staticmethod
    def match_inputs(gp: _GraphPack, reads: List[FastqRead]):
        """The match-bits inputs of a read batch: path codes u8 [P, L + Lr_b]
        (the rows padded with Lr_b columns of N, Lr_b the longest read
        rounded up to a multiple of 32, at least 32), variant codes u8
        [6R, Lr_b] and var_len int32 [6R]. A read's six variants are (fwd|rc)
        x (full | clip-start: read[1:] | clip-end: read[:Lr-1])."""
        R = len(reads)
        lens = np.fromiter((len(r.seq) for r in reads), np.int64, R)
        Lr_b = -(-max(int(lens.max()), 32) // 32) * 32
        col = np.arange(Lr_b)
        fwd = np.full((R, Lr_b), 4, dtype=np.uint8)
        fwd[col[None, :] < lens[:, None]] = ASCII_TO_CODE[
            np.frombuffer(b"".join(r.seq for r in reads), dtype=np.uint8)]
        src = lens[:, None] - 1 - col[None, :]  # rc[j] = comp(read[Lr-1-j])
        rc = np.where(src >= 0,
                      RC_CODE_NP[np.take_along_axis(fwd, src.clip(0), axis=1)], 4)
        var = np.full((R, 2, 3, Lr_b), 4, dtype=np.uint8)
        var_len = np.empty((R, 2, 3), dtype=np.int32)
        for o, cs in enumerate((fwd, rc)):
            var[:, o, 0] = cs
            var[:, o, 1, :-1] = cs[:, 1:]
            var[:, o, 2] = cs  # its last real base lies past var_len
            var_len[:, o, 0] = lens
            var_len[:, o, 1:] = (lens - 1)[:, None]
        return (gp.path_codes(Lr_b), var.reshape(R * 6, Lr_b),
                var_len.reshape(R * 6))

    def _batch_match_bits(self, gp: _GraphPack, reads: List[FastqRead]):
        """Match volumes for a read batch: bits u32 [R, 6, P, W32], from
        `match_bits` on the aligner's device."""
        path, var, var_len = self.match_inputs(gp, reads)
        dev = self.device
        bits = match_bits(torch.from_numpy(path).to(dev),
                          torch.from_numpy(var).to(dev),
                          torch.from_numpy(var_len).to(dev))
        bits = bits.view(torch.int32).cpu().numpy().view(np.uint32)
        return bits.reshape(len(reads), 6, path.shape[0], bits.shape[-1])

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
