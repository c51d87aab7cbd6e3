"""Match-volume cascade on a CUDA card (aligner v4): the `cascade` engine.

Counterpart of groot_tpu/align/device_cascade.py. Same semantics as the
`host` engine (align.aligner, the reference cascade of
src/graph/alignment.go + graphminion.go), but the probe cascade of every
(read, mapping) pair runs in one device call per chunk, `pair_cascade`,
which returns a packed int32 row per pair:

    [found, 0, ori, stage, node, off, clip_s, clip_e, ids_mask[Pb]]

The host picks the first successful mapping per read (mappings are sorted),
rebuilds the SAM records from its node position tables (start_p =
pos_p(node) + offset, alignment.go:294-296) and replays increment_subpath
for the mappings up to the winner.

Work is laid out on two axes, as in the reference: combos (one per (graph,
read) with a mapping) and pairs (one per (read, mapping)), with the stage-2
contained-node probes flattened to one row per (pair, node). Graphs are
stacked per shape signature (Pb path rows, Lb columns, Nb node rows) on the
device. The pair cap (2,048) and probe cap (32,768) of a chunk, and the
truncation of a combo that exceeds them, are the reference's: they decide
which mappings are tried. The port sizes each call's C, Np and Nq to the
real counts (the reference pins buckets to bound XLA compiles).

`pair_cascade_torch` is the plain PyTorch version of the reference's
`_pair_cascade`: one-hot path rows, the six read variants, match counts by a
grouped conv1d, the gate, reverse suffix-minimum NXT volumes, flat gathers
and the stage-2 segment minimum. `pair_cascade` launches the hand-written
kernel (csrc/pair_cascade.cu) on a CUDA tensor and takes the plain version
on a CPU tensor.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .._build import I, Kernel, P, ptr, resolve_device
from ..graph.grootgraph import GrootGraph
from ..io.fastx import FastqRead
from ..ops.nthash import ASCII_TO_CODE, CODE_TO_ASCII, RC_CODE_NP
from .aligner import (MAX_CLIP, NODE_SHUFFLES, AlignmentRecord, _GraphPack,
                      exact_conv)
from .batch_host import csr_expand, winners

log = logging.getLogger("groot")

INF = 2**30
NB = 640        # node-table rows per graph (shared; last row = pad)
CN = 160        # contained-node probes per mapping
MAX_READ = 352  # longest read the trailing wildcard pad covers
DB = 128        # position block of the reference's volumes (sets Wp)
PLAIN_CHUNK = 64  # combos per grouped conv of the plain version (memory)

PAIR_CASCADE = Kernel(
    "pair_cascade", "groot_pair_cascade",
    (P, P, P, P, P, I, I, I, I, P, P, P, I, I, P, P, P, P, P, I, P, P, P, I,
     I, I, I, P),
    source="groot_tpu_torch/csrc/pair_cascade.cu",
    replaces="groot_tpu/align/device_cascade.py:175",
)


class _HostGraph:
    """Per-graph host arrays + shape signature (device residency is managed
    by the per-signature stacks in DeviceAligner)."""

    def __init__(self, graph: GrootGraph):
        gp = _GraphPack(graph)
        self.gp = gp
        P_ = len(gp.path_ids)
        self.P = P_
        self.Pb = next((b for b in (16, 64, 256) if P_ <= b),
                       -(-P_ // 256) * 256)
        codes = gp.packed.codes
        L = codes.shape[1]
        # trailing wildcard pad must cover the longest read so overhang
        # probes (dead-end partials, alignment.go:229) see match-anything
        Lneed = L + MAX_READ
        self.Lb = next((b for b in (1024, 2048, 4096) if Lneed <= b),
                       -(-Lneed // 1024) * 1024)
        self.codes = np.full((self.Pb, self.Lb), 4, dtype=np.uint8)
        self.codes[:P_, :L] = codes
        # node tables: row index = dense node rank (sorted segment id)
        self.node_ids = sorted(gp.node_pos)
        self.node_rank = {nid: i for i, nid in enumerate(self.node_ids)}
        Nn = len(self.node_ids)
        self.Nb = NB if Nn < NB else -(-(Nn + 1) // NB) * NB
        self.node_pos = np.full((self.Nb, self.Pb), -1, dtype=np.int32)
        self.node_len = np.zeros(self.Nb, dtype=np.int32)
        for i, nid in enumerate(self.node_ids):
            self.node_len[i] = gp.node_len[nid]
            for row, pid in enumerate(gp.path_ids):
                pos = gp.node_pos[nid].get(pid)
                if pos is not None:
                    self.node_pos[i, row] = pos
        self.pad_node = self.Nb - 1  # all -1/0: probes there never match
        self.path_len = np.zeros(self.Pb, dtype=np.int32)
        self.path_len[:P_] = gp.lengths
        self.terminal_free = np.zeros(self.Pb, dtype=bool)
        for row, pid in enumerate(gp.path_ids):
            self.terminal_free[row] = gp.terminal_free[pid]
        self.sig = (self.Pb, self.Lb, self.Nb)
        # per-mapping probe params, cached by Key identity (the same Key
        # object seeds many reads; Keys live as long as the index)
        self.map_cache: Dict[int, Tuple] = {}
        self.slot = -1

    def mapping_params(self, mapping):
        """(seed_rank, span_limit, contained_ranks[:CN], (all_ranks,
        weight_shares, multi_node)) for a window Key. weight_shares replays
        increment_subpath vectorized (grootgraph.py:180-196): per-node
        kmer_freq delta = share * num_kmers; multi_node windows also bump
        kmer_total by int(num_kmers)."""
        params = self.map_cache.get(id(mapping))
        if params is None:
            nodes = sorted(mapping.contained_nodes)
            # probe ranks cap at CN; weighting covers EVERY contained node
            # (the reference weights the full dict, graphminion.go:67)
            all_ranks = np.array(
                [self.node_rank[n] for n in nodes], dtype=np.int32
            )
            gp = self.gp
            if len(nodes) == 1:
                shares = np.ones(1, dtype=np.float64)
                multi = False
            else:
                lens = np.array(
                    [gp.node_len[n] for n in nodes], dtype=np.float64
                )
                counts = np.array(
                    [mapping.contained_nodes[n] for n in nodes],
                    dtype=np.float64,
                )
                shares = (lens / lens.sum()) * counts
                multi = True
            params = (
                self.node_rank[mapping.node],
                int(mapping.merge_span + mapping.window_size),
                all_ranks[:CN],
                (all_ranks, shares, multi),
            )
            self.map_cache[id(mapping)] = params
        return params


class _SigStack:
    """All graphs of one signature, stacked on `device` on first use."""

    def __init__(self, sig, device):
        self.sig = sig
        self.device = device
        self.slots: Dict[int, int] = {}   # graph_id -> slot
        self.host: List[_HostGraph] = []
        self._dev: Optional[Tuple[torch.Tensor, ...]] = None

    def add(self, graph_id: int, hg: _HostGraph) -> int:
        slot = len(self.host)
        self.slots[graph_id] = slot
        self.host.append(hg)
        self._dev = None  # stale
        return slot

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        """(codes u8 [Gs, Pb, Lb], node_pos i32 [Gs, Nb, Pb], node_len i32
        [Gs, Nb], path_len i32 [Gs, Pb], terminal_free bool [Gs, Pb])."""
        if self._dev is None:
            self._dev = tuple(
                torch.from_numpy(np.stack([getattr(h, f) for h in self.host]))
                .to(self.device)
                for f in ("codes", "node_pos", "node_len", "path_len",
                          "terminal_free")
            )
        return self._dev


# ---------------------------------------------------------------------------
# the pair cascade: plain version and kernel
# ---------------------------------------------------------------------------
def _read_variants(read_codes, read_len):
    """The six read variants [C, 6, Lr] (forward, forward clip-start,
    forward clip-end, and the same of the reverse complement), with 5 (no
    channel) outside each variant, and their effective lengths [C, 6]."""
    dev = read_codes.device
    C, Lr = read_codes.shape
    rl = read_len.long()
    j = torch.arange(Lr, device=dev)
    valid = j[None, :] < rl[:, None]
    rcodes = read_codes.long()
    fwd = torch.where(valid, rcodes, 5)
    rev_idx = (rl[:, None] - 1 - j[None, :]).clamp(0, Lr - 1)
    rc_tab = torch.from_numpy(RC_CODE_NP.astype(np.int64)).to(dev)
    rc = torch.where(valid, rc_tab[rcodes.gather(1, rev_idx)], 5)
    five = torch.full((C, 1), 5, dtype=torch.int64, device=dev)

    def clip_start(c):  # shift left one: read[1:]
        return torch.cat([c[:, 1:], five], dim=1)

    def clip_end(c):  # blank the last REAL base
        return torch.where(j[None, :] == rl[:, None] - 1, 5, c)

    variants = torch.stack(
        [fwd, clip_start(fwd), clip_end(fwd), rc, clip_start(rc), clip_end(rc)],
        dim=1,
    )
    eff = torch.stack([rl, rl - 1, rl - 1] * 2, dim=1)
    return variants, eff


def _volumes(stack_codes, stack_plen, stack_term, g_idx, variants, eff,
             read_len, Wp: int):
    """Phase A of the reference: per-combo match counts of the six variants
    at every position w < Wp (one-hot path rows, wildcard N/pad rows, zero
    columns past Lb), the gated full-match positions and their reverse
    suffix minimum. Returns NXT_f, NXT_r int32 [C, Pb, Wp] and the clip
    match bits mcs_f, mce_f, mcs_r, mce_r bool [C, Pb, Wp]."""
    dev = stack_codes.device
    _Gs, Pb, Lb = stack_codes.shape
    C, _six, Lr = variants.shape
    pos = torch.arange(Wp, device=dev)
    pad_cols = Wp + Lr - 1 - Lb
    kern = torch.nn.functional.one_hot(variants, 6)[..., :5].float()
    kern = kern.permute(0, 1, 3, 2)  # [C, 6, 5, Lr]
    vols = [[] for _ in range(6)]
    with exact_conv():  # exact integer counts
        for c0 in range(0, C, PLAIN_CHUNK):
            cs = slice(c0, min(c0 + PLAIN_CHUNK, C))
            n = cs.stop - cs.start
            g = g_idx[cs].long()
            codes = stack_codes[g].long()                     # [n, Pb, Lb]
            wild = codes == 4
            oh = torch.stack(
                [(codes == b) | wild for b in range(4)] + [wild], dim=-1
            ).float()                                          # [n, Pb, Lb, 5]
            if pad_cols > 0:
                oh = torch.nn.functional.pad(oh, (0, 0, 0, pad_cols))
            x = oh.permute(1, 0, 3, 2).reshape(Pb, n * 5, -1)
            w = kern[cs].reshape(n * 6, 5, Lr)
            counts = torch.nn.functional.conv1d(x, w, groups=n)[..., :Wp]
            counts = counts.reshape(Pb, n, 6, Wp).permute(1, 0, 2, 3)
            e = eff[cs].to(counts.dtype)[:, None, :, None]     # [n, 1, 6, 1]
            match = counts == e                                # [n, Pb, 6, Wp]
            plen = stack_plen[g].long()[..., None]             # [n, Pb, 1]
            term = stack_term[g][..., None]
            rl = read_len[cs].long()[:, None, None]
            gate = (pos < plen) & ((pos + rl <= plen) | term)
            for v in (0, 3):  # gated full matches -> reverse suffix min
                m = torch.where(match[:, :, v] & gate, pos.to(torch.int32),
                                torch.tensor(INF, dtype=torch.int32, device=dev))
                vols[v].append(
                    torch.flip(torch.cummin(torch.flip(m, [-1]), -1).values, [-1])
                )
            for v in (1, 2, 4, 5):  # clip matches: ungated
                vols[v].append(match[:, :, v])
    cat = [torch.cat(v, 0) for v in vols]
    return cat[0], cat[3], cat[1], cat[2], cat[4], cat[5]


def pair_cascade_torch(
    stack_codes, stack_npos, stack_nlen, stack_plen, stack_term, g_idx,
    read_codes, read_len, pair_combo, pair_valid, seed_idx, seed_off,
    span_lim, probe_pair, probe_node, probe_rank,
    n_shuffles: int = NODE_SHUFFLES,
):
    """Plain PyTorch version of the reference's `_pair_cascade`, on the
    inputs' device. Shapes as there: stacks u8 [Gs, Pb, Lb], i32 [Gs, Nb,
    Pb], [Gs, Nb], [Gs, Pb], bool [Gs, Pb]; combos g_idx [C], read codes u8
    [C, Lr] (0-4), read_len [C]; pairs [Np] (pair_valid bool); probes [Nq],
    sorted by pair. Returns int32 [Np, 8 + Pb]. Combos are processed in
    chunks of PLAIN_CHUNK to bound memory."""
    dev = stack_codes.device
    _Gs, Pb, Lb = stack_codes.shape
    Nb = stack_nlen.shape[1]
    C, Lr = read_codes.shape
    Np = pair_combo.shape[0]
    Nq = probe_pair.shape[0]
    S = n_shuffles
    W = Lb - Lr + 1
    Wp = -(-W // DB) * DB
    variants, eff = _read_variants(read_codes, read_len)
    NXT_f, NXT_r, mcs_f, mce_f, mcs_r, mce_r = _volumes(
        stack_codes, stack_plen, stack_term, g_idx, variants, eff, read_len,
        Wp,
    )
    plen = stack_plen[g_idx.long()].long()      # [C, Pb]
    term = stack_term[g_idx.long()]
    npos_flat = stack_npos.reshape(-1).long()
    nlen_flat = stack_nlen.reshape(-1).long()

    # ================= phase B: per-pair probes (flat gathers) ==========
    pc = pair_combo.long()
    pg = g_idx.long()[pc]
    prow = torch.arange(Pb, device=dev)
    seed_idx, seed_off, span_lim = seed_idx.long(), seed_off.long(), span_lim.long()
    srow = pg * Nb + seed_idx
    seed_starts = npos_flat[srow[:, None] * Pb + prow[None, :]]   # [Np, Pb]
    seed_len = nlen_flat[srow]
    base = seed_starts + seed_off[:, None]
    base_safe = base.clamp(0, W - 1)
    p_plen = plen[pc]
    p_term = term[pc]
    p_effc = read_len.long()[pc] - 1

    qp = probe_pair.long()
    probe_node, probe_rank = probe_node.long(), probe_rank.long()
    crow = pg[qp] * Nb + probe_node
    c_starts = npos_flat[crow[:, None] * Pb + prow[None, :]]       # [Nq, Pb]
    c_len = nlen_flat[crow]
    c_safe = c_starts.clamp(0, W - 1)
    q_combo = pc[qp]
    q_iota = torch.arange(Nq, device=dev)
    BIG = torch.iinfo(torch.int64).max

    def per_ori(NXT, MCS, MCE):
        # stage 1: first valid match at/after base, bounded by the shuffle
        # limit and the seed node length (alignment.go:36-45)
        first1 = NXT[pc[:, None], prow[None, :], base_safe].long() - base
        bound1 = torch.minimum(span_lim, seed_len - 1 - seed_off)[:, None]
        ok1 = (seed_starts >= 0) & (first1 <= bound1)
        j1 = torch.where(ok1, first1, INF).min(dim=1).values
        s1 = j1 < INF
        ids1 = ok1 & (first1 == j1[:, None])

        # stage 2: contained nodes (ascending), shuffles 0..S
        # (alignment.go:48-70): the lowest (node order, shuffle) over the
        # pair's probes, the lowest probe row among equal values (the pair
        # of the two packed in 64 bits; the reference packs 15 + 15 bits)
        best2 = torch.full((Np,), BIG, dtype=torch.int64, device=dev)
        if Nq:
            first2 = NXT[q_combo[:, None], prow[None, :], c_safe].long() - c_starts
            bound2 = torch.clamp(c_len - 1, max=S)[:, None]
            ok2 = (c_starts >= 0) & (first2 <= bound2)
            prio_q = torch.where(ok2, probe_rank[:, None] * (S + 1) + first2,
                                 INF).min(dim=1).values
            key = torch.where(prio_q < INF, (prio_q << 32) | q_iota, BIG)
            best2 = best2.scatter_reduce(0, qp, key, "amin")
        s2 = best2 < BIG
        jj2 = (best2 >> 32) % (S + 1)
        if Nq:  # no success reads probe row 0, as the reference does
            q_w = torch.where(s2, best2 & 0xFFFFFFFF, 0)
            ids2 = ok2[q_w] & (first2[q_w] == jj2[:, None])
            win_cn = probe_node[q_w]
        else:
            ids2 = torch.zeros((Np, Pb), dtype=torch.bool, device=dev)
            win_cn = seed_idx

        # stages 3/4: single clipped probes at the original seed offset
        # (alignment.go:73-103)
        def probe_clip(M):
            valid = ((seed_starts >= 0) & (seed_off[:, None] < seed_len[:, None])
                     & (base < p_plen))
            bit = M[pc[:, None], prow[None, :], base_safe]
            over_ok = (base + p_effc[:, None] <= p_plen) | p_term
            return valid & bit & over_ok

        ok3 = probe_clip(MCS)
        s3 = ok3.any(dim=1)
        ok4 = probe_clip(MCE)
        s4 = ok4.any(dim=1)

        found = s1 | s2 | s3 | s4
        stage = torch.where(s1, 1, torch.where(s2, 2, torch.where(s3, 3, 4)))
        win_node = torch.where(s2 & ~s1, win_cn, seed_idx)
        win_off = torch.where(s1, seed_off + j1, torch.where(s2, jj2, seed_off))
        ids = torch.where(
            s1[:, None], ids1,
            torch.where((s2 & ~s1)[:, None], ids2,
                        torch.where(s3[:, None], ok3, ok4)),
        )
        return found, stage, win_node, win_off, ids

    f0, st0, n0, o0, ids0 = per_ori(NXT_f, mcs_f, mce_f)
    f1, st1, n1, o1, ids1 = per_ori(NXT_r, mcs_r, mce_r)
    found = (f0 | f1) & pair_valid
    use0 = f0  # forward orientation tried first (graphminion.go:76-98)
    stage = torch.where(use0, st0, st1)
    scalars = torch.stack(
        [
            found.long(),
            torch.zeros_like(stage),
            torch.where(use0, 0, 1),
            stage,
            torch.where(use0, n0, n1),
            torch.where(use0, o0, o1),
            torch.where(stage == 3, MAX_CLIP, 0),
            torch.where(stage == 4, MAX_CLIP, 0),
        ],
        dim=1,
    )
    ids = torch.where(use0[:, None], ids0, ids1)
    return torch.cat([scalars, ids.long()], dim=1).to(torch.int32)


_ARG_SPEC = (  # name, dtype, rank
    ("stack_codes", torch.uint8, 3), ("stack_npos", torch.int32, 3),
    ("stack_nlen", torch.int32, 2), ("stack_plen", torch.int32, 2),
    ("stack_term", torch.bool, 2), ("g_idx", torch.int32, 1),
    ("read_codes", torch.uint8, 2), ("read_len", torch.int32, 1),
    ("pair_combo", torch.int32, 1), ("pair_valid", torch.bool, 1),
    ("seed_idx", torch.int32, 1), ("seed_off", torch.int32, 1),
    ("span_lim", torch.int32, 1), ("probe_pair", torch.int32, 1),
    ("probe_node", torch.int32, 1), ("probe_rank", torch.int32, 1),
)


def pair_cascade(
    stack_codes, stack_npos, stack_nlen, stack_plen, stack_term, g_idx,
    read_codes, read_len, pair_combo, pair_valid, seed_idx, seed_off,
    span_lim, probe_pair, probe_node, probe_rank,
    n_shuffles: int = NODE_SHUFFLES,
):
    """The pair cascade (see pair_cascade_torch) -> int32 [Np, 8 + Pb]. A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel,
    or raises. Probes must be sorted by pair, as the reference requires."""
    args = (stack_codes, stack_npos, stack_nlen, stack_plen, stack_term,
            g_idx, read_codes, read_len, pair_combo, pair_valid, seed_idx,
            seed_off, span_lim, probe_pair, probe_node, probe_rank)
    dev = stack_codes.device
    for (name, dtype, nd), t in zip(_ARG_SPEC, args):
        if t.dtype != dtype or t.dim() != nd or t.device != dev:
            raise TypeError(f"{name}: want {dtype} rank {nd} on {dev}, got "
                            f"{t.dtype} rank {t.dim()} on {t.device}")
    Gs, Pb, Lb = stack_codes.shape
    Nb = stack_nlen.shape[1]
    C, Lr = read_codes.shape
    Np, Nq = pair_combo.shape[0], probe_pair.shape[0]
    if (stack_npos.shape != (Gs, Nb, Pb) or stack_plen.shape != (Gs, Pb)
            or stack_term.shape != (Gs, Pb) or g_idx.shape != (C,)
            or read_len.shape != (C,)
            or any(t.shape != (Np,) for t in args[8:13])
            or any(t.shape != (Nq,) for t in args[13:])):
        raise ValueError("pair_cascade: inconsistent shapes")
    W = Lb - Lr + 1
    if W < 1:
        raise ValueError(f"read width {Lr} exceeds the path width {Lb}")
    if dev.type == "cpu":
        return pair_cascade_torch(*args, n_shuffles=n_shuffles)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if Lb % 4 or Lr % 4:  # the kernel compares four bases a word
        raise ValueError(f"pair_cascade kernel: Lb {Lb} and Lr {Lr} must be "
                         "multiples of 4")
    args = tuple(t.contiguous() for t in args)
    probe_ptr = torch.searchsorted(
        args[13], torch.arange(Np + 1, dtype=torch.int32, device=dev),
        out_int32=True,
    )
    out = torch.empty((Np, 8 + Pb), dtype=torch.int32, device=dev)
    Wp = -(-W // DB) * DB
    PAIR_CASCADE.launch(
        dev, *(ptr(t) for t in args[:5]), Gs, Pb, Lb, Nb,
        ptr(args[5]), ptr(args[6]), ptr(args[7]), C, Lr,
        *(ptr(t) for t in args[8:13]), Np,
        ptr(probe_ptr), ptr(args[14]), ptr(args[15]), Nq,
        W, Wp, n_shuffles, ptr(out),
    )
    return out


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
class DeviceAligner:
    """The cascade engine: graphs stacked on `device`, one pair_cascade call
    per chunk of combos, the host tail in numpy."""

    C_BUCKETS = (32, 128, 512)        # combos (graph x read) per call
    P_CAP = 2048                      # pairs (read x mapping) per call
    Q_CAP = 32768                     # stage-2 probes per call
    MEM_BUDGET = 4 * 1024 * 1024 * 1024  # the reference's per-call budget

    def __init__(self, store: Dict[int, GrootGraph], references=None,
                 device="cuda"):
        self.store = store
        self.device = resolve_device(device)
        self._graphs: Dict[int, _HostGraph] = {}
        self._stacks: Dict[Tuple[int, int, int], _SigStack] = {}
        # deferred weighting of the single-graph API: per-graph (kmer_freq
        # deltas, kmer_total delta), flushed by flush_weights()
        self._kf_acc: Dict[int, np.ndarray] = {}
        self._kt_acc: Dict[int, float] = {}
        self.stage_times: Dict[str, float] = {}
        # pack every graph up front: each signature stack uploads once
        for gid in sorted(store):
            self.graph_dev(store[gid])

    def _count(self, key: str, value) -> None:
        self.stage_times[key] = self.stage_times.get(key, 0) + value

    def flush_weights(self) -> None:
        """Apply the accumulated increment_subpath replay to the graphs.
        MUST be called before prune/EM/GFA-save read node.kmer_freq."""
        for gid, kf in self._kf_acc.items():
            graph = self.store[gid]
            hg = self._graphs[gid]
            for i, nid in enumerate(hg.node_ids):
                if kf[i]:
                    graph.get_node(nid).kmer_freq += float(kf[i])
            graph.kmer_total += self._kt_acc.get(gid, 0.0)
        self._kf_acc.clear()
        self._kt_acc.clear()

    def graph_dev(self, graph: GrootGraph) -> _HostGraph:
        hg = self._graphs.get(graph.graph_id)
        if hg is None:
            hg = _HostGraph(graph)
            self._graphs[graph.graph_id] = hg
            stack = self._stacks.get(hg.sig)
            if stack is None:
                stack = self._stacks[hg.sig] = _SigStack(hg.sig, self.device)
            hg.slot = stack.add(graph.graph_id, hg)
        return hg

    def _combo_cap(self, sig) -> int:
        """Largest combo bucket whose transient volumes fit MEM_BUDGET in
        the reference's layout: per combo one-hot bf16 [Pb, Lb, 5] + counts
        f32 [Pb, W, 6] + match bools + two i32 NXT volumes ~= Pb*Lb*48
        bytes, plus the banded kernel tensor [(Lr+DB-1)*5, 6*DB] bf16."""
        Pb, Lb, _Nb = sig
        bm_bytes = (MAX_READ + DB - 1) * 5 * 6 * DB * 2
        per_combo = Pb * Lb * 48 + bm_bytes
        cap = self.C_BUCKETS[0]
        for b in self.C_BUCKETS:
            if b * per_combo <= self.MEM_BUDGET:
                cap = b
        return cap

    def _launch(self, stack: _SigStack, arrays) -> torch.Tensor:
        """Copy one chunk's numpy arrays to the device and launch."""
        dev = self.device
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
        self._count("calls", 1)
        self._count("pairs", int(t[3].shape[0]))
        self._count("probes", int(t[9].shape[0]))
        return pair_cascade(*stack.tensors(), *t)

    # ------------------------------------------------------------------
    # batch-level API: one submit for ALL graphs seeded by a read batch
    # ------------------------------------------------------------------
    def submit_batch(self, per_graph: Dict[int, List[Tuple[FastqRead, List, float]]]):
        """Launch the cascade for every (graph, items) group in as few
        device calls as possible. Returns handles for collect_batch."""
        items_by_sig: Dict[Tuple[int, int, int], List] = {}
        for gid, items in per_graph.items():
            hg = self.graph_dev(self.store[gid])
            dst = items_by_sig.setdefault(hg.sig, [])
            for item in items:
                dst.append((hg, gid, item))

        calls = []
        p_cap, q_cap = self.P_CAP, self.Q_CAP
        for sig, sig_items in items_by_sig.items():
            c_cap = self._combo_cap(sig)
            stack = self._stacks[sig]
            chunk: List = []
            n_pairs = 0
            n_probes = 0
            for entry in sig_items:
                mappings = entry[2][1]
                # a single entry must fit one chunk on its own: cap its
                # mapping list explicitly — the reference tries mappings in
                # order and stops at the first success, so dropping the
                # tail only loses pathological reads' last-resort probes
                nq = 0
                for mi, m in enumerate(mappings):
                    mq = min(len(m.contained_nodes), CN)
                    if mi >= p_cap or nq + mq > q_cap:
                        log.warning(
                            "read %s: truncating %d->%d mappings to fit the "
                            "device cascade buckets",
                            entry[2][0].id, len(mappings), mi,
                        )
                        mappings = mappings[:mi]
                        entry = (entry[0], entry[1],
                                 (entry[2][0], mappings, entry[2][2]))
                        break
                    nq += mq
                npair = max(len(mappings), 1)
                if chunk and (
                    len(chunk) + 1 > c_cap
                    or n_pairs + npair > p_cap
                    or n_probes + nq > q_cap
                ):
                    calls.append(self._submit_chunk(stack, chunk))
                    chunk, n_pairs, n_probes = [], 0, 0
                chunk.append(entry)
                n_pairs += npair
                n_probes += nq
            if chunk:
                calls.append(self._submit_chunk(stack, chunk))
        return calls

    def collect_batch(self, calls):
        """Fetch all results; returns {graph_id: [(records, n_weighted), ...]}
        in the per-graph item order."""
        out: Dict[int, List[Tuple[List[AlignmentRecord], int]]] = {}
        for meta, dev_out in calls:
            packed = dev_out.cpu().numpy()  # [Np, 8 + Pb]
            for hg, gid, (read, mappings, kc), p0 in meta:
                graph = self.store[gid]
                res = self._collect_item(
                    graph, hg, read, mappings, kc, packed[p0 : p0 + len(mappings)]
                )
                out.setdefault(gid, []).append(res)
        return out

    def _submit_chunk(self, stack: _SigStack, chunk):
        """One device call for the items (combos) of one signature."""
        _Pb, _Lb, Nb = stack.sig
        pad_node = Nb - 1
        C = len(chunk)
        Np = max(sum(len(e[2][1]) for e in chunk), 1)
        Nq = sum(min(len(m.contained_nodes), CN) for e in chunk for m in e[2][1])
        Lr_max = max(len(e[2][0].seq) for e in chunk)
        Lr = -(-max(Lr_max, 32) // 32) * 32

        g_idx = np.zeros(C, dtype=np.int32)
        read_codes = np.full((C, Lr), 4, dtype=np.uint8)
        read_len = np.zeros(C, dtype=np.int32)
        pair_combo = np.zeros(Np, dtype=np.int32)
        pair_valid = np.zeros(Np, dtype=bool)
        seed_idx = np.full(Np, pad_node, dtype=np.int32)
        seed_off = np.zeros(Np, dtype=np.int32)
        span_lim = np.full(Np, -1, dtype=np.int32)
        probe_pair = np.zeros(Nq, dtype=np.int32)
        probe_node = np.zeros(Nq, dtype=np.int32)
        probe_rank = np.zeros(Nq, dtype=np.int32)

        meta = []
        p = q = 0
        for c, (hg, gid, (read, mappings, kc)) in enumerate(chunk):
            g_idx[c] = hg.slot
            codes = ASCII_TO_CODE[np.frombuffer(read.seq, np.uint8)]
            read_codes[c, : len(codes)] = codes
            read_len[c] = len(codes)
            meta.append((hg, gid, (read, mappings, kc), p))
            for mapping in mappings:
                s_rank, s_lim, c_ranks, _w = hg.mapping_params(mapping)
                pair_combo[p] = c
                pair_valid[p] = True
                seed_idx[p] = s_rank
                seed_off[p] = mapping.offset
                span_lim[p] = s_lim
                ncn = len(c_ranks)
                probe_pair[q : q + ncn] = p
                probe_node[q : q + ncn] = c_ranks
                probe_rank[q : q + ncn] = np.arange(ncn, dtype=np.int32)
                q += ncn
                p += 1
        out = self._launch(stack, (
            g_idx, read_codes, read_len, pair_combo, pair_valid, seed_idx,
            seed_off, span_lim, probe_pair, probe_node, probe_rank,
        ))
        return meta, out

    # ------------------------------------------------------------------
    # vectorized pair-list API (batch_host tables; no per-hit Python)
    # ------------------------------------------------------------------
    def attach_tables(self, tables) -> None:
        """Bind flat WindowTables and precompute graph-local cascade ranks
        for every window/contained-node (one pass at startup; per batch the
        pair arrays are pure numpy gathers)."""
        self.tables = t = tables
        grank = np.zeros(t.num_nodes, dtype=np.int32)
        gid_col = t.node_table[:, 0]
        starts = np.searchsorted(gid_col, t.graph_ids)
        ends = np.append(starts[1:], len(gid_col))
        self._sig_ids: Dict[Tuple[int, int, int], int] = {}
        self._sig_list: List[Tuple[int, int, int]] = []
        sig_by_g = np.zeros(len(t.graph_ids), dtype=np.int16)
        slot_by_g = np.zeros(len(t.graph_ids), dtype=np.int32)
        for gi, gid in enumerate(t.graph_ids.tolist()):
            hg = self.graph_dev(self.store[gid])
            nr = hg.node_rank
            seg_col = t.node_table[starts[gi] : ends[gi], 1]
            grank[starts[gi] : ends[gi]] = np.fromiter(
                (nr[int(s)] for s in seg_col), np.int32, len(seg_col)
            )
            sid = self._sig_ids.get(hg.sig)
            if sid is None:
                sid = self._sig_ids[hg.sig] = len(self._sig_list)
                self._sig_list.append(hg.sig)
            sig_by_g[gi] = sid
            slot_by_g[gi] = hg.slot
        gpos = np.searchsorted(t.graph_ids, t.w_graph)
        self.w_sig = sig_by_g[gpos]
        self.w_slot = slot_by_g[gpos]
        self.w_seed_rank = grank[t.w_seed_grow]
        self.cn_rank = grank[t.cn_grow]
        self.probe_cnt = np.minimum(t.cn_cnt, CN).astype(np.int32)

    def process_batch_pairs(
        self, batch, rows, wins, combo_start, kc_read, acc, bam_writer, stats
    ):
        """Full cascade for one read batch from sorted (read, window) hit
        lists: submit every chunk, then collect."""
        calls = self.submit_pairs(batch, rows, wins, combo_start)
        self.collect_pairs(calls, batch, rows, wins, kc_read, acc, bam_writer, stats)

    def pair_chunks(self, rows, wins, combo_start):
        """The calls of one batch: (stack, pair counts per combo, combo
        indices) per chunk, cut at the combo cap of the signature and the
        pair and probe caps of a call."""
        n_pairs_total = len(rows)
        if n_pairs_total == 0:
            return
        combo_end = np.append(combo_start[1:], n_pairs_total)
        pair_cnt = (combo_end - combo_start).astype(np.int64)
        pc_pair = self.probe_cnt[wins].astype(np.int64)
        pc_combo = np.add.reduceat(pc_pair, combo_start)
        combo_sig = self.w_sig[wins[combo_start]]
        for sid in np.unique(combo_sig):
            stack = self._stacks[self._sig_list[sid]]
            c_cap = self._combo_cap(stack.sig)
            combos = np.flatnonzero(combo_sig == sid)
            cp = np.cumsum(pair_cnt[combos])
            cq = np.cumsum(pc_combo[combos])
            i = 0
            while i < len(combos):
                base_p = int(cp[i - 1]) if i else 0
                base_q = int(cq[i - 1]) if i else 0
                j = min(
                    int(np.searchsorted(cp, base_p + self.P_CAP, side="right")),
                    int(np.searchsorted(cq, base_q + self.Q_CAP, side="right")),
                    i + c_cap,
                )
                if j <= i:
                    j = i + 1  # oversized combo: pairs capped in the packer
                yield stack, pair_cnt, combos[i:j]
                i = j

    def submit_pairs(self, batch, rows, wins, combo_start):
        """Launch all cascade chunks for a batch; returns handles."""
        t0 = time.perf_counter()
        calls = []
        for stack, pair_cnt, chunk in self.pair_chunks(rows, wins, combo_start):
            arrays, meta = self.chunk_arrays(
                stack, batch, rows, wins, combo_start, pair_cnt, chunk
            )
            calls.append((meta, self._launch(stack, arrays)))
        self._count("submit_s", time.perf_counter() - t0)
        return calls

    def chunk_arrays(self, stack, batch, rows, wins, combo_start, pair_cnt,
                     chunk):
        """The numpy inputs of one chunk's pair_cascade call on `stack` (all
        gathers), and its meta (pair_idx, owner, starts_local,
        total_pairs)."""
        pad_node = stack.sig[2] - 1
        p_cap, q_cap = self.P_CAP, self.Q_CAP
        capped = np.minimum(pair_cnt[chunk], p_cap)
        if (capped < pair_cnt[chunk]).any():
            log.warning(
                "capping %d oversized combos to %d mappings",
                int((capped < pair_cnt[chunk]).sum()), p_cap,
            )
        total_pairs = int(capped.sum())
        owner = np.repeat(np.arange(len(chunk)), capped)
        starts_local = np.concatenate(
            ([0], np.cumsum(capped[:-1]))
        ).astype(np.int64)
        rank = np.arange(total_pairs, dtype=np.int64) - starts_local[owner]
        pair_idx = combo_start[chunk][owner] + rank
        wch = wins[pair_idx]
        pq = self.probe_cnt[wch].astype(np.int64)
        cum_pq = np.cumsum(pq)
        total_probes = int(cum_pq[-1]) if total_pairs else 0
        if total_probes > q_cap:
            # only reachable for a single-combo chunk: drop tail pairs
            keep = int(np.searchsorted(cum_pq, q_cap, side="right"))
            log.warning(
                "truncating oversized combo to %d mappings (probe budget)",
                keep,
            )
            total_pairs = keep
            owner = owner[:keep]
            pair_idx = pair_idx[:keep]
            wch = wch[:keep]
            starts_local = np.zeros(len(chunk), dtype=np.int64)

        t = self.tables
        heads = combo_start[chunk]
        crows = rows[heads]
        Np = max(total_pairs, 1)
        pair_combo = np.zeros(Np, np.int32)
        pair_combo[:total_pairs] = owner
        pair_valid = np.zeros(Np, bool)
        pair_valid[:total_pairs] = True
        seed_idx = np.full(Np, pad_node, np.int32)
        seed_idx[:total_pairs] = self.w_seed_rank[wch]
        seed_off = np.zeros(Np, np.int32)
        seed_off[:total_pairs] = t.w_off[wch]
        span_lim = np.full(Np, -1, np.int32)
        span_lim[:total_pairs] = t.w_span[wch]
        pflat, powner, prank = csr_expand(t.cn_ptr, self.probe_cnt, wch)
        arrays = (
            self.w_slot[wins[heads]].astype(np.int32),
            batch.codes[crows],
            batch.lengths[crows].astype(np.int32),
            pair_combo, pair_valid, seed_idx, seed_off, span_lim,
            powner.astype(np.int32), self.cn_rank[pflat].astype(np.int32),
            prank.astype(np.int32),
        )
        return arrays, (pair_idx, owner, starts_local, total_pairs)

    def collect_pairs(
        self, calls, batch, rows, wins, kc_read, acc, bam_writer, stats
    ):
        """Drain cascade results: winner selection, weight replay, BAM."""
        t0 = time.perf_counter()
        t = self.tables
        for meta, dev_out in calls:
            pair_idx, owner, starts_local, total_pairs = meta
            packed = dev_out.cpu().numpy()[:total_pairs]
            found = packed[:, 0].astype(bool)
            win, n_weighted = winners(found, starts_local)
            lim = (starts_local + n_weighted)[owner]
            sel = np.arange(total_pairs, dtype=np.int64) < lim
            sel_pairs = pair_idx[sel]
            acc.add_pairs(wins[sel_pairs], kc_read[rows[sel_pairs]])
            for ci in np.flatnonzero(win >= 0):
                p_local = int(win[ci])
                gpair = int(pair_idx[p_local])
                row = packed[p_local]
                gid = int(t.w_graph[wins[gpair]])
                hg = self._graphs[gid]
                read = batch.read(int(rows[gpair]))
                records = self._build_records(
                    self.store[gid], hg.gp, hg, read,
                    int(row[2]), int(row[4]), int(row[5]),
                    int(row[6]), int(row[7]), row[8:],
                )
                stats.alignment_count += len(records)
                if bam_writer is not None:
                    for rec in records:
                        bam_writer.write(rec)
        self._count("collect_s", time.perf_counter() - t0)

    # ------------------------------------------------------------------
    # single-graph API (tests / host-aligner drop-in)
    # ------------------------------------------------------------------
    def align_read_batch(
        self, graph: GrootGraph, items: List[Tuple[FastqRead, List, float]]
    ) -> List[Tuple[List[AlignmentRecord], int]]:
        calls = self.submit_batch({graph.graph_id: items})
        out = self.collect_batch(calls)[graph.graph_id]
        self.flush_weights()  # single-graph API weights eagerly
        return out

    def _collect_item(
        self, graph, hg: _HostGraph, read, mappings, kmer_count, packed
    ) -> Tuple[List[AlignmentRecord], int]:
        """Winner = first successful mapping (mappings are pre-sorted,
        graphminion.go:57); weight replay covers mappings up to the winner
        inclusive (the reference weights each mapping as it tries it)."""
        found = packed[:, 0].astype(bool)
        win = int(np.argmax(found)) if found.any() else -1
        n_weighted = win + 1 if win >= 0 else len(mappings)
        n_weighted = min(n_weighted, len(mappings))

        gid = graph.graph_id
        kf = self._kf_acc.get(gid)
        if kf is None:
            kf = self._kf_acc[gid] = np.zeros(len(hg.node_ids), np.float64)
            self._kt_acc[gid] = 0.0
        for mapping in mappings[:n_weighted]:
            _s, _l, _c, (w_ranks, shares, multi) = hg.mapping_params(mapping)
            kf[w_ranks] += shares * kmer_count
            if multi:
                self._kt_acc[gid] += float(int(kmer_count))

        records: List[AlignmentRecord] = []
        if win >= 0:
            row = packed[win]
            records = self._build_records(
                graph, hg.gp, hg, read,
                int(row[2]), int(row[4]), int(row[5]),
                int(row[6]), int(row[7]), row[8:],
            )
        return records, n_weighted

    def _build_records(
        self, graph, gp, hg, read, ori, node_rank, o_node, cs, ce, ids_mask
    ) -> List[AlignmentRecord]:
        node_id = hg.node_ids[node_rank]
        pos_map = gp.node_pos[node_id]
        seq = read.seq
        qual = read.qual
        if ori == 1:
            codes = ASCII_TO_CODE[np.frombuffer(read.seq, np.uint8)]
            seq = CODE_TO_ASCII[RC_CODE_NP[codes][::-1]].tobytes()
            qual = read.qual[::-1]
        Lr = len(read.seq)
        seq_len = Lr - cs - ce
        aligned = seq[cs : cs + seq_len]
        aligned_qual = qual[cs : cs + seq_len] if qual else b""
        records = []
        hit_pids = [
            pid
            for row, pid in enumerate(gp.path_ids)
            if ids_mask[row] and pid in pos_map
        ]
        for i, pid in enumerate(sorted(hit_pids)):
            records.append(
                AlignmentRecord(
                    name=read.id[1:].decode(),
                    graph_id=graph.graph_id,
                    path_id=pid,
                    pos=pos_map[pid] + o_node,
                    seq=aligned,
                    qual=aligned_qual,
                    start_clip=cs,
                    end_clip=ce,
                    reverse=ori == 1,
                    secondary=len(hit_pids) > 1 and i != 0,
                )
            )
        return records


def cascade_from_jax(jax_aligner, device) -> dict:
    """The reference's DeviceAligner (groot_tpu.align.device_cascade, after
    attach_tables) -> the port's cascade state: per signature the five
    stacks (codes, node_pos, node_len, path_len, terminal_free) as tensors
    on `device`, as `_SigStack.tensors` holds them, and the per-window ranks
    of attach_tables (w_sig, w_slot, w_seed_rank, cn_rank, probe_cnt) as
    numpy arrays."""
    dev = torch.device(device)
    stacks = {}
    for sig, st in jax_aligner._stacks.items():
        stacks[sig] = tuple(torch.from_numpy(np.array(a)).to(dev)
                            for a in st.device())
    out = {"stacks": stacks}
    for f in ("w_sig", "w_slot", "w_seed_rank", "cn_rank", "probe_cnt"):
        out[f] = np.asarray(getattr(jax_aligner, f))
    return out
