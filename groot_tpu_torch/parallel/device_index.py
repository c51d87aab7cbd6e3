"""Device-resident containment index + the fused align step.

Counterpart of groot_tpu/parallel/device_index.py, the multi-device data
plane: the LSH band tables, window sketches and window -> node weighting
coefficients live on the device as dense tensors (replicated on each device
of the data axis: the full CARD/resfinder indexes are tens of MB); read
batches split over the data axis; per-graph k-mer tallies are scatter-adds
into a global node-weight vector, summed over the axis — the counterpart of
the reference's mutex-guarded counters (boss.go:28, graphminion.go:67).

One step is three kernels: the KHF sketch (ops.sketch), the LSH query with
containment and keep decisions (index.lshe.query_device, csrc/lsh_query.cu)
and the weighting (weight_scatter, csrc/weight_scatter.cu). align_step_torch
runs the plain PyTorch version of each. make_sharded_align_step runs the
step over a list of devices in one process, or over the ranks of a
torch.distributed process group (the shard_map + psum of the reference).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._build import I, I64, Kernel, P, ptr, resolve_device
from ..index.lshe import (
    MAX_PER_BAND, ContainmentIndex, query_device, query_device_torch,
)
from ..ops.nthash import khf_sketch_torch
from ..ops.sketch import khf_sketch
from .mesh import pad_batch_for_mesh

WEIGHT_SCATTER = Kernel(
    "weight_scatter", "groot_weight_scatter",
    (P, I, I, P, P, I, P, P, P, I64, P, I64, P, P, P, P),
    source="groot_tpu_torch/csrc/weight_scatter.cu",
    replaces="groot_tpu/parallel/device_index.py:188",
)
_TENSORS = ("sorted_sigs", "band_idx", "fsig_sorted", "forder", "sketches",
            "graph_ids", "win_nodes", "win_coeff", "win_multi")


@dataclass
class DeviceIndex:
    """Flat tensors for the device align step, all on one device."""

    k: int
    s: int
    band_k: int
    num_window_kmers: int
    sorted_sigs: torch.Tensor  # int32 [L, N] band signatures (u32 bits)
    band_idx: torch.Tensor     # int32 [L, N]
    fsig_sorted: torch.Tensor  # int32 [N] sorted full-sketch sigs (u32 bits)
    forder: torch.Tensor       # int32 [N] fsig order -> window id
    cf: int                    # max identical-fsig bucket size
    sketches: torch.Tensor     # int64 [N, s] window sketches (u64 bits)
    graph_ids: torch.Tensor    # int32 [N]
    win_nodes: torch.Tensor    # int32 [N, Cn] global node rows (-1 pad)
    win_coeff: torch.Tensor    # float32 [N, Cn] weight coefficient per node
    win_multi: torch.Tensor    # bool [N] window spans >1 node
    num_nodes: int
    num_graphs: int
    # host-side lookup: global node row -> (graph_id, segment_id)
    node_table: Optional[np.ndarray] = None  # int64 [num_nodes, 2]

    @property
    def device(self) -> torch.device:
        return self.sketches.device

    def to(self, device) -> "DeviceIndex":
        """A replica with every tensor on `device`."""
        return dataclasses.replace(
            self, **{n: getattr(self, n).to(device) for n in _TENSORS}
        )

    @classmethod
    def build(
        cls, index: ContainmentIndex, store, kmer_size: int,
        threshold: float = 0.99, device="cuda",
    ) -> "DeviceIndex":
        """The reference's arrays from the port's index (always a v2
        struct-of-arrays) and graph store, on `device` ("cuda" without a
        card raises)."""
        dev = resolve_device(device)
        index.prepare()
        K = index.optimal_k(index.num_window_kmers, threshold)
        t = index._tables[K]
        # global node numbering over all graphs
        node_row: Dict[Tuple[int, int], int] = {}
        rows: List[Tuple[int, int]] = []
        for gid in sorted(store):
            for node in store[gid].sorted_nodes:
                node_row[(gid, node.segment_id)] = len(rows)
                rows.append((gid, node.segment_id))
        N = index.num_sketches
        soa = index.soa
        cn_ptr = soa["cn_ptr"].astype(np.int64)
        cn_cnt = np.diff(cn_ptr)
        Cn = int(cn_cnt.max())
        win_nodes = np.full((N, Cn), -1, dtype=np.int32)
        win_coeff = np.zeros((N, Cn), dtype=np.float32)
        win_multi = cn_cnt > 1
        gid_e = np.repeat(soa["w_graph"], cn_cnt)
        grow_e = np.fromiter(
            (node_row[(int(g), int(s_))] for g, s_ in zip(gid_e, soa["cn_seg"])),
            np.int64, len(soa["cn_seg"]),
        )
        node_len_f = np.empty(len(rows), dtype=np.float64)
        for (gid, seg), r in node_row.items():
            node_len_f[r] = store[gid].get_node(seg).segment_length
        lens = node_len_f[grow_e]
        len_sums = np.add.reduceat(lens, cn_ptr[:-1], dtype=np.float64)
        coeff = (lens / np.repeat(len_sums, cn_cnt)) * soa["cn_val"]
        coeff[np.repeat(cn_cnt == 1, cn_cnt)] = 1.0
        owner = np.repeat(np.arange(N), cn_cnt)
        col = np.arange(len(grow_e)) - np.repeat(cn_ptr[:-1], cn_cnt)
        win_nodes[owner, col] = grow_e
        win_coeff[owner, col] = coeff
        # full-sketch signature table for the exact all-slot-equality mode
        # (the table the host fast path uses, lshe._build_full_table)
        if not hasattr(index, "_full_table"):
            index._build_full_table()
        fsig, forder = index._full_table
        cf = int(np.unique(fsig, return_counts=True)[1].max()) if len(fsig) else 1

        def u32_bits(a):
            return torch.from_numpy(
                np.ascontiguousarray(a, np.uint32).view(np.int32)
            ).to(dev)

        return cls(
            k=kmer_size,
            s=index.sketch_size,
            band_k=K,
            num_window_kmers=index.num_window_kmers,
            sorted_sigs=u32_bits(t["sorted_sigs"]),
            band_idx=torch.from_numpy(np.ascontiguousarray(t["idx"], np.int32)).to(dev),
            fsig_sorted=u32_bits(fsig),
            forder=torch.from_numpy(forder.astype(np.int32)).to(dev),
            cf=cf,
            sketches=index.dev_tensors(dev)["sketches"],
            graph_ids=torch.from_numpy(soa["w_graph"].astype(np.int32)).to(dev),
            win_nodes=torch.from_numpy(win_nodes).to(dev),
            win_coeff=torch.from_numpy(win_coeff).to(dev),
            win_multi=torch.from_numpy(win_multi).to(dev),
            num_nodes=len(rows),
            num_graphs=len(store),
            node_table=np.array(rows, dtype=np.int64),
        )


def device_index_from_jax(arrays: dict, device) -> DeviceIndex:
    """The reference's DeviceIndex, its fields given as numpy arrays and
    ints (e.g. {f: np.asarray(v) for f, v in vars(ref).items()}), as the
    port's DeviceIndex on `device`: sk_hi/sk_lo joined into u64 sketches,
    the u32 signature tables as int32 bits, every other array as it is."""
    a = arrays
    dev = torch.device(device)

    def t(x, dtype=None):
        x = np.ascontiguousarray(np.array(x))  # a writable copy
        return torch.from_numpy(x if dtype is None else x.view(dtype)).to(dev)

    sk = (np.asarray(a["sk_hi"]).astype(np.uint64) << np.uint64(32)) | np.asarray(
        a["sk_lo"]
    ).astype(np.uint64)
    node_table = a.get("node_table")
    return DeviceIndex(
        k=int(a["k"]), s=int(a["s"]), band_k=int(a["band_k"]),
        num_window_kmers=int(a["num_window_kmers"]),
        sorted_sigs=t(np.asarray(a["sorted_sigs"], np.uint32), np.int32),
        band_idx=t(a["band_idx"]),
        fsig_sorted=t(np.asarray(a["fsig_sorted"], np.uint32), np.int32),
        forder=t(a["forder"]),
        cf=int(a["cf"]),
        sketches=t(sk, np.int64),
        graph_ids=t(a["graph_ids"]), win_nodes=t(a["win_nodes"]),
        win_coeff=t(a["win_coeff"]), win_multi=t(a["win_multi"]),
        num_nodes=int(a["num_nodes"]), num_graphs=int(a["num_graphs"]),
        node_table=None if node_table is None else np.asarray(node_table),
    )


def max_keep_q(d: float, t: float) -> int:
    """Largest integer q with (q+d)/(2q) > t evaluated in float64 — the
    exact containment bound of the host full-equality fast path
    (lshe.query_batch_np); monotonically decreasing in q."""
    if not (1.0 + d) / 2.0 > t:  # q=1 already fails
        return 0
    lo, hi = 1, 1 << 30
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if (mid + d) / (2.0 * mid) > t:
            lo = mid
        else:
            hi = mid - 1
    return lo


# ---------------------------------------------------------------------------
# weighting
# ---------------------------------------------------------------------------
def _check_weight(win, kc, win_nodes, win_coeff, win_multi, graph_ids):
    B = win.shape[0] if win.dim() == 2 else -1
    N = win_nodes.shape[0] if win_nodes.dim() == 2 else -1
    checks = (
        (win, torch.int32, 2), (kc, torch.int32, 1), (win_nodes, torch.int32, 2),
        (win_coeff, torch.float32, 2), (win_multi, torch.bool, 1),
        (graph_ids, torch.int32, 1),
    )
    for x, dtype, nd in checks:
        if x.dtype != dtype or x.dim() != nd or x.device != win.device:
            raise TypeError(
                "weight_scatter takes int32 win [B, C], int32 kc [B], int32 "
                "win_nodes [N, Cn], float32 win_coeff [N, Cn], bool win_multi "
                "[N], int32 graph_ids [N], all on one device"
            )
    if (kc.shape[0] != B or win_coeff.shape != win_nodes.shape
            or win_multi.shape[0] != N or graph_ids.shape[0] != N
            or win_nodes.shape[1] < 1):
        raise TypeError("weight_scatter shapes disagree")


def weight_scatter_torch(win, kc, win_nodes, win_coeff, win_multi, graph_ids,
                         num_nodes: int, num_graphs: int, pair_budget: int):
    """Plain PyTorch version of the weight_scatter kernel (the weighting
    half of the reference's align_step): the first pair_budget kept slots
    of win [B, C] (>= 0) in flat row-major order add win_coeff * kc to
    their window's nodes and, for multi-node windows, floor(kc) to the
    window's graph. Returns (node_weights f32 [num_nodes], graph_kmers f32
    [num_graphs], mapped bool [B], dropped int32 = kept slots past the
    budget)."""
    _check_weight(win, kc, win_nodes, win_coeff, win_multi, graph_ids)
    dev = win.device
    C = win.shape[1]
    flat = win.reshape(-1)
    kept = torch.nonzero(flat >= 0).squeeze(1)
    sel = kept[:pair_budget]
    w = flat[sel].long()
    kcf = kc[sel // C].to(torch.float32)
    nodes = win_nodes[w]
    coeff = win_coeff[w] * kcf[:, None]
    ok = nodes >= 0
    node_w = torch.zeros(num_nodes, dtype=torch.float32, device=dev)
    node_w.index_add_(0, nodes[ok].long(), coeff[ok])
    gm = win_multi[w]
    graph_k = torch.zeros(num_graphs, dtype=torch.float32, device=dev)
    graph_k.index_add_(0, graph_ids[w][gm].long(), torch.floor(kcf)[gm])
    dropped = torch.tensor(max(kept.numel() - pair_budget, 0),
                           dtype=torch.int32, device=dev)
    return node_w, graph_k, (win >= 0).any(dim=1), dropped


def _up16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def weight_scatter(win, kc, win_nodes, win_coeff, win_multi, graph_ids,
                   num_nodes: int, num_graphs: int, pair_budget: int):
    """The weighting (see weight_scatter_torch). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (two device functions,
    one allocation whose views are the four outputs), or raises; the
    inputs must be contiguous (the DeviceIndex tables are)."""
    if win.device.type == "cpu":
        return weight_scatter_torch(win, kc, win_nodes, win_coeff, win_multi,
                                    graph_ids, num_nodes, num_graphs, pair_budget)
    if win.device.type != "cuda":
        raise ValueError(f"no kernel for device {win.device}")
    _check_weight(win, kc, win_nodes, win_coeff, win_multi, graph_ids)
    args = (win, kc, win_nodes, win_coeff, win_multi, graph_ids)
    if not all(x.is_contiguous() for x in args):
        raise ValueError("weight_scatter takes contiguous tensors")
    B, C = win.shape
    n_tiles = -(-(B * C) // 1024)  # kTile in csrc/weight_scatter.cu
    # one allocation: the outputs the kernel zeroes (node_w, graph_k,
    # mapped) as one region of 16-byte words, then the tile counts and
    # dropped
    o_gk = _up16(4 * num_nodes)
    o_map = o_gk + _up16(4 * num_graphs)
    o_cnt = o_map + _up16(B)
    o_drop = o_cnt + _up16(4 * n_tiles)
    buf = torch.empty(o_drop + 16, dtype=torch.uint8, device=win.device)
    node_w = buf[:4 * num_nodes].view(torch.float32)
    graph_k = buf[o_gk:o_gk + 4 * num_graphs].view(torch.float32)
    mapped = buf[o_map:o_map + B].view(torch.bool)
    dropped = buf[o_drop:o_drop + 4].view(torch.int32).reshape(())
    WEIGHT_SCATTER.launch(
        win.device, ptr(win), B, C, ptr(kc), ptr(win_nodes), win_nodes.shape[1],
        ptr(win_coeff), ptr(win_multi), ptr(graph_ids), int(pair_budget),
        ptr(buf), o_cnt, ptr(graph_k), ptr(mapped), ptr(buf) + o_cnt,
        ptr(dropped),
    )
    return node_w, graph_k, mapped, dropped


# ---------------------------------------------------------------------------
# the fused step
# ---------------------------------------------------------------------------
def _align_step(dev: DeviceIndex, codes, lengths, threshold, full_equality,
                pair_budget, sketch, query, weight):
    B = codes.shape[0]
    q = sketch(codes, lengths, dev.k, dev.s)
    kc = (lengths - (dev.k - 1)).to(torch.int32)
    common = dict(domain_size=dev.num_window_kmers, threshold=threshold)
    if full_equality:
        win, contain = query(
            q, kc, dev.sketches, dev.fsig_sorted[None], dev.forder[None],
            K=dev.s, M=dev.cf,
            qmax=max_keep_q(float(dev.num_window_kmers), threshold), **common,
        )
    else:
        win, contain = query(
            q, kc, dev.sketches, dev.sorted_sigs, dev.band_idx, K=dev.band_k,
            M=MAX_PER_BAND, **common,
        )
    nw, gk, mapped, dropped = weight(
        win, kc, dev.win_nodes, dev.win_coeff, dev.win_multi, dev.graph_ids,
        dev.num_nodes, dev.num_graphs,
        pair_budget if pair_budget > 0 else 8 * B,
    )
    return win, contain, nw, gk, mapped, dropped


def align_step(dev: DeviceIndex, codes: torch.Tensor, lengths: torch.Tensor,
               *, threshold: float, full_equality: bool = False,
               pair_budget: int = 0):
    """One fused step: sketch -> LSH seed -> containment filter -> weight
    scatter, on the device of `dev` (codes uint8 [B, L], lengths int32 [B]
    there too): the khf_sketch, lsh_query and weight_scatter kernels on a
    card, their plain versions on the CPU.

    Kept pairs past `pair_budget` slots (default 8*B) are counted in
    `dropped`, not weighted. full_equality (valid whenever the containment
    bound forces all s slots equal for every read of the batch; chosen per
    batch by make_sharded_align_step as the host query chooses it) joins
    on the full-sketch signature table instead of the band tables, with
    the float64 containment cutoff: the host query's hit set exactly.
    Length-0 rows (mesh padding) keep nothing.

    Returns (win_idx int32 [B, C], contain f32 [B, C], node_weights f32
    [num_nodes], graph_kmers f32 [num_graphs], mapped bool [B], dropped
    int32)."""
    return _align_step(dev, codes, lengths, threshold, full_equality,
                       pair_budget, khf_sketch, query_device, weight_scatter)


def align_step_torch(dev: DeviceIndex, codes: torch.Tensor,
                     lengths: torch.Tensor, *, threshold: float,
                     full_equality: bool = False, pair_budget: int = 0):
    """align_step built from the plain PyTorch version of each kernel."""
    return _align_step(
        dev, codes, lengths, threshold, full_equality, pair_budget,
        lambda c, v, k, s: khf_sketch_torch(c, v, k, s), query_device_torch,
        weight_scatter_torch,
    )


def local_qmin(lengths: np.ndarray, k: int) -> float:
    """The least k-mer count over the batch's reads (length-0 padding rows
    left out); inf for a batch of padding only."""
    ln = np.asarray(lengths)
    kc = ln[ln > 0].astype(np.float64) - (k - 1)
    return float(kc.min()) if kc.size else np.inf


def full_equality_mode(qmin: float, s: int, d: float, threshold: float) -> bool:
    """The host query's full-equality condition for the batch's least
    k-mer count: the containment bound forces all s slots equal."""
    if not np.isfinite(qmin):
        qmin = 1.0
    bound = s * threshold * qmin / (qmin + d - threshold * qmin)
    return bool(bound >= s - 1)


def make_sharded_align_step(
    dev: DeviceIndex, threshold: float, *,
    devices: Optional[Sequence] = None, group=None,
):
    """The align step with its per-batch mode choice, over a data axis.

    Returns step(codes, lengths) for a host batch (numpy uint8 [B, L],
    int32 [B]) -> align_step's six outputs (pair budget 8 * rows per
    device).

    - Neither `devices` nor `group`: the whole batch on dev's device.
    - `devices` (one process, the single-controller shard_map): the batch is
      padded to a multiple of len(devices) and split into contiguous shards,
      one per device; each distinct device holds a replica of the index,
      copied once. The tallies and `dropped` are summed onto devices[0];
      win, contain and mapped come back there in batch order, padding cut.
    - `group` (a torch.distributed process group; each rank passes its own
      shard, its index on its own device): node weights, graph k-mers and
      dropped are merged with all_reduce(SUM); win, contain and mapped stay
      local. The least k-mer count is first reduced with all_reduce(MIN)
      so that every rank takes the same mode, and every rank issues every
      collective, whatever its shard holds (a skipped one deadlocks).

    The mode is the host query's (lshe.query_batch_np): the full-equality
    join when the containment bound forces all s slots equal for every
    read of the batch, padding rows left out; else the band tables."""
    if devices is not None and group is not None:
        raise ValueError("give devices or group, not both")
    d = float(dev.num_window_kmers)
    replicas: Dict[str, DeviceIndex] = {}
    if devices is not None:
        devices = [torch.device(x) for x in devices]
        if not devices:
            raise ValueError("devices is empty")
        for x in devices:
            if str(x) not in replicas:
                replicas[str(x)] = dev if x == dev.device else dev.to(x)

    def choose_mode(lengths: np.ndarray) -> bool:
        qmin = local_qmin(lengths, dev.k)
        if group is not None:
            import torch.distributed as dist

            t = torch.tensor([qmin], dtype=torch.float64, device=dev.device)
            dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
            qmin = float(t.item())
        return full_equality_mode(qmin, dev.s, d, threshold)

    def run(index: DeviceIndex, codes: np.ndarray, lengths: np.ndarray, full_eq):
        c = torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(index.device)
        v = torch.from_numpy(np.ascontiguousarray(lengths, np.int32)).to(index.device)
        return align_step(index, c, v, threshold=threshold,
                          full_equality=full_eq)

    def step(codes, lengths):
        codes, lengths = np.asarray(codes), np.asarray(lengths)
        full_eq = choose_mode(lengths)
        if devices is None:
            out = run(dev, codes, lengths, full_eq)
            if group is not None:
                import torch.distributed as dist

                for t in (out[2], out[3], out[5]):
                    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
            return out
        n = len(devices)
        codes_p, lengths_p, B = pad_batch_for_mesh(codes, lengths, n)
        per = codes_p.shape[0] // n
        outs = [
            run(replicas[str(x)], codes_p[i * per:(i + 1) * per],
                lengths_p[i * per:(i + 1) * per], full_eq)
            for i, x in enumerate(devices)
        ]
        main = devices[0]
        win, contain, mapped = (
            torch.cat([o[j].to(main) for o in outs])[:B] for j in (0, 1, 4)
        )
        nw, gk, dropped = (outs[0][j].clone() for j in (2, 3, 5))
        for o in outs[1:]:
            nw += o[2].to(main)
            gk += o[3].to(main)
            dropped += o[5].to(main)
        return win, contain, nw, gk, mapped, dropped

    return step
