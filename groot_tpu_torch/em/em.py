"""Expectation-Maximization over graph equivalence classes.

Counterpart of groot_tpu/em/em.py. Reference: src/em/em.go (plain EM, no
SQUAREM) driven by GrootGraph.RunEM/ProcessEMpaths (src/graph/paths.go:
32-98): equivalence classes (ecs) are graph nodes; each ec's member set is
the node's path IDs and its count is KmerFreq / len(sequence). One round:

    denom[e]   = sum of alpha over the ec's paths  (ec ignored when its count
                                                    is 0 or denom < TOLERANCE)
    next[p]    = alpha[p] * sum over the path's ecs of count[e] / denom[e]

with the reference's convergence rule: after min_iterations, once no path
with alpha > 1e-2 changes by more than 1%, zero the alphas under 1e-8 and
run one final round (em.go:60-150).

Every graph runs as one lane of a padded batch [G, E, P]: on a card the
EM kernel (csrc/em.cu, `em_batched`) runs each graph's whole loop in one
block, on the CPU `run_em_batched_torch` runs the reference's batched loop
(`_run_em_batched`) step by step. The single-graph entry points run a batch
of one, which the reference's own test holds equal to its single-graph loop
(tests/test_pipeline.py::test_batched_em_equals_per_graph).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .._build import I, I64, Kernel, P, card_query, ptr, resolve_device, smem_optin

TOLERANCE = np.nextafter(1.0, 2.0) - 1.0  # em.go:11
ALPHA_LIMIT = 1e-7
ALPHA_CHANGE = 1e-2
ALPHA_CHANGE_LIMIT = 1e-2

EM_BATCHED = Kernel(
    "em_batched", "groot_em_batched",
    (P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I64, I, I, P, P, P),
    source="groot_tpu_torch/csrc/em.cu",
    replaces="groot_tpu/em/em.py:159",
)
MASK_LANES = 32     # path lanes of the kernel's mask route
ECS_PER_THREAD = 1  # live ecs a thread of the kernel aims at (csrc/em.cu)


def run_em_batched_torch(
    membership: torch.Tensor, counts: torch.Tensor, n_paths: torch.Tensor,
    min_iterations: int, max_iterations: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The EM loop over a padded graph batch, plain PyTorch: float32 0/1
    membership [G, E, P], float32 counts [G, E], int32 n_paths [G] ->
    (int32 iterations [G], float32 alpha [G, P]).

    The reference's `_run_em_batched`, step by step: pad ecs carry count 0
    and pad path lanes start at alpha 0; each lane keeps its own final-round
    and done flags and is frozen once done, and `it` counts only the rounds
    a lane ran. The reference's alpha_b4 has no reader and is left out. The
    sums are elementwise products summed in float32 (no matmul, so no TF32
    on a card)."""
    G, E, Pn = membership.shape
    dev = membership.device
    m = membership.float()
    counts = counts.float()
    n_paths = n_paths.to(dev)
    lanes = torch.arange(Pn, device=dev)
    np_f = n_paths.float().clamp(min=1.0)
    alpha = torch.where(
        lanes[None, :] < n_paths[:, None], 1.0 / np_f[:, None],
        torch.zeros((), device=dev),
    )
    tol = float(TOLERANCE)
    it = torch.zeros(G, dtype=torch.int32, device=dev)
    final_round = torch.zeros(G, dtype=torch.bool, device=dev)
    done = torch.zeros(G, dtype=torch.bool, device=dev)
    zero = torch.zeros((), device=dev)
    while bool(((~done) & (it < max_iterations)).any()):
        denom = (m * alpha[:, None, :]).sum(dim=2)
        valid = (counts != 0) & (denom >= tol)
        cn = torch.where(valid, counts / denom.clamp(min=tol), zero)
        na = alpha * (cn[:, :, None] * m).sum(dim=1)
        changed = (
            (na > ALPHA_CHANGE_LIMIT)
            & ((na - alpha).abs() / na.clamp(min=1e-30) > ALPHA_CHANGE)
        ).any(dim=1)
        stop = ~changed & (it > min_iterations)
        new_done = done | final_round  # lanes that just ran their final round
        enter_final = stop & ~final_round & ~done
        na = torch.where(enter_final[:, None] & (na < ALPHA_LIMIT / 10.0), zero, na)
        na = torch.where(done[:, None], alpha, na)  # frozen lanes don't move
        it = it + (~done).to(torch.int32)
        final_round = final_round | enter_final
        done = new_done
        alpha = na
    return it, alpha


def em_layout(membership: torch.Tensor, counts: torch.Tensor,
              n_paths: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The EM kernel's per-graph layout of a dense batch, built on its
    device without a host round trip (csrc/em.cu reads it):
    - order int64 [G, E]: the ec in each slot, the graph's live ecs (count
      != 0 and some member path) first, in ec order; the rest after them;
    - mask int32 [G, E]: the ec's member path lanes below 32 as bits (the
      u32 value's bits), cnt float32 [G, E]: its count, both in slot order;
    - n_live int32 [G]: live ecs; width int32 [G]: path lanes the graph
      uses (its path count, or its highest member lane + 1 if larger; at
      most P), so a graph of width <= 32 is whole in its masks.
    An ec with count 0 adds 0.0 to every path sum and a lane at or past
    n_paths keeps alpha 0, so the kernel drops neither's effect."""
    G, E, Pn = membership.shape
    dev = membership.device
    member = membership != 0
    lanes = torch.arange(Pn, device=dev)
    top = torch.where(member.any(dim=1), lanes + 1, 0).amax(dim=1)
    width = torch.maximum(n_paths.long(), top).clamp(max=Pn).to(torch.int32)
    live = member.any(dim=2) & (counts != 0)
    order = torch.sort((~live).to(torch.uint8), dim=1, stable=True).indices
    lo = min(Pn, MASK_LANES)
    bits = (member[:, :, :lo].long() << lanes[:lo]).sum(dim=2)
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return {
        "order": order,
        "mask": bits.to(torch.int32).gather(1, order).contiguous(),
        "cnt": counts.gather(1, order).contiguous(),
        "n_live": live.sum(dim=1).to(torch.int32),
        "width": width,
    }


def _ptr_rows(per_row: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-graph local CSR offsets (int32 [G, R + 1]) of the row counts
    [G, R], and each graph's segment start in the flat list (int64 [G])."""
    G, R = per_row.shape
    ptr_ = torch.zeros((G, R + 1), dtype=torch.int32, device=per_row.device)
    ptr_[:, 1:] = torch.cumsum(per_row, dim=1)
    base = torch.zeros(G, dtype=torch.int64, device=per_row.device)
    base[1:] = torch.cumsum(ptr_[:, -1].long(), dim=0)[:-1]
    return ptr_, base


def em_csr(membership: torch.Tensor, layout: Dict[str, torch.Tensor]
           ) -> Dict[str, torch.Tensor]:
    """CSR of each graph's live ecs in the layout's slot order, for the
    kernel's route of graphs wider than 32 lanes: ec_ptr int32 [G, E + 1]
    and path_ptr int32 [G, P + 1] (local offsets into the graph's segment,
    which starts at ec_base / path_base int64 [G]), ec_paths (path lanes,
    ascending) and path_ecs (live slots, ascending), int32."""
    G, E, Pn = membership.shape
    order = layout["order"]
    m = (membership != 0).gather(1, order[:, :, None].expand(G, E, Pn))
    m &= (torch.arange(E, device=m.device) < layout["n_live"][:, None])[:, :, None]
    ec_ptr, ec_base = _ptr_rows(m.sum(dim=2))
    mt = m.transpose(1, 2)
    path_ptr, path_base = _ptr_rows(mt.sum(dim=2))
    return {
        "ec_ptr": ec_ptr, "ec_base": ec_base,
        "ec_paths": m.nonzero()[:, 2].to(torch.int32).contiguous(),
        "path_ptr": path_ptr, "path_base": path_base,
        "path_ecs": mt.nonzero()[:, 2].to(torch.int32).contiguous(),
    }


def em_launch_shape(E: int, Pn: int) -> Tuple[int, int]:
    """(threads a block wanted, NP: the mask route's path lanes, 8, 16 or
    32) for a batch of E ecs and Pn path lanes: a thread for ECS_PER_THREAD
    live ecs, and one a path when paths are wider than masks. The kernel
    lowers the count to what keeps all the batch's blocks resident."""
    want = max(-(-E // ECS_PER_THREAD), Pn if Pn > MASK_LANES else 0)
    threads = min(max(-(-want // 32) * 32, 32), 1024)
    NP = 8 if Pn <= 8 else (16 if Pn <= 16 else MASK_LANES)
    return threads, NP


def em_batched(
    membership: torch.Tensor, counts: torch.Tensor, n_paths: torch.Tensor,
    min_iterations: int, max_iterations: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batched EM (see run_em_batched_torch). A CPU tensor takes the
    plain version; a CUDA tensor launches the EM kernel on the batch's
    em_layout (and em_csr when a graph is wider than 32 path lanes), or
    raises."""
    if membership.dtype != torch.float32 or membership.dim() != 3:
        raise TypeError("membership must be float32 [G, E, P]")
    G, E, Pn = membership.shape
    if counts.dtype != torch.float32 or counts.shape != (G, E):
        raise TypeError("counts must be float32 [G, E]")
    if n_paths.dtype != torch.int32 or n_paths.shape != (G,):
        raise TypeError("n_paths must be int32 [G]")
    if counts.device != membership.device or n_paths.device != membership.device:
        raise ValueError("EM inputs must share one device")
    if membership.device.type == "cpu":
        return run_em_batched_torch(
            membership, counts, n_paths, min_iterations, max_iterations
        )
    if membership.device.type != "cuda":
        raise ValueError(f"no kernel for device {membership.device}")
    dev = membership.device
    it = torch.empty(G, dtype=torch.int32, device=dev)
    alpha = torch.empty((G, Pn), dtype=torch.float32, device=dev)
    if G == 0:
        return it, alpha
    if Pn < 1:
        raise ValueError("an EM batch needs a path lane")
    bad = ((membership != 0) & (membership != 1)).any()
    lay = em_layout(membership, counts, n_paths)
    least = fits = 0
    if Pn > MASK_LANES:
        csr = em_csr(membership, lay)
        wide = lay["width"] > MASK_LANES
        nl, wd = lay["n_live"].long(), lay["width"].long()
        nnz = csr["ec_ptr"].gather(1, nl[:, None])[:, 0].long()
        least = torch.where(wide, 2 * nl + 2 * wd, 0).max()
        full = torch.where(wide, 3 * nl + 3 * wd + 2 + 2 * nnz, 0)
        fits = torch.where(full <= smem_optin(dev) // 4, full, 0).max()
        bad, least, fits = torch.stack([bad.long(), least, fits]).tolist()
        csr_ptrs = [ptr(csr[k]) for k in ("ec_ptr", "ec_base", "ec_paths",
                                          "path_ptr", "path_base", "path_ecs")]
    else:  # every graph fits the mask route: no CSR (null pointers)
        csr_ptrs = [None] * 6
        bad = bool(bad)
    if bad:
        raise ValueError("membership must be 0/1")
    words = card_query(dev, "groot_em_smem_words", E, least, fits)
    nbytes = card_query(dev, "groot_em_scratch_bytes", G, E, Pn, least, fits)
    scratch = (torch.empty(nbytes // 4, dtype=torch.float32, device=dev)
               if nbytes else None)
    threads, NP = em_launch_shape(E, Pn)
    n_paths = n_paths.contiguous()
    EM_BATCHED.launch(
        dev, ptr(lay["mask"]), ptr(lay["cnt"]), ptr(lay["n_live"]),
        ptr(lay["width"]), ptr(n_paths), *csr_ptrs,
        G, E, Pn, NP, threads, words, min_iterations, max_iterations,
        ptr(it), ptr(alpha), None if scratch is None else ptr(scratch),
    )
    return it, alpha


def _check_iterations(min_iterations: int, num_iterations: int) -> None:
    if num_iterations < min_iterations:
        raise ValueError(
            f"number of EM iterations ({num_iterations}) must be greater "
            f"than minimum iterations ({min_iterations})"
        )


def _ec_nodes(graph) -> list:
    """The graph's unmarked nodes (its ecs), in sorted-node order."""
    nodes, seen = [], set()
    for node in graph.sorted_nodes:
        if node.marked:
            continue
        if node.segment_id in seen:
            raise ValueError("duplicate node ID found in graph")
        seen.add(node.segment_id)
        nodes.append(node)
    return nodes


def padded_batch(graphs) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[List[int]]]:
    """The EM inputs of many graphs as one padded batch: float32 0/1
    membership [G, E, P] (ecs in sorted-node order, path lanes in path-id
    order), float32 counts [G, E], int32 n_paths [G], and each graph's
    path ids in lane order."""
    metas = [(_ec_nodes(g), sorted(g.paths)) for g in graphs]
    G = len(metas)
    E = max((len(e) for e, _p in metas), default=0)
    Pn = max(max((len(p) for _e, p in metas), default=0), 1)
    membership = np.zeros((G, E, Pn), dtype=np.float32)
    counts = np.zeros((G, E), dtype=np.float32)
    n_paths = np.zeros(G, dtype=np.int32)
    for g, (nodes, path_ids) in enumerate(metas):
        dense = {p: i for i, p in enumerate(path_ids)}
        n_paths[g] = len(path_ids)
        for e, node in enumerate(nodes):
            for pid in node.path_ids:
                membership[g, e, dense[pid]] = 1.0
            counts[g, e] = node.kmer_freq / len(node.sequence)
    return membership, counts, n_paths, [p for _e, p in metas]


def _run(membership, counts, n_paths, min_iterations: int,
         num_iterations: int, device) -> Tuple[np.ndarray, np.ndarray]:
    """em_batched on `device` for numpy inputs -> (iterations, float64 alpha)."""
    dev = resolve_device(device)
    it, alpha = em_batched(
        *(torch.from_numpy(x).to(dev) for x in (membership, counts, n_paths)),
        min_iterations, num_iterations,
    )
    return it.cpu().numpy(), alpha.cpu().numpy().astype(np.float64)


class EMRunner:
    """NewEM/Run/Return equivalent (em.go:29-158) on `device`: a batch of
    one graph."""

    def __init__(
        self,
        num_iterations: int,
        min_iterations: int,
        paths: Dict[int, str],
        lengths: Dict[int, int],
        ec_map: Dict[int, List[int]],
        counts: Dict[int, float],
        device="cuda",
    ):
        _check_iterations(min_iterations, num_iterations)
        self.device = resolve_device(device)
        self.path_ids = sorted(paths)
        dense = {p: i for i, p in enumerate(self.path_ids)}
        ecs = sorted(ec_map)
        self.membership = np.zeros((len(ecs), len(self.path_ids)), dtype=np.float32)
        self.counts = np.zeros(len(ecs), dtype=np.float32)
        for e, ec in enumerate(ecs):
            for pid in ec_map[ec]:
                self.membership[e, dense[pid]] = 1.0
            self.counts[e] = counts[ec]
        self.num_iterations = num_iterations
        self.min_iterations = min_iterations
        self.iterations_ran = 0
        self.alpha: np.ndarray | None = None

    def run(self) -> None:
        it, alpha = _run(
            self.membership[None], self.counts[None],
            np.array([len(self.path_ids)], dtype=np.int32),
            self.min_iterations, self.num_iterations, self.device,
        )
        self.iterations_ran = int(it[0])
        self.alpha = alpha[0]

    def result(self) -> Tuple[int, Dict[int, float]]:
        if self.iterations_ran < 1:
            raise RuntimeError("no EM iterations were ran")
        return self.iterations_ran, {
            pid: float(self.alpha[i]) for i, pid in enumerate(self.path_ids)
        }


def run_em_on_graph(graph, min_iterations: int, num_iterations: int,
                    device="cuda") -> None:
    """GrootGraph.RunEM (paths.go:32-69)."""
    nodes = _ec_nodes(graph)
    em = EMRunner(
        num_iterations,
        min_iterations,
        graph.paths,
        graph.lengths,
        {n.segment_id: list(n.path_ids) for n in nodes},
        {n.segment_id: n.kmer_freq / len(n.sequence) for n in nodes},
        device,
    )
    em.run()
    graph.em_iterations, graph.alpha = em.result()


def run_em_on_graphs(graphs, min_iterations: int, num_iterations: int,
                     device="cuda") -> None:
    """RunEM over many graphs as one padded batch on `device`; equivalent
    to run_em_on_graph per graph (the reference runs one goroutine per
    graph, haplotype.go:95-119)."""
    _check_iterations(min_iterations, num_iterations)
    device = resolve_device(device)
    if not graphs:
        return
    membership, counts, n_paths, path_ids = padded_batch(graphs)
    it, alpha = _run(membership, counts, n_paths, min_iterations,
                     num_iterations, device)
    for g, (graph, pids) in enumerate(zip(graphs, path_ids)):
        graph.em_iterations = int(it[g])
        graph.alpha = {pid: float(alpha[g, i]) for i, pid in enumerate(pids)}


def process_em_paths(graph, cutoff: float, total_kmers: int) -> None:
    """GrootGraph.ProcessEMpaths (paths.go:72-98): normalise alpha -> rho,
    abundance = rho * KmerTotal / totalKmers, drop paths below cutoff."""
    if graph.em_iterations == 0:
        raise RuntimeError("EM has not been run for this graph")
    total = sum(graph.alpha.values())
    graph.abundances = {}
    for pid, a in graph.alpha.items():
        rho = a / total if total > 0 else 0.0
        kmer_share = rho * float(graph.kmer_total) / float(total_kmers)
        if kmer_share >= cutoff:
            graph.abundances[pid] = kmer_share
        else:
            graph.paths.pop(pid, None)
