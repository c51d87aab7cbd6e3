"""The port's EM against groot_tpu's: on synthetic variation graphs with
random node weights, the port's single-graph and batched EM (the plain
PyTorch loop on the CPU) give the reference's iteration counts exactly and
its alphas within 1e-5 * max(1, |alpha|), the reference suite's own
tolerance (tests/test_pipeline.py::test_batched_em_equals_per_graph). The
CUDA kernel is held against the plain loop on the card
(tests/test_torch_kernels.py)."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groot_tpu.em import em as ref_em
from groot_tpu.graph.grootgraph import GrootGraph
from groot_tpu.io.msa2gfa import msa_to_gfa
from groot_tpu_torch import synth
from groot_tpu_torch.em import em


def _graphs(seed: int, n_graphs: int = 5, zero_frac: float = 0.2):
    """Clusters of 2-5 alleles (400 bp, a few SNPs each) as graphs whose
    nodes carry random k-mer counts, some zero."""
    rng = np.random.default_rng(seed)
    graphs = []
    for gid in range(n_graphs):
        base = rng.integers(0, 4, size=400)
        rows = []
        for v in range(int(rng.integers(2, 6))):
            seq = base.copy()
            pos = rng.integers(0, 400, size=int(rng.integers(2, 8)))
            seq[pos] = (seq[pos] + 1 + v) % 4
            rows.append((f"gene{gid}~~~allele{v}", "".join("ACGT"[b] for b in seq)))
        g = GrootGraph.from_gfa(msa_to_gfa(rows, drop_consensus=False), gid)
        for node in g.sorted_nodes:
            node.kmer_freq = float(rng.integers(0, 500))
            if rng.random() < zero_frac:
                node.kmer_freq = 0.0
        g.kmer_total = sum(n.kmer_freq for n in g.sorted_nodes)
        graphs.append(g)
    return graphs


def _assert_same(port, ref):
    for g, r in zip(port, ref):
        assert g.em_iterations == r.em_iterations, g.graph_id
        assert set(g.alpha) == set(r.alpha)
        for pid, a in r.alpha.items():
            assert abs(g.alpha[pid] - a) <= 1e-5 * max(1.0, abs(a)), (g.graph_id, pid)


@pytest.mark.parametrize("seed", [9, 10])
@pytest.mark.parametrize("iters", [(10, 2000), (50, 10000)])
@pytest.mark.parametrize("mode", ["batched", "single", "batched-vs-single"])
def test_em_matches_reference(seed, iters, mode):
    graphs = _graphs(seed)
    port, ref = copy.deepcopy(graphs), copy.deepcopy(graphs)
    if mode == "single":
        for g in port:
            em.run_em_on_graph(g, *iters, "cpu")
    else:
        em.run_em_on_graphs(port, *iters, "cpu")
    if mode == "batched":
        ref_em.run_em_on_graphs(ref, *iters)
    else:
        for g in ref:
            ref_em.run_em_on_graph(g, *iters)
    _assert_same(port, ref)
    assert all(g.em_iterations > iters[0] for g in port)


def test_em_hits_max_iterations():
    """A graph stopped by max_iterations keeps its last alphas, in both
    packages, while the others in the batch converge."""
    graphs = _graphs(3, n_graphs=8)
    full = copy.deepcopy(graphs)
    em.run_em_on_graphs(full, 10, 10000, "cpu")
    cap = int(np.median([g.em_iterations for g in full]))
    port, ref = copy.deepcopy(graphs), copy.deepcopy(graphs)
    em.run_em_on_graphs(port, 10, cap, "cpu")
    ref_em.run_em_on_graphs(ref, 10, cap)
    _assert_same(port, ref)
    its = [g.em_iterations for g in port]
    assert max(its) == cap and min(its) < cap


def test_em_batched_torch_equals_reference_loop():
    """The plain loop equals `_run_em_batched` on the same padded arrays,
    pad lanes and count-0 ecs included."""
    rng = np.random.default_rng(4)
    G, E, Pn = 6, 40, 7
    n_paths = rng.integers(1, Pn + 1, size=G).astype(np.int32)
    membership = np.zeros((G, E, Pn), np.float32)
    counts = np.zeros((G, E), np.float32)
    for g in range(G):
        n_ec = int(rng.integers(5, E + 1))
        for e in range(n_ec):
            k = int(rng.integers(1, n_paths[g] + 1))
            membership[g, e, rng.choice(n_paths[g], size=k, replace=False)] = 1
        counts[g, :n_ec] = rng.integers(0, 300, size=n_ec) / rng.integers(
            20, 200, size=n_ec
        )
    it_r, alpha_r, _b4 = ref_em._run_em_batched(
        jnp.asarray(membership), jnp.asarray(counts), jnp.asarray(n_paths), 10, 3000
    )
    it, alpha = em.em_batched(
        torch.from_numpy(membership), torch.from_numpy(counts),
        torch.from_numpy(n_paths), 10, 3000,
    )
    np.testing.assert_array_equal(it.numpy(), np.asarray(it_r))
    a_r = np.asarray(alpha_r, np.float64)
    assert np.all(np.abs(alpha.numpy() - a_r) <= 1e-5 * np.maximum(1.0, np.abs(a_r)))


@pytest.mark.parametrize("n_paths", [[3, 7], [3, 40]])
def test_em_large_batch_equals_reference_and_plans(n_paths):
    """A batch of E = 30,000 ecs, each graph's more than 27,008 live ecs
    past what the kernel's shared memory stages (the mask route, [3, 7]
    paths; a mask graph and a CSR graph of 40 paths), so the card's launch
    plan (csrc/em.cu, held in the card tests) takes its large route: the
    plain loop gives `_run_em_batched`'s iteration counts and its alphas
    within 5e-5 of max(1, |alpha|). The tolerance is not the small
    batches' 1e-5: both sum ~29,000 float32 products per path and round
    in their own orders, and that alone parts their alphas by more than
    1e-5."""
    m, c, n = synth.em_batch(1, n_paths, 30_000, zero_frac=0.02, min_fill=0.95)
    it_r, alpha_r, _b4 = ref_em._run_em_batched(
        jnp.asarray(m), jnp.asarray(c), jnp.asarray(n), 10, 3000)
    it, alpha = em.em_batched(*(torch.from_numpy(x) for x in (m, c, n)), 10, 3000)
    np.testing.assert_array_equal(it.numpy(), np.asarray(it_r))
    a_r = np.asarray(alpha_r, np.float64)
    assert np.all(np.abs(alpha.numpy() - a_r) <= 5e-5 * np.maximum(1.0, np.abs(a_r)))
    lay = em.em_layout(*(torch.from_numpy(x) for x in (m, c, n)))
    assert int(lay["n_live"].min()) > 27_008
    assert bool((lay["width"] > em.MASK_LANES).any()) == (max(n_paths) > em.MASK_LANES)


def test_em_rejects_bad_input():
    m = torch.zeros((1, 3, 2))
    c = torch.zeros((1, 3))
    n = torch.ones(1, dtype=torch.int32)
    with pytest.raises(TypeError):
        em.em_batched(m.double(), c, n, 1, 5)
    with pytest.raises(TypeError):
        em.em_batched(m, c[:, :2], n, 1, 5)
    with pytest.raises(TypeError):
        em.em_batched(m, c, n.long(), 1, 5)
    with pytest.raises(ValueError, match="iterations"):
        em.run_em_on_graphs(_graphs(1, 1), 50, 10, "cpu")


def test_process_em_paths_matches_reference():
    graphs = _graphs(12)
    em.run_em_on_graphs(graphs, 10, 2000, "cpu")
    port, ref = copy.deepcopy(graphs), copy.deepcopy(graphs)
    total = int(sum(g.kmer_total for g in graphs))
    for p, r in zip(port, ref):
        em.process_em_paths(p, 0.05, total)
        ref_em.process_em_paths(r, 0.05, total)
        assert p.paths == r.paths and p.abundances == r.abundances


def _layout_batch(P):
    """Graphs of 1..P paths (the widest first), one empty graph, E = 60."""
    return [torch.from_numpy(x) for x in synth.em_batch(
        P, [P, 1, max(P // 2, 1), 0, 3], 60, zero_frac=0.3)]


@pytest.mark.parametrize("P", [1, 12, 32, 33, 100])
def test_em_layout_decodes_to_membership(P):
    """The kernel's layout holds the dense batch: each graph's live ecs
    (count != 0, some path) first in ec order, their masks decode to their
    membership lanes below 32 and their counts are theirs; the width covers
    every member lane and the path count."""
    m, c, n = _layout_batch(P)
    lay = em.em_layout(m, c, n)
    G, E, _P = m.shape
    live = (m != 0).any(dim=2) & (c != 0)
    assert torch.equal(lay["n_live"], live.sum(dim=1).int())
    lanes = torch.arange(min(P, 32))
    for g in range(G):
        order = lay["order"][g]
        nl = int(lay["n_live"][g])
        assert sorted(order.tolist()) == list(range(E))
        assert order[:nl].tolist() == torch.nonzero(live[g])[:, 0].tolist()
        bits = lay["mask"][g, :nl].long() & 0xFFFFFFFF
        dec = ((bits[:, None] >> lanes) & 1).float()
        assert torch.equal(dec, m[g, order[:nl], : len(lanes)])
        assert torch.equal(lay["cnt"][g], c[g, order])
        used = torch.nonzero(m[g].any(dim=0))[:, 0]
        top = int(used.max()) + 1 if len(used) else 0
        assert int(lay["width"][g]) == max(int(n[g]), top)


@pytest.mark.parametrize("P", [33, 100])
def test_em_csr_decodes_to_membership(P):
    """The CSR of the wide route, both ways, decodes to the membership of
    each graph's live ecs in slot order, paths and ecs ascending."""
    m, c, n = _layout_batch(P)
    lay = em.em_layout(m, c, n)
    csr = em.em_csr(m, lay)
    G, E, _P = m.shape
    for g in range(G):
        nl = int(lay["n_live"][g])
        want = m[g, lay["order"][g, :nl]]
        ep, pp = csr["ec_ptr"][g].long(), csr["path_ptr"][g].long()
        eb, pb = int(csr["ec_base"][g]), int(csr["path_base"][g])
        assert int(ep[nl]) == int(ep[-1]) == int(pp[-1]) == int(want.sum())
        got = torch.zeros_like(want)
        for e in range(nl):
            lst = csr["ec_paths"][eb + ep[e]: eb + ep[e + 1]].long()
            assert torch.equal(lst, lst.sort().values)
            got[e, lst] = 1.0
        assert torch.equal(got, want)
        got_t = torch.zeros_like(want)
        for p in range(P):
            lst = csr["path_ecs"][pb + pp[p]: pb + pp[p + 1]].long()
            assert torch.equal(lst, lst.sort().values)
            got_t[lst, p] = 1.0
        assert torch.equal(got_t, want)


@pytest.mark.parametrize("E,P,threads,NP", [
    (675, 6, 704, 8),     # the haplotype batch of chip_smoke
    (1, 1, 32, 8), (4000, 12, 1024, 16), (9000, 32, 1024, 32),
    (10, 100, 128, 32), (50, 2000, 1024, 32), (16, 9, 32, 16),
])
def test_em_launch_shape(E, P, threads, NP):
    assert em.em_launch_shape(E, P) == (threads, NP)
