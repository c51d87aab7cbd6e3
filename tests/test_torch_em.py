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
