"""Haplotype calling: weighted GFAs -> EM -> called alleles.

Counterpart of groot_tpu/pipeline/haplotype.py. Reference:
src/pipeline/haplotype.go (GFAreader -> EMpathFinder -> HaplotypeParser),
which the reference wires only in tests and the WASM build; both packages
expose it as the `haplotype` command. The EM of every graph runs as one
batch on `device` (em.run_em_on_graphs)."""

from __future__ import annotations

import logging
import re
from typing import List

from .._build import resolve_device
from ..config import Info
from ..em.em import process_em_paths, run_em_on_graphs
from ..graph.grootgraph import GrootGraph, Store
from ..io.gfa import parse_gfa
from ..version import get_version

log = logging.getLogger("groot")

_TOTAL_KMERS_RE = re.compile(r"graphs: (\d+)\)")


def load_weighted_gfas(info: Info, gfa_files: List[str]) -> List[GrootGraph]:
    """GFAreader.Run (haplotype.go:37-66): load GFAs; the total k-mer count
    round-trips through the first file's comment."""
    graphs = []
    for i, path in enumerate(gfa_files):
        g = parse_gfa(path)
        if i == 0:
            m = _TOTAL_KMERS_RE.search(" ".join(g.comments))
            if not m:
                raise ValueError(
                    f"could not parse total k-mer count from GFA comment: {path}"
                )
            info.haplotype.total_kmers = int(m.group(1))
        graphs.append(GrootGraph.from_gfa(g, i))
    return graphs


def find_haplotypes(info: Info, graphs: List[GrootGraph], device="cuda") -> List[str]:
    """EMpathFinder + HaplotypeParser (haplotype.go:91-181); the EM runs on
    `device` ("cuda" without a card raises)."""
    device = resolve_device(device)
    for g in graphs:
        info.store[g.graph_id] = g
    mean_iterations = 0
    kept: Store = {}
    kept_paths: List[str] = []
    for g in graphs:
        g.remove_dead_paths()
    run_em_on_graphs(
        graphs, info.haplotype.min_iterations, info.haplotype.max_iterations,
        device,
    )
    for g in graphs:
        process_em_paths(g, info.haplotype.cutoff, info.haplotype.total_kmers)
        mean_iterations += g.em_iterations
        if not g.paths:
            continue
        g.remove_dead_paths()
        log.info("\tgraph %d has %d called alleles after EM", g.graph_id, len(g.paths))
        for pid in sorted(g.paths):
            log.info(
                "\t- [%s (abundance: %.3f)]",
                g.paths[pid],
                g.abundances.get(pid, 0.0),
            )
            kept_paths.append(g.paths[pid])
        g.groot_version = get_version()
        kept[g.graph_id] = g
    info.store = kept
    if not kept:
        return kept_paths
    log.info("summarising...")
    log.info("\tmean number of EM iterations: %d", mean_iterations // len(kept))
    log.info("\tnumber of graphs with viable paths: %d", len(kept))
    log.info("\tnumber of called alleles: %d", len(kept_paths))
    return kept_paths
