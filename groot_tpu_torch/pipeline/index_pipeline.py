"""The index pipeline: MSAs -> variation graphs -> window sketches -> LSH.

Counterpart of groot_tpu/pipeline/index_pipeline.py. Reference: the three
pipeline processes in src/pipeline/index.go (MSAconverter -> GraphSketcher
-> SketchIndexer) wired by cmd/index.go:108-131. Graphs build on the host,
the window sketches of all graphs come from one pass on `device`
(index.window: the window-sketch kernel on a card, the native runtime on the
CPU), and the files written — groot.gg (the pickled config.Info, under the
reference's class names), groot.lshe and the groot.align sidecar — are the
ones groot_tpu writes and reads."""

from __future__ import annotations

import glob
import logging
import os
from typing import List, Tuple

import numpy as np

from .._build import native_runtime, resolve_device
from ..config import Info
from ..graph.grootgraph import GrootGraph, Store
from ..index.lshe import ContainmentIndex, _KeysView
from ..index.window import sketch_graphs_soa
from ..io.fastx import read_msa
from ..io.msa2gfa import msa_to_gfa

log = logging.getLogger("groot")


def find_msa_files(msa_dir: str) -> List[str]:
    """Glob cluster*.msa like indexParamCheck (cmd/index.go:143)."""
    files = sorted(glob.glob(os.path.join(msa_dir, "cluster*.msa")))
    if not files:
        # accept any .msa as a convenience superset
        files = sorted(glob.glob(os.path.join(msa_dir, "*.msa")))
    return files


def build_graphs(info: Info, msa_files: List[str]) -> List[GrootGraph]:
    """MSAconverter: MSA -> GFA -> GrootGraph, masking graphs whose shortest
    sequence is under the window size (index.go:58-65)."""
    graphs = []
    for msa_id, path in enumerate(msa_files):
        rows = read_msa(path)
        gfa = msa_to_gfa(rows)
        graph = GrootGraph.from_gfa(gfa, msa_id)
        for pid, seq_len in graph.lengths.items():
            if seq_len < info.window_size:
                log.info(
                    "\tsequence for %s is shorter than window size (%d vs. %d), "
                    "skipping graph",
                    graph.paths[pid],
                    seq_len,
                    info.window_size,
                )
                graph.masked = True
                break
        graphs.append(graph)
    return graphs


def sketch_and_index(
    info: Info, graphs: List[GrootGraph], device
) -> ContainmentIndex:
    """GraphSketcher + SketchIndexer (index.go:91-211), the window sketches
    on `device`. Consumes the merge struct-of-arrays directly — no
    per-window Key objects on the build path."""
    store: Store = {}
    num_windows = 0
    prop_distinct = 0.0
    num_masked = 0
    unmasked = [g for g in graphs if not g.masked]
    soas = sketch_graphs_soa(
        unmasked, info.window_size, info.kmer_size, info.sketch_size, device
    )
    soa_iter = iter(soas)
    all_soas: List[Tuple[int, dict]] = []  # (graph_id, merge soa)
    for graph in graphs:
        if not graph.masked:
            all_soas.append((graph.graph_id, next(soa_iter)))
            if graph.max_span > info.max_sketch_span:
                # the reference intends this as a fatal error
                # (index.go:139-143) but its maxSpan counter is never
                # updated, so the check can't fire there; warn instead
                log.warning(
                    "graph (ID: %d) has %d sketches in a row merged "
                    "(max advised span: %d)",
                    graph.graph_id,
                    graph.max_span,
                    info.max_sketch_span,
                )
            num_windows += graph.num_windows
            prop_distinct += graph.num_distinct_sketches / max(
                graph.num_windows, 1
            )
        else:
            num_masked += 1
        store[graph.graph_id] = graph

    num_graphs = len(store) - num_masked
    if num_graphs == 0:
        raise ValueError("could not create and sketch any graphs")
    log.info("\tnumber of groot graphs built: %d", len(store))
    log.info("\t\tgraphs sketched: %d", num_graphs)
    log.info("\t\tgraph windows processed: %d", num_windows)
    log.info(
        "\t\tmean approximate distinct sketches per graph: %.2f%%",
        (prop_distinct / num_graphs) * 100,
    )
    info.store = store

    index = ContainmentIndex(
        num_part=info.num_part,
        max_k=info.max_k,
        num_window_kmers=info.window_size - info.kmer_size + 1,
        sketch_size=info.sketch_size,
    )
    # concatenate the per-graph merge soas into the index soa and the
    # window key strings "g{g}n{n}o{o}-{i}"
    counts = [len(soa["w_node"]) for _gid, soa in all_soas]
    sketch_count = int(sum(counts))
    soa = {
        "w_graph": np.concatenate(
            [np.full(c, gid, np.int64) for (gid, _), c in zip(all_soas, counts)]
        ),
        "w_node": np.concatenate([s["w_node"] for _, s in all_soas]),
        "w_off": np.concatenate([s["w_off"] for _, s in all_soas]),
        "w_merge_span": np.concatenate(
            [s["w_merge_span"] for _, s in all_soas]
        ),
        "w_window_size": np.full(sketch_count, info.window_size, np.int32),
        "sketches": np.concatenate([s["sketches"] for _, s in all_soas]),
    }
    for ptr_name, flat_name in (("cn_ptr", "cn_seg"), ("ref_ptr", "ref_ids")):
        parts_ptr = [np.zeros(1, np.int64)]
        base = 0
        for _, s in all_soas:
            parts_ptr.append(s[ptr_name][1:] + base)
            base += int(s[ptr_name][-1])
        soa[ptr_name] = np.concatenate(parts_ptr)
        soa[flat_name] = np.concatenate([s[flat_name] for _, s in all_soas])
    soa["cn_val"] = np.concatenate([s["cn_val"] for _, s in all_soas])
    index.soa = soa
    index.sketches = soa["sketches"]
    index.keys = _KeysView(soa)
    index.window_keys = [
        f"g{gid}n{n}o{o}-{i}"
        for (gid, s_) in all_soas
        for n, o, i in zip(
            s_["w_node"].tolist(),
            s_["w_off"].tolist(),
            s_["w_key_i"].tolist(),
        )
    ]
    info.attach_db(index)
    log.info("\tnumber of sketches added to the LSH Ensemble index: %d", sketch_count)
    return index


def run_index(info: Info, msa_dir: str, device) -> None:
    """The full `groot index` command (cmd/index.go:57-133), the window
    sketches on `device` ("cuda" without a card raises)."""
    from ..hostmem import tune as _malloc_tune

    dev = resolve_device(device)
    _malloc_tune()  # keep batch buffers on the heap (see hostmem.py)
    native_runtime()
    msa_files = find_msa_files(msa_dir)
    if not msa_files:
        raise FileNotFoundError(
            "no MSA files found that passed the file checks (make sure "
            "filenames follow 'cluster-DD.msa' convention)"
        )
    if info.kmer_size > info.window_size:
        raise ValueError("supplied k-mer size greater than read length")
    log.info("\tnumber of MSA files: %d", len(msa_files))
    graphs = build_graphs(info, msa_files)
    index = sketch_and_index(info, graphs, dev)
    index.prepare()
    os.makedirs(info.index_dir, exist_ok=True)
    info.save_db(os.path.join(info.index_dir, "groot.lshe"))
    info.dump(os.path.join(info.index_dir, "groot.gg"))

    # groot.align sidecar: the aligner's setup arrays are pure functions of
    # the index, so build them once here instead of on every align startup.
    # The device engine's tables are a superset of the hash engine's, and
    # are only derived here, not uploaded.
    try:
        from ..align.batch_host import WindowTables

        from ..align.device_join import DeviceJoinAligner
        from ..io.bam import build_references

        aligner = DeviceJoinAligner(
            info.store, build_references(info.store), device="cpu"
        )
        tables = WindowTables(index, info.store)
        aligner.derive_tables(tables, index, info.kmer_size)
        aligner.save_arrays(os.path.join(info.index_dir, "groot.align"))
    except Exception as e:  # pragma: no cover - cache is best-effort
        log.warning("could not precompute the align sidecar: %s", e)
