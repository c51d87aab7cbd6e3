"""Synthetic clustered ARG databases and read sets, made from a seed.

Used by the port's tests (a few small clusters) and by chip_smoke.py (a
database at the scale of arg-annot.90: 583 clusters, ~1,700 alleles).
`cascade_case`, `match_bits_case` and `match_bits_batch_case` make the
inputs of one pair-cascade, match-bits or batched match-bits call
directly. A cluster is a founder sequence plus alleles
at most `max_div` divergent from it (substitutions, plus a few short
deletions that become MSA gaps); each cluster is written as an aligned
FASTA `cluster-N.msa`, the layout `index` reads. Reads are sampled from the ungapped alleles with numpy; a FASTQ may
name each read the way bbmap's randomreads does, so that the `accuracy`
command can score an alignment of it.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

_ACGT = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _COMP[_a] = _b
_RC_CODE = np.array([3, 2, 1, 0, 4], np.uint8)


def make_clusters(
    rng: np.random.Generator,
    n_clusters: int,
    alleles: Tuple[int, int] = (1, 12),
    mean_alleles: float = 2.9,
    length: Tuple[int, int] = (500, 1500),
    max_div: float = 0.10,
    max_gaps: int = 2,
) -> List[List[Tuple[str, bytes]]]:
    """[cluster][allele] = (name, aligned sequence with '-' gaps). The
    allele count is 1 + a Poisson draw (mean `mean_alleles`), clipped to
    `alleles`; each allele's divergence is max_div * U^2 (mean max_div/3)."""
    out = []
    for c in range(n_clusters):
        L = int(rng.integers(length[0], length[1] + 1))
        founder = _ACGT[rng.integers(0, 4, L)]
        n_al = int(np.clip(1 + rng.poisson(mean_alleles - 1), *alleles))
        rows = []
        for a in range(n_al):
            seq = founder.copy()
            n_sub = int(round(max_div * rng.random() ** 2 * L))
            pos = rng.choice(L, size=n_sub, replace=False)
            seq[pos] = _ACGT[(np.searchsorted(_ACGT, seq[pos]) + rng.integers(1, 4, n_sub)) % 4]
            for _ in range(int(rng.integers(0, max_gaps + 1))):
                g0 = int(rng.integers(1, L - 8))
                seq[g0 : g0 + int(rng.integers(1, 7))] = ord("-")
            name = f"argsyn~~~(Syn)C{c}-{a}~~~SYN{c:04d}{a:02d}:1-{L}"
            rows.append((name, seq.tobytes()))
        out.append(rows)
    return out


def write_msa_dir(clusters, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for c, rows in enumerate(clusters):
        with open(os.path.join(out_dir, f"cluster-{c}.msa"), "wb") as fh:
            for name, seq in rows:
                fh.write(b">%s\n%s\n" % (name.encode(), seq))


def alleles_of(clusters) -> List[bytes]:
    """Ungapped allele sequences, in cluster then allele order."""
    return [seq.replace(b"-", b"") for rows in clusters for _n, seq in rows]


def allele_names(clusters) -> List[str]:
    """Allele names (the MSA rows' names), in the order of alleles_of."""
    return [name for rows in clusters for name, _seq in rows]


def sample_reads(
    rng: np.random.Generator,
    alleles: Sequence[bytes],
    n: int,
    lengths: Sequence[int] = (150,),
    rc_frac: float = 0.5,
    sub_frac: float = 0.25,
    sub_rate: float = 0.005,
    n_frac: float = 0.01,
    tail_frac: float = 0.0,
) -> Tuple[List[bytes], np.ndarray, np.ndarray]:
    """n reads: length drawn from `lengths`, start uniform in the allele
    (or flush with its end for a `tail_frac` share), reverse-complemented
    for `rc_frac`, with `sub_rate` substitutions in a `sub_frac` share and
    one N in an `n_frac` share. Returns (reads, each read's allele index,
    its 0-based leftmost position on the allele)."""
    lens = np.asarray(lengths)[rng.integers(0, len(lengths), n)]
    which = rng.integers(0, len(alleles), n)
    starts = np.zeros(n, dtype=np.int64)
    reads = []
    for i in range(n):
        ref = np.frombuffer(alleles[which[i]], np.uint8)
        ln = int(min(lens[i], len(ref)))
        if rng.random() < tail_frac:
            start = len(ref) - ln
        else:
            start = int(rng.integers(0, len(ref) - ln + 1))
        starts[i] = start
        r = ref[start : start + ln].copy()
        if rng.random() < sub_frac:
            k = rng.random(ln) < sub_rate
            r[k] = _ACGT[(np.searchsorted(_ACGT, r[k]) + rng.integers(1, 4, int(k.sum()))) % 4]
        if rng.random() < n_frac:
            r[int(rng.integers(0, ln))] = ord("N")
        if rng.random() < rc_frac:
            r = _COMP[r[::-1]]
        reads.append(r.tobytes())
    return reads, which, starts


def tiny_clusters(seed: int = 42):
    """The test fixture's clusters: 4 clusters x 3 alleles x 400 bp (index
    them at k31 s20 w100)."""
    return make_clusters(
        np.random.default_rng(seed), 4, alleles=(3, 3), mean_alleles=3,
        length=(400, 400), max_div=0.03,
    )


def tiny_db(msa_dir: str, seed: int = 42) -> List[bytes]:
    """Writes the MSAs of tiny_clusters and returns the ungapped alleles."""
    clusters = tiny_clusters(seed)
    write_msa_dir(clusters, msa_dir)
    return alleles_of(clusters)


def write_fastq(
    reads: Sequence[bytes], path: str, prefix: str = "r",
    origins: Optional[Tuple[Sequence[str], np.ndarray]] = None,
) -> None:
    """Reads named prefix0, prefix1, ...; or, given `origins` (each read's
    allele name and 0-based leftmost position on it), named as bbmap's
    randomreads does: split on '_', field 2 is the position and field 9 the
    allele (report/accuracy.py parses them)."""
    with open(path, "wb") as fh:
        for i, s in enumerate(reads):
            if origins is None:
                name = b"%s%d" % (prefix.encode(), i)
            else:
                allele, start = origins[0][i], int(origins[1][i])
                name = b"%d_0_%d_%d_%d_0_0_0_0_%s" % (
                    i, start, start + len(s) - 1, len(s), allele.encode()
                )
            fh.write(b"@%s\n%s\n+\n%s\n" % (name, s, b"I" * len(s)))


def cascade_case(seed, Gs=3, P=5, Pb=8, Lb=160, Lr=32, C=12, Nb=24,
              pad_pairs=3, pad_probes=5, short=False, rev_frac=0.5, n_run=0,
              twins=False, max_probes=5):
    """Seeded inputs of the pair cascade (groot_tpu's `_pair_cascade`, the
    port's `align.device_cascade.pair_cascade`) as numpy arrays, and the
    number of real pairs: Gs graphs of P aligned rows whose
    segments are shared or variant nodes, reads cut from the rows (a
    `rev_frac` share reverse complemented, some with a first/last/middle
    base changed or an N), 1-3 mappings per read with 0-`max_probes`
    contained-node probes each (past 5, drawn with repeats from all the
    graph's nodes), then pad pairs and pad probes as the reference's packer
    makes them. `short` makes paths long enough that reads reach past the
    last window. `n_run` puts a run of that many Ns in each graph's rows and
    cuts half of the reads from it (every strand matches there). `twins`
    gives some segments a twin node on the same rows at the same
    coordinates, probed at its original's rank: a stage-2 tie that the
    lowest probe row must win."""
    rng = np.random.default_rng(seed)
    codes = np.full((Gs, Pb, Lb), 4, np.uint8)
    plen = np.zeros((Gs, Pb), np.int32)
    term = np.zeros((Gs, Pb), bool)
    npos = np.full((Gs, Nb, Pb), -1, np.int32)
    nlen = np.zeros((Gs, Nb), np.int32)
    segs_of, run_at, twin_of = [], [], {}
    for g in range(Gs):
        Lg = int(rng.integers(Lb - Lr - 10, Lb - 4) if short
                 else rng.integers(Lb // 2, Lb - Lr))
        base = rng.integers(0, 4, Lg).astype(np.uint8)
        base[rng.random(Lg) < 0.01] = 4
        if n_run:
            run_at.append(int(rng.integers(4, Lg - n_run - 4)))
            base[run_at[-1]: run_at[-1] + n_run] = 4
        n_seg = (Nb - 1) // 2
        cuts = np.sort(rng.choice(np.arange(4, Lg - 4), n_seg - 1, replace=False))
        bounds = list(zip([0, *cuts.tolist()], [*cuts.tolist(), Lg]))
        segs = []
        node = 0
        rows = np.tile(base, (P, 1))
        for a, b in bounds:
            variants = [node]
            nlen[g, node] = b - a
            node += 1
            if rng.random() < 0.5:  # a variant node at the same coordinates
                variants.append(node)
                nlen[g, node] = b - a
                node += 1
            for r in range(P):
                v = variants[int(rng.integers(len(variants)))]
                npos[g, v, r] = a
                if v != variants[0]:
                    pos = int(rng.integers(a, b))
                    rows[r, pos] = (rows[r, pos] + 1) % 4
            if twins and node < Nb - 1 and rng.random() < 0.5:
                npos[g, node] = npos[g, variants[0]]
                nlen[g, node] = b - a
                twin_of[(g, node)] = variants[0]
                variants.append(node)
                node += 1
            segs.append((a, b, variants))
        segs_of.append(segs)
        for r in range(P):
            plen[g, r] = Lg - int(rng.integers(0, 3))
            codes[g, r, : plen[g, r]] = rows[r, : plen[g, r]]
            term[g, r] = rng.random() < 0.4
    read_codes = np.full((C, Lr), 4, np.uint8)
    read_len = np.zeros(C, np.int32)
    g_idx = rng.integers(0, Gs, C).astype(np.int32)
    pairs, probes = [], []
    for c in range(C):
        g = int(g_idx[c])
        r = int(rng.integers(P))
        rl = int(rng.integers(Lr - 12, Lr + 1)) if rng.random() < 0.8 else int(rng.integers(2, 12))
        s = int(rng.integers(0, max(plen[g, r] - rl // 2, 1)))
        if n_run and rng.random() < 0.5:
            s = run_at[g] + int(rng.integers(0, max(n_run - rl, 0) + 1))
        seq = codes[g, r, s : s + rl].copy()
        rl = len(seq)
        wild = seq == 4
        seq[wild] = rng.integers(0, 4, int(wild.sum()))
        kind = rng.choice(["exact", "exact", "first", "last", "mid", "N"])
        if rl > 2:
            i = {"first": 0, "last": rl - 1, "mid": rl // 2}.get(str(kind))
            if i is not None:
                seq[i] = (seq[i] + 1) % 4
            elif kind == "N":
                seq[int(rng.integers(rl))] = 4
        if rng.random() < rev_frac:
            seq = _RC_CODE[seq][::-1]
        read_codes[c, :rl] = seq
        read_len[c] = rl
        segs = segs_of[g]
        near = [i for i, (a, b, _v) in enumerate(segs) if a <= s + 20 and b >= s - 20]
        for _m in range(int(rng.integers(1, 4))):
            si = near[int(rng.integers(len(near)))]
            a, _b, variants = segs[si]
            seed_node = variants[int(rng.integers(len(variants)))]
            shift = 0 if rng.random() < 0.5 else int(rng.integers(-4, 3))
            off = max(s - a + shift, 0)
            span = int(rng.choice([-1, 0, 2, 5, 20, 60]))
            pairs.append((c, seed_node, off, span))
            if max_probes <= 5:
                cand = sorted({v for i in near for v in segs[i][2]})
                n_p = int(rng.integers(0, min(max_probes + 1, len(cand)) + 1))
                chosen = rng.choice(cand, n_p, replace=False)
            else:
                cand = [v for _a, _b, vs in segs for v in vs]
                n_p = int(rng.integers(max_probes // 2, max_probes + 1))
                chosen = rng.choice(cand, n_p, replace=True)
            pr = sorted(chosen.tolist())
            if twins:  # probe every chosen node's twin or original too
                pair_of = {}
                for (gg, t), o in twin_of.items():
                    if gg == g:
                        pair_of[t], pair_of[o] = o, t
                pr = sorted(set(pr) | {pair_of[v] for v in pr if v in pair_of})
            # a probe's rank: its place among the pair's nodes, a twin
            # taking its original's
            canon = sorted({twin_of.get((g, v), v) for v in pr})
            probes.append([(v, canon.index(twin_of.get((g, v), v))) for v in pr])
    n_real = len(pairs)
    Np = n_real + pad_pairs
    pad_node = Nb - 1
    pair_combo = np.zeros(Np, np.int32)
    pair_valid = np.zeros(Np, bool)
    seed_idx = np.full(Np, pad_node, np.int32)
    seed_off = np.zeros(Np, np.int32)
    span_lim = np.full(Np, -1, np.int32)
    probe_pair, probe_node, probe_rank = [], [], []
    for p, ((c, node, off, span), pr) in enumerate(zip(pairs, probes)):
        pair_combo[p], pair_valid[p] = c, True
        seed_idx[p], seed_off[p], span_lim[p] = node, off, span
        for nd, rank in pr:
            probe_pair.append(p)
            probe_node.append(nd)
            probe_rank.append(rank)
    probe_pair += [Np - 1] * pad_probes
    probe_node += [pad_node] * pad_probes
    probe_rank += [0] * pad_probes
    arrays = (
        codes, npos, nlen, plen, term, g_idx, read_codes, read_len,
        pair_combo, pair_valid, seed_idx, seed_off, span_lim,
        np.array(probe_pair, np.int32), np.array(probe_node, np.int32),
        np.array(probe_rank, np.int32),
    )
    return arrays, n_real


def em_batch(seed: int, n_paths: Sequence[int], E: int, P: Optional[int] = None,
             zero_frac: float = 0.1, min_fill: float = 0.25):
    """A padded EM batch (em.em_batched's inputs) as numpy arrays: float32
    0/1 membership [G, E, P], float32 counts [G, E], int32 n_paths [G]. Graph
    g has n_paths[g] paths and a random number of ecs from min_fill * E up
    to E; as in a
    variation graph, about half its ecs hold every path and the rest a
    random subset; a `zero_frac` share of the counts is 0 and the padding
    ecs are empty with count 0. n_paths 0 makes an empty graph."""
    rng = np.random.default_rng(seed)
    G = len(n_paths)
    P = max(max(n_paths, default=1), 1) if P is None else P
    membership = np.zeros((G, E, P), np.float32)
    counts = np.zeros((G, E), np.float32)
    for g, n in enumerate(n_paths):
        if n == 0 or E == 0:
            continue
        n_ec = int(rng.integers(max(int(E * min_fill), 1), E + 1))
        full = rng.random(n_ec) < 0.5
        for e in range(n_ec):
            k = n if full[e] else int(rng.integers(1, n + 1))
            membership[g, e, rng.choice(n, size=k, replace=False)] = 1.0
        counts[g, :n_ec] = rng.integers(1, 300, size=n_ec) / rng.integers(
            20, 200, size=n_ec)
        counts[g, :n_ec][rng.random(n_ec) < zero_frac] = 0.0
    return membership, counts, np.asarray(n_paths, np.int32)


def match_bits_case(seed: int, P: int = 3, Lp: int = 200, K: int = 40,
                    Lr: int = 45, pad: int = 0, n_frac: float = 0.02,
                    n_run: int = 0, zero_frac: float = 0.1,
                    pad_frac: float = 0.1):
    """Seeded inputs of one match-bits call (`align.aligner.match_bits`) as
    numpy arrays: u8 path codes [P, Lp] (rows that share a founder, a few
    substitutions each, an `n_frac` share of Ns, a run of `n_run` Ns in
    row 0, the last `pad` columns N as the aligner pads them), u8 variant
    codes [K, Lr] and int32 var_len [K]. Most variants are cut from a row at
    a random offset (some with a base changed or an N), the rest are random;
    var_len is mostly 1..Lr, a `zero_frac` share 0 (matches everywhere) and
    a `pad_frac` share -1 (padding, never matches)."""
    rng = np.random.default_rng(seed)
    real = Lp - pad
    founder = rng.integers(0, 4, real).astype(np.uint8)
    path = np.full((P, Lp), 4, np.uint8)
    for p in range(P):
        row = founder.copy()
        sub = rng.random(real) < 0.02
        row[sub] = rng.integers(0, 4, int(sub.sum()))
        row[rng.random(real) < n_frac] = 4
        path[p, :real] = row
    if n_run:
        at = int(rng.integers(0, max(real - n_run, 1)))
        path[0, at:at + n_run] = 4
    var = rng.integers(0, 4, (K, Lr)).astype(np.uint8)
    var_len = rng.integers(1, Lr + 1, K).astype(np.int32)
    for k in range(K):
        if rng.random() < 0.8:
            o = int(rng.integers(0, Lp - Lr + 1))
            var[k] = np.where(path[k % P, o:o + Lr] >= 4,
                              rng.integers(0, 4, Lr), path[k % P, o:o + Lr])
            if rng.random() < 0.3:
                var[k, rng.integers(0, Lr)] = rng.integers(0, 4)
        if rng.random() < 0.2:
            var[k, rng.integers(0, Lr)] = 4
    u = rng.random(K)
    var_len[u < zero_frac] = 0
    var_len[u > 1 - pad_frac] = -1
    return path, var, var_len


def match_bits_batch_case(seed: int, n_graphs: int = 6, rows: Tuple[int, int] = (1, 5),
                          row_len: Tuple[int, int] = (300, 1500), n_reads: int = 60,
                          read_len: Sequence[int] = (20, 25, 31, 32, 60, 100, 150),
                          per_graph: Tuple[int, int] = (1, 12), n_frac: float = 0.01,
                          long_reads: Sequence[int] = ()):
    """Seeded inputs of one batched match-bits call
    (`align.aligner.match_bits_batch`, nvar 6) as numpy arrays: path rows
    (u8 codes, flat, each row's real bases; int64 row_off, int32 row_len),
    reads (u8 [R, Lr], Lr the longest rounded up to a multiple of 32, N past
    a read's end; int32 read_len), int32 pairs and int64 segs (first pair,
    pairs, first row, rows, W = the graph's longest row + 1). A graph's rows
    share a founder (a few substitutions each, and a deletion, so its rows
    differ in length; an `n_frac` share of Ns); most reads are cut from a
    row (some reverse complemented, some with an N), the rest random; each
    graph takes a random subset of the reads, so a read can be seeded to
    several graphs. Each of `long_reads` (lengths, after the others) is a
    row's tail (Ns replaced) followed by random bases, half of them
    reverse complemented, seeded to that row's graph alone."""
    rng = np.random.default_rng(seed)
    codes, lens, segs, graph_rows = [], [], [], []
    for _g in range(n_graphs):
        founder = rng.integers(0, 4, int(rng.integers(*row_len))).astype(np.uint8)
        P = int(rng.integers(rows[0], rows[1] + 1))
        segs.append([0, 0, len(lens), P, 0])
        grows = []
        for _p in range(P):
            row = founder.copy()
            sub = rng.random(len(row)) < 0.02
            row[sub] = rng.integers(0, 4, int(sub.sum()))
            row[rng.random(len(row)) < n_frac] = 4
            if rng.random() < 0.5:
                at = int(rng.integers(0, len(row) - 20))
                row = np.delete(row, np.s_[at:at + int(rng.integers(1, 20))])
            grows.append(row)
            codes.append(row)
            lens.append(len(row))
        segs[-1][4] = max(len(r) for r in grows) + 1
        graph_rows.append(grows)
    R = n_reads
    rlen = np.asarray(read_len)[rng.integers(0, len(read_len), R)].astype(np.int32)
    rlen = np.concatenate([rlen, np.asarray(long_reads, np.int32)])
    Lr = -(-max(int(rlen.max()), 32) // 32) * 32
    reads = np.full((len(rlen), Lr), 4, np.uint8)
    long_graph = []
    for i in range(R, len(rlen)):
        g = int(rng.integers(0, n_graphs))
        row = graph_rows[g][int(rng.integers(0, len(graph_rows[g])))]
        tail = row[int(rng.integers(0, len(row))):]
        n = int(rlen[i])
        r = np.concatenate([tail, rng.integers(0, 4, max(n - len(tail), 0))])[:n]
        r = np.where(r >= 4, rng.integers(0, 4, n), r)
        reads[i, :n] = _RC_CODE[r[::-1]] if rng.random() < 0.5 else r
        long_graph.append(g)
    for i in range(R):
        n = int(rlen[i])
        if rng.random() < 0.85:
            grows = graph_rows[int(rng.integers(0, n_graphs))]
            row = grows[int(rng.integers(0, len(grows)))]
            at = int(rng.integers(0, max(len(row) - n, 0) + 1))
            r = np.where(row[at:at + n] >= 4, rng.integers(0, 4, n), row[at:at + n])
            if rng.random() < 0.5:
                r = _RC_CODE[r[::-1]]
        else:
            r = rng.integers(0, 4, n)
        if rng.random() < 0.2:
            r[int(rng.integers(0, n))] = 4
        reads[i, :n] = r
    pairs = []
    for g, seg in enumerate(segs):
        take = rng.choice(R, size=min(int(rng.integers(per_graph[0], per_graph[1] + 1)), R),
                          replace=False).tolist()
        take += [R + i for i, lg in enumerate(long_graph) if lg == g]
        seg[0], seg[1] = len(pairs), len(take)
        pairs.extend(take)
    lens = np.asarray(lens, np.int32)
    row_off = (np.cumsum(lens) - lens).astype(np.int64)
    return (np.concatenate(codes), row_off, lens, reads, rlen,
            np.asarray(pairs, np.int32), np.asarray(segs, np.int64))
