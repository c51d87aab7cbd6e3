"""The plain reference of one align + report pass, in numpy and Python.

It imports nothing of the program. Its inputs are the raw ones (the
configuration's alleles and settings, and the reads written for the run)
and the graph store that the program's `index` command built (`groot.gg`).
The reference follows the graphs' nodes as state and checks them on their
own (`check_index`): the index's k, s and w must be the configuration's,
every path must spell its allele, every node's position must be its path's
running length, and consecutive nodes of a path must be joined by an edge.
Everything else of the index it works out again from the path sequences
(`window_table`, after graph.go:298-388): every window's sketch, the runs
of equal sketches, the windows merged across paths and the node tallies
that weight a mapping. It never reads the program's window table.

From there it works out, for every read: the KHF sketch (a frozen copy of
the ntHash/KHF arithmetic), the windows whose whole sketch equals it (the
index's full-equality mode, which t = 0.99 puts every read of these
configurations in; a configuration or traffic outside that mode is outside
this reference and raises), the weight of every mapping tried in (node,
offset) order up to the first that aligns, the four-stage exact cascade of
src/graph/alignment.go (seed offsets, contained nodes, a clipped start, a
clipped end) by plain byte comparison, and one record a matching path.
Then the pruned paths at -c 1.0 and the report rows at --covCutoff 0.97,
from its own records.
"""

from __future__ import annotations

import bisect
import gzip
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# ntHash / KHF MinHash (frozen copy of the arithmetic)
# ---------------------------------------------------------------------------
SEEDS = np.array([0x3C8BFBB395C60474, 0x3193C18562A02B4C, 0x20323ED082572324,
                  0x295549F54BE24456, 0], dtype=np.uint64)
SEEDS_RC = SEEDS[np.array([3, 2, 1, 0, 4])]
MULTISEED = 0x90B45D39FB6DA1FA
MULTISHIFT = 27
ASCII_TO_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    ASCII_TO_CODE[_b] = _i
    ASCII_TO_CODE[_b + 32] = _i
_RC_BYTES = bytes.maketrans(b"ACGTacgt", b"TGCATGCA")
_NON_ACGT = bytes(sorted(set(range(256)) - set(b"ACGTacgt")))
_TO_N = bytes.maketrans(_NON_ACGT, b"N" * len(_NON_ACGT))


def _rol(x: np.ndarray, r) -> np.ndarray:
    r = np.asarray(r, dtype=np.uint64) % np.uint64(64)
    with np.errstate(over="ignore"):
        return np.where(r == 0, x, (x << r) | (x >> (np.uint64(64) - r))).astype(np.uint64)


def canonical_hashes(codes: np.ndarray, k: int) -> np.ndarray:
    """u8 codes [B, L] -> the canonical ntHash of every k-mer [B, L-k+1]:
    rol(seed, k-1-j) XORed over the k-mer's bases, forward and reverse
    complement, the smaller of the two."""
    B, L = codes.shape
    m = np.arange(L, dtype=np.uint64) % np.uint64(64)
    t = _rol(np.broadcast_to(SEEDS[:, None], (5, L)), np.uint64(64) - m[None, :])
    u = _rol(np.broadcast_to(SEEDS_RC[:, None], (5, L)), m[None, :])
    pos = np.arange(L)
    X = np.bitwise_xor.accumulate(t[codes, pos[None, :]], axis=1)
    Y = np.bitwise_xor.accumulate(u[codes, pos[None, :]], axis=1)
    nk = L - k + 1
    wx = X[:, k - 1 :].copy()
    wx[:, 1:] ^= X[:, : nk - 1]
    wy = Y[:, k - 1 :].copy()
    wy[:, 1:] ^= Y[:, : nk - 1]
    lane = np.arange(nk, dtype=np.uint64)
    fwd = _rol(wx, (lane + np.uint64(k - 1)) % np.uint64(64))
    rev = _rol(wy, (np.uint64(64) - lane % np.uint64(64)) % np.uint64(64))
    return np.minimum(fwd, rev)


def khf_sketch(codes: np.ndarray, k: int, s: int, chunk: int = 4096) -> np.ndarray:
    """KHF sketches of equal-length coded sequences, u64 [B, s]: slot 0 is
    the least canonical hash, slot m the least of h * (m ^ k*MULTISEED)
    xor-shifted right by 27."""
    codes = np.asarray(codes, np.uint8)
    out = np.empty((len(codes), s), np.uint64)
    with np.errstate(over="ignore"):
        kseed = np.uint64(np.uint64(k) * np.uint64(MULTISEED))
        for a in range(0, len(codes), chunk):
            c = canonical_hashes(codes[a : a + chunk], k)
            o = out[a : a + chunk]
            o[:, 0] = c.min(axis=1)
            for slot in range(1, s):
                h = c * (np.uint64(slot) ^ kseed)
                h ^= h >> np.uint64(MULTISHIFT)
                o[:, slot] = h.min(axis=1)
    return out


# ---------------------------------------------------------------------------
# the index, read as state
# ---------------------------------------------------------------------------
class _Plain:
    """Stand-in for a pickled class of the index: attributes only."""


_STANDINS = {name: type(name, (_Plain,), {})
             for name in ("Info", "AlignCmd", "HaploCmd", "GrootGraph", "GraphNode")}
_ALLOWED = ("builtins", "copyreg", "collections", "numpy", "_codecs")


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        top = module.split(".")[0]
        if top in ("groot_tpu", "groot_tpu_torch"):
            if name in _STANDINS:
                return _STANDINS[name]
            raise pickle.UnpicklingError(f"unexpected class {module}.{name}")
        if top not in _ALLOWED:
            raise pickle.UnpicklingError(f"unexpected module {module}")
        return super().find_class(module, name)


class Index:
    """The graph store of an index directory, and the window table this
    module works out from its paths."""

    def __init__(self, index_dir: str):
        with gzip.open(f"{index_dir}/groot.gg", "rb") as fh:
            info = _Unpickler(fh).load()
        self.k = int(info.kmer_size)
        self.s = int(info.sketch_size)
        self.w = int(info.window_size)
        self.d = self.w - self.k + 1
        self.store = info.store  # {graph id: GrootGraph stand-in}
        self.graphs = {}
        for gid, g in self.store.items():
            self.graphs[gid] = _Graph(g)
        # reference ids: sorted (graph id, path id), as the BAM header
        self.ref_of = {}
        self.refs = []
        for gid in sorted(self.store):
            g = self.store[gid]
            for pid in sorted(g.paths):
                self.ref_of[(gid, pid)] = len(self.refs)
                self.refs.append((g.paths[pid], int(g.lengths[pid])))
        tab = window_table(self)
        self.sketches = tab["sketches"]
        self.w_graph, self.w_node, self.w_off = tab["graph"], tab["node"], tab["off"]
        self.w_span = tab["span"]
        self.cn_ptr, self.cn_seg, self.cn_val = tab["cn_ptr"], tab["cn_seg"], tab["cn_val"]

    def contained(self, w: int) -> List[Tuple[int, float]]:
        a, b = int(self.cn_ptr[w]), int(self.cn_ptr[w + 1])
        return list(zip(self.cn_seg[a:b].tolist(), self.cn_val[a:b].tolist()))


class _Graph:
    """One graph's paths as bytes, node positions and lengths."""

    def __init__(self, g):
        self.gid = int(g.graph_id)
        self.nodes = g.sorted_nodes
        self.seg_len = {n.segment_id: len(n.sequence) for n in g.sorted_nodes}
        self.node_pos = {n.segment_id: dict(n.position) for n in g.sorted_nodes}
        self.path_ids = sorted(g.paths)
        self.seq: Dict[int, bytes] = {}
        self.tfree: Dict[int, bool] = {}
        self.path_nodes: Dict[int, list] = {}
        for pid in self.path_ids:
            nodes = [n for n in g.sorted_nodes if pid in n.path_ids]
            self.path_nodes[pid] = nodes
            self.seq[pid] = b"".join(bytes(n.sequence) for n in nodes)
            if self.seq[pid].translate(None, b"ACGT"):
                # a graph N matches any read base: outside this reference
                raise ValueError(f"graph {self.gid} has a path with a base other than ACGT")
            self.tfree[pid] = bool(nodes) and len(nodes[-1].out_edges) == 0
        self.plen = {pid: len(sq) for pid, sq in self.seq.items()}
        self._occ: Dict[bytes, Dict[int, List[int]]] = {}

    def occ_map(self, v: bytes) -> Dict[int, List[int]]:
        """{path: occurrences of v}, kept until `_occ` is cleared."""
        got = self._occ.get(v)
        if got is None:
            got = self._occ[v] = {pid: self.occurrences(v, pid) for pid in self.path_ids}
        return got

    def occurrences(self, v: bytes, pid: int) -> List[int]:
        """Sorted starts at which variant v lies wholly inside path pid."""
        p = self.seq[pid]
        got = []
        i = p.find(v)
        while i >= 0:
            got.append(i)
            i = p.find(v, i + 1)
        return got

    def tail_matches(self, v: bytes, pid: int, lo: int, hi: int) -> List[int]:
        """Starts in [lo, hi] at which v runs past the end of path pid with
        the path's tail its prefix; only a path that ends in a dead end
        takes such a match (alignment.go:229)."""
        plen = self.plen[pid]
        if hi <= plen - len(v) or not self.tfree[pid]:
            return []
        p = self.seq[pid]
        return [i for i in range(max(lo, plen - len(v) + 1), min(hi, plen - 1) + 1)
                if v.startswith(p[i:])]

    def can_match(self, v: bytes) -> bool:
        """Whether v starts anywhere on any path, inside it or past a dead
        end (a tail match of 8 or more bases holds v's first 8 bases)."""
        occ = self.occ_map(v)
        if any(occ.values()):
            return True
        pre = v[:8]
        for pid in self.path_ids:
            if not self.tfree[pid]:
                continue
            p, plen = self.seq[pid], self.plen[pid]
            i = p.find(pre, max(plen - len(v) + 1, 0))
            while 0 <= i <= plen - 8:
                if v.startswith(p[i:]):
                    return True
                i = p.find(pre, i + 1)
            if self.tail_matches(v, pid, plen - 7, plen - 1):
                return True
        return False


def check_index(ix: Index, clusters, config: dict) -> int:
    """The graph store against the raw database and the configuration: k, s
    and w are the configuration's, every path spells its allele under its
    name, every node sits at its path's running length, and consecutive
    nodes of a path are joined by an edge. Returns the number of faults."""
    faults = sum(int(getattr(ix, key) != int(config[key])) for key in ("k", "s", "w"))
    want = {name: seq.replace(b"-", b"") for rows in clusters for name, seq in rows}
    seen = 0
    for gid, g in ix.graphs.items():
        for pid in g.path_ids:
            seen += 1
            name = ix.store[gid].paths[pid]
            if want.get(name) != g.seq[pid]:
                faults += 1
            nodes = g.path_nodes[pid]
            for a, b in zip(nodes[:-1], nodes[1:]):
                faults += b.segment_id not in a.out_edges
        run = {pid: 0 for pid in g.path_ids}
        for n in g.nodes:
            for pid in n.path_ids:
                if n.position.get(pid) != run[pid]:
                    faults += 1
                run[pid] += len(n.sequence)
    faults += abs(seen - len(want))
    return faults


# ---------------------------------------------------------------------------
# the window table, worked out from the paths
# ---------------------------------------------------------------------------
_U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _sliding_min(h: np.ndarray, m: int) -> np.ndarray:
    """min(h[i : i + m]) for every i, by block prefix and suffix minima."""
    n = len(h)
    nb = -(-n // m)
    hp = np.concatenate([h, np.full(nb * m - n, _U64_MAX)]).reshape(nb, m)
    pre = np.minimum.accumulate(hp, axis=1).ravel()
    suf = np.minimum.accumulate(hp[:, ::-1], axis=1)[:, ::-1].ravel()
    i = np.arange(n - m + 1)
    return np.minimum(suf[i], pre[i + m - 1])


def _clip_sum(u, v, s, e):
    """sum over j in [u, v] of min(max(j, s), e), elementwise (u <= v + 1)."""
    def q(x):  # sum over j <= x of clip(j) - s
        d = e - s
        return np.where(x < s, 0, np.where(x <= e, (x - s) * (x - s + 1) // 2,
                                           d * (d + 1) // 2 + (x - e) * d))
    return (v - u + 1) * s + q(v) - q(u - 1)


def window_table(ix: Index) -> Dict[str, np.ndarray]:
    """The index's windows from the path sequences (graph.go:298-388).
    Every stride-1 window of w bases of every path is sketched; consecutive
    windows of a path with equal sketches form a run, and a path's last run
    is dropped unless it is its only one. A run is a window at (its first
    window's node, offset) with span = its windows - 1, and tallies for
    every node it touches: the bases of the node that each of its windows
    covers, summed. Runs of any paths of a graph at the same (node, offset)
    with the same sketch merge: the largest span, the tallies summed per
    node. Returns the windows' graph, node, offset, span and sketch, and the
    tallies as CSR (cn_ptr, cn_seg ascending, cn_val)."""
    k, s, w = ix.k, ix.s, ix.w
    m = w - k + 1
    p_gid, seqs, n_seg, n_start, n_len, n_path = [], [], [], [], [], []
    for gid in sorted(ix.graphs):
        g = ix.graphs[gid]
        for pid in g.path_ids:
            if g.plen[pid] < w:
                raise ValueError(f"graph {gid} has a path shorter than the window")
            pi = len(seqs)
            p_gid.append(gid)
            seqs.append(g.seq[pid])
            start = 0
            for n in g.path_nodes[pid]:
                n_seg.append(n.segment_id)
                n_start.append(start)
                n_len.append(len(n.sequence))
                n_path.append(pi)
                start += len(n.sequence)
    p_gid = np.asarray(p_gid, np.int64)
    p_len = np.array([len(q) for q in seqs], np.int64)
    p_base = np.concatenate(([0], np.cumsum(p_len)[:-1]))
    n_seg = np.asarray(n_seg, np.int64)
    n_start = np.asarray(n_start, np.int64)
    n_len = np.asarray(n_len, np.int64)
    n_key = (np.asarray(n_path, np.int64) << np.int64(32)) | n_start

    # every window's sketch: the k-mers' hashes along all paths at once
    # (those across two paths are never read)
    codes = ASCII_TO_CODE[np.frombuffer(b"".join(seqs), np.uint8)]
    canon = canonical_hashes(codes[None, :], k)[0]
    p_nw = p_len - w + 1
    w_path = np.repeat(np.arange(len(seqs)), p_nw)
    w_pos = np.arange(int(p_nw.sum()), dtype=np.int64) - np.repeat(
        np.concatenate(([0], np.cumsum(p_nw)[:-1])), p_nw)
    first_kmer = p_base[w_path] + w_pos
    sk = np.empty((len(w_path), s), np.uint64)
    with np.errstate(over="ignore"):
        kseed = np.uint64(np.uint64(k) * np.uint64(MULTISEED))
        for slot in range(s):
            if slot:
                h = canon * (np.uint64(slot) ^ kseed)
                h ^= h >> np.uint64(MULTISHIFT)
            else:
                h = canon
            sk[:, slot] = _sliding_min(h, m)[first_kmer]

    # runs of equal sketches; a path's last run goes unless it is its only one
    change = np.ones(len(w_path), bool)
    change[1:] = (sk[1:] != sk[:-1]).any(axis=1) | (w_path[1:] != w_path[:-1])
    starts = np.flatnonzero(change)
    ends = np.append(starts[1:], len(w_path)) - 1
    r_path = w_path[starts]
    last = np.append(r_path[1:] != r_path[:-1], True)
    first = np.insert(r_path[1:] != r_path[:-1], 0, True)
    keep = ~last | first
    starts, ends, r_path = starts[keep], ends[keep], r_path[keep]
    a, b = w_pos[starts], w_pos[ends]
    r_sk = sk[starts]
    del sk
    fi = np.searchsorted(n_key, (r_path << np.int64(32)) | a, side="right") - 1
    li = np.searchsorted(n_key, (r_path << np.int64(32)) | (b + w - 1), side="right") - 1
    r_node, r_off = n_seg[fi], a - n_start[fi]

    # tallies of each (run, node): over the run's windows j, the bases of
    # [j, j + w) in the node, summed
    cnt = li - fi + 1
    rr = np.repeat(np.arange(len(a)), cnt)
    nn = fi[rr] + np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    ns, ne = n_start[nn], n_start[nn] + n_len[nn]
    val = (_clip_sum(a[rr] + w, b[rr] + w, ns, ne) - _clip_sum(a[rr], b[rr], ns, ne))

    # merge across paths: same graph, node, offset and sketch
    comp = np.empty((len(a), s + 3), np.uint64)
    comp[:, 0] = p_gid[r_path].astype(np.uint64)
    comp[:, 1] = r_node.astype(np.uint64)
    comp[:, 2] = r_off.astype(np.uint64)
    comp[:, 3:] = r_sk
    view = np.ascontiguousarray(comp).view(np.dtype((np.void, 8 * (s + 3)))).ravel()
    _u, g_first, ginv = np.unique(view, return_index=True, return_inverse=True)
    ginv = ginv.ravel()
    G = len(g_first)
    span = np.zeros(G, np.int64)
    np.maximum.at(span, ginv, b - a)
    combo = (ginv[rr].astype(np.int64) << np.int64(32)) | n_seg[nn]
    uc, uinv = np.unique(combo, return_inverse=True)
    cn_val = np.bincount(uinv.ravel(), weights=val.astype(np.float64))
    cn_ptr = np.searchsorted(uc >> np.int64(32), np.arange(G + 1))
    return {
        "graph": p_gid[r_path[g_first]], "node": r_node[g_first], "off": r_off[g_first],
        "span": span, "sketches": np.ascontiguousarray(r_sk[g_first]),
        "cn_ptr": cn_ptr, "cn_seg": uc & np.int64(0xFFFFFFFF), "cn_val": cn_val,
    }


# ---------------------------------------------------------------------------
# one pass
# ---------------------------------------------------------------------------
NODE_SHUFFLES = 10  # alignment.go:52


def _seed_hits(ix: Index, reads: np.ndarray, threshold: float):
    """(read, window) pairs whose whole sketches are equal, in read then
    (graph, node, offset, window) order. Only the full-equality mode: a
    configuration outside it is outside this reference."""
    B, L = reads.shape
    q = float(L - ix.k + 1)
    d = float(ix.d)
    bound = ix.s * threshold * q / (q + d - threshold * q)
    if bound < ix.s - 1:
        raise ValueError("t, k, w and the read length leave the full-equality mode")
    if not (q + d) / (2.0 * q) > threshold:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    codes = ASCII_TO_CODE[reads]
    # slot 0 first: a read whose least hash no window has cannot match
    slot0 = np.unique(ix.sketches[:, 0])
    c0 = np.empty(B, np.uint64)
    for a in range(0, B, 4096):
        c0[a : a + 4096] = canonical_hashes(codes[a : a + 4096], ix.k).min(axis=1)
    cand = np.flatnonzero(np.isin(c0, slot0))
    sk = khf_sketch(codes[cand], ix.k, ix.s)
    # exact join on the whole sketch
    win_view = np.ascontiguousarray(ix.sketches).view(np.dtype((np.void, 8 * ix.s))).ravel()
    order = np.argsort(win_view, kind="stable")
    sorted_w = win_view[order]
    q_view = np.ascontiguousarray(sk).view(np.dtype((np.void, 8 * ix.s))).ravel()
    lo = np.searchsorted(sorted_w, q_view, side="left")
    hi = np.searchsorted(sorted_w, q_view, side="right")
    cnt = hi - lo
    rows = np.repeat(cand, cnt)
    starts = np.repeat(lo, cnt) + (np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt))
    wins = order[starts].astype(np.int64)
    o = np.lexsort((wins, ix.w_off[wins], ix.w_node[wins], ix.w_graph[wins], rows))
    return rows[o], wins[o]


def _probe(g: _Graph, v: bytes, occ: Dict[int, List[int]], node: int,
           o: int) -> Optional[Dict[int, int]]:
    """The paths through `node` on which v (its inner occurrences `occ`)
    starts at in-node offset `o`: {path: start}, or None."""
    if o >= g.seg_len.get(node, 0):
        return None
    out = {}
    for pid, pos in g.node_pos.get(node, {}).items():
        st = pos + o
        lst = occ[pid]
        i = bisect.bisect_left(lst, st)
        if (i < len(lst) and lst[i] == st) or g.tail_matches(v, pid, st, st):
            out[pid] = st
    return out or None


def _first_probe(g: _Graph, v: bytes, occ, node: int, o0: int, o1: int):
    """The probe at the least in-node offset in [o0, o1] (and below the
    node's length) at which some path matches, or None."""
    o1 = min(o1, g.seg_len.get(node, 0) - 1)
    if o1 < o0:
        return None
    best = None
    for pid, pos in g.node_pos.get(node, {}).items():
        lst = occ[pid]
        if lst:
            i = bisect.bisect_left(lst, pos + o0)
            if i < len(lst) and lst[i] <= pos + o1:
                o = lst[i] - pos
                best = o if best is None else min(best, o)
        tail = g.tail_matches(v, pid, pos + o0, pos + o1)
        if tail:
            o = tail[0] - pos
            best = o if best is None else min(best, o)
    return None if best is None else _probe(g, v, occ, node, best)


def _cascade(g: _Graph, seq: bytes, node: int, offset: int, span: int,
             contained: List[Tuple[int, float]]):
    """alignment.go:34-103 on one orientation: ({path: start}, clips)."""
    full = g.occ_map(seq)
    if g.can_match(seq):  # else no probe of the whole read can match
        hit = _first_probe(g, seq, full, node, offset, offset + span)
        if hit:
            return hit, 0, 0
        for nd in sorted(n for n, _c in contained):
            hit = _first_probe(g, seq, full, nd, 0, NODE_SHUFFLES)
            if hit:
                return hit, 0, 0
    v = seq[1:]
    hit = _probe(g, v, g.occ_map(v), node, offset)
    if hit:
        return hit, 1, 0
    v = seq[:-1]
    hit = _probe(g, v, g.occ_map(v), node, offset)
    if hit:
        return hit, 0, 1
    return None


class Result:
    """What one pass gives: stats, node weights (sorted graph id, then the
    graph's node order), record keys, pruned paths, report rows."""

    def __init__(self, stats, weights, records, kept, rows):
        self.stats = stats
        self.weights = weights
        self.records = records
        self.kept = kept
        self.rows = rows


def align(ix: Index, reads: np.ndarray, names: List[bytes], threshold: float,
          min_kmer_coverage: float, cov_cutoff: float, weight_dtype=np.float64) -> Result:
    """The reference pass. `weight_dtype` float32 makes the control: the
    precision below the float64 that the configuration's weights keep."""
    B, L = reads.shape
    rows, wins = _seed_hits(ix, reads, threshold)
    kc = float(L - ix.k + 1)
    node_row = {}
    for gid in sorted(ix.store):
        for n in ix.store[gid].sorted_nodes:
            node_row[(gid, n.segment_id)] = len(node_row)
    w_rows: List[int] = []
    w_vals: List[float] = []
    records = []
    mapped = multimapped = 0
    starts = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]]) if len(rows) else []
    bounds = list(starts) + [len(rows)]
    for a, b in zip(bounds[:-1], bounds[1:]):
        r = int(rows[a])
        fwd = reads[r].tobytes().translate(_TO_N)
        rc = fwd.translate(_RC_BYTES)[::-1]
        ws = wins[a:b]
        gs = ix.w_graph[ws]
        graphs = sorted(set(gs.tolist()))
        mapped += 1
        multimapped += len(graphs) > 1
        for gid in graphs:
            g = ix.graphs[gid]
            g._occ.clear()  # occurrences are of this read's variants
            for w in ws[gs == gid].tolist():
                cn = ix.contained(w)
                if len(cn) == 1:
                    w_rows.append(node_row[(gid, cn[0][0])])
                    w_vals.append(kc)
                else:
                    tot = float(sum(g.seg_len[n] for n, _c in cn))
                    for n, c in cn:
                        w_rows.append(node_row[(gid, n)])
                        w_vals.append((g.seg_len[n] / tot) * kc * c)
                hit = None
                for ori, seq in enumerate((fwd, rc)):
                    hit = _cascade(g, seq, int(ix.w_node[w]), int(ix.w_off[w]),
                                   int(ix.w_span[w]) + ix.w, cn)
                    if hit:
                        break
                if hit:
                    matches, c0, c1 = hit
                    n_len = L - c0 - c1
                    cigar = (((c0, 5),) if c0 else ()) + ((n_len, 0),) + (((c1, 5),) if c1 else ())
                    for i, pid in enumerate(sorted(matches)):
                        flag = (16 if ori else 0) | (256 if len(matches) > 1 and i else 0)
                        records.append((names[r].decode(), ix.ref_of[(gid, pid)],
                                        matches[pid], flag, n_len, cigar))
                    break
    weights = np.zeros(len(node_row), weight_dtype)
    np.add.at(weights, np.asarray(w_rows, np.int64), np.asarray(w_vals, weight_dtype))
    stats = {"received": B, "mapped": mapped, "multimapped": multimapped,
             "alignment_count": len(records)}
    if mapped == 0:
        return Result(stats, np.zeros(0), sorted(records), [], [])
    kept = prune(ix, weights.astype(np.float64), node_row, min_kmer_coverage)
    return Result(stats, weights.astype(np.float64), sorted(records), kept,
                  report(ix, records, cov_cutoff))


def prune(ix: Index, weights: np.ndarray, node_row, min_cov: float) -> List[str]:
    """graph.go:455-525: a graph whose every path runs through a node under
    the coverage is dropped; of the others every path name is kept."""
    kept = []
    for gid, g in ix.store.items():
        remove = set()
        for n in g.sorted_nodes:
            if weights[node_row[(gid, n.segment_id)]] / float(len(n.sequence)) < min_cov:
                remove.update(n.path_ids)
        if len(remove) == len(g.paths):
            continue
        kept.extend(g.paths[pid] for pid in sorted(g.paths))
    return kept


def cigar_clean(symbols: List[str]) -> Tuple[str, bool]:
    """reporting.go:178-213, with its handling of the last symbol."""
    counter = 1
    pre = symbols[0]
    cigar = ""
    dm: Dict[str, int] = {}
    for i in range(1, len(symbols)):
        val = symbols[i]
        if i == len(symbols) - 1:
            if val == pre:
                counter += 1
                cigar += f"{counter}{val}"
            else:
                cigar += f"{counter}{pre}1{val}"
            dm[val] = dm.get(val, 0) + 1
            break
        if val == pre:
            counter += 1
        else:
            dm[pre] = dm.get(pre, 0) + 1
            cigar += f"{counter}{pre}"
            pre = val
            counter = 1
    d, m = dm.get("D", 0), dm.get("M", 0)
    return cigar, not ((d + m <= 2) or (d == 2 and m == 1))


def report(ix: Index, records, cov_cutoff: float) -> List[Tuple[str, int, int, str]]:
    """reporting.go: per reference the records' pileup, inclusive of
    pos + aligned length and cut at the reference's last base; rows of the
    references covered at least `cov_cutoff`, sorted by name."""
    per_ref: Dict[int, List[Tuple[int, int]]] = {}
    for _name, ref_id, pos, flag, n_len, _cigar in records:
        if flag != 4:
            per_ref.setdefault(ref_id, []).append((pos, n_len))
    rows = []
    for ref_id, recs in per_ref.items():
        name, length = ix.refs[ref_id]
        diff = np.zeros(length + 1, np.int64)
        for pos, n_len in recs:
            end = min(pos + n_len, length - 1)
            diff[pos] += 1
            diff[end + 1] -= 1
        pile = np.cumsum(diff[:-1])
        if (pile > 0).sum() / length < cov_cutoff:
            continue
        cigar, _internal = cigar_clean(["M" if v else "D" for v in pile])
        rows.append((name[1:] if name.startswith("*") else name, len(recs), length, cigar))
    rows.sort()
    return rows
