"""LSH containment index (the `groot.lshe` file), host and device query.

Counterpart of groot_tpu/index/lshe.py without the hi/lo u32 sketch pairs:
sketches are u64 [B, s] throughout (int64 tensors holding the bits on a
device). The file format (v2: a pickled dict of numpy arrays) is the
reference's, so each package loads what the other dumped. The device query
(`mix_bands_torch`, `dev_tensors`, `query_device`: the lsh_query kernel, and
its plain version `query_device_torch`) is the counterpart of
`_mix_bands_jax`, `dev` and `_query_device`.

Reference: src/lshe/lshe.go wraps ekzhu/lshensemble (Zhu et al., VLDB'16).
In groot every indexed domain has the SAME size (NumWindowKmers =
windowSize - kmerSize + 1), so the ensemble's equi-depth partitioning is
degenerate — a single banded MinHash LSH with the containment<->jaccard
conversion reproduces the post-filtered hit set (lshe.go:153-175 re-verifies
every candidate with an exact signature containment estimate).

For each K in 1..maxK (K = hash funcs per band, L_K = sketchSize // K bands)
a band table holds the sorted 32-bit band signatures and their argsort
permutation. The query is band-sig mix -> searchsorted -> gather -> dedup
-> exact containment; when the containment bound forces all s slots equal
it collapses to an exact join on a full-sketch hash (native when the
runtime library is present)."""

from __future__ import annotations

import ctypes
import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .._build import I, Kernel, P, card_query, ptr
from ..io import native
from .window import Key

MAX_PER_BAND = 24  # max candidates gathered per (read, band) before dedup
M32 = 0xFFFFFFFF
LSH_QUERY = Kernel(
    "lsh_query", "groot_lsh_query",
    (P, P, P, P, P, I, I, I, I, I, I, I, ctypes.c_float, ctypes.c_float, I,
     P, P, P),
    source="groot_tpu_torch/csrc/lsh_query.cu",
    replaces="groot_tpu/index/lshe.py:557",
)


def _mix_bands_np(sketch_u64: np.ndarray, K: int) -> np.ndarray:
    """[N, s] uint64 -> [N, L] uint32 band signatures (32-bit FNV mix)."""
    N, s = sketch_u64.shape
    L = s // K
    use = sketch_u64[:, : L * K].reshape(N, L, K)
    h = np.full((N, L), 2166136261, dtype=np.uint32)
    prime = np.uint32(16777619)
    with np.errstate(over="ignore"):
        for j in range(K):
            v = use[:, :, j]
            h = (h ^ (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)) * prime
            h = (h ^ (v >> np.uint64(32)).astype(np.uint32)) * prime
    return h


def mix_bands_torch(q: torch.Tensor, K: int) -> torch.Tensor:
    """int64 [B, s] (u64 sketch bits) -> int64 [B, L] band signatures, the
    32-bit FNV mix of _mix_bands_np op for op, zero-extended (torch has no
    searchsorted on uint32)."""
    B, s = q.shape
    L = s // K
    use = q[:, : L * K].reshape(B, L, K)
    h = torch.full((B, L), 2166136261, dtype=torch.int64, device=q.device)
    prime = 16777619
    for j in range(K):
        v = use[:, :, j]
        h = ((h ^ (v & M32)) * prime) & M32
        h = ((h ^ ((v >> 32) & M32)) * prime) & M32
    return h


def _check_query(q, kmer_counts, sketches, sorted_sigs, band_idx, K, M, qmax):
    dev = q.device
    if q.dtype != torch.int64 or q.dim() != 2:
        raise TypeError("q must be int64 [B, s] (u64 sketch bits)")
    B, s = q.shape
    if kmer_counts.dtype != torch.int32 or kmer_counts.shape != (B,):
        raise TypeError("kmer_counts must be int32 [B]")
    if sketches.dtype != torch.int64 or sketches.dim() != 2 or sketches.shape[1] != s:
        raise TypeError("sketches must be int64 [N, s]")
    N = sketches.shape[0]
    for t, name in ((sorted_sigs, "sorted_sigs"), (band_idx, "band_idx")):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != N:
            raise TypeError(f"{name} must be int32 [L, N]")
    if sorted_sigs.shape != band_idx.shape:
        raise TypeError("sorted_sigs and band_idx differ in shape")
    if any(t.device != dev for t in (kmer_counts, sketches, sorted_sigs, band_idx)):
        raise ValueError("query inputs must share one device")
    if not 1 <= K <= s or sorted_sigs.shape[0] != s // K or N < 1 or M < 1:
        raise ValueError(f"bad query shape s={s} K={K} L={sorted_sigs.shape[0]} N={N} M={M}")
    if qmax is not None and sorted_sigs.shape[0] != 1:
        raise ValueError("the full-equality query takes one table row (K = s)")


def query_device_torch(q, kmer_counts, sketches, sorted_sigs, band_idx, *,
                       K: int, M: int, domain_size: int, threshold: float,
                       qmax: Optional[int] = None):
    """Plain PyTorch version of the lsh_query kernel: banded LSH lookup +
    exact containment, fixed shapes (the reference's _query_device and the
    seed half of parallel/device_index.py::align_step).

    q int64 [B, s] (u64 bits), kmer_counts int32 [B], sketches int64 [N, s],
    sorted_sigs int32 [L, N] (u32 bits, ascending as u32) and band_idx
    int32 [L, N]. Each band gathers at most M windows; banded mode (qmax
    None) sorts the B x L*M ids, masks adjacent duplicates to -1 and keeps
    contain > threshold (f32); full-equality mode (qmax set, one table row
    of full-sketch signatures, K = s) keeps all-slot-equal windows of reads
    with kmer_counts <= qmax. Rows with no k-mer (kmer_counts <= 0: mesh
    padding) keep nothing. Returns (win_idx int32 [B, C], kept ids else -1;
    contain f32 [B, C], of window 0 where the slot is empty)."""
    _check_query(q, kmer_counts, sketches, sorted_sigs, band_idx, K, M, qmax)
    B, s = q.shape
    Lb, N = sorted_sigs.shape
    sigs = mix_bands_torch(q, K)  # [B, L]
    take = torch.arange(M, device=q.device)
    parts = []
    for b in range(Lb):
        row = sorted_sigs[b].long() & M32
        lo = torch.searchsorted(row, sigs[:, b].contiguous(), side="left")
        hi = torch.searchsorted(row, sigs[:, b].contiguous(), side="right")
        pos = lo[:, None] + take[None, :]
        parts.append(torch.where(
            pos < hi[:, None], band_idx[b][pos.clamp(max=N - 1)], -1
        ))
    cands = torch.stack(parts, dim=1).reshape(B, Lb * M)
    if qmax is None:
        cands = torch.sort(cands, dim=1).values
        dup = torch.zeros_like(cands, dtype=torch.bool)
        dup[:, 1:] = cands[:, 1:] == cands[:, :-1]
        cands = torch.where(dup, -1, cands)
    eq = (sketches[cands.clamp(min=0)] == q[:, None, :]).sum(-1)
    # s as a device tensor: a CUDA division by a host scalar multiplies by
    # its reciprocal, which is not the reference's correctly rounded j
    j = eq.to(torch.float32) / torch.full((), s, dtype=torch.float32, device=q.device)
    qs = kmer_counts[:, None].to(torch.float32)
    contain = j * (qs + domain_size) / ((1.0 + j) * qs)
    if qmax is None:
        keep = contain > torch.tensor(threshold, dtype=torch.float32)
    else:
        keep = (eq == s) & (kmer_counts[:, None] <= qmax)
    keep &= (cands >= 0) & (kmer_counts[:, None] > 0)
    return torch.where(keep, cands, -1).to(torch.int32), contain


def query_device(q, kmer_counts, sketches, sorted_sigs, band_idx, *,
                 K: int, M: int, domain_size: int, threshold: float,
                 qmax: Optional[int] = None):
    """The device LSH query (see query_device_torch). A CPU tensor takes the
    plain version; a CUDA tensor launches the lsh_query kernel, or raises."""
    if q.device.type == "cpu":
        return query_device_torch(
            q, kmer_counts, sketches, sorted_sigs, band_idx, K=K, M=M,
            domain_size=domain_size, threshold=threshold, qmax=qmax,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_query(q, kmer_counts, sketches, sorted_sigs, band_idx, K, M, qmax)
    B, s = q.shape
    Lb, N = sorted_sigs.shape
    C = Lb * M
    win = torch.empty((B, C), dtype=torch.int32, device=q.device)
    contain = torch.empty((B, C), dtype=torch.float32, device=q.device)
    if B:
        args = [t.contiguous() for t in (q, kmer_counts, sketches, sorted_sigs, band_idx)]
        nbytes = query_scratch_bytes(B, s, Lb, M, q.device)
        scratch = (torch.empty(nbytes // 4, dtype=torch.int32, device=q.device)
                   if nbytes else None)
        LSH_QUERY.launch(
            q.device, *(ptr(t) for t in args), B, s, N, Lb, K, M,
            -1 if qmax is None else int(qmax), float(domain_size),
            float(threshold), int(qmax is not None), ptr(win), ptr(contain),
            None if scratch is None else ptr(scratch),
        )
    return win, contain


def query_scratch_bytes(B: int, s: int, L: int, M: int, device) -> int:
    """The bytes of scratch the lsh_query kernel takes for B reads of s
    slots and L bands of M candidates on `device`, as csrc/lsh_query.cu
    reports them (groot_lsh_query_scratch_bytes): 0 for the shared route,
    else the global route's int32 [B, 2 Cp] sort buffers."""
    return card_query(device, "groot_lsh_query_scratch_bytes", B, s, L, M)


class _KeysView:
    """Sequence view over the struct-of-arrays index: materialises Key
    objects lazily (only LSH-hit windows of the fallback aligner ever need
    one)."""

    def __init__(self, soa: dict):
        self._soa = soa

    def __len__(self) -> int:
        return len(self._soa["w_graph"])

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        s = self._soa
        lo, hi = int(s["cn_ptr"][i]), int(s["cn_ptr"][i + 1])
        rlo, rhi = int(s["ref_ptr"][i]), int(s["ref_ptr"][i + 1])
        return Key(
            graph_id=int(s["w_graph"][i]),
            node=int(s["w_node"][i]),
            offset=int(s["w_off"][i]),
            contained_nodes=dict(
                zip(s["cn_seg"][lo:hi].tolist(), s["cn_val"][lo:hi].tolist())
            ),
            ref=s["ref_ids"][rlo:rhi].tolist(),
            sketch=s["sketches"][i],
            merge_span=int(s["w_merge_span"][i]),
            window_size=int(s["w_window_size"][i]),
        )

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


@dataclass
class ContainmentIndex:
    num_part: int
    max_k: int
    num_window_kmers: int
    sketch_size: int
    window_keys: List[str] = field(default_factory=list)
    keys: object = field(default_factory=list)  # _KeysView over `soa`
    sketches: Optional[np.ndarray] = None  # uint64 [N, s]
    soa: Optional[dict] = None
    _tables: Optional[dict] = None

    # ------------------------------------------------------------------
    # build
    # ------------------------------------------------------------------
    def prepare(self) -> None:
        """Build the sorted band tables (the reference defers the LSH build
        to Load, lshe.go:108-147; here it is built once and serialised)."""
        if self._tables is not None:
            return
        if self.sketches is None or not len(self.sketches):
            raise ValueError("loaded an empty index file")
        N, s = self.sketches.shape
        assert s == self.sketch_size
        tables = {}
        for K in range(1, self.max_k + 1):
            L = s // K
            if L < 1:
                continue
            sigs = _mix_bands_np(self.sketches, K)  # [N, L]
            order = np.argsort(sigs, axis=0, kind="stable")  # [N, L]
            tables[K] = {
                "sorted_sigs": np.take_along_axis(sigs, order, axis=0).T.copy(),
                "idx": order.T.astype(np.int32).copy(),  # [L, N]
            }
        self._tables = tables

    @property
    def num_sketches(self) -> int:
        return len(self.keys)

    def dev_tensors(self, device) -> dict:
        """{"sketches": the window sketches, int64 [N, s] (u64 bits)} on
        `device`, copied on first use per device (counterpart of the
        reference's `dev` property, whose hi/lo pair this replaces)."""
        dev = torch.device(device)
        cache = self.__dict__.setdefault("_dev_cache", {})
        out = cache.get(str(dev))
        if out is None:
            sk = np.ascontiguousarray(self.sketches, np.uint64).view(np.int64)
            out = cache[str(dev)] = {"sketches": torch.from_numpy(sk).to(dev)}
        return out

    def _band_tensors(self, K: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """Band table K on `device`: sorted signatures as int32 (u32 bits)
        and their window ids, both [L, N]; copied on first use."""
        dev = torch.device(device)
        cache = self.__dict__.setdefault("_band_cache", {})
        key = (K, str(dev))
        if key not in cache:
            t = self._tables[K]
            cache[key] = (
                torch.from_numpy(np.ascontiguousarray(
                    t["sorted_sigs"], np.uint32).view(np.int32)).to(dev),
                torch.from_numpy(np.ascontiguousarray(t["idx"], np.int32)).to(dev),
            )
        return cache[key]

    # ------------------------------------------------------------------
    # query
    # ------------------------------------------------------------------
    def optimal_k(self, query_size: int, threshold: float) -> int:
        """Pick K (hash funcs per band) like lshensemble's OptimalKL: the
        jaccard threshold implied by the containment threshold is
        j* = t*q / (q + d - t*q); choose the largest K with false-negative
        prob (1 - j*^K)^L below 1e-6."""
        q, d = query_size, self.num_window_kmers
        j_star = threshold * q / (q + d - threshold * q)
        j_star = min(max(j_star, 1e-9), 1.0)
        best = 1
        for K in sorted(self._tables):
            L = self.sketch_size // K
            fn = (1.0 - j_star**K) ** L
            if fn < 1e-6:
                best = K
        return best

    def query_batch(
        self, q64: np.ndarray, query_sizes: np.ndarray, threshold: float
    ) -> List[Dict[int, List[Key]]]:
        """Per read, {graphID: [Key, ...]} with keys sorted by (node, offset)
        — the graphMinion sort (graphminion.go:57)."""
        self.prepare()
        rows, wins = self.query_batch_np(q64, query_sizes, threshold)
        out: List[Dict[int, List[Key]]] = [{} for _ in range(len(q64))]
        keys = self.keys
        for b, w in zip(rows.tolist(), wins.tolist()):
            key = keys[w]
            out[b].setdefault(key.graph_id, []).append(key)
        for hits in out:
            for g in hits:
                hits[g].sort(key=lambda k: (k.node, k.offset))
        return out

    def full_equality_applies(self, query_sizes, threshold: float) -> bool:
        """True when the containment bound forces ALL s slots equal for
        every read in the batch (the full-equality fast-path condition and
        the validity condition for the slot-0 sketch prescreen)."""
        qs = np.asarray(query_sizes, np.float64)
        if not qs.size:
            return False
        d = float(self.num_window_kmers)
        s = self.sketch_size
        bound = s * threshold * qs / (qs + d - threshold * qs)
        return bool(np.all(bound >= s - 1))

    def slot0_prescreen(self):
        """(sorted unique slot-0 window hashes, 20-bit prefix buckets) for
        the native sketcher's full-equality prescreen (io.native.sketch)."""
        t = getattr(self, "_slot0_tab", None)
        if t is None:
            s0 = np.unique(np.ascontiguousarray(self.sketches[:, 0]))
            t = self._slot0_tab = (s0, native._prefix16(s0))
        return t

    def _build_full_table(self) -> None:
        """Full-sketch signature table for the all-slot-equality fast path
        (built once; call before sharing the index across threads)."""
        s = self.sketch_size
        fs = _mix_bands_np(self.sketches, s)[:, 0]  # [N]
        order = np.argsort(fs, kind="stable")
        fsig, forder = fs[order], order.astype(np.int64)
        fpref = np.empty(65537, np.int32)
        fpref[:65536] = np.searchsorted(
            fsig, np.arange(65536, dtype=np.uint32) << np.uint32(16)
        )
        fpref[65536] = len(fsig)
        self._full_native = (
            np.ascontiguousarray(fsig, np.uint32),
            fpref,
            np.ascontiguousarray(forder, np.int64),
            np.ascontiguousarray(self.sketches, np.uint64),
        )
        self._full_table = (fsig, forder)

    def query_batch_np(
        self,
        q64: np.ndarray,
        query_sizes: np.ndarray,
        threshold: float,
        force_banded: bool = False,
        prescreened: bool = False,
        device=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """u64 read sketches [B, s] -> (read_rows, window_ids), unsorted
        numpy int arrays. No per-band candidate cap: every bucket collision
        is verified (lshe.go:157-171). ``prescreened`` marks a batch
        sketched with the native slot-0 prescreen (its sentinel rows skip
        the lookup); full sketches, as the CUDA sketch gives, pass False.
        GROOT_DEVICE_QUERY=1 runs the capped device query on ``device``
        instead, which must then be given."""
        self.prepare()
        q64 = np.ascontiguousarray(q64, np.uint64)
        if os.environ.get("GROOT_DEVICE_QUERY"):
            if device is None:
                raise ValueError("GROOT_DEVICE_QUERY=1 needs an explicit device")
            return self._query_batch_np_dev(q64, query_sizes, threshold, device)
        B = int(q64.shape[0])

        # Full-equality fast path: containment = j(q+d)/((1+j)q) with
        # j = eq/s, so `contain > t` needs eq > s*t*q/(q+d-t*q). Whenever
        # that bound is >= s-1 for every read, a hit requires ALL s slots
        # equal — the banded LSH collapses to an exact full-sketch join.
        s = self.sketch_size
        qs_all = np.asarray(query_sizes, np.float64)
        d = float(self.num_window_kmers)
        eq_bound = s * threshold * qs_all / (qs_all + d - threshold * qs_all)
        if np.all(eq_bound >= s - 1) and not force_banded:
            if not hasattr(self, "_full_table"):
                self._build_full_table()
            fsig, forder = self._full_table
            fn = self._full_native
            res = native.lsh_query_full64(
                q64, qs_all, d, threshold,
                fn[0], fn[1], fn[2], fn[3], prescreened,
            )
            if res is not None:
                return res
            qsig = _mix_bands_np(q64, s)[:, 0]
            lo_i = np.searchsorted(fsig, qsig, side="left")
            hi_i = np.searchsorted(fsig, qsig, side="right")
            cnt = (hi_i - lo_i).astype(np.int64)
            total = int(cnt.sum())
            if total == 0:
                return np.empty(0, np.int64), np.empty(0, np.int64)
            rows = np.repeat(np.arange(B), cnt)
            starts = np.concatenate(([0], np.cumsum(cnt[:-1])))
            ai = lo_i[rows] + (np.arange(total) - starts[rows])
            cands = forder[ai]
            # exact verify (32-bit mix collisions) + the contain>t bound
            full_eq = (self.sketches[cands] == q64[rows]).all(axis=1)
            qs_c = qs_all[rows]
            contain = (qs_c + d) / (2.0 * qs_c)
            keep = full_eq & (contain > threshold)
            return rows[keep], cands[keep]

        K = self.optimal_k(int(np.min(query_sizes)) if B else 1, threshold)
        t = self._tables[K]
        sigs = _mix_bands_np(q64, K)  # [B, L]
        sorted_sigs = t["sorted_sigs"]  # [L, N]
        idx = t["idx"]
        cand_parts: List[np.ndarray] = []
        row_parts: List[np.ndarray] = []
        for b in range(sorted_sigs.shape[0]):
            lo_i = np.searchsorted(sorted_sigs[b], sigs[:, b], side="left")
            hi_i = np.searchsorted(sorted_sigs[b], sigs[:, b], side="right")
            cnt = (hi_i - lo_i).astype(np.int64)
            total = int(cnt.sum())
            if total == 0:
                continue
            owner = np.repeat(np.arange(B), cnt)
            starts = np.concatenate(([0], np.cumsum(cnt[:-1])))
            ai = lo_i[owner] + (np.arange(total) - starts[owner])
            cand_parts.append(idx[b][ai].astype(np.int64))
            row_parts.append(owner)
        if not cand_parts:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        cands = np.concatenate(cand_parts)
        rows = np.concatenate(row_parts)
        # dedup (read, window)
        key = np.unique(rows * self.num_sketches + cands)
        rows = key // self.num_sketches
        cands = key % self.num_sketches
        # exact containment post-filter (lshe.go:165)
        eq = (self.sketches[cands] == q64[rows]).sum(axis=1)
        j = eq.astype(np.float64) / s
        qs = np.asarray(query_sizes, np.float64)[rows]
        contain = j * (qs + self.num_window_kmers) / ((1.0 + j) * qs)
        keep = contain > threshold
        return rows[keep], cands[keep]

    def _query_batch_np_dev(
        self, q64, query_sizes, threshold: float, device
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The banded device query (query_device, at most MAX_PER_BAND
        windows per band) on `device` -> (read_rows, window_ids)."""
        B = int(q64.shape[0])
        K = self.optimal_k(int(np.min(query_sizes)) if B else 1, threshold)
        dev = torch.device(device)
        sigs, idx = self._band_tensors(K, dev)
        win, _contain = query_device(
            torch.from_numpy(q64.view(np.int64)).to(dev),
            torch.from_numpy(np.asarray(query_sizes, np.int32)).to(dev),
            self.dev_tensors(dev)["sketches"], sigs, idx, K=K,
            M=MAX_PER_BAND, domain_size=self.num_window_kmers,
            threshold=threshold,
        )
        win = win.cpu().numpy()
        rows, cols = np.nonzero(win >= 0)
        return rows.astype(np.int64), win[rows, cols].astype(np.int64)

    # ------------------------------------------------------------------
    # serialisation (groot.lshe, format v2)
    # ------------------------------------------------------------------
    def dump(self, file_path: str) -> None:
        """Format v2: struct-of-arrays + prebuilt band tables."""
        self.prepare()
        payload = {
            "version": 2,
            "num_part": self.num_part,
            "max_k": self.max_k,
            "num_window_kmers": self.num_window_kmers,
            "sketch_size": self.sketch_size,
            "window_keys": "\n".join(self.window_keys).encode(),
            "soa": self.soa,
            "tables": self._tables,
        }
        with open(file_path, "wb") as fh:
            pickle.dump(payload, fh, protocol=4)

    @classmethod
    def load(cls, file_path: str) -> "ContainmentIndex":
        if os.path.getsize(file_path) == 0:
            raise ValueError("index appears empty")
        with open(file_path, "rb") as fh:
            payload = pickle.load(fh)
        if payload.get("version", 1) < 2:
            raise ValueError(
                f"{file_path}: index format v1 is not supported; rebuild it"
            )
        self = cls(
            num_part=payload["num_part"],
            max_k=payload["max_k"],
            num_window_kmers=payload["num_window_kmers"],
            sketch_size=payload["sketch_size"],
        )
        self.window_keys = payload["window_keys"].decode().split("\n")
        self.soa = payload["soa"]
        self.sketches = self.soa["sketches"]
        if len(self.sketches) == 0:
            raise ValueError("loaded an empty index file")
        self.keys = _KeysView(self.soa)
        self._tables = payload["tables"]
        return self
