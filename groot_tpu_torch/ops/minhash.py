"""MinHash sketch objects — the reference's src/minhash API surface.

Reference: src/minhash/ (KHFsketch khf.go, KMVsketch kmv.go +
heap.go, BloomFilter bloom.go, MinHash interface minhash.go:8-11). The
production path uses KHF everywhere (both call sites pass kmv=false,
boss.go:163 / graph.go:293); KMV and the bloom filter exist for API parity
(the bloom filter is plumbed but never engaged in v1.1.2, runtime.go:38).

These classes are thin host-side wrappers (counterpart of
groot_tpu/ops/minhash.py); the batched device paths live in ops.sketch
(khf_sketch) and index.window."""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import nthash


class KHFsketch:
    """K-Hash-Functions MinHash: sketch[i] = min over k-mers of the i-th
    ntHash multihash value (khf.go:10-55)."""

    def __init__(self, kmer_size: int, sketch_size: int):
        self.kmer_size = kmer_size
        self.sketch_size = sketch_size
        self.sketch = np.full(sketch_size, np.iinfo(np.uint64).max, np.uint64)

    def add_sequence(self, seq: bytes) -> None:
        codes = nthash.encode_seq(seq)
        if len(codes) < self.kmer_size:
            raise ValueError(
                f"sequence length ({len(codes)}) is shorter than k-mer size "
                f"({self.kmer_size})"
            )
        c = nthash.canonical_hashes_np(codes, self.kmer_size)
        h = nthash.multihash_np(c, self.kmer_size, self.sketch_size)
        self.sketch = np.minimum(self.sketch, h.min(axis=0))

    def get_sketch(self) -> np.ndarray:
        return self.sketch

    def get_similarity(self, other: "KHFsketch") -> float:
        if not isinstance(other, KHFsketch):
            raise TypeError(f"mismatched MinHash types: {type(self)} vs {type(other)}")
        if len(self.sketch) != len(other.sketch):
            raise ValueError(
                "sketches do not have the same number of minimums: "
                f"{len(self.sketch)} vs {len(other.sketch)}"
            )
        return float((self.sketch == other.sketch).mean())


class KMVsketch:
    """K-Minimum-Values (bottom-k) MinHash over canonical k-mer hashes
    (kmv.go:12-112; heap semantics == sorted bottom-k with duplicates)."""

    def __init__(self, kmer_size: int, sketch_size: int):
        self.kmer_size = kmer_size
        self.sketch_size = sketch_size
        self._values = np.empty(0, np.uint64)

    def add_sequence(self, seq: bytes) -> None:
        codes = nthash.encode_seq(seq)
        if len(codes) < self.kmer_size:
            raise ValueError(
                f"sequence length ({len(codes)}) is short than k-mer length "
                f"({self.kmer_size})"
            )
        c = nthash.canonical_hashes_np(codes, self.kmer_size)
        merged = np.sort(np.concatenate([self._values, c]))
        self._values = merged[: self.sketch_size]

    def get_sketch(self) -> np.ndarray:
        return self._values.copy()

    def get_similarity(self, other: "KMVsketch") -> float:
        if not isinstance(other, KMVsketch):
            raise TypeError(f"mismatched MinHash types: {type(self)} vs {type(other)}")
        a, b = self._values, other._values
        if len(a) != len(b):
            raise ValueError("sketches do not have the same number of minimums")
        # multiset intersection (kmv.go:86-112)
        inter = 0
        counts: dict = {}
        for v in a:
            counts[v] = counts.get(v, 0) + 1
        for v in b:
            if counts.get(v, 0) > 0:
                inter += 1
                counts[v] -= 1
        return inter / max(len(a), len(b), 1)


class BloomFilter:
    """RW-locked bitset in the reference (bloom.go:26-50); plain here."""

    def __init__(self, size_bits: int = 24):
        self.size = 1 << size_bits
        self.bits = np.zeros(self.size // 8, np.uint8)

    def _pos(self, value: int):
        h = int(value) % self.size
        return h >> 3, 1 << (h & 7)

    def add(self, value: int) -> None:
        byte, bit = self._pos(value)
        self.bits[byte] |= bit

    def check(self, value: int) -> bool:
        byte, bit = self._pos(value)
        return bool(self.bits[byte] & bit)

    def reset(self) -> None:
        self.bits[:] = 0


def run_minhash(
    seq: bytes,
    kmer_size: int,
    sketch_size: int,
    kmv: bool = False,
    bloom: Optional[BloomFilter] = None,
) -> np.ndarray:
    """seqio.Sequence.RunMinHash equivalent (seqio.go:40-68): KMV sketches
    shorter than sketch_size are zero-padded."""
    mh = (KMVsketch if kmv else KHFsketch)(kmer_size, sketch_size)
    mh.add_sequence(seq)
    sketch = mh.get_sketch()
    if kmv and len(sketch) != sketch_size:
        sketch = np.concatenate(
            [sketch, np.zeros(sketch_size - len(sketch), np.uint64)]
        )
    return sketch
