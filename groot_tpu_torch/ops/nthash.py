"""ntHash: canonical rolling DNA k-mer hashing, numpy goldens + torch.

Counterpart of groot_tpu/ops/nthash.py. Re-implements the hashing used by
the reference's sketching layer (will-rowe/nthash, called from
src/minhash/khf.go:38-44 and kmv.go:41-47) from the published ntHash v1
algorithm (Mohamadi et al. 2016):

  forward  f(i)  = XOR_{j=0..k-1} rol(seed[s[i+j]], k-1-j)
  reverse  r(i)  = XOR_{j=0..k-1} rol(seed[rc(s[i+j])], j)
  canonical c(i) = min(f(i), r(i))
  multihash h_m(i) = c(i) * (m XOR k*MULTISEED);  h ^= h >> MULTISHIFT

The numpy tables and `*_np` goldens are copied unchanged. `khf_sketch_torch`
is the plain PyTorch version of the sketch (the CPU path of
ops.sketch.khf_sketch and the check for its CUDA kernel). It uses the
rotate-normalised prefix-XOR identity

  f(i) = rol( X[i+k] ^ X[i], (k-1+i) mod 64 ),  X = prefix-xor of
         t[m] = ror(seed[s[m]], m mod 64)
  r(i) = ror( Y[i+k] ^ Y[i], i mod 64 ),        Y = prefix-xor of
         u[m] = rol(seed[rc(s[m])], m mod 64)

on int64 tensors holding the u64 bit patterns. Three things differ from
unsigned arithmetic and are handled explicitly: `>>` on int64 is arithmetic
(logical shifts mask the sign fill), unsigned order is signed order after
flipping the sign bit (`x ^ INT64_MIN`), and multiplication wraps mod 2^64
exactly as u64 does.
"""

from __future__ import annotations

import numpy as np
import torch

# ntHash v1 base seeds (A, C, G, T, N) — published constants
SEED_A = 0x3C8BFBB395C60474
SEED_C = 0x3193C18562A02B4C
SEED_G = 0x20323ED082572324
SEED_T = 0x295549F54BE24456
SEED_N = 0x0000000000000000

MULTISEED = 0x90B45D39FB6DA1FA
MULTISHIFT = 27

# base codes: A=0 C=1 G=2 T=3 N=4
SEEDS_NP = np.array([SEED_A, SEED_C, SEED_G, SEED_T, SEED_N], dtype=np.uint64)
RC_CODE_NP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)  # A<->T, C<->G, N->N
SEEDS_RC_NP = SEEDS_NP[RC_CODE_NP]

# 256-entry ASCII -> code table (everything non-ACGTacgt becomes N=4),
# mirroring seqio.BaseCheck (src/seqio/seqio.go:72-91)
ASCII_TO_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    ASCII_TO_CODE[_b] = _i
    ASCII_TO_CODE[_b + 32] = _i  # lower case

CODE_TO_ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8).copy()


# ---------------------------------------------------------------------------
# NumPy golden implementation (host / parity checks)
# ---------------------------------------------------------------------------

def _rol_np(x: np.ndarray, r) -> np.ndarray:
    r = np.asarray(r, dtype=np.uint64) % np.uint64(64)
    with np.errstate(over="ignore"):
        return np.where(
            r == 0, x, (x << r) | (x >> (np.uint64(64) - r))
        ).astype(np.uint64)


def canonical_hashes_np(codes: np.ndarray, k: int) -> np.ndarray:
    """All canonical k-mer hashes of a coded sequence. Direct O(L*k) formula."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros((0,), dtype=np.uint64)
    fwd = np.zeros(n, dtype=np.uint64)
    rev = np.zeros(n, dtype=np.uint64)
    seeds = SEEDS_NP[codes]
    seeds_rc = SEEDS_RC_NP[codes]
    for j in range(k):
        fwd ^= _rol_np(seeds[j : j + n], k - 1 - j)
        rev ^= _rol_np(seeds_rc[j : j + n], j)
    return np.minimum(fwd, rev)


def multihash_np(base: np.ndarray, k: int, num: int) -> np.ndarray:
    """ntHash multihash: [n] base hashes -> [n, num] derived hashes."""
    base = np.asarray(base, dtype=np.uint64)
    out = np.empty(base.shape + (num,), dtype=np.uint64)
    out[..., 0] = base
    with np.errstate(over="ignore"):
        kseed = np.uint64(np.uint64(k) * np.uint64(MULTISEED))
        for m in range(1, num):
            t = base * (np.uint64(m) ^ kseed)
            t ^= t >> np.uint64(MULTISHIFT)
            out[..., m] = t
    return out


_ROTTAB_CACHE: dict = {}


def khf_sketch_np(codes: np.ndarray, k: int, s: int) -> np.ndarray:
    """Golden KHF MinHash sketch of one coded sequence -> u64 [s]."""
    c = canonical_hashes_np(codes, k)
    if len(c) == 0:
        raise ValueError(
            f"sequence length ({len(codes)}) is shorter than k-mer size ({k})"
        )
    return multihash_np(c, k, s).min(axis=0)


def _rot_tables_np(L: int):
    """Position-rotated seed tables [5, L] (u64): t[c, m] = ror(seed[c], m)
    and u[c, m] = rol(seed_rc[c], m), cached per L."""
    tabs = _ROTTAB_CACHE.get(L)
    if tabs is None:
        m = (np.arange(L, dtype=np.uint64)) % np.uint64(64)
        tabs = (
            _rol_np(
                np.broadcast_to(SEEDS_NP[:, None], (5, L)),
                np.uint64(64) - m[None, :],
            ),
            _rol_np(
                np.broadcast_to(SEEDS_RC_NP[:, None], (5, L)),
                m[None, :],
            ),
        )
        _ROTTAB_CACHE[L] = tabs
    return tabs


def khf_sketch_np_batch(
    codes: np.ndarray, valid_len: np.ndarray, k: int, s: int
) -> np.ndarray:
    """Batched host KHF sketching: u8 codes [B, L] (+ per-row valid length)
    -> u64 sketches [B, s], with np.bitwise_xor.accumulate as the scan.
    Rows shorter than k sketch to all-ones (never match anything)."""
    codes = np.asarray(codes, dtype=np.uint8)
    valid_len = np.asarray(valid_len, dtype=np.int64)
    B, L = codes.shape
    FULL = np.uint64(0xFFFFFFFFFFFFFFFF)
    with np.errstate(over="ignore"):
        tabs = _rot_tables_np(L)
        pos_idx = np.arange(L)
        t = tabs[0][codes, pos_idx[None, :]]
        u_ = tabs[1][codes, pos_idx[None, :]]
        X = np.bitwise_xor.accumulate(t, axis=1)
        Y = np.bitwise_xor.accumulate(u_, axis=1)
        nk = L - k + 1
        if nk <= 0:
            return np.full((B, s), FULL, dtype=np.uint64)
        # W[i] = X[i+k-1] ^ X[i-1]  (X[-1] = 0)
        wx = X[:, k - 1 :].copy()
        wx[:, 1:] ^= X[:, : nk - 1]
        wy = Y[:, k - 1 :].copy()
        wy[:, 1:] ^= Y[:, : nk - 1]
        lane = np.arange(nk, dtype=np.uint64)
        fwd = _rol_np(wx, (lane + np.uint64(k - 1)) % np.uint64(64))
        rev = _rol_np(
            wy, (np.uint64(64) - (lane % np.uint64(64))) % np.uint64(64)
        )
        c = np.minimum(fwd, rev)
        nk_valid = np.maximum(valid_len - (k - 1), 0)
        invalid = np.arange(nk)[None, :] >= nk_valid[:, None]
        c[invalid] = FULL
        out = np.empty((B, s), dtype=np.uint64)
        out[:, 0] = c.min(axis=1)
        kseed = np.uint64(np.uint64(k) * np.uint64(MULTISEED))
        for slot in range(1, s):
            h = c * (np.uint64(slot) ^ kseed)
            h ^= h >> np.uint64(MULTISHIFT)
            h[invalid] = FULL
            out[:, slot] = h.min(axis=1)
    return out


def slot_multipliers(k: int, s: int) -> np.ndarray:
    """Per-slot multipliers (m XOR k*MULTISEED) as u64 [s]; slot 0 unused."""
    with np.errstate(over="ignore"):
        kseed = np.uint64(np.uint64(k) * np.uint64(MULTISEED))
        return np.arange(s, dtype=np.uint64) ^ kseed


# ---------------------------------------------------------------------------
# PyTorch implementation (int64 tensors holding u64 bit patterns)
# ---------------------------------------------------------------------------

INT64_MIN = -(1 << 63)


def as_i64(a: np.ndarray) -> np.ndarray:
    """u64 numpy array -> the same bits as int64 (for torch.from_numpy)."""
    return np.ascontiguousarray(a, dtype=np.uint64).view(np.int64)


def lsr(x: torch.Tensor, n) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by n in [1, 63] (scalar or
    tensor): the arithmetic shift with its sign fill masked off."""
    if isinstance(n, int):
        return (x >> n) & ((1 << (64 - n)) - 1)
    return (x >> n) & ~(torch.full_like(n, -1) << (64 - n))


def rol(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """64-bit rotate left by a per-element amount r in [0, 63]."""
    r0 = r == 0
    rr = torch.where(r0, torch.ones_like(r), r)  # keep shifts in [1, 63]
    return torch.where(r0, x, (x << rr) | lsr(x, 64 - rr))


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise unsigned min of int64 bit patterns."""
    return torch.where((a ^ INT64_MIN) < (b ^ INT64_MIN), a, b)


def umin_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Unsigned min over `dim` of int64 bit patterns."""
    return (x ^ INT64_MIN).amin(dim) ^ INT64_MIN


def _prefix_xor(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix XOR along dim 1 (torch has no cumulative XOR):
    Hillis-Steele, log2(L) shifted XOR passes."""
    L = x.shape[1]
    d = 1
    while d < L:
        y = x.clone()
        y[:, d:] ^= x[:, : L - d]
        x = y
        d *= 2
    return x


def canonical_hashes_torch(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical hashes of every k-mer of each row, plain PyTorch: u8 codes
    [B, L] (A=0 C=1 G=2 T=3 N=4; larger codes count as N) -> int64
    [B, L-k+1] holding the u64 bits. Needs L >= k."""
    dev = codes.device
    L = codes.shape[1]
    nk = L - k + 1
    ftab, rtab = (
        torch.from_numpy(as_i64(t)).to(dev) for t in _rot_tables_np(L)
    )
    c_idx = codes.long().clamp(max=4)
    pos = torch.arange(L, device=dev)[None, :]
    X = _prefix_xor(ftab[c_idx, pos])
    Y = _prefix_xor(rtab[c_idx, pos])

    def window(P):  # W[i] = P[i+k-1] ^ P[i-1]  (P[-1] = 0)
        w = P[:, k - 1 :].clone()
        w[:, 1:] ^= P[:, : nk - 1]
        return w

    lane = torch.arange(nk, dtype=torch.int64, device=dev)[None, :]
    fwd = rol(window(X), (lane + (k - 1)) % 64)
    rev = rol(window(Y), (64 - lane % 64) % 64)
    return umin(fwd, rev)


def slot_hashes_torch(c: torch.Tensor, k: int, slot: int) -> torch.Tensor:
    """Multihash slot `slot` of canonical hashes c (int64 u64 bits)."""
    if slot == 0:
        return c
    h = c * int(as_i64(slot_multipliers(k, slot + 1))[slot])
    return h ^ lsr(h, MULTISHIFT)


def khf_sketch_torch(
    codes: torch.Tensor, valid_len: torch.Tensor, k: int, s: int
) -> torch.Tensor:
    """KHF MinHash sketch of a read batch, plain PyTorch.

    codes u8 [B, L] (A=0 C=1 G=2 T=3 N=4), valid_len int [B] -> int64 [B, s]
    holding the u64 sketch bits. k-mers starting at or past valid_len-k+1
    are masked to all-ones in every slot (so rows shorter than k sketch to
    all-ones), exactly as khf_sketch_np_batch and the Pallas kernel do."""
    dev = codes.device
    B, L = codes.shape
    nk = L - k + 1
    if nk <= 0 or B == 0:
        return torch.full((B, s), -1, dtype=torch.int64, device=dev)
    c = canonical_hashes_torch(codes, k)
    lane = torch.arange(nk, dtype=torch.int64, device=dev)[None, :]
    nk_valid = torch.clamp(valid_len.to(dev).long() - (k - 1), min=0)
    invalid = lane >= nk_valid[:, None]
    c = c.masked_fill(invalid, -1)
    out = torch.empty((B, s), dtype=torch.int64, device=dev)
    for slot in range(s):
        h = slot_hashes_torch(c, k, slot)
        out[:, slot] = umin_reduce(h.masked_fill(invalid, -1), 1)
    return out
