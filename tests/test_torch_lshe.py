"""groot.lshe across the two packages, and the port's LSH query.

Each package loads the index file the other dumped and both give the same
(rows, wins) on the same sketches, on the full-equality path and the banded
one. The device route (full sketches, prescreened=False) gives what the
reference's native prescreened route gives. The device query's plain
version equals the reference's _mix_bands_jax and jitted _query_device, and
the GROOT_DEVICE_QUERY=1 route equals the reference's."""

import os

import numpy as np
import pytest
import torch

from groot_tpu.config import Info as RefInfo
from groot_tpu.index.lshe import ContainmentIndex as RefIndex
from groot_tpu.io import native
from groot_tpu.ops import nthash as ref_nthash
from groot_tpu.pipeline.index_pipeline import run_index as ref_run_index
from groot_tpu_torch import synth
from groot_tpu_torch.config import Info
from groot_tpu_torch.index import lshe
from groot_tpu_torch.index.lshe import ContainmentIndex
from groot_tpu_torch.ops.nthash import ASCII_TO_CODE
from groot_tpu_torch.ops.sketch import sketch_reads_u64
from groot_tpu_torch.pipeline.index_pipeline import run_index

K, S, W = 31, 20, 100


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lshe")
    alleles = synth.tiny_db(str(tmp / "msa"))
    out = {}
    for name, fn, cfg in (("port", lambda i, m: run_index(i, m, "cpu"), Info),
                          ("ref", ref_run_index, RefInfo)):
        d = str(tmp / name)
        fn(cfg(kmer_size=K, sketch_size=S, window_size=W, index_dir=d),
           str(tmp / "msa"))
        out[name] = os.path.join(d, "groot.lshe")
    reads, _which, _starts = synth.sample_reads(
        np.random.default_rng(7), alleles, 96, lengths=(100, 120), n_frac=0.05
    )
    L = 128
    codes = np.full((len(reads), L), 4, np.uint8)
    lens = np.array([len(r) for r in reads], np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = ASCII_TO_CODE[np.frombuffer(r, np.uint8)]
    return out, codes, lens


def _hits(rows, wins):
    return sorted(zip(rows.tolist(), wins.tolist()))


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("banded", [False, True])
def test_cross_load_same_hits(indexes, writer, banded):
    paths, codes, lens = indexes
    port = ContainmentIndex.load(paths[writer])
    ref = RefIndex.load(paths[writer])
    q64 = ref_nthash.khf_sketch_np_batch(codes, lens, K, S)
    kc = (lens - K + 1).astype(np.int32)
    t = 0.99 if not banded else 0.6
    got = port.query_batch_np(q64, kc, t, force_banded=banded)
    want = ref.query_batch_np(None, None, kc, t, force_banded=banded, q64=q64)
    assert _hits(*got) == _hits(*want)
    assert len(got[0]) > 0
    # the files themselves agree: same sketches and band tables
    other = ContainmentIndex.load(paths["ref" if writer == "port" else "port"])
    assert (other.sketches == port.sketches).all()
    for Kb, tab in port._tables.items():
        assert (tab["sorted_sigs"] == other._tables[Kb]["sorted_sigs"]).all()
        assert (tab["idx"] == other._tables[Kb]["idx"]).all()


def test_device_route_query_equals_native_prescreened(indexes):
    paths, codes, lens = indexes
    port = ContainmentIndex.load(paths["port"])
    ref = RefIndex.load(paths["ref"])
    kc = (lens - K + 1).astype(np.int32)
    full = sketch_reads_u64(codes, lens, K, S, "cpu")
    got = port.query_batch_np(full, kc, 0.99, prescreened=False)
    if native.available():
        pre = ref.slot0_prescreen()
        q = native.sketch(codes, lens, K, S, prescreen=pre)
        want = ref.query_batch_np(
            None, None, kc, 0.99, q64=q, prescreened=True
        )
    else:
        want = ref.query_batch_np(None, None, kc, 0.99, q64=full)
    assert _hits(*got) == _hits(*want)
    assert len(got[0]) > 0


# ---------------------------------------------------------------------------
# the device query (counterpart of _mix_bands_jax / _query_device)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def sketched(indexes):
    paths, codes, lens = indexes
    port = ContainmentIndex.load(paths["port"])
    ref = RefIndex.load(paths["ref"])
    q64 = ref_nthash.khf_sketch_np_batch(codes, lens, K, S)
    return port, ref, q64, (lens - K + 1).astype(np.int32)


@pytest.mark.parametrize("Kb", range(1, S + 1))
def test_mix_bands_torch_matches_jax_and_numpy(sketched, Kb):
    import jax.numpy as jnp

    from groot_tpu.index.lshe import _mix_bands_jax, _mix_bands_np

    _port, _ref, q64, _kc = sketched
    got = lshe.mix_bands_torch(torch.from_numpy(q64.view(np.int64)), Kb)
    hi = (q64 >> np.uint64(32)).astype(np.uint32)
    lo = (q64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    want = np.asarray(_mix_bands_jax(jnp.asarray(hi), jnp.asarray(lo), Kb))
    assert got.dtype == torch.int64 and got.shape == (len(q64), S // Kb)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(want, _mix_bands_np(q64, Kb))


@pytest.mark.parametrize("t", [0.6, 0.9, 0.97])
def test_query_device_torch_matches_jax(sketched, t):
    import jax
    import jax.numpy as jnp

    from groot_tpu.index.lshe import _query_device

    port, ref, q64, kc = sketched
    Kb = ref.optimal_k(int(kc.min()), t)
    tab = ref._tables[Kb]
    hi = (q64 >> np.uint64(32)).astype(np.uint32)
    lo = (q64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    ref.prepare()
    fn = jax.jit(_query_device, static_argnames=("K", "domain_size", "threshold"))
    want = np.asarray(fn(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(tab["sorted_sigs"]),
        jnp.asarray(tab["idx"]), ref.dev["hi"], ref.dev["lo"], jnp.asarray(kc),
        Kb, ref.num_window_kmers, t,
    ))
    sigs, idx = port._band_tensors(Kb, "cpu")
    win, contain = lshe.query_device(
        torch.from_numpy(q64.view(np.int64)), torch.from_numpy(kc),
        port.dev_tensors("cpu")["sketches"], sigs, idx, K=Kb,
        M=lshe.MAX_PER_BAND, domain_size=port.num_window_kmers, threshold=t,
    )
    assert win.shape == want.shape == (len(q64), (S // Kb) * lshe.MAX_PER_BAND)
    np.testing.assert_array_equal(win.numpy(), want)
    assert (want >= 0).sum() > len(q64)


@pytest.mark.parametrize("t", [0.99, 0.97])
def test_device_query_route_matches_jax(sketched, monkeypatch, t):
    port, ref, q64, kc = sketched
    hi = (q64 >> np.uint64(32)).astype(np.uint32)
    lo = (q64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    monkeypatch.setenv("GROOT_DEVICE_QUERY", "1")
    want = ref.query_batch_np(hi, lo, kc, t)
    got = port.query_batch_np(q64, kc, t, device="cpu")
    assert _hits(*got) == _hits(*want) and len(got[0]) > 0
    with pytest.raises(ValueError, match="device"):
        port.query_batch_np(q64, kc, t)
    # the capped device query finds what the host query finds here
    monkeypatch.delenv("GROOT_DEVICE_QUERY")
    host = port.query_batch_np(q64, kc, t, force_banded=True)
    assert set(_hits(*got)) <= set(_hits(*host))


@pytest.mark.parametrize("s,Kb,t", [(128, None, 0.9), (256, 1, 0.6)])
def test_query_device_any_s_and_c_matches_jax(indexes, tmp_path, s, Kb, t):
    """The device query on an index sketched at s = 128 (the optimal K's
    bands) and at s = 256 with K = 1 (C = 256 x 24 = 6,144 candidate slots,
    past the shared route's 4,096: the kernel's global route) equals the
    reference's jitted _query_device."""
    import jax
    import jax.numpy as jnp

    from groot_tpu.index.lshe import _query_device

    _paths, codes, lens = indexes
    synth.tiny_db(str(tmp_path / "msa"))
    run_index(Info(kmer_size=K, sketch_size=s, window_size=W,
                   index_dir=str(tmp_path / "idx")), str(tmp_path / "msa"), "cpu")
    port = ContainmentIndex.load(str(tmp_path / "idx" / "groot.lshe"))
    ref = RefIndex.load(str(tmp_path / "idx" / "groot.lshe"))
    q64 = ref_nthash.khf_sketch_np_batch(codes, lens, K, s)
    kc = (lens - K + 1).astype(np.int32)
    ref.prepare()
    Kb = Kb or ref.optimal_k(int(kc.min()), t)
    C = (s // Kb) * lshe.MAX_PER_BAND
    hi = (q64 >> np.uint64(32)).astype(np.uint32)
    lo = (q64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    tab = ref._tables[Kb]
    fn = jax.jit(_query_device, static_argnames=("K", "domain_size", "threshold"))
    want = np.asarray(fn(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(tab["sorted_sigs"]),
        jnp.asarray(tab["idx"]), ref.dev["hi"], ref.dev["lo"], jnp.asarray(kc),
        Kb, ref.num_window_kmers, t,
    ))
    port.prepare()
    sigs, idx = port._band_tensors(Kb, "cpu")
    win, _contain = lshe.query_device(
        torch.from_numpy(q64.view(np.int64)), torch.from_numpy(kc),
        port.dev_tensors("cpu")["sketches"], sigs, idx, K=Kb,
        M=lshe.MAX_PER_BAND, domain_size=port.num_window_kmers, threshold=t,
    )
    assert win.shape == want.shape == (len(q64), C)
    np.testing.assert_array_equal(win.numpy(), want)
    assert (want >= 0).sum() > len(q64)


def test_query_device_checks_its_inputs(sketched):
    port, _ref, q64, kc = sketched
    sigs, idx = port._band_tensors(2, "cpu")
    q = torch.from_numpy(q64.view(np.int64))
    sk = port.dev_tensors("cpu")["sketches"]
    kw = dict(M=lshe.MAX_PER_BAND, domain_size=70, threshold=0.97)
    with pytest.raises(TypeError):
        lshe.query_device(q.int(), torch.from_numpy(kc), sk, sigs, idx, K=2, **kw)
    with pytest.raises(TypeError):
        lshe.query_device(q, torch.from_numpy(kc).long(), sk, sigs, idx, K=2, **kw)
    with pytest.raises(ValueError):
        lshe.query_device(q, torch.from_numpy(kc), sk, sigs, idx, K=3, **kw)
    with pytest.raises(ValueError):
        lshe.query_device(q, torch.from_numpy(kc), sk, sigs, idx, K=2, qmax=71, **kw)


# ---------------------------------------------------------------------------
# the lsh_query kernel's search and sort (csrc/lsh_query.cu), emulated
# ---------------------------------------------------------------------------
def _kary_lower_bound(row: np.ndarray, key: int, g: int):
    """The kernel's (g + 1)-ary lower bound with g lanes: each level the
    lanes test the last entry of g of the g + 1 sub-ranges of the unknown
    entries [lo, hi) and the count of those below the key picks the
    sub-range. Returns (lo, levels)."""
    lo, hi, levels = 0, len(row), 0
    while lo < hi:
        n = hi - lo
        ends = lo + (np.arange(1, g + 1) * n + g) // (g + 1)
        below = row[ends - 1] < key
        c = int(below.sum())
        assert not below[c:].any()  # the lanes below the key are a prefix
        nlo = lo + (c * n + g) // (g + 1)
        if c < g:
            hi = lo + ((c + 1) * n + g) // (g + 1) - 1
        lo, levels = nlo, levels + 1
    return lo, levels


def _search_rows(rng, N: int):
    """A sorted u32 row of N entries with runs of equal signatures longer
    than 24, one of them at the row's end, and the keys to look up: every
    value, each value +- 1, keys below the minimum and above the maximum."""
    vals = np.sort(rng.integers(10, 2**32 - 10, size=max(N // 8, 1)))
    row = np.sort(np.concatenate([
        rng.choice(vals, size=N - min(N, 30)), np.full(min(N, 30), vals[-1])]))
    row = row.astype(np.uint32)
    keys = np.unique(np.concatenate([
        row.astype(np.int64), row.astype(np.int64) + 1, row.astype(np.int64) - 1,
        [0, 1, int(row[0]) - 5, int(row[-1]) + 5, 2**32 - 1]]))
    return row, keys[(keys >= 0) & (keys < 2**32)].astype(np.uint32)


def _group_width(L: int) -> int:
    """The kernel's lanes a band: the largest 2^d - 1 <= 32 // L (at least
    1), so that the 2^d sub-range edges are shifts."""
    lg = 1
    while (2 << lg) - 1 <= (1 if L >= 32 else 32 // L):
        lg += 1
    return (1 << lg) - 1


@pytest.mark.parametrize("L,g", [(1, 31), (2, 15), (4, 7), (5, 3), (10, 3), (11, 1),
                                 (20, 1), (64, 1)])
def test_group_width_gives_every_band_a_group(L, g):
    assert _group_width(L) == g
    assert g * min(L, 32 // g) <= 32


@pytest.mark.parametrize("g", range(1, 33))
def test_kary_lower_bound_and_equality_scan(g):
    """For every group width (the kernel takes g = 2^d - 1, where the edges
    are shifts), the k-ary lower bound equals searchsorted's,
    and the kernel's equality scan (slot m holds an id when lo + m < N and
    row[lo + m] == key) equals the reference's lo + m < hi, on N = 1, 31,
    32, 33 and 1,000, with runs longer than M = 24, runs that end at the
    row's end and keys off both ends."""
    rng = np.random.default_rng(g)
    M = lshe.MAX_PER_BAND
    for N in (1, 31, 32, 33, 1000):
        row, keys = _search_rows(rng, N)
        lo_ref = np.searchsorted(row, keys, side="left")
        hi_ref = np.searchsorted(row, keys, side="right")
        for key, lo_r, hi_r in zip(keys, lo_ref, hi_ref):
            lo, levels = _kary_lower_bound(row, key, g)
            assert lo == lo_r
            assert levels <= int(np.ceil(np.log(N + 1) / np.log(g + 1))) + 1
            pos = lo + np.arange(M)
            mine = (pos < N) & (row[np.minimum(pos, N - 1)] == key)
            np.testing.assert_array_equal(mine, pos < hi_r)
        assert (hi_ref - lo_ref).max() > M or N < M  # a run longer than M


def test_kary_full_warp_levels_at_the_data_plane_scale():
    """The full mode's whole-warp search (g = 32) needs 4 levels at the
    data plane's 408,788 windows, against 19 for a binary search."""
    rng = np.random.default_rng(3)
    row = np.sort(rng.integers(0, 2**32, size=408_788)).astype(np.uint32)
    for key in rng.choice(row, 50):
        lo, levels = _kary_lower_bound(row, int(key), 32)
        assert lo == np.searchsorted(row, key) and levels <= 4


def _warp_bitonic_np(buf: np.ndarray) -> np.ndarray:
    """The kernel's bitonic sort of Cp entries held as entry r * 32 + lane
    of lane `lane`: strides of 32 and more compare entries in shared
    memory, smaller ones exchange with lane ^ stride (a shuffle)."""
    v = buf.copy()
    Cp = len(v)
    e = np.arange(Cp)
    size = 2
    while size <= Cp:
        stride = size // 2
        while stride > 0:
            partner = e ^ stride
            asc = (e & size) == 0
            lower = (e & stride) == 0
            if stride < 32:
                assert ((e % 32) ^ stride == partner % 32).all()  # same r
            lo_v, hi_v = np.minimum(v, v[partner]), np.maximum(v, v[partner])
            v = np.where(lower == asc, lo_v, hi_v)
            stride //= 2
        size *= 2
    return v


@pytest.mark.parametrize("C", [1, 3, 24, 33, 240, 480, 4096])
@pytest.mark.parametrize("found", [0.0, 0.2, 1.0])
def test_compacted_sort_gives_the_reference_order(C, found):
    """The kernel's banded order: the ids found compacted in slot order (by
    ballots, 32 slots a round), padded with INT_MAX to P2 = max(32,
    2^ceil(log2 n)) and sorted by the bitonic network, the -1s of the
    empty slots in front: the reference's jnp.sort order, so the duplicate
    mask leaves its ids."""
    rng = np.random.default_rng(C)
    ids = rng.integers(0, max(C // 3, 2), size=C).astype(np.int32)
    ids[rng.random(C) >= found] = -1
    real = ids[ids >= 0]  # what the ballots compact, in slot order
    P2 = max(32, 1 << max(len(real) - 1, 0).bit_length())
    buf = np.full(P2, 0x7FFFFFFF, np.int32)
    buf[:len(real)] = real
    got = np.concatenate([np.full(C - len(real), -1, np.int32),
                          _warp_bitonic_np(buf)[:len(real)]])
    np.testing.assert_array_equal(got, np.sort(ids))

