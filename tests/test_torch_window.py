"""The port's window sketch (the index build's device pass) against
groot_tpu: the plain PyTorch version equals the reference's XLA
`window_sketches` bit for bit, and the numpy golden; its run starts equal
the native runtime's. The CUDA kernel is held against these on the card
(tests/test_torch_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groot_tpu.index.window import _change_mask, window_sketches
from groot_tpu.io import native
from groot_tpu_torch.index import window as pw
from groot_tpu_torch.ops import nthash

SHAPES = [(7, 16, 40), (31, 20, 100)]


def _ragged(rng, R, L, w, n_rate=0.03):
    """u8 codes [R, L] with Ns, rows of lengths w-3 .. L padded with N."""
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    codes[rng.random((R, L)) < n_rate] = 4
    lens = rng.integers(w - 3, L + 1, size=R).astype(np.int32)
    lens[0] = L
    for i in range(R):
        codes[i, lens[i]:] = 4
    return codes, lens


def _u64(hi, lo):
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        lo
    ).astype(np.uint64)


@pytest.mark.parametrize("k,s,w", SHAPES)
def test_window_sketches_torch_equals_jax(k, s, w):
    codes, lens = _ragged(np.random.default_rng(k), 9, 260, w)
    hi, lo = window_sketches(jnp.asarray(codes), jnp.asarray(lens), k, s, w)
    sk, start = pw.window_sketches_torch(
        torch.from_numpy(codes), torch.from_numpy(lens), k, s, w
    )
    np.testing.assert_array_equal(sk.numpy().view(np.uint64), _u64(hi, lo))
    valid = np.arange(260 - w + 1)[None, :] < (lens - w + 1)[:, None]
    np.testing.assert_array_equal(
        start.numpy(), np.asarray(_change_mask(hi, lo)) & valid
    )


@pytest.mark.parametrize("k,s,w", SHAPES)
def test_window_sketches_torch_equals_numpy_golden(k, s, w):
    codes, lens = _ragged(np.random.default_rng(100 + k), 7, 300, w)
    sk, _start = pw.window_sketches_torch(
        torch.from_numpy(codes), torch.from_numpy(lens), k, s, w
    )
    sk = sk.numpy().view(np.uint64)
    for r in range(len(codes)):
        nw = lens[r] - w + 1
        if nw > 0:
            np.testing.assert_array_equal(
                sk[r, :nw], pw._window_sketch_np(codes[r, : lens[r]], k, s, w)
            )


def _repeat_rows(rng, L=2700):
    """Rows of 2,600+ bases with constant and copied stretches, so runs of
    identical window sketches cross every 1,024-window tile edge."""
    rows = []
    for n in (L, 2600, 2048 + 99, 1024 + 99, 1024 + 100, 150):
        seq = rng.integers(0, 4, size=n).astype(np.uint8)
        seq[min(1000, n // 2) : min(1300, n)] = seq[0]
        if n > 2100:
            seq[1900:2150] = 2
            seq[400:700] = seq[1500:1800]
        rows.append(seq)
    codes = np.full((len(rows), L), 4, np.uint8)
    lens = np.array([len(r) for r in rows], np.int32)
    for i, r in enumerate(rows):
        codes[i, : len(r)] = r
    return codes, lens


@pytest.mark.parametrize("k,s,w", [(31, 16, 100), (31, 20, 150), (7, 16, 40)])
def test_run_starts_equal_native(k, s, w):
    assert native.available()
    codes, lens = _repeat_rows(np.random.default_rng(21))
    want = native.window_sketch(codes, lens.astype(np.int64), k, s, w)
    got = pw.window_run_starts(
        torch.from_numpy(codes), torch.from_numpy(lens), k, s, w
    )
    rows, cols, sk, counts = (t.numpy() for t in got)
    np.testing.assert_array_equal(rows, want[0])
    np.testing.assert_array_equal(cols, want[1])
    np.testing.assert_array_equal(sk.view(np.uint64), want[2])
    np.testing.assert_array_equal(counts, want[3])
    # repeats make runs: fewer run starts than windows
    assert len(rows) < int((lens - w + 1).clip(min=0).sum())


def test_window_run_starts_rejects_bad_input():
    codes = torch.zeros((2, 50), dtype=torch.uint8)
    lens = torch.full((2,), 50, dtype=torch.int32)
    with pytest.raises(TypeError):
        pw.window_run_starts(codes.long(), lens, 7, 4, 20)
    with pytest.raises(TypeError):
        pw.window_run_starts(codes, lens.long(), 7, 4, 20)
    with pytest.raises(ValueError):
        pw.window_run_starts(codes, lens, 21, 4, 20)  # window shorter than k
    with pytest.raises(ValueError):
        pw.window_run_starts(codes, lens, 7, 0, 20)  # no slot
    with pytest.raises(ValueError):
        pw.window_run_starts(codes.to("meta"), lens.to("meta"), 7, 4, 20)


def test_sketch_graphs_soa_refuses_unknown_device():
    with pytest.raises(ValueError, match="device"):
        pw.sketch_graphs_soa([], 100, 31, 20, "meta")


# ---------------------------------------------------------------------------
# the window-sketch kernel's walk (csrc/window_sketch.cu), emulated in numpy
# ---------------------------------------------------------------------------
def _prefix_hashes_np(row, k: int, nk: int) -> np.ndarray:
    """The kernel's canonical hashes of a tile: the exclusive prefix-XORs
    X of ror(seed[b_p], p) and Y of rol(seed_rc[b_p], p) over the tile's
    bases (p from the tile's first base), then each k-mer from two of
    them."""
    p = np.arange(len(row), dtype=np.uint64)
    gf = nthash._ror_np(nthash.SEEDS_NP[row], p)
    gr = nthash._rol_np(nthash.SEEDS_RC_NP[row], p)
    X = np.concatenate([[np.uint64(0)], np.bitwise_xor.accumulate(gf)])
    Y = np.concatenate([[np.uint64(0)], np.bitwise_xor.accumulate(gr)])
    j = np.arange(nk)
    return np.minimum(nthash._rol_np(X[j + k] ^ X[j], j + k - 1),
                      nthash._ror_np(Y[j + k] ^ Y[j], j))


def _tiles_np(lens, w: int, tw: int):
    """The wrapper's tile table (`tile_table`) for rows of `lens`: (the row
    of each tile, the first tile of each row)."""
    table, n = pw.tile_table(np.clip(lens.astype(np.int64) - w + 1, 0, None), tw)
    return table[:n], table[n:]


def _kernel_walk_np(codes, lens, k: int, s: int, w: int, tw: int, sg: int = 0):
    """The kernel's run starts, walked as it walks them: the tiles of the
    wrapper's tile table in order (tw windows of a row each, none for a row
    without a window), each with the previous tile's last window as a halo; per
    (slot, m-block) the backward suffix minima and the forward prefix
    minima, a change marked where a finished window differs from the one
    before it, windows at an m-block start compared over every slot; each
    tile's run starts ranked in order at the count of every tile before it
    (what the look-back sums). With sg < s the slots run in groups of sg,
    each group's change marks and m-block start compares ORed into the
    tile's, and each group's minima written to its slots of the run
    starts. Returns native.window_sketch's contract."""
    sg = sg or s
    R, L = codes.shape
    m = w - k + 1
    out_row, out_col, out_sk = [], [], []
    counts = np.zeros(R, np.int64)
    tile_row, row_tile0 = _tiles_np(lens, w, tw)
    for tile, r in enumerate(tile_row):
        t0 = (tile - int(row_tile0[r])) * tw
        nw = int(lens[r]) - w + 1
        nt = min(nw - t0, tw)
        assert nt > 0  # no tile is empty
        halo = 1 if t0 > 0 else 0
        a0, nwc = t0 - halo, nt + halo
        nk = nwc + m - 1
        row = np.minimum(codes[r, a0:a0 + nk + k - 1], 4)
        h_all = nthash.multihash_np(_prefix_hashes_np(row, k, nk), k, s)  # [nk, s]
        diff = np.zeros(nwc, bool)
        i = np.arange(halo, nwc)
        edge = np.zeros(len(i), bool)
        groups = []
        for g0 in range(0, s, sg):
            h = h_all[:, g0:g0 + sg]
            mins = np.empty((nwc, h.shape[1]), np.uint64)
            b0 = np.arange(0, nwc, m)
            sv = np.full((len(b0), h.shape[1]), np.uint64(2**64 - 1))
            for d in range(m - 1, -1, -1):  # suffix minima, all blocks at once
                j = b0 + d
                ok = j < nk
                sv[ok] = np.minimum(sv[ok], h[j[ok]])
                ok &= j < nwc
                mins[j[ok]] = sv[ok]
            pv = np.full_like(sv, np.uint64(2**64 - 1))
            prev = sv.copy()
            for d in range(1, m):  # prefix minima of the next block
                ii = b0 + d
                ok = ii < nwc
                pv[ok] = np.minimum(pv[ok], h[ii[ok] + m - 1])
                v = np.minimum(mins[ii[ok]], pv[ok])
                mins[ii[ok]] = v
                diff[ii[ok]] |= (v != prev[ok]).any(axis=1)
                prev[ok] = v
            at = (i > 0) & (i % m == 0)
            edge[at] |= (mins[i[at]] != mins[i[at] - 1]).any(axis=1)
            groups.append(mins)
        mins = np.concatenate(groups, axis=1)
        flag = (a0 + i == 0) | diff[i] | edge
        out_row.append(np.full(int(flag.sum()), r, np.int32))
        out_col.append((a0 + i[flag]).astype(np.int32))
        out_sk.append(mins[i[flag]])
        counts[r] += int(flag.sum())
    if not out_row:
        return (np.empty(0, np.int32), np.empty(0, np.int32),
                np.empty((0, s), np.uint64), counts)
    return (np.concatenate(out_row), np.concatenate(out_col),
            np.concatenate(out_sk), counts)


def _edge_rows(rng, w: int, tw: int, L: int = 2700):
    """Rows whose window counts sit on tile edges and one off them, rows
    of exactly w bases and one short of w, and the _repeat_rows rows (runs
    of equal sketches across tile edges)."""
    rep, rep_lens = _repeat_rows(rng, L)
    lens = [w, w - 1] + [n * tw + d + w - 1 for n in (1, 2, 3) for d in (-1, 0, 1)]
    lens = [n for n in lens if n <= L]
    codes = rng.integers(0, 4, size=(len(lens), L)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    for i, n in enumerate(lens):
        codes[i, n:] = 4
    return (np.concatenate([codes, rep]),
            np.concatenate([np.array(lens, np.int32), rep_lens]))


@pytest.mark.parametrize("k,s,w,tw,sg", [
    (31, 20, 150, 512, 0), (31, 16, 100, 512, 0), (7, 16, 40, 512, 0),
    (31, 20, 31, 512, 0), (7, 3, 7, 512, 0), (15, 5, 47, 64, 0), (31, 20, 150, 32, 0),
    (7, 16, 40, 100, 0), (31, 20, 150, 512, 7), (7, 16, 40, 64, 1),
    (31, 128, 150, 512, 25),
])
def test_kernel_walk_matches_plain_jax_and_native(k, s, w, tw, sg):
    """m = 1 (w = k), m not a power of two (120, 70, 34, 33), the kernel's
    widest tile and narrower ones (more tile edges), rows at tile edges
    +- 1, rows of exactly w and w - 1 and the _repeat_rows rows; slot
    groups (sg < s: the kernel's route where no tile holds every slot's
    minima), down to one slot a group, and s = 128 in groups of 25."""
    rng = np.random.default_rng(k * 1000 + w)
    codes, lens = _edge_rows(rng, w, tw)
    got = _kernel_walk_np(codes, lens, k, s, w, tw, sg)
    assert len(got[0]) < int((lens - w + 1).clip(min=0).sum())  # runs exist
    want = native.window_sketch(codes, lens.astype(np.int64), k, s, w)
    plain = pw.window_run_starts_torch(torch.from_numpy(codes),
                                       torch.from_numpy(lens), k, s, w)
    for a, b, c in zip(got, want, plain):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64).view(np.int64),
                                      c.numpy().astype(np.int64))
    hi, lo = window_sketches(jnp.asarray(codes), jnp.asarray(lens), k, s, w)
    valid = np.arange(codes.shape[1] - w + 1)[None, :] < (lens - w + 1)[:, None]
    r, c = np.nonzero(np.asarray(_change_mask(hi, lo)) & valid)
    np.testing.assert_array_equal(got[0], r)
    np.testing.assert_array_equal(got[1], c)
    np.testing.assert_array_equal(got[2], _u64(hi, lo)[r, c])


@pytest.mark.parametrize("tw,lens", [
    (512, [1499, 149, 150, 0, 661, 662, 663, 1173, 1174, 1175]),
    (512, [149, 0, 149]), (512, [150]), (32, [180, 181, 182, 149, 40_000]),
    (100, list(range(140, 460, 7))),
])
def test_tile_table_covers_every_window(tw, lens):
    """The wrapper's tile table (at w = 150): in row-major order, a tile
    for each tw windows of a row, the last one partial, none for a row
    without a window; the kernel's (row, first window) of every tile."""
    lens = np.array(lens, np.int32)
    tile_row, row_tile0 = _tiles_np(lens, 150, tw)
    want = [(r, t0) for r, ln in enumerate(lens) for t0 in range(0, ln - 149, tw)]
    got = [(int(r), (t - int(row_tile0[r])) * tw) for t, r in enumerate(tile_row)]
    assert got == want
    assert tile_row.dtype == row_tile0.dtype == np.int32
