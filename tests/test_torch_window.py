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
