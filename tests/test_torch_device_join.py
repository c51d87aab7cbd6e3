"""The port's device engine pieces against groot_tpu.align.device_join.

read_hashes_torch equals the reference's jitted `_read_hash_fn`, and
seed_scan_torch equals its `seed_scan` (single device, no mesh) on the rows
of a real batch plus rows seeded at and past the end of the last path;
tables_from_jax equals the port's own setup (the CUDA kernels are held to
the plain versions in test_torch_kernels.py)."""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groot_tpu.align.device_join import DeviceJoinAligner as RefAligner
from groot_tpu.align.device_join import _offsets as ref_offsets
from groot_tpu.align.device_join import seed_scan as ref_seed_scan
from groot_tpu_torch import synth
from groot_tpu_torch.align import device_join as dj
from groot_tpu_torch.align.batch_host import WindowTables
from groot_tpu_torch.config import Info
from groot_tpu_torch.index.lshe import ContainmentIndex
from groot_tpu_torch.io import bam as bamio
from groot_tpu_torch.io.fastx import FastqRead
from groot_tpu_torch.pipeline.align_pipeline import _compute_hits, _make_batch
from groot_tpu_torch.pipeline.index_pipeline import run_index

K, S, W = 31, 20, 100


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dj")
    alleles = synth.tiny_db(str(tmp / "msa"))
    run_index(Info(kmer_size=K, sketch_size=S, window_size=W,
                   index_dir=str(tmp / "idx")), str(tmp / "msa"), "cpu")
    info = Info.load(str(tmp / "idx" / "groot.gg"))
    index = ContainmentIndex.load(str(tmp / "idx" / "groot.lshe"))
    info.attach_db(index)
    refs = bamio.build_references(info.store)
    tables = WindowTables(index, info.store)
    port = dj.DeviceJoinAligner(info.store, refs, device="cpu")
    port.attach_tables(tables, index, K)
    ref = RefAligner(info.store, refs, mesh=None)
    ref.attach_tables(tables, index, K)

    seqs, _which, _starts = synth.sample_reads(
        np.random.default_rng(11), alleles, 160,
        lengths=(60, 75, 100, 101, 130, 150, 190), n_frac=0.05,
        tail_frac=0.3,
    )
    batch = _make_batch([
        FastqRead(id=b"@t%d" % i, seq=s, qual=b"I" * len(s))
        for i, s in enumerate(seqs)
    ])
    kc = (batch.lengths - K + 1).astype(np.int32)
    rows, wins, combo_start = _compute_hits(
        info, batch, kc, K, S, 0.99, tables, "cpu"
    )
    st = port.phase_a_rows(batch, rows, wins, combo_start)
    return port, ref, batch, st


def _ref_read_hashes(ref, codes, lens):
    """The reference's per-read tables, fed its 2-bit packed input."""
    U, L = codes.shape
    nm = codes == 4
    c2 = np.where(nm, 0, codes)
    packed = c2[:, 0::4] | (c2[:, 1::4] << 2) | (c2[:, 2::4] << 4) | (
        c2[:, 3::4] << 6
    )
    nmask = np.packbits(nm, axis=1, bitorder="little")
    ref._ensure_pow(L + 2)
    build = ref._read_hash_fn(U, L)
    return [np.asarray(x) for x in build(
        jnp.asarray(packed), jnp.asarray(nmask), jnp.asarray(lens)
    )]


def test_tables_from_jax_equal_setup_device(setup):
    port, ref, _batch, _st = setup
    assert port._d1 == ref._d1
    got = dj.tables_from_jax(
        {k: np.asarray(v) for k, v in ref._dev.items()}, "cpu"
    )
    assert got["rinv1"] == port._dev["rinv1"]
    for name in ("ah32", "pe2", "ph_start", "path_len", "tfree"):
        assert torch.equal(got[name], port._dev[name]), name


def test_read_hashes_torch_matches_jax(setup):
    port, ref, batch, st = setup
    codes, lens, rpow32, rinv32, _rows, sx = port.phase_a_inputs(batch, st)
    got = dj.read_hashes_torch(codes, lens, rpow32, rinv32, K, sx["WPH"])
    want = _ref_read_hashes(ref, codes.numpy(), lens.numpy())
    assert len(codes) > 50
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)


def _tail_rows(port, n_reads, lb_pool, rng):
    """Rows on the last path row seeded near, at and past its end — where
    the reference's clipped gather reads its zero padding."""
    prow = port.R - 1
    plen = int(port.path_len[prow])
    base = np.arange(plen - 60, plen + 12)
    n = len(base)
    return np.stack([
        rng.integers(0, n_reads, n), np.full(n, prow), base,
        rng.integers(0, port._d1, n), rng.choice(lb_pool, n),
    ]).astype(np.int32)


def test_seed_scan_torch_matches_jax(setup):
    port, ref, batch, st = setup
    codes, lens, rpow32, rinv32, rows_t, sx = port.phase_a_inputs(batch, st)
    extra = _tail_rows(
        port, len(codes), st["rows_np"][4], np.random.default_rng(3)
    )
    rows = np.concatenate([st["rows_np"], extra], axis=1)
    # real rows reach the last path's end, and its flat row F-1
    assert (st["rows_np"][1] == port.R - 1).any()
    assert (rows[2] + port.ph_start[rows[1]] >= len(port.ph) - 1).any()
    PH = dj.read_hashes_torch(codes, lens, rpow32, rinv32, K, sx["WPH"])
    got = dj.seed_scan_torch(
        port._dev, *PH, *torch.from_numpy(rows),
        D1=sx["D1"], k=K, n_offs=sx["n_offs"],
    )
    # the anchor ladder comes from the reference, so a fault in the port's
    # copy of it (which sets n_offs) cannot reach both sides
    offs = ref_offsets(batch.codes.shape[1], K)
    assert len(offs) == sx["n_offs"]
    want = ref_seed_scan(
        ref._dev, *(jnp.asarray(x.numpy()) for x in PH),
        *(jnp.asarray(r) for r in rows),
        jnp.ones(rows.shape[1], bool),
        D1=ref._d1, k=K, offs=offs,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the scan finds stage-1 and clip hits, not only "no match"
    assert ((got.numpy() & 0xFF) < 255).sum() > 10


def test_seed_scan_wrapper_checks(setup):
    port, _ref, batch, st = setup
    codes, lens, rpow32, rinv32, rows_t, sx = port.phase_a_inputs(batch, st)
    PH = dj.read_hashes(codes, lens, rpow32, rinv32, K, sx["WPH"])
    out = dj.seed_scan(port._dev, *PH, *rows_t, D1=sx["D1"], k=K,
                       n_offs=sx["n_offs"])
    assert out.dtype == torch.int32 and out.shape == (rows_t.shape[1],)
    with pytest.raises(TypeError):
        dj.seed_scan(port._dev, *PH, *rows_t.long(), D1=sx["D1"], k=K,
                     n_offs=sx["n_offs"])
    with pytest.raises(ValueError):
        dj.seed_scan(port._dev, *PH, *rows_t, D1=256, k=K,
                     n_offs=sx["n_offs"])


def test_row_pos_keys_do_not_alias_on_long_paths():
    long_path = (1 << 21) + 5
    shift = dj.row_pos_shift(long_path, 4)
    a = (np.int64(0) << shift) + np.int64(1 << 21)  # row 0, pos 2^21
    b = (np.int64(1) << shift) + np.int64(0)        # row 1, pos 0
    assert a != b
    assert (np.int64(0) << 21) + np.int64(1 << 21) == (np.int64(1) << 21)
    with pytest.raises(ValueError):
        dj.row_pos_shift(1 << 40, 1 << 30)


def test_stage_time_counters_are_locked(setup):
    port = setup[0]
    port.stage_times.pop("stress", None)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(
                target=lambda: [port._count("stress", 1) for _ in range(2000)]
            )
            for _ in range(16)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert port.stage_times["stress"] == 16 * 2000

