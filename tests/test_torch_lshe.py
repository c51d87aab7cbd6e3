"""groot.lshe across the two packages, and the port's LSH query.

Each package loads the index file the other dumped and both give the same
(rows, wins) on the same sketches, on the full-equality path and the banded
one. The device route (full sketches, prescreened=False) gives what the
reference's native prescreened route gives."""

import os

import numpy as np
import pytest

from groot_tpu.config import Info
from groot_tpu.index.lshe import ContainmentIndex as RefIndex
from groot_tpu.io import native
from groot_tpu.ops import nthash as ref_nthash
from groot_tpu.pipeline.index_pipeline import run_index as ref_run_index
from groot_tpu_torch import synth
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
    for name, fn in (("port", lambda i, m: run_index(i, m, "cpu")),
                     ("ref", ref_run_index)):
        d = str(tmp / name)
        fn(Info(kmer_size=K, sketch_size=S, window_size=W, index_dir=d),
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
