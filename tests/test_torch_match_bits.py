"""The `host` engine's match volumes: the match-bits kernel's algorithm, its
plain version and the reference's `_match_bits`.

`_kernel_walk_np` runs csrc/match_bits.cu's algorithm in numpy (bit planes
of each path row, the funnel shift of two plane words, the AND with its
early exit, the last-word mask); it, the port's plain `match_bits_torch`
and groot_tpu's `_match_bits` (an XLA convolution on the CPU) must give the
same bits on seeded `synth.match_bits_case` inputs. `_batch_match_bits` on
codes must equal the one-hot route it replaced and groot_tpu's aligner on
a synthetic graph. The tolerance everywhere is bit equality."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groot_tpu.align import aligner as ref_aligner
from groot_tpu.config import Info as RefInfo
from groot_tpu_torch import synth
from groot_tpu_torch.align import aligner
from groot_tpu_torch.config import Info
from groot_tpu_torch.io.fastx import FastqRead
from groot_tpu_torch.ops.nthash import ASCII_TO_CODE, RC_CODE_NP
from groot_tpu_torch.pipeline.index_pipeline import run_index

CASES = [
    dict(seed=1),                                     # Lr 45, W 156: neither a multiple of 32
    dict(seed=2, P=1, Lp=97, K=30, Lr=32),            # one path row
    dict(seed=3, P=5, Lp=287, K=24, Lr=32),           # W = 256, a multiple of 32
    dict(seed=4, P=4, Lp=1160, K=60, Lr=160, pad=160),  # the aligner's widths, pad columns
    dict(seed=5, P=2, Lp=120, K=20, Lr=1),            # one-column variants: eff 1 and 0
    dict(seed=6, P=3, Lp=300, K=30, Lr=64, n_run=80),  # a run of path Ns
    dict(seed=7, P=2, Lp=70, K=16, Lr=70),            # W = 1
    dict(seed=8, P=3, Lp=200, K=40, Lr=33, n_frac=0.2, zero_frac=0.3,
         pad_frac=0.3),                               # many Ns, eff 0 and -1
]


def _kernel_walk_np(path, var, var_len):
    """csrc/match_bits.cu in numpy: per path row five u32 planes over NWp =
    W32 + ceil(Lr/32) words (plane c < 4: base c or wildcard; plane 4:
    wildcard; 0 past Lp), then per (variant, word) the AND of funnel-shifted
    plane words over the variant's bases, stopping at 0, and the last word
    masked to W. A plane word read past NWp raises IndexError."""
    P, Lp = path.shape
    K, Lr = var.shape
    W = Lp - Lr + 1
    W32 = -(-W // 32)
    NWp = W32 + -(-Lr // 32)
    x = np.arange(NWp * 32)
    out = np.zeros((K, P, W32), np.uint32)
    shifts = np.arange(32, dtype=np.uint64)
    early = 0
    for p in range(P):
        inside = x < Lp
        c = path[p, np.minimum(x, Lp - 1)]
        wild = inside & (c >= 4)
        preds = [(inside & (c == b)) | wild for b in range(4)] + [wild]
        planes = [[int(v) for v in (m.reshape(NWp, 32).astype(np.uint64) << shifts).sum(1)]
                  for m in preds]
        for k in range(K):
            n = int(var_len[k])
            v = [min(int(b), 4) for b in var[k]]
            for w in range(W32):
                acc = 0 if n < 0 or n > Lr else 0xFFFFFFFF
                j = 0
                while j < n and acc:
                    pl = planes[v[j]]
                    lo, hi = pl[w + (j >> 5)], pl[w + (j >> 5) + 1]
                    acc &= ((hi << 32 | lo) >> (j & 31)) & 0xFFFFFFFF
                    j += 1
                early += j < n
                if w == W32 - 1 and W % 32:
                    acc &= (1 << (W % 32)) - 1
                out[k, p, w] = acc
    return out, early


def _onehots(path, var, var_len):
    """The reference's one-hots of the codes: [P, Lp, 5] with wildcard rows,
    [K, Lr, 5] with a variant's rows from var_len on zero."""
    path_oh = aligner.path_onehot(torch.from_numpy(path)).numpy()
    live = np.arange(var.shape[1])[None, :] < var_len[:, None]
    kern = np.eye(5, dtype=np.float32)[np.minimum(var, 4)] * live[..., None]
    return path_oh, kern


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("case", CASES)
def test_kernel_walk_matches_plain(case):
    path, var, var_len = synth.match_bits_case(**case)
    walk, early = _kernel_walk_np(path, var, var_len)
    got = aligner.match_bits(*(torch.from_numpy(a) for a in (path, var, var_len)))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(walk, _bits(got))
    assert walk.any()
    if var.shape[1] >= 32:  # words that stop before their last base
        assert early > 0


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_match_bits(case):
    path, var, var_len = synth.match_bits_case(**case)
    plain = aligner.match_bits_torch(*(torch.from_numpy(a) for a in (path, var, var_len)))
    path_oh, kern = _onehots(path, var, var_len)
    want = np.asarray(ref_aligner._match_bits(
        jnp.asarray(path_oh), jnp.asarray(kern), jnp.asarray(var_len)))
    np.testing.assert_array_equal(_bits(plain), want)
    # the variants that never or always match
    W = path.shape[1] - var.shape[1] + 1
    assert not want[var_len < 0].any()
    full = np.zeros(want.shape[-1] * 32, bool)
    full[:W] = True
    every = (full.reshape(-1, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(1)
    assert (want[var_len == 0] == every.astype(np.uint32)).all()


def test_match_bits_checks_its_inputs():
    path = torch.zeros((2, 40), dtype=torch.uint8)
    var = torch.zeros((3, 8), dtype=torch.uint8)
    n = torch.full((3,), 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        aligner.match_bits(path.long(), var, n)
    with pytest.raises(TypeError):
        aligner.match_bits(path, var, n.long())
    with pytest.raises(ValueError, match="variant width"):
        aligner.match_bits(path[:, :7], var, n)
    meta = [t.to("meta") for t in (path, var, n)]
    with pytest.raises(ValueError, match="no kernel"):
        aligner.match_bits(*meta)
    assert aligner.match_bits(path, var[:0], n[:0]).shape == (0, 2, 2)


@pytest.fixture(scope="module")
def graph_stores(tmp_path_factory):
    """The port's and the reference's stores of one synthetic index, and the
    alleles it was made from."""
    tmp = tmp_path_factory.mktemp("mb")
    alleles = synth.tiny_db(str(tmp / "msa"))
    run_index(Info(kmer_size=31, sketch_size=20, window_size=100,
                   index_dir=str(tmp / "idx")), str(tmp / "msa"), "cpu")
    port = Info.load(str(tmp / "idx" / "groot.gg")).store
    ref = RefInfo.load(str(tmp / "idx" / "groot.gg")).store
    return port, ref, alleles


def _reads(alleles, seed: int):
    """Reads of 1-200 bases cut from the alleles (some reverse complemented,
    with Ns, with a base changed), then a 1-base read and an all-N read."""
    seqs, _which, _starts = synth.sample_reads(
        np.random.default_rng(seed), alleles, 40, lengths=(31, 60, 100, 150, 200),
        n_frac=0.1, tail_frac=0.2)
    seqs += [b"A", b"N" * 40]
    return [FastqRead(id=b"@m%d" % i, seq=s, qual=b"I" * len(s))
            for i, s in enumerate(seqs)]


def _onehot_route(gp, reads):
    """The match volumes as `_batch_match_bits` made them before it built
    codes: one-hot read kernels per read and variant, `gp.onehot`, then
    `_match_bits`."""
    R = len(reads)
    Lr_b = -(-max(max(len(r.seq) for r in reads), 32) // 32) * 32
    kernels = np.zeros((R * 6, Lr_b, 5), dtype=np.float32)
    eff = np.full(R * 6, -1, dtype=np.int32)
    for r, read in enumerate(reads):
        codes = ASCII_TO_CODE[np.frombuffer(read.seq, dtype=np.uint8)]
        Lr = len(codes)
        for o, cs in enumerate((codes, RC_CODE_NP[codes][::-1])):
            oh = np.zeros((Lr_b, 5), dtype=np.float32)
            oh[np.arange(Lr), cs] = 1.0
            base = r * 6 + o * 3
            kernels[base], eff[base] = oh, Lr
            kernels[base + 1, : Lr - 1], eff[base + 1] = oh[1:Lr], Lr - 1
            kernels[base + 2], eff[base + 2] = oh, Lr - 1
            kernels[base + 2, Lr - 1] = 0.0
    path_oh = gp.onehot(extra_pad=Lr_b)
    bits = aligner._match_bits(torch.from_numpy(path_oh), torch.from_numpy(kernels),
                               torch.from_numpy(eff))
    return bits.reshape(R, 6, path_oh.shape[0], bits.shape[-1])


@pytest.mark.parametrize("seed", [11, 12])
def test_batch_match_bits_codes_equal_onehot_route_and_reference(graph_stores, seed):
    port, ref, alleles = graph_stores
    reads = _reads(alleles, seed)
    for gid in sorted(port):
        ga = aligner.GraphAligner(copy.deepcopy(port), device="cpu")
        gp = ga.pack(ga.store[gid])
        got = ga._batch_match_bits(gp, reads)
        np.testing.assert_array_equal(got, _onehot_route(gp, reads))
        # the reference pads rows to a power of two and the width to a
        # multiple of 512: its real rows and the port's offsets o < W agree
        ref_ga = ref_aligner.GraphAligner(ref)
        want = ref_ga._batch_match_bits(ref_ga.pack(ref[gid]), reads)
        R, _six, P, W32 = got.shape
        W = gp.path_codes(0).shape[1] + 1  # Lp - Lr_b + 1 with Lp = L + Lr_b
        mask = np.zeros(W32 * 32, bool)
        mask[:W] = True
        mask_w = (mask.reshape(W32, 32).astype(np.uint64)
                  << np.arange(32, dtype=np.uint64)).sum(1).astype(np.uint32)
        np.testing.assert_array_equal(got, want[:, :, :P, :W32] & mask_w)
        assert got.any()
