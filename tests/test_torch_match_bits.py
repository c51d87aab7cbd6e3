"""The `host` engine's match volumes: the match-bits kernel's algorithm, its
plain version and the reference's `_match_bits`.

`_kernel_walk_np` runs csrc/match_bits.cu's algorithm in numpy (bit planes
of each path row, the funnel shift of two plane words, the AND with its
early exit, the last-word mask); it, the port's plain `match_bits_torch`
and groot_tpu's `_match_bits` (an XLA convolution on the CPU) must give the
same bits on seeded `synth.match_bits_case` inputs, and on batches of
many graphs (`synth.match_bits_batch_case`, and mixed-length reads seeded
to a synthetic index's graphs) the batched route `match_bits_batch` /
`GraphAligner._match_volumes` equals the per-graph plain version on the
inputs the aligner built before, the one-hot route and groot_tpu's
aligner, graph by graph. The tolerance everywhere is bit equality."""

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

SERIAL = 8  # csrc/match_bits.cu's kSerial: bases a thread walks alone

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


# a shared-route block's dynamic shared memory on an H100, as
# groot_match_bits_smem_limit gives it: the 232,448 opt-in bytes less the
# kernel's 2,052-byte static queue
H100_LIMIT = 232_448 - 2_052


def _kernel_walk_np(rows, row_off, row_len, reads, read_len, pairs, segs, nvar,
                    items=aligner.ITEMS_PER_BLOCK, max_words=aligner.MAX_BLOCK_WORDS,
                    limit=H100_LIMIT):
    """csrc/match_bits.cu in numpy, block by block of `aligner.work_table`
    (`limit` bytes of shared memory a block; the global route's blocks
    walk the same way): per block five u32 planes over its chunk's words +
    ceil(ls/32) (plane c < 4: base c or wildcard; plane 4: wildcard;
    wildcard past the row's end; ls the segment's staged bases), the first
    ls codes of its pairs staged (and of their reverse complements for
    nvar 6), then per (variant, word) the AND of funnel-shifted plane words
    over the variant's bases, cut to the staged ones: the first SERIAL
    stopping at 0, the rest only for the words still live (the kernel's
    queue), and the last word masked to W. Returns (the u32 bits, words
    that stopped before their last base); a plane word read past the
    block's planes raises IndexError, a block past its route's bytes, or a
    word written twice or never, fails."""
    rows, row_off, row_len, reads, read_len, pairs = (
        np.asarray(a) for a in (rows, row_off, row_len, reads, read_len, pairs))
    Lr = reads.shape[1]
    segs = np.asarray(segs, np.int64).reshape(-1, 5)
    ls_seg = aligner.staged_bases(segs, Lr, read_len, pairs, row_len)
    seg_tab, work, n_shared, smem, slice_bytes = aligner.work_table(
        segs, nvar, ls_seg, items, max_words, limit)
    assert smem <= limit
    sizes = seg_tab[:, 1].astype(np.int64) * nvar * seg_tab[:, 3] * seg_tab[:, 5]
    seg_out = np.concatenate([[0], np.cumsum(sizes)])
    out = np.zeros(seg_out[-1], np.uint32)
    written = np.zeros(seg_out[-1], np.int64)
    shifts = np.arange(32, dtype=np.uint64)
    comp = np.array([3, 2, 1, 0, 4])
    nc = 2 if nvar == 6 else 1
    early = 0
    for b, (s, p, pair0, word0) in enumerate(work.tolist()):
        pair_off, n_seg, row0, P, W, W32, PG, WC, ls = seg_tab[s].tolist()
        row = row0 + p
        n_p, nw = min(PG, n_seg - pair0), min(WC, W32 - word0)
        nws = nw + -(-ls // 32)
        assert 20 * nws + n_p * nc * ls <= (smem if b < n_shared else slice_bytes)
        x = word0 * 32 + np.arange(nws * 32)
        inside = x < row_len[row]
        c = np.where(inside, rows[row_off[row] + np.where(inside, x, 0)], 4)
        preds = [(c == b) | (c >= 4) for b in range(4)] + [c >= 4]
        planes = np.stack([(m.reshape(nws, 32).astype(np.uint64) << shifts).sum(1)
                           for m in preds])                      # [5, nws]
        rd = pairs[pair_off + pair0:pair_off + pair0 + n_p]
        staged = [np.minimum(reads[rd][:, :ls], 4)]
        if nvar == 6:
            src = read_len[rd][:, None] - 1 - np.arange(ls)[None, :]
            ok = (src >= 0) & (src < Lr)
            staged.append(np.where(ok, comp[np.minimum(np.take_along_axis(
                reads[rd], np.clip(src, 0, Lr - 1), 1), 4)], 4))
        staged = np.stack(staged, 1)                             # [n_p, nc, ls]
        pl, v, wl = (a.reshape(-1) for a in np.meshgrid(
            np.arange(n_p), np.arange(nvar), np.arange(nw), indexing="ij"))
        length = read_len[rd][pl].astype(np.int64)
        strand, skip = np.zeros_like(v), np.zeros_like(v)
        if nvar == 6:
            strand, kind = v // 3, v % 3
            skip = (kind == 1).astype(np.int64)
            length = length - (kind > 0)
        lim = np.minimum(length, ls - skip)  # the bases the walk takes
        acc = np.where((length < 0) | (length > Lr), 0, 0xFFFFFFFF).astype(np.uint64)
        queued = None
        for j in range(ls):
            if j < SERIAL:  # a thread alone, stopping at 0
                live = (acc != 0) & (j < lim)
            else:  # the queued words, a warp each, no early exit
                if queued is None:
                    queued = (acc != 0) & (lim > SERIAL)
                    early += int(((acc == 0) & (length > 0)).sum())
                live = queued & (j < lim)
            if not live.any():
                break
            code = staged[pl[live], strand[live], j + skip[live]]
            lo = planes[code, wl[live] + (j >> 5)]
            hi = planes[code, wl[live] + (j >> 5) + 1]
            acc[live] &= ((hi << np.uint64(32) | lo) >> np.uint64(j & 31)) & np.uint64(0xFFFFFFFF)
        if queued is None:
            early += int(((acc == 0) & (length > 0)).sum())
        w = word0 + wl
        last = (w == W32 - 1) & (W % 32 != 0)
        acc[last] &= np.uint64((1 << (W % 32)) - 1) if W % 32 else np.uint64(0)
        idx = seg_out[s] + (((pair0 + pl) * nvar + v) * P + p) * W32 + w
        out[idx] = acc.astype(np.uint32)
        written[idx] += 1
    assert (written == 1).all()
    return out, early


def _one_graph_args(path, var, var_len):
    """`match_bits`' one segment as `match_bits_batch` arguments (numpy)."""
    (P, Lp), (K, Lr) = path.shape, var.shape
    return (path.reshape(-1), np.arange(P, dtype=np.int64) * Lp, np.full(P, Lp, np.int32),
            var, var_len, np.arange(K, dtype=np.int32),
            np.array([[0, K, 0, P, Lp - Lr + 1]], np.int64))


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
    walk, early = _kernel_walk_np(*_one_graph_args(path, var, var_len), nvar=1)
    got = aligner.match_bits(*(torch.from_numpy(a) for a in (path, var, var_len)))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(walk.reshape(got.shape), _bits(got))
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


def _pr9_match_inputs(gp, reads):
    """The per-graph match-bits inputs as the aligner built them before one
    call covered a batch: path codes u8 [P, L + Lr_b] (N-padded), variant
    codes u8 [6R, Lr_b] and var_len int32 [6R]; a read's six variants (fwd
    | rc) x (full | clip-start: read[1:] | clip-end: read[:Lr-1])."""
    R = len(reads)
    lens = np.fromiter((len(r.seq) for r in reads), np.int64, R)
    Lr_b = -(-max(int(lens.max()), 32) // 32) * 32
    col = np.arange(Lr_b)
    fwd = np.full((R, Lr_b), 4, dtype=np.uint8)
    fwd[col[None, :] < lens[:, None]] = ASCII_TO_CODE[
        np.frombuffer(b"".join(r.seq for r in reads), dtype=np.uint8)]
    src = lens[:, None] - 1 - col[None, :]  # rc[j] = comp(read[Lr-1-j])
    rc = np.where(src >= 0,
                  RC_CODE_NP[np.take_along_axis(fwd, src.clip(0), axis=1)], 4)
    var = np.full((R, 2, 3, Lr_b), 4, dtype=np.uint8)
    var_len = np.empty((R, 2, 3), dtype=np.int32)
    for o, cs in enumerate((fwd, rc)):
        var[:, o, 0] = cs
        var[:, o, 1, :-1] = cs[:, 1:]
        var[:, o, 2] = cs
        var_len[:, o, 0] = lens
        var_len[:, o, 1:] = (lens - 1)[:, None]
    codes = gp.packed.codes
    path = np.full((codes.shape[0], codes.shape[1] + Lr_b), 4, dtype=np.uint8)
    path[:, :codes.shape[1]] = codes
    return path, var.reshape(R * 6, Lr_b), var_len.reshape(R * 6)


def _onehot_route(gp, reads):
    """The match volumes as `_batch_match_bits` made them before it built
    codes: one-hot read kernels per read and variant, the path one-hots,
    then `_match_bits`."""
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
    path_oh = aligner.path_onehot(torch.from_numpy(_pr9_match_inputs(gp, reads)[0]))
    bits = aligner._match_bits(path_oh, torch.from_numpy(kernels), torch.from_numpy(eff))
    return bits.reshape(R, 6, path_oh.shape[0], bits.shape[-1])


def _below_w(ref_bits, P, W32, W):
    """The reference's bits (rows padded to a power of two, the width to a
    multiple of 512) cut to the real rows and the offsets o < W."""
    mask = np.zeros(W32 * 32, bool)
    mask[:W] = True
    mask_w = (mask.reshape(W32, 32).astype(np.uint64)
              << np.arange(32, dtype=np.uint64)).sum(1).astype(np.uint32)
    return ref_bits[:, :, :P, :W32] & mask_w


@pytest.mark.parametrize("seed", [11, 12])
def test_batch_match_bits_codes_equal_onehot_route_and_reference(graph_stores, seed):
    port, ref, alleles = graph_stores
    reads = _reads(alleles, seed)
    for gid in sorted(port):
        ga = aligner.GraphAligner(copy.deepcopy(port), device="cpu")
        gp = ga.pack(ga.store[gid])
        got = ga._match_volumes([(gp, reads)])[0]
        np.testing.assert_array_equal(got, _onehot_route(gp, reads))
        # the reference pads rows to a power of two and the width to a
        # multiple of 512: its real rows and the port's offsets o < W agree
        ref_ga = ref_aligner.GraphAligner(ref)
        want = ref_ga._batch_match_bits(ref_ga.pack(ref[gid]), reads)
        R, _six, P, W32 = got.shape
        np.testing.assert_array_equal(got, _below_w(want, P, W32, gp.packed.codes.shape[1] + 1))
        assert got.any()


def _mixed_batch(alleles, gids, seed: int,
                 lengths=(20, 25, 31, 32, 33, 64, 100, 150)):
    """A read batch of mixed lengths (20-150 bp, a few under 32; Ns, reverse
    complements, a base changed) and the reads seeded to each graph: a
    random subset each, so that some reads go to several graphs, in a
    shuffled graph order."""
    rng = np.random.default_rng(seed)
    seqs, _which, _starts = synth.sample_reads(
        rng, alleles, 30, lengths=lengths, n_frac=0.2, tail_frac=0.2)
    reads = [FastqRead(id=b"@x%d" % i, seq=s, qual=b"I" * len(s))
             for i, s in enumerate(seqs)]
    order = list(rng.permutation(gids))
    groups = {int(g): [reads[i] for i in rng.choice(len(reads), int(rng.integers(3, 15)),
                                                    replace=False)]
              for g in order}
    return reads, groups


@pytest.mark.parametrize("seed", [11, 12])
def test_variant_tables_equal_match_inputs(graph_stores, seed):
    """The batch's pair and read tables give, through `segment_inputs`
    (the kernel's derivation of a pair's six variants), exactly the path
    rows, variant rows and var_len of the per-graph inputs the aligner built
    before, at every graph."""
    port, _ref, alleles = graph_stores
    _reads_, groups = _mixed_batch(alleles, sorted(port), seed)
    ga = aligner.GraphAligner(copy.deepcopy(port), device="cpu")
    packs = [(ga.pack(ga.store[g]), rs) for g, rs in groups.items()]
    args = ga.match_batch_inputs(packs)
    rows, row_off, row_len, codes, lens, pairs, segs = args
    assert len(codes) < len(pairs)  # a read seeded to several graphs is sent once
    t = [torch.as_tensor(a) for a in args[:-1]]
    for (gp, rs), seg in zip(packs, segs):
        path, var, var_len = aligner.segment_inputs(*t, seg, nvar=6)
        want_path, want_var, want_len = _pr9_match_inputs(gp, rs)
        Lr_b = want_var.shape[1]
        # the batch's read width may exceed this graph's: the extra columns
        # of every row are N, and so is the extra path padding
        assert var.shape[1] >= Lr_b and (var.numpy()[:, Lr_b:] == 4).all()
        np.testing.assert_array_equal(var.numpy()[:, :Lr_b], want_var)
        np.testing.assert_array_equal(var_len.numpy(), want_len)
        np.testing.assert_array_equal(path.numpy()[:, :want_path.shape[1]], want_path)
        assert (path.numpy()[:, want_path.shape[1]:] == 4).all()


@pytest.mark.parametrize("seed", [21, 22])
def test_batch_equals_per_graph_and_jax(graph_stores, seed):
    """One `_match_volumes` call over every graph of a mixed-length batch
    (reads of 20-150 bp with Ns, a read in several graphs, graphs whose
    rows differ in length) equals, graph by graph, the per-graph plain
    version on the inputs the aligner built before, the JAX `_match_bits`
    (the reference aligner's `_batch_match_bits`) at its real rows and
    offsets below W, and the kernel's loop walked in numpy; and a second
    batch on the same aligner (other lengths, so another read width) too."""
    port, ref, alleles = graph_stores
    ga = aligner.GraphAligner(copy.deepcopy(port), device="cpu")
    ref_ga = ref_aligner.GraphAligner(ref)
    unequal = [g for g in port if len(set(ga.pack(port[g]).lengths.tolist())) > 1]
    assert unequal  # a graph whose rows differ in length
    widths = set()
    for batch_seed, lengths in ((seed, (20, 25, 31, 32, 33, 64, 100, 150)),
                                (seed + 100, (20, 30, 45, 90))):
        _r, groups = _mixed_batch(alleles, sorted(port), batch_seed, lengths)
        packs = [(ga.pack(ga.store[g]), rs) for g, rs in groups.items()]
        args = ga.match_batch_inputs(packs)
        widths.add(args[3].shape[1])
        walk, _early = _kernel_walk_np(*args, nvar=6)
        got = ga._match_volumes(packs)
        off = 0
        for (gp, rs), bits in zip(packs, got):
            path, var, var_len = _pr9_match_inputs(gp, rs)
            plain = aligner.match_bits_torch(*(torch.from_numpy(a) for a in (path, var, var_len)))
            np.testing.assert_array_equal(bits, _bits(plain).reshape(bits.shape))
            R, _six, P, W32 = bits.shape
            want = ref_ga._batch_match_bits(ref_ga.pack(ref[gp.packed.graph_id]), rs)
            np.testing.assert_array_equal(bits, _below_w(want, P, W32, gp.packed.codes.shape[1] + 1))
            np.testing.assert_array_equal(walk[off:off + bits.size].reshape(bits.shape), bits)
            off += bits.size
        assert off == len(walk) and walk.any()
    assert len(widths) == 2


@pytest.mark.parametrize("layout", [(256, 1024), (64, 5), (2000, 2), (1, 1)])
@pytest.mark.parametrize("seed", [1, 2])
def test_kernel_walk_batch_layouts(seed, layout):
    """The kernel's loop over any launch layout (pairs a block, row chunks
    down to one word) gives the plain batched version's bits on a seeded
    `synth.match_bits_batch_case`: rows of 300-1,500 bp of unequal length
    within a graph, reads of 20-150 bp with Ns in several graphs."""
    args = synth.match_bits_batch_case(seed, n_graphs=4, n_reads=20)
    plain = aligner.match_bits_batch_torch(*(torch.from_numpy(a) for a in args[:-1]),
                                           args[-1], nvar=6)
    walk, early = _kernel_walk_np(*args, nvar=6, items=layout[0], max_words=layout[1])
    np.testing.assert_array_equal(walk, _bits(plain))
    assert walk.any() and early > 0
    bits, off = aligner.match_bits_batch(torch.from_numpy(args[0]), *args[1:])
    np.testing.assert_array_equal(_bits(bits), walk)
    assert off[-1] == len(walk)


@pytest.mark.parametrize("nvar,Lr,W", [(1, 1000, 1), (1, 32, 1), (6, 160, 1500),
                                       (6, 4096, 40_000), (1, 200_000, 10)])
def test_work_table_bounds_a_blocks_shared_memory(nvar, Lr, W):
    """A block stages at most MAX_STAGED_BYTES of codes (or one pair) and
    the planes of at most MAX_BLOCK_WORDS words + ceil(ls/32), whatever the
    items target; a segment whose block fits the H100's shared memory
    takes the shared route, one that does not (ls = 200,000) the global
    route with a slice that holds its block; and the table covers every
    (row, pair, word) once."""
    n, P = 3000, 3
    segs = np.array([[0, n, 0, P, W]], np.int64)
    nc = 2 if nvar == 6 else 1
    for items in (aligner.ITEMS_PER_BLOCK, 1 << 20):
        seg_tab, work, n_shared, smem, slice_bytes = aligner.work_table(
            segs, nvar, np.array([Lr]), items, aligner.MAX_BLOCK_WORDS, H100_LIMIT)
        PG, WC, W32 = int(seg_tab[0, 6]), int(seg_tab[0, 7]), int(seg_tab[0, 5])
        assert PG == 1 or PG * nc * Lr <= aligner.MAX_STAGED_BYTES
        assert WC <= aligner.MAX_BLOCK_WORDS and int(seg_tab[0, 8]) == Lr
        nbytes = 20 * (WC + -(-Lr // 32)) + PG * nc * Lr
        if Lr < 100_000:
            assert n_shared == len(work) and nbytes == smem <= H100_LIMIT
            assert slice_bytes == 0
        else:
            assert n_shared == 0 and smem == 0
            assert H100_LIMIT < nbytes <= slice_bytes and slice_bytes % 16 == 0
        covered = sum(min(PG, n - p0) * min(WC, W32 - w0) for _s, _r, p0, w0 in work.tolist())
        assert covered == P * n * W32


@pytest.mark.parametrize("long_reads", [(200_000,), (100_000, 200_000)])
def test_long_read_blocks_fit_shared_memory(long_reads):
    """Reads of 100-200 kb among 20-150 bp reads on rows of 300-1,500 bp:
    each segment stages its own longest read's bases, cut to its longest
    row + 1, so every block takes the shared route within the H100's
    shared memory, and the segments without a long read keep their
    short-read staging."""
    args = synth.match_bits_batch_case(5, n_graphs=6, n_reads=40, long_reads=long_reads)
    rows, row_off, row_len, reads, read_len, pairs, segs = args
    assert reads.shape[1] >= max(long_reads)
    ls = aligner.staged_bases(segs, reads.shape[1], read_len, pairs, row_len)
    _tab, work, n_shared, smem, slice_bytes = aligner.work_table(
        segs, 6, ls, aligner.ITEMS_PER_BLOCK, aligner.MAX_BLOCK_WORDS, H100_LIMIT)
    assert n_shared == len(work) and 0 < smem <= H100_LIMIT and slice_bytes == 0
    for (p0, n, r0, n_rows, _W), got in zip(segs.tolist(), ls.tolist()):
        longest = int(read_len[pairs[p0:p0 + n]].max())
        if longest > 150:
            assert got == int(row_len[r0:r0 + n_rows].max()) + 1 < longest
        else:
            assert got == longest


@pytest.mark.parametrize("limit", [H100_LIMIT, 4096])
def test_long_read_batch_equals_jax(graph_stores, limit):
    """A batch of 150 bp reads and one 5 kb read (an allele's tail, then
    random bases) over every graph: `_match_volumes` (the plain batched
    version on the CPU) equals the JAX `_batch_match_bits` below W, graph
    by graph, and the kernel's loop walked in numpy with the long read's
    staging cut to the rows' length + 1, on the shared route and (at a
    4,096-byte limit) on the global route; the long read matches where
    its allele's tail lies."""
    port, ref, alleles = graph_stores
    rng = np.random.default_rng(31)
    seqs, _which, _starts = synth.sample_reads(rng, alleles, 12, lengths=(150,), n_frac=0.2)
    tail = alleles[0][len(alleles[0]) - 120:]
    long_seq = tail + bytes(rng.choice(list(b"ACGT"), 5000 - len(tail)).tolist())
    reads = [FastqRead(id=b"@l%d" % i, seq=s, qual=b"I" * len(s))
             for i, s in enumerate(seqs + [long_seq])]
    ga = aligner.GraphAligner(copy.deepcopy(port), device="cpu")
    ref_ga = ref_aligner.GraphAligner(ref)
    packs = [(ga.pack(ga.store[g]), reads) for g in sorted(port)]
    args = ga.match_batch_inputs(packs)
    assert args[3].shape[1] == 5024
    walk, _early = _kernel_walk_np(*args, nvar=6, limit=limit)
    got = ga._match_volumes(packs)
    off, long_hits = 0, 0
    for (gp, rs), bits in zip(packs, got):
        R, _six, P, W32 = bits.shape
        want = ref_ga._batch_match_bits(ref_ga.pack(ref[gp.packed.graph_id]), rs)
        np.testing.assert_array_equal(bits, _below_w(want, P, W32, gp.packed.codes.shape[1] + 1))
        np.testing.assert_array_equal(walk[off:off + bits.size].reshape(bits.shape), bits)
        off += bits.size
        long_hits += int(np.count_nonzero(bits[-1]))
    assert off == len(walk) and long_hits > 0


def test_match_bits_batch_checks_its_inputs():
    args = list(synth.match_bits_batch_case(3, n_graphs=2, n_reads=5))
    rows = torch.from_numpy(args[0])
    with pytest.raises(TypeError):
        aligner.match_bits_batch(rows.long(), *args[1:])
    with pytest.raises(TypeError):
        aligner.match_bits_batch(rows, *args[1:3], args[3].astype(np.int32), *args[4:])
    with pytest.raises(ValueError, match="nvar"):
        aligner.match_bits_batch(rows, *args[1:], nvar=3)
    with pytest.raises(ValueError, match="longer than"):
        aligner.match_bits_batch(rows, *args[1:4], args[4] + 1000, *args[5:])
    with pytest.raises(ValueError, match="no kernel"):
        aligner.match_bits_batch(rows.to("meta"), *args[1:])
    bits, off = aligner.match_bits_batch(rows, *args[1:6], args[6][:0])
    assert bits.numel() == 0 and list(off) == [0]
