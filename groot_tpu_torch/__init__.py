"""groot_tpu_torch: the PyTorch + CUDA port of groot_tpu.

Every command of groot_tpu (get, index, align, report, haplotype, accuracy,
version, iamgroot), with five kernels written in CUDA C++ for sm_90a under
`csrc/` and built at first use by `_build`: the window sketch of `index`,
the KHF read sketch, per-read hashes and phase-A seed scan of `align`, and
the batched EM of `haplotype`. It imports torch and never jax; of groot_tpu
it reuses only the jax-free modules (config, graph.grootgraph,
io.gfa/msa2gfa/fastx/native, align.batch_host, hostmem, version, get), so
both packages read the same groot.gg / groot.lshe / groot.align / GFA
files."""
