"""groot_tpu_torch: the PyTorch + CUDA port of groot_tpu.

The `index -> align -> report` main path, with the device engine's three
kernels (KHF read sketch, per-read hashes, phase-A seed scan) written in
CUDA C++ for sm_90a under `csrc/` and built at first use by `_build`. It
imports torch and never jax; of groot_tpu it reuses only the jax-free
modules (config, graph.grootgraph, io.gfa/msa2gfa/fastx/native,
align.batch_host, hostmem, version), so both packages read the same
groot.gg / groot.lshe / groot.align files."""
