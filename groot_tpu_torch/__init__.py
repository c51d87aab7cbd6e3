"""groot_tpu_torch: the PyTorch + CUDA port of groot_tpu.

Every command of groot_tpu (get, index, align, report, haplotype, accuracy,
version, iamgroot) and every align engine (device, hash, host, cascade),
with eight kernels written in CUDA C++ for sm_90a under `csrc/` and built
at first use by `_build`. It imports torch and never jax, and nothing of
groot_tpu: it carries its own copies of the host modules (config,
graph.grootgraph, io.gfa/msa2gfa/fastx/seqio/native, align.batch_host,
ops.minhash, hostmem, version, get) and loads the shared native runtime
(native/grootio.cpp) itself. Both packages read the same groot.gg (written
under the reference's class names, see config), groot.lshe, groot.align and
GFA files."""
