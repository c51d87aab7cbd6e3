"""Read-batch sketching: the wrapper of the KHF-sketch CUDA kernel.

Counterpart of groot_tpu/ops/pallas_sketch.py (`sketch_reads`,
`sketch_reads_u64`, `khf_sketch_pallas`). The output is u64 [B, s] only —
an int64 tensor holding the bits, viewed as np.uint64 on the host — with no
hi/lo split, no padding of B or L, and no backend probe: the device is the
tensor's.
"""

from __future__ import annotations

import numpy as np
import torch

from .._build import I, Kernel, P, ptr
from .nthash import khf_sketch_torch

KHF_SKETCH = Kernel(
    "khf_sketch", "groot_khf_sketch",
    (P, P, P, I, I, I, I),
    source="groot_tpu_torch/csrc/khf_sketch.cu",
    replaces="groot_tpu/ops/pallas_sketch.py:274",
)
# kMaxK: a warp's ring of next_pow2(k + 32) prefixes fits 48 KB. A k-mer
# longer than any window groot indexes; the one shape limit of the kernel
# (any s: more than 64 slots run in groups of at most 64)
MAX_K = 1024


def khf_sketch(
    codes: torch.Tensor, valid_len: torch.Tensor, k: int, s: int
) -> torch.Tensor:
    """KHF MinHash sketches: u8 codes [B, L] (N = 4), int32 valid_len [B]
    -> int64 [B, s] (u64 bits). A CPU tensor takes the plain PyTorch
    version; a CUDA tensor launches the kernel, or raises."""
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise TypeError(f"codes must be uint8 [B, L], got {codes.dtype} {tuple(codes.shape)}")
    if valid_len.dtype != torch.int32 or valid_len.shape != codes.shape[:1]:
        raise TypeError("valid_len must be int32 [B]")
    if valid_len.device != codes.device:
        raise ValueError("codes and valid_len must be on one device")
    if not (s >= 1 and 1 <= k <= MAX_K):
        raise ValueError(f"unsupported sketch shape k={k} s={s}")
    if codes.device.type == "cpu":
        return khf_sketch_torch(codes, valid_len, k, s)
    if codes.device.type != "cuda":
        raise ValueError(f"no kernel for device {codes.device}")
    codes = codes.contiguous()
    valid_len = valid_len.contiguous()
    B, L = codes.shape
    out = torch.empty((B, s), dtype=torch.int64, device=codes.device)
    KHF_SKETCH.launch(
        codes.device, ptr(codes), ptr(valid_len), ptr(out), B, L, k, s
    )
    return out


def sketch_reads_u64(codes, valid_len, k: int, s: int, device) -> np.ndarray:
    """Host batch -> sketches on `device` -> u64 [B, s] numpy. The query
    that follows must run with prescreened=False: these are full sketches."""
    dev = torch.device(device)
    c = torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(dev)
    v = torch.from_numpy(np.ascontiguousarray(valid_len, np.int32)).to(dev)
    return khf_sketch(c, v, k, s).cpu().numpy().view(np.uint64)
