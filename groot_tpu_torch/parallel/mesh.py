"""Devices of the data axis, and batch padding for it.

Counterpart of groot_tpu/parallel/mesh.py. There is no Mesh object: the
data axis is a list of torch devices (one process) or a torch.distributed
process group (N processes, see parallel.device_index). The index is
replicated on each device, read batches are split over the axis, and the
per-graph tallies are summed."""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


def data_devices(n: Optional[int] = None, device="cuda") -> List[torch.device]:
    """The devices of the data axis: every visible card (the first n) for
    "cuda"; n shards of the one host device (default 1) for "cpu". Raises
    when fewer than n cards are present."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * (1 if n is None else n)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n is None:
        n = have
    if n < 1 or have < n:
        raise ValueError(f"requested {n} devices but only {have} present")
    return [torch.device("cuda", i) for i in range(n)]


def pad_batch_for_mesh(codes: np.ndarray, lengths: np.ndarray, n_shards: int):
    """Pad the batch dim to a multiple of n_shards (padding reads have code
    4, length 0 and map nowhere). Returns (codes, lengths, original B)."""
    B = codes.shape[0]
    Bp = -(-B // n_shards) * n_shards
    if Bp != B:
        codes = np.concatenate(
            [codes, np.full((Bp - B, codes.shape[1]), 4, dtype=codes.dtype)]
        )
        lengths = np.concatenate(
            [lengths, np.zeros(Bp - B, dtype=lengths.dtype)]
        )
    return codes, lengths, B
