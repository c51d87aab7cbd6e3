#!/usr/bin/env python3
"""Device time of one match-bits launch at the `host` engine's batch shape.

    python3 match_bits_timing.py [--baseline-csrc DIR] [--items 128,256,...]

On a seeded batch of the shape chip_smoke.py's first batch has
(`synth.match_bits_batch_case`: 509 graphs of 1-6 rows of 300-1,500 bp,
2,048 reads of 150 bp, 1-8 reads a graph) and on a denser one (20 graphs
of 60-120 reads each):
  - for each value of `aligner.ITEMS_PER_BLOCK` in --items, the launch's
    blocks, device ms (torch.profiler) and CUDA-event ms (the wrapper
    included), its bits equal to the default layout's;
  - with --baseline-csrc DIR (an earlier groot_tpu_torch/csrc whose
    `groot_match_bits` has this version's C signature and work table),
    that kernel swapped into this version's wrapper and timed beside this
    one in turns (earlier, this, this, earlier), bits equal.
The read lengths, pairs and row lengths go up with each call's layout, as
the `host` engine's calls send them.
Prints the card's name and power limit first. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from groot_tpu_torch import _build, synth
from groot_tpu_torch.align import aligner

CASES = {
    "main path (509 graphs, 150 bp)": dict(seed=3, n_graphs=509, rows=(1, 6), n_reads=2048,
                                          read_len=(150,), per_graph=(1, 8)),
    "dense (20 graphs, 60-120 reads each)": dict(seed=4, n_graphs=20, rows=(1, 6),
                                                 n_reads=2048, read_len=(150,),
                                                 per_graph=(60, 120)),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline-csrc", metavar="DIR")
    ap.add_argument("--items", default="128,256,512,1024,2048")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("match_bits_timing: no CUDA card")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    kern = aligner.MATCH_BITS
    this_fn = kern._entry()
    earlier_fn = None
    if args.baseline_csrc:
        src = Path(args.baseline_csrc).resolve()
        earlier_fn = getattr(ctypes.CDLL(str(_build.build(src, src / "_build"))), kern.symbol)
        earlier_fn.restype, earlier_fn.argtypes = this_fn.restype, this_fn.argtypes
    default_items = aligner.ITEMS_PER_BLOCK
    for name, case in CASES.items():
        a = synth.match_bits_batch_case(**case)
        rows = torch.from_numpy(a[0]).to(dev)
        # the row and read tables on the card; lengths and pairs on the
        # host, uploaded with the layout as the aligner's calls do
        rest = [torch.from_numpy(a[1]).to(dev), a[2], torch.from_numpy(a[3]).to(dev),
                *a[4:]]
        ls = aligner.staged_bases(a[6], a[3].shape[1], a[4], a[5], a[2])
        limit = aligner.match_limits(str(dev))[0]
        fn = lambda: aligner.match_bits_batch(rows, *rest)  # noqa: E731
        want = fn()[0].view(torch.int32).clone()
        print(f"{name}: {want.numel()} words, {len(a[5])} pairs", flush=True)
        for items in (int(v) for v in args.items.split(",")):
            aligner.ITEMS_PER_BLOCK = items
            try:
                cs._check(torch.equal(fn()[0].view(torch.int32), want),
                          f"items {items}: bits differ")
                blocks = len(aligner.work_table(a[6], 6, ls, items,
                                                aligner.MAX_BLOCK_WORDS, limit)[1])
                print(f"  items {items}: {blocks} blocks, device "
                      f"{cs._device_ms(fn, 'match_bits'):.5f} ms, events "
                      f"{cs._time_ms(fn, dev):.4f} ms", flush=True)
            finally:
                aligner.ITEMS_PER_BLOCK = default_items
        if earlier_fn is None:
            continue
        times = []
        for which in ("earlier", "this", "this", "earlier"):
            kern._fn = earlier_fn if which == "earlier" else this_fn
            try:
                cs._check(torch.equal(fn()[0].view(torch.int32), want),
                          f"the {which} kernel's bits differ")
                times.append(f"{which} device {cs._device_ms(fn, 'match_bits'):.5f} ms "
                             f"events {cs._time_ms(fn, dev):.4f} ms")
            finally:
                kern._fn = this_fn
        print("  " + "; ".join(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
