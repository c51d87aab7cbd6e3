#!/usr/bin/env python3
"""Run one cell of the groot_tpu_torch benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is the result: with --trace 0 the
cell's end-to-end metrics, with --trace 1 its per-layer metrics, the
device, and every number compared with the reference beside its limit
(also the last lines of standard error). Exits non-zero, with no result,
when there is no CUDA card, when the program cannot be imported, and when
the process has loaded jax, jaxlib, flax or groot_tpu.
"""

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def main(argv=None) -> int:
    t_start = min(process_start(), T_IMPORT)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(BENCH))
    from harness.manifest import Manifest

    manifest = Manifest(ROOT)
    cell = manifest.cell(args.workload)
    procs = int(manifest.config(cell["config"])["processors"])
    # the thread count and cores are the configuration's, set before numpy
    # and torch load
    from harness.host import fix_threads

    host = fix_threads(procs)
    cache = BENCH / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    print(host, flush=True)
    print(host, file=sys.stderr, flush=True)

    import torch

    torch.set_num_threads(procs)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"no result: the cell needs {cell['chips']} CUDA card(s), "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    try:
        import groot_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"no result: the program cannot be imported ({e})", file=sys.stderr)
        return 4
    from harness import cell as cellrun
    from harness import judge

    result, numbers, forbidden = cellrun.run(
        manifest, args.workload, args.seed, args.seconds, bool(args.trace), t_start,
        cache=cache)
    if forbidden:
        print(f"no result: the process loaded {', '.join(forbidden)}", file=sys.stderr)
        return 5
    result["checks"] = {k: {"value": numbers[k], "limit": judge.LIMITS[k]}
                        for k in judge.LIMITS}
    print(f"correct: {result['correct']}", file=sys.stderr)
    for line in judge.lines(numbers):
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
