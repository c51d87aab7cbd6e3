#!/usr/bin/env python3
"""The control of `correct` at a cell's own size: for each seed, one pass of
the program and the plain reference put in its place with its node weights
kept in float32, the precision below the float64 the configuration states.
Each is judged against the float64 reference as a run is; the control has
to come out not correct on every seed.

    python3 benchmark/control.py --workload <cell> --seed <n> [--seed <n> ...]

Prints, a line a seed, the numbers compared for the program and for the
control. The benchmark's own runs do not run it.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(ROOT))
    from harness.manifest import Manifest

    manifest = Manifest(ROOT)
    cell = manifest.cell(args.workload)
    cfg = manifest.config(cell["config"])
    from harness.host import fix_threads

    print(fix_threads(int(cfg["processors"])), file=sys.stderr, flush=True)
    import numpy as np
    import torch

    from harness import cell as cellrun
    from harness import data, judge, reference

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    traffic = manifest.traffic(cell["traffic"])
    cache = BENCH / ".cache"
    clusters = data.database(cfg)
    idx, prog, _load_s = cellrun.load_program(manifest, cell["config"], cfg, clusters, cache,
                                              "cuda")
    ix = reference.Index(str(idx))
    tmp = cellrun.tmp_dir(cache)
    ok = True
    for seed in args.seed:
        reads, names, _o = data.sample(traffic, clusters, seed, int(cfg["db_seed"]))
        fq = os.path.join(tmp, f"control-{os.getpid()}.fq")
        data.write_fastq(reads, names, fq)
        prog.restore()
        out = prog.one_pass(fq)
        os.unlink(fq)
        t0 = time.perf_counter()
        faults = reference.check_index(ix, clusters, cfg)
        ref = reference.align(ix, reads, names, float(cfg["t"]), float(cfg["c"]),
                              float(cfg["cov_cutoff"]))
        t_ref = time.perf_counter() - t0
        ctl = reference.align(ix, reads, names, float(cfg["t"]), float(cfg["c"]),
                              float(cfg["cov_cutoff"]), weight_dtype=np.float32)
        prog_numbers = judge.compare_pass(out, [judge.digest(out)], [out.weights], ref,
                                          faults, ix.refs)
        ctl_numbers = judge.compare(ctl.stats, ix.refs, ctl.records, ctl.kept, ctl.rows,
                                    ["control"], [ctl.weights], ref, faults, ix.refs)
        ok &= judge.verdict(prog_numbers) and not judge.verdict(ctl_numbers)
        print(json.dumps({"seed": seed, "reference_s": round(t_ref, 3),
                          "program": prog_numbers, "control": ctl_numbers,
                          "program_correct": judge.verdict(prog_numbers),
                          "control_correct": judge.verdict(ctl_numbers)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
