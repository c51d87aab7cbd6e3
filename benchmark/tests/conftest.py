"""Shared fixtures of the benchmark's tests: a checkout in a temporary
directory that holds a copy of benchmark/, the program by link, and a
BENCHMARK.json whose one cell is small enough for the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CELL = "tiny_w150.dense"


def tiny_checkout(dst: Path) -> Path:
    """dst/ with benchmark/ copied, the program linked and one tiny cell."""
    shutil.copytree(BENCH, dst / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    for name in ("groot_tpu_torch", "native"):
        (dst / name).symlink_to(ROOT / name)
    cfg = json.loads((BENCH / "configs" / "argannot90_w150_s20.json").read_text())
    cfg.update(name="tiny_w150", clusters=12, processors=2)
    (dst / "benchmark" / "configs" / "tiny_w150.json").write_text(json.dumps(cfg))
    mix = {"reads": 3000, "arg_reads": 3000, "length": 150, "rc_share": 0.5,
           "sub_share": 0.25, "sub_rate": 0.005, "n_share": 0.01}
    (dst / "benchmark" / "traffic" / "tiny.json").write_text(json.dumps(mix))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["configs"] = [{"name": "tiny_w150", "source": "https://example.org/tiny",
                       "file": "benchmark/configs/tiny_w150.json", "reduced": ["clusters"],
                       "why": "a CPU-sized database"}]
    doc["workloads"] = [{"name": TINY_CELL, "config": "tiny_w150", "traffic": "tiny",
                         "chips": 1, "why": "a CPU-sized cell"}]
    for m in doc["per_layer"]:
        m["workloads"] = [TINY_CELL]
    (dst / "BENCHMARK.json").write_text(json.dumps(doc))
    return dst


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(manifest, cache dir) of the tiny checkout; the index is built on the
    first run and kept for the session."""
    from harness.manifest import Manifest

    root = tiny_checkout(tmp_path_factory.mktemp("checkout"))
    return Manifest(root, root / "benchmark"), root / "benchmark" / ".cache"
