"""BENCHMARK.json against the contract's form, and the benchmark grown by
new files alone: a configuration, a traffic mix and a metric."""

import hashlib
import json
import shutil

from conftest import BENCH, ROOT
from harness import manifest as mf

DOC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_and_units():
    assert mf.problems(DOC) == []


def test_form():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert DOC["paths"] == ["benchmark"] and DOC["command"][1] == "benchmark/run.py"
    assert 1 <= DOC["run_seconds"] <= 51
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/")
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in DOC["end_to_end"]}
    assert "setup_s" in e2e
    for m in DOC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in DOC["per_layer"]:
        assert m["moves"] in e2e


def test_every_named_file_is_there():
    man = mf.Manifest(ROOT)
    for w in DOC["workloads"]:
        man.config(w["config"])
        man.traffic(w["traffic"])
        for m in man.per_layer(w["name"]) + man.end_to_end(w["name"]):
            mod = man.reader(m["name"])
            assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
            if "layer" in m:
                assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_grows_by_new_files(tmp_path):
    """A new configuration, traffic mix and metric, each a file of its own,
    and the entries that name them: found with no file edited but
    BENCHMARK.json."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(bench)
    cfg = json.loads((bench / "configs" / "argannot90_w150_s20.json").read_text())
    cfg.update(name="argannot90_w150_s128", s=128)
    (bench / "configs" / "argannot90_w150_s128.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "dense_errors.json").write_text(json.dumps(
        {"reads": 1000, "arg_reads": 1000, "length": 150, "rc_share": 0.5,
         "sub_share": 1.0, "sub_rate": 0.02, "n_share": 0.01}))
    (bench / "metrics" / "passes_per_run.py").write_text(
        'UNIT, SOURCE, LAYER, MOVES = "passes", "program_counter", "host process", '
        '"reads_per_s"\n\n\ndef read(ctx):\n    return len(ctx["passes"])\n')
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "argannot90_w150_s128", "source": "https://example.org",
                           "file": "benchmark/configs/argannot90_w150_s128.json",
                           "reduced": ["database"], "why": "s = 128"})
    doc["workloads"].append({"name": "argannot90_w150_s128.dense_errors",
                             "config": "argannot90_w150_s128", "traffic": "dense_errors",
                             "chips": 1, "why": "errors"})
    doc["per_layer"].append({"name": "passes_per_run", "unit": "passes", "better": "higher",
                             "source": "program_counter", "layer": "host process",
                             "moves": "reads_per_s",
                             "workloads": ["argannot90_w150_s128.dense_errors"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    man = mf.Manifest(tmp_path, bench)
    cell = man.cell("argannot90_w150_s128.dense_errors")
    assert man.config(cell["config"])["s"] == 128
    assert man.traffic(cell["traffic"])["sub_rate"] == 0.02
    every_cell = [m["name"] for m in doc["per_layer"] if "workloads" not in m]
    assert every_cell  # metrics without `workloads` are read in a new cell too
    assert [m["name"] for m in man.per_layer(cell["name"])] == every_cell + ["passes_per_run"]
    assert man.reader("passes_per_run").read({"passes": [1, 2, 3]}) == 3
    after = _digests(bench)
    assert all(after[p] == d for p, d in before.items())
    assert mf.problems(doc) == []


def test_fix_threads_pins_the_process():
    """The configuration's thread count sets the pools and pins the process
    (in a child, so the test run keeps its cores)."""
    import subprocess
    import sys

    code = ("import os, sys; sys.path.insert(0, sys.argv[1]); "
            "from harness.host import fix_threads; line = fix_threads(1); "
            "print(len(os.sched_getaffinity(0)), os.environ['OMP_NUM_THREADS'], line)")
    out = subprocess.run([sys.executable, "-c", code, str(BENCH)], capture_output=True,
                         text=True, check=True).stdout.split()
    assert out[:2] == ["1", "1"]
    assert "pinned" in out
