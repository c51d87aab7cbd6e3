"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (its `file`), a traffic mix
(`benchmark/traffic/<name>.json`) and, through `per_layer`, the metric
readers it reports (`benchmark/metrics/<name>.py`). Adding any of them is
adding files; nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class Manifest:
    def __init__(self, root: Path, bench: Path = BENCH):
        self.root = Path(root)
        self.bench = Path(bench)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json").read_text())

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.doc["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        return [m for m in self.doc["per_layer"]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """The module of benchmark/metrics/<metric>.py."""
        path = self.bench / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def problems(doc: dict) -> List[str]:
    """What in a manifest breaks the naming rules (empty when none)."""
    out = []
    names: Dict[str, int] = {}
    for c in doc["configs"]:
        for key in [c["name"], *c["reduced"]]:
            if not NAME.match(key):
                out.append(f"configuration name or reduced key {key!r}")
    for w in doc["workloads"]:
        for key in (w["name"], w["config"], w["traffic"]):
            if not NAME.match(key):
                out.append(f"workload name {key!r}")
    for m in doc["end_to_end"] + doc["per_layer"]:
        if not NAME.match(m["name"]):
            out.append(f"metric name {m['name']!r}")
        if not UNIT.match(m["unit"]):
            out.append(f"unit {m['unit']!r}")
        names[m["name"]] = names.get(m["name"], 0) + 1
    out += [f"metric {n!r} named twice" for n, k in names.items() if k > 1]
    return out
