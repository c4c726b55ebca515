"""``BENCHMARK.json`` and the files it names, found by name.

* a cell's configuration: ``configs[].file`` (``bench/configs/<config>.json``),
  whose ``reference`` names its plain reference under ``bench/`` (its
  weights' ``layout(model)`` and ``logits(...)``);
* a traffic mix: ``bench/traffic/<traffic>.json``, whose ``kind`` names
  the generator ``bench/traffic/<kind>.py`` (``make(mix, vocab, seed,
  seconds)``);
* a metric: ``bench/metrics/<metric>.py``, whose ``read(run)`` returns the
  number or None when the run has nothing to read;
* a kernel family: ``bench/kernels/<family>.json``: the device kernels (by
  a part of their names) that make it up, and ``count``, the
  ``<file>.py:<function>`` under ``bench/`` that reckons its work.

A later change adds a cell, a configuration, a mix, a metric or a family
by adding files and entries; none of this code changes for it.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent


def load_module(path: Path, name: Optional[str] = None):
    name = name or "bench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """One ``BENCHMARK.json`` and the directory of its data files."""

    def __init__(self, root: Path, bench_dir: Path = BENCH_DIR):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in self.data['workloads']]}")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def reference(self, cfg: dict):
        return load_module(self.dir / cfg["reference"])

    def mix(self, traffic: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{traffic}.json").read_text())

    def generator(self, kind: str) -> Callable:
        return load_module(self.dir / "traffic" / f"{kind}.py", f"traffic.{kind}").make

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def reader(self, metric: str) -> Callable:
        return load_module(self.dir / "metrics" / f"{metric}.py").read

    def families(self) -> Dict[str, dict]:
        return {p.stem: json.loads(p.read_text())
                for p in sorted((self.dir / "kernels").glob("*.json"))}

    def count_fn(self, ref: str) -> Callable:
        file, fn = ref.split(":")
        return getattr(load_module(self.dir / file), fn)
