"""Data-driven: a new configuration, traffic mix, metric or kernel family
dropped into a copy of the benchmark is found by its name, with no code
changed; BENCHMARK.json keeps to the contract's shape."""
import json
import re
import shutil

import tiny_cell
from benchkit.spec import Bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _copy(tmp):
    shutil.copytree(tiny_cell.BENCH, tmp / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(tiny_cell.REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return tmp


def test_new_files_are_found_by_name(tmp_path):
    root = _copy(tmp_path)
    b = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "bench/configs/quasar-paper-7b.json").read_text())
    (root / "bench/configs/new-model.json").write_text(json.dumps(dict(cfg, name="new-model")))
    (root / "bench/traffic/new-mix.json").write_text(
        json.dumps(dict(json.loads((root / "bench/traffic/backlog-1k.json").read_text()),
                        depth=7)))
    (root / "bench/metrics/new_metric.py").write_text(
        "def read(run):\n    return 41.0 + run.seconds\n")
    (root / "bench/kernels/new_family.json").write_text(
        json.dumps({"kernels": ["my_kernel"], "count": "benchkit/families.py:paged_attn"}))
    b["configs"].append({"name": "new-model", "source": "s", "file": "bench/configs/new-model.json",
                         "reduced": [], "why": "w"})
    b["workloads"].append({"name": "new-cell", "config": "new-model", "traffic": "new-mix",
                           "chips": 1, "why": "w"})
    b["per_layer"].append({"name": "new_metric", "unit": "x", "better": "higher",
                           "source": "host_clock", "layer": "l", "moves": "tok_s",
                           "workloads": ["new-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    bench = Bench(root, root / "bench")
    wl = bench.workload("new-cell")
    assert bench.config(wl["config"])["name"] == "new-model"
    assert bench.mix(wl["traffic"])["depth"] == 7
    traffic = bench.generator(bench.mix(wl["traffic"])["kind"])(bench.mix(wl["traffic"]),
                                                                1000, 1, 1.0)
    assert traffic.depth == 7 and len(traffic.requests[1000].prompt) == 1024
    assert [m["name"] for m in bench.per_layer("new-cell")] == ["new_metric"]
    assert bench.reader("new_metric")(type("R", (), {"seconds": 1.0})()) == 42.0
    fam = bench.families()["new_family"]
    assert fam["kernels"] == ["my_kernel"] and callable(bench.count_fn(fam["count"]))
    # the cells already there keep their metrics
    assert "new_metric" not in [m["name"] for m in bench.per_layer("paper7b-backlog-1k")]


def test_every_named_file_exists():
    bench = Bench(tiny_cell.REPO)
    for w in bench.data["workloads"]:
        bench.config(w["config"])
        mix = bench.mix(w["traffic"])
        assert (bench.dir / "traffic" / f"{mix['kind']}.py").exists()
        for m in bench.end_to_end(w["name"]) + bench.per_layer(w["name"]):
            assert callable(bench.reader(m["name"]))
        assert bench.end_to_end(w["name"]) and bench.per_layer(w["name"])
        assert "setup_s" in [m["name"] for m in bench.end_to_end(w["name"])]
    for fam in bench.families().values():
        assert callable(bench.count_fn(fam["count"]))


def test_benchmark_json_shape():
    b = json.loads((tiny_cell.REPO / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in b["end_to_end"]}
    layers = {}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {"name", "unit", "better", "source", "layer",
                                                "moves", "workloads"}
        layers.setdefault(m["layer"], set())
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for c in b["configs"]:
        assert (tiny_cell.REPO / c["file"]).exists() and len(c["why"]) <= 200
        assert c["file"].startswith("bench/")
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert 1 <= b["run_seconds"] <= 51 and b["paths"] == ["bench"]
