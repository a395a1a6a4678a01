"""Cells, configurations, traffic mixes and metric readers are found by
name, and new ones are picked up from new files alone."""

import json
import re
import shutil

import pytest

from benchmark import harness

BENCH_JSON = harness.ROOT / "BENCHMARK.json"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def spec():
    with open(BENCH_JSON) as f:
        return json.load(f)


@pytest.mark.parametrize("workload", [w["name"] for w in spec()["workloads"]])
def test_every_cell_loads_with_its_files(workload):
    cell = harness.load_cell(workload)
    assert cell.config["state_size"] > 0 and cell.traffic["batch"] > 0
    pcg = {"iters_short"} if cell.traffic["method"] == "pcg" else set()
    assert set(cell.limits) == {"lam_err", "dz_err", "unconverged"} | pcg
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    harness.load_reference(cell.config["reference"])


def test_every_metric_has_a_reader():
    for entry in spec()["end_to_end"] + spec()["per_layer"]:
        assert callable(harness.load_reader(entry["name"]).read)


def test_names_units_and_keys_keep_the_contract():
    b = spec()
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in b[k]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for e in b["end_to_end"] + b["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", e["unit"])
        assert e["better"] in ("lower", "higher")
    for c in b["configs"]:
        with open(harness.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert len(c["source"]) <= 200


def copy_tree(tmp_path):
    base = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH, base, ignore=shutil.ignore_patterns("__pycache__"))
    b = spec()
    return base, b


def test_new_files_and_entries_add_a_cell_without_editing_a_file(tmp_path):
    base, b = copy_tree(tmp_path)
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    cfg = json.loads((base / "configs" / "iiwa14_k50.json").read_text())
    cfg.update(name="toy_k20", knot_points=20)
    (base / "configs" / "toy_k20.json").write_text(json.dumps(cfg))
    traffic = json.loads((base / "traffic" / "b1.pcg.json").read_text())
    traffic.update(batch=3)
    (base / "traffic" / "b3.pcg.json").write_text(json.dumps(traffic))
    (base / "cells" / "toy_k20.b3.pcg.json").write_text(
        json.dumps({"limits": {"lam_err": 1.0, "dz_err": 1.0, "unconverged": 0,
                               "iters_short": 1.0}}))
    (base / "metrics" / "calls_seen.py").write_text(
        "def read(run):\n    return float(run.calls)\n")
    b["workloads"].append({"name": "toy_k20.b3.pcg", "config": "toy_k20",
                           "traffic": "b3.pcg", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "calls_seen", "unit": "calls", "better": "higher",
                           "source": "host_clock", "layer": "dispatch",
                           "moves": "solves_per_s", "workloads": ["toy_k20.b3.pcg"]})
    bench_json = tmp_path / "BENCHMARK.json"
    bench_json.write_text(json.dumps(b))

    cell = harness.load_cell("toy_k20.b3.pcg", bench_json, base)
    assert cell.config["knot_points"] == 20 and cell.traffic["batch"] == 3
    assert "calls_seen" in [m["name"] for m in cell.per_layer]
    assert harness.load_reader("calls_seen", base).read(
        harness.Run(cell, (20, 14, 7), 3, "pcg", 1.0, 1.0, [0.1] * 7, [0.01] * 7)) == 7.0
    # The metric lists only the new cell: the old cells do not report it.
    old = harness.load_cell("iiwa14_k50.b1.pcg", bench_json, base)
    assert "calls_seen" not in [m["name"] for m in old.per_layer]
    for path, data in before.items():
        assert path.read_bytes() == data, f"{path} was edited"


def test_an_unknown_workload_is_refused():
    with pytest.raises(KeyError, match="no workload"):
        harness.load_cell("no_such_cell")
