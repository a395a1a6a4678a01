"""Cells, configurations, traffic mixes and metric readers are found by
name, and new ones are picked up from new files alone."""

import dataclasses
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


# A new entry point as a later change would add it: the program's
# single-problem ``solve``, its result given the batch axis back.
TOY_ENTRY = """
import torch

from benchmark.harness import Result


def program(cell, device):
    import gato_tpu_torch as gt

    cfg, sv = cell.config, cell.config["solver"]
    spec = gt.ProblemSpec(cfg["state_size"], cfg["control_size"], cfg["knot_points"])
    options = gt.SolverOptions(rho=sv["rho"], exit_tol=sv["exit_tol"],
                               max_iters=sv["max_iters"], method=cell.traffic["method"])

    def prepare(fields):
        return gt.KKTBlocks(*(f[0] for f in fields))

    def solve(blocks):
        return gt.solve(spec, blocks, options, device=device)

    return prepare, solve


def to_result(out):
    return Result(*(torch.as_tensor(t)[None] for t in out))
"""


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
    # A cell on a new entry point: an entry file and a traffic file naming it.
    (base / "entries" / "one_solve.py").write_text(TOY_ENTRY)
    traffic.update(batch=1, entry="one_solve", pool_mb=0, warmup_s=0.05, sample_calls=2,
                   profile_calls=2)
    (base / "traffic" / "one.pcg.json").write_text(json.dumps(traffic))
    (base / "cells" / "toy_k20.one.pcg.json").write_text(
        (base / "cells" / "iiwa14_k50.b1.pcg.json").read_text())
    b["workloads"].append({"name": "toy_k20.one.pcg", "config": "toy_k20",
                           "traffic": "one.pcg", "chips": 1, "why": "test"})
    iters = next(m for m in b["per_layer"] if m["name"] == "pcg_iters_mean")
    iters["workloads"].append("toy_k20.one.pcg")
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
    # The new entry drives a whole run, correct against the reference.
    cell = harness.load_cell("toy_k20.one.pcg", bench_json, base)
    entry = harness.entry_of(cell, base)
    assert entry.program is not harness.program and callable(entry.to_result)
    result = harness.measure(cell, 2**31 + 77, 0.1, True, solver=entry.program,
                             to_result=entry.to_result, device="cpu")
    assert result["correct"] is True and result["attempted"] >= 1, result["checks"]
    assert result["metrics"]["pcg_iters_mean"]["value"] > 0
    for path, data in before.items():
        assert path.read_bytes() == data, f"{path} was edited"


@pytest.mark.parametrize("traffic", sorted(p.stem for p in (harness.BENCH / "traffic").glob("*.json")))
def test_a_cell_drives_the_entry_its_traffic_names(traffic):
    cell = harness.load_cell("iiwa14_k50.b1.pcg")
    cell = dataclasses.replace(
        cell, traffic=json.loads((harness.BENCH / "traffic" / f"{traffic}.json").read_text()))
    entry = harness.entry_of(cell)
    if "entry" not in cell.traffic:
        # Without one: solve_batched through harness.program itself.
        assert entry == harness.Entry(harness.program, None)
    else:
        path = harness.BENCH / "entries" / f"{cell.traffic['entry']}.py"
        assert entry.program.__code__.co_filename == str(path)
        assert callable(entry.to_result)


def test_an_unknown_workload_is_refused():
    with pytest.raises(KeyError, match="no workload"):
        harness.load_cell("no_such_cell")
