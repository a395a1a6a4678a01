"""The cell on gato-python's own call, ``linsys_solve`` from CSR
(``traffic/csr.pcg.json``, ``cells/iiwa14_k50.csr.json``; held out of
``BENCHMARK.json`` for now, so built here from its files): the
benchmark's CSR encoder against the program's packing, the answer read
back against the reference, and a run with the timed path broken
underneath, or the control in its place, coming out not correct."""

import ast
import dataclasses
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import generator, harness
from benchmark.reference import kkt

WORKLOAD = "iiwa14_k50.csr"
ENTRY = harness.BENCH / "entries" / "linsys_solve.py"
entry = harness._load_module(ENTRY, "benchmark_entry_linsys_solve")
SEED = 2**31 + 8642
EARLY_STOP = 20.0


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("shape", [(50, 14, 7), (5, 2, 1)], ids=["iiwa14", "pendulum"])
def test_the_encoder_round_trips_through_the_programs_packing(shape, native, monkeypatch):
    from gato_tpu_torch import api, formats

    monkeypatch.setattr(formats, "USE_NATIVE", native)
    K, s, c = shape
    fields = generator.make_problems(3, K, s, c, 21, "cpu")
    G_indptr, G_indices, C_indptr, C_indices = entry.structure(K, s, c)
    G, C, g, cc = entry.values(*(f.numpy() for f in fields))
    assert G_indptr.dtype == G_indices.dtype == np.int32 and G.dtype == np.float64
    spec = api.infer_spec(C_indptr, g[0], cc[0])
    assert (spec.knot_points, spec.state_size, spec.control_size) == shape
    for i in range(3):
        blocks = formats.pack_kkt(spec, G_indptr, G_indices, G[i],
                                  C_indptr, C_indices, C[i], g[i], cc[i])
        for name, got, want in zip(formats.KKTBlocks._fields, blocks, fields):
            np.testing.assert_array_equal(got, want[i].numpy(), err_msg=name)


@pytest.mark.parametrize("shape", [(50, 14, 7), (5, 2, 1)], ids=["iiwa14", "pendulum"])
def test_the_encoder_writes_the_layout_the_programs_test_helper_writes(shape):
    """The same arrays as ``gato_tpu_torch.testing.blocks_to_csr``, written
    independently: a loop over rows there, whole-array passes here."""
    from gato_tpu_torch import KKTBlocks, ProblemSpec, testing

    K, s, c = shape
    fields = generator.make_problems(1, K, s, c, 22, "cpu")
    theirs = testing.blocks_to_csr(ProblemSpec(s, c, K),
                                   KKTBlocks(*(f[0].numpy() for f in fields)))
    G_indptr, G_indices, C_indptr, C_indices = entry.structure(K, s, c)
    G, C, g, cc = entry.values(*(f.numpy() for f in fields))
    for ours, name in ((G_indptr, "G_row"), (G_indices, "G_col"), (G[0], "G_val"),
                       (C_indptr, "C_row"), (C_indices, "C_col"), (C[0], "C_val"),
                       (g[0], "g"), (cc[0], "c")):
        np.testing.assert_array_equal(ours, np.asarray(getattr(theirs, name)), err_msg=name)


def test_the_entry_takes_nothing_of_the_program_but_its_call():
    tree = ast.parse(ENTRY.read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in top if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names if n.split(".")[0].startswith("gato")]
    assert "blocks_to_csr" not in ENTRY.read_text()


def csr_cell():
    """The cell as ``BENCHMARK.json`` would name it: configuration
    ``iiwa14_k50``, traffic ``csr.pcg``, one chip."""
    with open(harness.ROOT / "BENCHMARK.json") as f:
        spec = json.load(f)
    spec["workloads"].append({"name": WORKLOAD, "config": "iiwa14_k50", "traffic": "csr.pcg",
                              "chips": 1, "why": "test"})
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "BENCHMARK.json"
        path.write_text(json.dumps(spec))
        return harness.load_cell(WORKLOAD, path)


def small(knot_points=None):
    cell = csr_cell()
    traffic = dict(cell.traffic, pool_mb=0, warmup_s=0.05, sample_calls=2)
    config = cell.config if knot_points is None else dict(cell.config, knot_points=knot_points)
    return dataclasses.replace(cell, traffic=traffic, config=config)


def test_to_result_matches_the_reference_and_reads_the_iterations(capsys):
    """One call on the CPU at K = 12: the lists read back into (lam, dz_x,
    dz_u) agree with the float64 reference to float32 PCG's accuracy at
    exit_tol 1e-6 (the K = 50 cell's limits, 3e-3 and 1.5e-3, hold with
    room; these read ~1e-4), and ``iters`` is the count the program's
    ``solve`` returns on the same blocks."""
    import gato_tpu_torch as gt

    cell = small(knot_points=12)
    prepare, solve = entry.program(cell, torch.device("cpu"))
    fields = generator.make_problems(1, 12, 14, 7, SEED, "cpu")
    out = solve(prepare(fields))
    assert capsys.readouterr().out == ""
    assert "first run PCG terminated in" in out.printed
    res = entry.to_result(out)
    assert res.lam.shape == (1, 12, 14) and res.dz_x.shape == (1, 12, 14)
    assert res.dz_u.shape == (1, 11, 7) and bool(res.converged[0])
    sv = cell.config["solver"]
    ref = kkt.solve(fields, sv["rho"])
    err = lambda got, want: float((got.double() - want).abs().max() / want.abs().max())
    assert err(res.lam, ref.lam) < 1e-3
    assert err(res.dz_x, ref.dz_x) < 1e-3 and err(res.dz_u, ref.dz_u) < 1e-3
    spec = gt.ProblemSpec(14, 7, 12)
    options = gt.SolverOptions(rho=sv["rho"], exit_tol=sv["exit_tol"], max_iters=sv["max_iters"])
    direct = gt.solve(spec, gt.KKTBlocks(*(f[0] for f in fields)), options, device="cpu")
    assert int(res.iters[0]) == int(direct.iters) > 0
    capped = entry.to_result(out._replace(printed=out.printed.replace(
        f"in {int(direct.iters)} iterations", f"in {sv['max_iters']} iterations")))
    assert not bool(capped.converged[0])
    with pytest.raises(ValueError, match="no iteration count"):
        entry.to_result(out._replace(printed=""))


def test_the_entry_refuses_what_the_call_cannot_state():
    cell = small()
    with pytest.raises(ValueError, match="one KKT system a call"):
        entry.program(dataclasses.replace(cell, traffic=dict(cell.traffic, batch=2)), "cpu")
    solver = dict(cell.config["solver"], precond_poly_degree=2)
    with pytest.raises(ValueError, match="linsys_solve runs"):
        entry.program(dataclasses.replace(cell, config=dict(cell.config, solver=solver)),
                      torch.device("cpu"))


def altered(fault):
    """The entry with ``fault`` applied where each call's answer is made."""
    def solver(cell, device):
        prepare, solve = entry.program(cell, device)
        return prepare, lambda args: fault(solve(args))
    return solver


def lam_off(out):
    lam = list(out.lam)
    lam[0] += 0.01 * max(map(abs, lam))
    return out._replace(lam=lam)


def dz_off(out):
    dz = list(out.dz)
    dz[-1] += 0.01 * max(map(abs, dz))
    return out._replace(dz=dz)


def count_capped(out):
    return out._replace(printed=entry.ITERS.sub(
        f"first run PCG terminated in {out.max_iters} iterations", out.printed))


def stopped_early(cell, device):
    """The entry with its exit tolerance loosened EARLY_STOP times."""
    solver = dict(cell.config["solver"])
    solver["exit_tol"] *= EARLY_STOP
    return entry.program(dataclasses.replace(cell, config=dict(cell.config, solver=solver)),
                         device)


FAULTS = {"lam": altered(lam_off), "dz": altered(dz_off), "count": altered(count_capped),
          "early_stop": stopped_early}


def run(cell, solver, device, seconds, to_result=entry.to_result):
    return harness.measure(cell, SEED, seconds, False, solver=solver, to_result=to_result,
                           device=device)


def test_on_the_cpu_the_entry_is_correct_and_each_fault_is_not():
    cell = small()
    result = harness.measure(cell, SEED, 0.2, False, device="cpu")
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"
    for name, solver in FAULTS.items():
        broken = run(cell, solver, "cpu", 0.2)
        assert broken["correct"] is False, (name, broken["checks"])
        assert broken["failed"] >= 1, name
    control = run(cell, harness.control, "cpu", 0.2, to_result=None)
    assert control["correct"] is False, control["checks"]


@pytest.mark.cuda
def test_on_the_card_the_entry_faults_and_control(card):
    from gato_tpu_torch import native

    cell = csr_cell()
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, warmup_s=0.2))
    calls = native.CALLS
    result = harness.measure(cell, SEED, 1.0, False, device=card)
    assert result["correct"] is True, result["checks"]
    # The native packer ran, two calls (G, C) a solve: not the NumPy path.
    assert native.CALLS - calls >= 2 * result["attempted"]
    for name, solver in FAULTS.items():
        assert run(cell, solver, card, 1.0)["correct"] is False, name
    assert run(cell, harness.control, card, 1.0, to_result=None)["correct"] is False
    torch.cuda.empty_cache()
