"""A run with the timed path broken underneath comes out not correct; the
control (the reference at TF32 in the program's place) too.  The CPU cases
drive the program's plain PyTorch path at a small batch; the ``cuda``
cases drive the kernels at the cell's own batch on the card."""

import dataclasses

import pytest
import torch

from benchmark import harness

CELLS = ["iiwa14_k50.b1.pcg", "iiwa14_k512.b1.pcg",
         "iiwa14_k50.b1.direct", "iiwa14_k512.b1.direct"]
PCG_CELLS = [c for c in CELLS if c.endswith(".pcg")]
# The early stop planted in the PCG cells: the exit tolerance loosened so.
EARLY_STOP = 20.0
SEED = 2**31 + 4321


def small(workload):
    cell = harness.load_cell(workload)
    traffic = dict(cell.traffic, batch=2, pool_mb=0, warmup_s=0.05, sample_calls=2)
    return dataclasses.replace(cell, traffic=traffic)


def altered(fault):
    """The program with ``fault`` applied to each call's result."""
    def solver(cell, device):
        prepare, solve = harness.program(cell, device)
        return prepare, lambda blocks: fault(solve(blocks))
    return solver


def stopped_early(cell, device):
    """The program with its exit tolerance loosened EARLY_STOP times: it
    still reports every problem converged."""
    solver = dict(cell.config["solver"])
    solver["exit_tol"] *= EARLY_STOP
    loose = dataclasses.replace(cell, config=dict(cell.config, solver=solver))
    return harness.program(loose, device)


def one_answer_off(res):
    lam = res.lam.clone()
    lam[0, 0, 0] += 0.01 * lam[0].abs().max()
    return res._replace(lam=lam)


def one_step_off(res):
    dz_u = res.dz_u.clone()
    dz_u[-1, -1, -1] += 0.01 * dz_u[-1].abs().max()
    return res._replace(dz_u=dz_u)


def flagged_unconverged(res):
    conv = res.converged.clone()
    conv[0] = False
    return res._replace(converged=conv)


FAULTS = {"answer": one_answer_off, "step": one_step_off, "flag": flagged_unconverged}


def run(cell, solver, device, seconds):
    return harness.measure(cell, SEED, seconds, False, solver=solver, device=device)


@pytest.mark.parametrize("workload", CELLS)
def test_the_program_is_correct_and_each_fault_is_not(workload):
    cell = small(workload)
    result = run(cell, harness.program, "cpu", 0.2)
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"
    for name, fault in FAULTS.items():
        broken = run(cell, altered(fault), "cpu", 0.2)
        assert broken["correct"] is False, (name, broken["checks"])
        assert broken["failed"] >= 1


@pytest.mark.parametrize("workload", PCG_CELLS)
def test_a_pcg_that_stops_early_is_not_correct(workload):
    cell = small(workload)
    result = run(cell, stopped_early, "cpu", 0.2)
    assert result["correct"] is False, result["checks"]
    check = result["checks"]["iters_short"]
    assert check["value"] > check["limit"] and result["failed"] >= 1


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    result = run(small(workload), harness.control, "cpu", 0.2)
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["lam_err"]["value"] > result["checks"]["lam_err"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_on_the_card_program_faults_and_control(workload, card):
    cell = harness.load_cell(workload)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, warmup_s=0.2))
    assert run(cell, harness.program, card, 1.0)["correct"] is True
    for name, fault in FAULTS.items():
        assert run(cell, altered(fault), card, 1.0)["correct"] is False, name
    if workload in PCG_CELLS:
        assert run(cell, stopped_early, card, 1.0)["correct"] is False
    assert run(cell, harness.control, card, 1.0)["correct"] is False
    torch.cuda.empty_cache()
