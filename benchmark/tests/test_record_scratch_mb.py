"""The reader of ``record_scratch_mb`` on the program's counters, on the CPU:
nothing without the counter (a program that lacks it) or in an exact
cell, 0 where every launch kept its records in shared memory, and the
counted megabytes a launch otherwise."""

import types

from benchmark import harness
from gato_tpu_torch.kernels import fused_solve

READ = harness.load_reader("record_scratch_mb").read


def _run(method="pcg"):
    return types.SimpleNamespace(method=method)


def test_nothing_without_the_counter_or_in_an_exact_cell(monkeypatch):
    monkeypatch.setattr(fused_solve, "LAUNCHES", 3)
    monkeypatch.setattr(fused_solve, "SCRATCH_FLOATS", 0)
    assert READ(_run("direct")) is None
    monkeypatch.delattr(fused_solve, "SCRATCH_FLOATS")
    assert READ(_run()) is None


def test_nothing_before_a_launch(monkeypatch):
    monkeypatch.setattr(fused_solve, "LAUNCHES", 0)
    monkeypatch.setattr(fused_solve, "SCRATCH_FLOATS", 0)
    assert READ(_run()) is None


def test_zero_with_the_records_in_shared_memory(monkeypatch):
    monkeypatch.setattr(fused_solve, "LAUNCHES", 7)
    monkeypatch.setattr(fused_solve, "SCRATCH_FLOATS", 0)
    assert READ(_run()) == 0.0


def test_counted_megabytes_a_launch(monkeypatch):
    # IIWA at K = 512: 512 records of 1,519 floats a launch, in global memory.
    floats = 512 * fused_solve.record_floats(14, 7)
    monkeypatch.setattr(fused_solve, "LAUNCHES", 4)
    monkeypatch.setattr(fused_solve, "SCRATCH_FLOATS", 4 * floats)
    assert abs(READ(_run()) - 3.110912) < 1e-9
