"""gato_tpu_torch.debug against gato_tpu.debug (the port of
tests/test_debug.py): residual histories, debug solves, the profiler span.

Tolerances: in float64 (gato_tpu under x64) equal iteration counts, and the
eta history, lambda, dz and the true residual within 1e-9 relative (of each
array's scale); in float32 the iteration counts equal (or one apart where
eta lands within 1e-3 of exit_tol, a float32 round-off tie) and
lambda within 1e-4 of scale: the eta traces of two float32 orderings part
after some 40 iterations, so they are not compared there.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import gato_tpu
from gato_tpu import debug as jd

import gato_tpu_torch as gt
from gato_tpu_torch import assemble, debug, pcg, spans
from gato_tpu_torch.testing import dense_oracle, random_batch, random_blocks

torch.set_num_threads(1)

CASES = [((4, 2, 16), 3, 1e-10, 300, 0.01), ((3, 2, 12), 11, 1e-10, 200, 0.01),
         ((6, 3, 10), 21, 1e-12, 400, 0.02)]


def _rel(ours, ref, tol):
    ours = ours.detach().double().numpy()
    ref = np.asarray(ref, dtype=np.float64)
    scale = max(float(np.abs(ref).max()), 1e-300)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("case, poly", [(CASES[0], 1), (CASES[2], 2)])
def test_solve_debug_matches_gato_tpu_float64(case, poly):
    sizes, seed, tol, mi, rho = case
    spec = gt.ProblemSpec(*sizes)
    blocks = random_blocks(spec, seed=seed)
    kw = dict(exit_tol=tol, max_iters=mi, rho=rho, precond_poly_degree=poly,
              dtype="float64")
    ours = debug.solve_debug(spec, blocks, gt.SolverOptions(**kw), device="cpu")
    with jax.enable_x64(True):
        ref = jd.solve_debug(gato_tpu.ProblemSpec(*sizes), gato_tpu.KKTBlocks(*blocks),
                             gato_tpu.SolverOptions(**kw))
        assert ours.eta_history.dtype == torch.float64
        assert int(ours.result.iters) == int(ref.result.iters)
        assert bool(ours.result.converged) == bool(ref.result.converged)
        _rel(ours.eta_history, ref.eta_history, 1e-9)
        for name in ("lam", "dz_x", "dz_u"):
            _rel(getattr(ours.result, name), getattr(ref.result, name), 1e-9)
        np.testing.assert_allclose(float(ours.final_residual_norm),
                                   float(ref.final_residual_norm), rtol=1e-6,
                                   atol=1e-12 * float(np.abs(ref.system.gamma).max()))
        _rel(ours.system.S, ref.system.S, 1e-12)


@pytest.mark.parametrize("sizes, seed, tol, mi, rho", CASES[1:2])
def test_solve_debug_matches_gato_tpu_float32(sizes, seed, tol, mi, rho):
    spec = gt.ProblemSpec(*sizes)
    blocks = random_blocks(spec, seed=seed)
    kw = dict(exit_tol=max(tol, 1e-8), max_iters=mi, rho=rho)
    ours = debug.solve_debug(spec, blocks, gt.SolverOptions(**kw), device="cpu")
    ref = jd.solve_debug(gato_tpu.ProblemSpec(*sizes), gato_tpu.KKTBlocks(*blocks),
                         gato_tpu.SolverOptions(**kw))
    it, it_ref = int(ours.result.iters), int(ref.result.iters)
    if it != it_ref:
        first = min(it, it_ref)
        eta = float(np.asarray(ref.eta_history)[first + 1])
        assert abs(it - it_ref) == 1 and abs(eta - kw["exit_tol"]) <= 1e-3 * kw["exit_tol"]
    _rel(ours.result.lam, ref.result.lam, 1e-4)


def test_debug_matches_solve():
    spec = gt.ProblemSpec(4, 2, 16)
    blocks = random_blocks(spec, seed=3)
    opts = gt.SolverOptions(exit_tol=1e-10, max_iters=300, rho=0.01)
    dbg = debug.solve_debug(spec, blocks, opts, device="cpu")
    plain = gt.solve(spec, blocks, opts, pcg_backend="torch", device="cpu")
    assert int(dbg.result.iters) == int(plain.iters)
    np.testing.assert_allclose(dbg.result.lam.numpy(), plain.lam.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("prec", ["symmetric_stair", "block_jacobi"])
def test_poly_degree_2_iterations_match_pcg(prec):
    spec = gt.ProblemSpec(5, 2, 14)
    blocks = random_blocks(spec, seed=8)
    opts = gt.SolverOptions(exit_tol=1e-9, max_iters=200, rho=0.01,
                            preconditioner=prec, precond_poly_degree=2,
                            dtype="float64")
    dbg = debug.solve_debug(spec, blocks, opts, device="cpu")
    sys_ = assemble.condense(*gt.blocks_to_torch(blocks, "cpu", torch.float64),
                             0.01, gt.Preconditioner(prec))
    res = pcg.pcg(sys_.S, sys_.Pinv, sys_.gamma, exit_tol=1e-9, max_iters=200,
                  poly_degree=2)
    assert int(dbg.result.iters) == int(res.iters)
    assert bool(dbg.result.converged) == bool(res.converged)
    _rel(dbg.result.lam, res.lam.numpy(), 1e-12)


def test_eta_history_monotone_tail_and_residual():
    spec = gt.ProblemSpec(3, 2, 12)
    blocks = random_blocks(spec, seed=11)
    opts = gt.SolverOptions(exit_tol=1e-10, max_iters=200, rho=0.01)
    dbg = debug.solve_debug(spec, blocks, opts, device="cpu")
    hist = dbg.eta_history.numpy()
    assert hist.shape == (201,)
    it = int(dbg.result.iters)
    # eta at the recorded exit iteration is below tol; start is above.
    assert hist[it + 1] < 1e-10 < hist[0]
    assert float(dbg.final_residual_norm) < 1e-4
    assert dbg.system.S.shape == (12, 3, 3, 3)


def test_debug_oracle_consistency():
    spec = gt.ProblemSpec(4, 2, 10)
    blocks = random_blocks(spec, seed=21)
    opts = gt.SolverOptions(exit_tol=1e-12, max_iters=400, rho=0.02)
    dbg = debug.solve_debug(spec, blocks, opts, device="cpu")
    lam_ref, _ = dense_oracle(spec, blocks, rho=0.02)
    np.testing.assert_allclose(dbg.result.lam.numpy().reshape(-1), lam_ref,
                               rtol=2e-3, atol=2e-3)


def test_residual_history_without_iterations():
    spec = gt.ProblemSpec(3, 2, 6)
    dbg = debug.solve_debug(spec, random_blocks(spec, seed=2),
                            gt.SolverOptions(max_iters=0), device="cpu")
    assert dbg.eta_history.shape == (1,) and int(dbg.result.iters) == 0


def test_solve_debug_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = gt.ProblemSpec(3, 2, 6)
    with pytest.raises(RuntimeError, match="cuda"):
        debug.solve_debug(spec, random_blocks(spec, seed=2))
    with pytest.raises(RuntimeError, match="cuda"):
        with debug.trace("unused"):
            pass


def test_trace_on_the_cpu_writes_a_trace(tmp_path):
    p = gt.testing.pendulum_problem()
    with debug.trace(str(tmp_path), device="cpu", with_stack=True) as prof:
        gt.linsys_solve(p.G_row, p.G_col, p.G_val, p.C_row, p.C_col, p.C_val,
                        p.g, p.c, [0.0] * 10, 1, 1e-6, 10, False, 1e-3,
                        device="cpu", verbose=False)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((tmp_path / files[0]).read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "python_function"}
    assert any(n.endswith(": pack_kkt") for n in names)
    assert any(n.endswith(": solve") for n in names)
    assert any("einsum" in e.key for e in prof.key_averages())


# ---- the spans of the solve path (gato_tpu_torch.spans) ----

SPAN_SPEC = gt.ProblemSpec(3, 2, 6)
INNER = ("gato.route", "gato.stage", "gato.solve_core")


def _gato_spans(path):
    """(name, start_us, end_us, cat) of each ``gato.`` span of a Chrome
    trace, in order of start, an outer span before the spans it holds."""
    events = json.loads(path.read_text())["traceEvents"]
    found = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
              e.get("cat")) for e in events
             if e.get("ph") == "X" and e["name"].startswith("gato.")]
    return sorted(found, key=lambda sp: (sp[1], -sp[2]))


def _profiled_spans(tmp_path, fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return _gato_spans(path)


def _assert_nested_in_order(found, outer):
    names = [n for n, *_ in found]
    assert names == [outer, *INNER], names
    _, a, b, _ = found[0]
    ends = a
    for name, x, y, _ in found[1:]:
        assert a <= x <= y <= b, (name, x, y, a, b)
        assert x >= ends, f"{name} starts before the span ahead of it ends"
        ends = y


@pytest.mark.parametrize("method", ["pcg", "direct"])
@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_solve_batched_records_its_spans_nested(tmp_path, method, backend):
    """Under torch.profiler, a repeat solve_batched (its launch plan kept)
    records gato.solve_batched holding gato.route, gato.stage and
    gato.solve_core in that order; CPU tensors launch nothing, so no
    gato.launch (the 'fused' wrappers run their plain versions here)."""
    blocks = random_batch(SPAN_SPEC, 2, seed0=5)
    opts = gt.SolverOptions(method=method)

    def call():
        gt.solve_batched(SPAN_SPEC, blocks, opts, pcg_backend=backend, device="cpu")

    call()
    found = _profiled_spans(tmp_path, call)
    _assert_nested_in_order(found, "gato.solve_batched")


def test_gato_plan_is_recorded_inside_the_route_on_a_miss_only(tmp_path, monkeypatch):
    """A signature's first solve_batched builds its launch plan in a
    gato.plan span inside gato.route; the next call finds the plan and
    records the spans without it."""
    from gato_tpu_torch import solver

    monkeypatch.setattr(solver, "_PLANS", {})
    blocks = random_batch(SPAN_SPEC, 2, seed0=10)

    def call():
        gt.solve_batched(SPAN_SPEC, blocks, gt.SolverOptions(), device="cpu")

    miss = _profiled_spans(tmp_path, call)
    assert [n for n, *_ in miss] == ["gato.solve_batched", "gato.route", "gato.plan",
                                     *INNER[1:]]
    (_, a, b, _), (_, x, y, _) = miss[1], miss[2]
    assert a <= x <= y <= b
    _assert_nested_in_order([sp for sp in miss if sp[0] != "gato.plan"],
                            "gato.solve_batched")
    _assert_nested_in_order(_profiled_spans(tmp_path, call), "gato.solve_batched")


def test_solve_records_gato_solve(tmp_path):
    blocks = random_blocks(SPAN_SPEC, seed=6)
    found = _profiled_spans(tmp_path, lambda: gt.solve(
        SPAN_SPEC, blocks, gt.SolverOptions(), device="cpu"))
    _assert_nested_in_order(found, "gato.solve")


class _Entered(Exception):
    pass


def _raise(*args, **kwargs):
    raise _Entered


def test_spans_enter_no_record_function_without_a_profiler(monkeypatch):
    """With no profiler session, no span site enters a RecordFunction: with
    both RecordFunction classes made to raise, a solve runs; inside a
    session the same solve reaches them."""
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    blocks = random_batch(SPAN_SPEC, 2, seed0=7)
    for method in ("pcg", "direct"):
        res = gt.solve_batched(SPAN_SPEC, blocks, gt.SolverOptions(method=method),
                               device="cpu")
        assert bool(res.converged.all())
    assert spans.span("gato.route") is spans.span("gato.stage")
    from torch.profiler import ProfilerActivity, profile
    with pytest.raises(_Entered):
        with profile(activities=[ProfilerActivity.CPU]):
            gt.solve_batched(SPAN_SPEC, blocks, gt.SolverOptions(), device="cpu")


def test_spans_fall_back_to_record_function(tmp_path, monkeypatch):
    """Where torch has no fast RecordFunction, the spans are
    record_function's, exported as user annotations."""
    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast")
    blocks = random_batch(SPAN_SPEC, 2, seed0=8)
    gt.solve_batched(SPAN_SPEC, blocks, gt.SolverOptions(), device="cpu")
    found = _profiled_spans(tmp_path, lambda: gt.solve_batched(
        SPAN_SPEC, blocks, gt.SolverOptions(), device="cpu"))
    _assert_nested_in_order(found, "gato.solve_batched")
    assert {cat for *_, cat in found} == {"user_annotation"}


def test_debug_trace_writes_the_spans(tmp_path):
    blocks = random_batch(SPAN_SPEC, 2, seed0=9)
    gt.solve_batched(SPAN_SPEC, blocks, gt.SolverOptions(), device="cpu")
    with debug.trace(str(tmp_path), device="cpu"):
        gt.solve_batched(SPAN_SPEC, blocks, gt.SolverOptions(), device="cpu")
    (path,) = tmp_path.iterdir()
    _assert_nested_in_order(_gato_spans(path), "gato.solve_batched")


def test_launch_is_one_span_around_the_launcher(tmp_path, monkeypatch):
    """_build.launch on the CPU with a stand-in launcher: the call, stream
    and all, is one gato.launch span inside a profiler session, none
    outside it, and a CUDA error code still raises."""
    from gato_tpu_torch.kernels import _build

    calls = []

    def launcher(*args):
        calls.append(args)
        return args[0]

    class Stream:
        cuda_stream = 7

    monkeypatch.setattr(_build, "function", lambda name: launcher)
    monkeypatch.setattr(_build, "check_launch", lambda code, what: _raise())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda index: Stream())
    dev = torch.device("cuda", 0)
    _build.launch("test", "gato_null_copy", dev, 0, 5)
    found = _profiled_spans(tmp_path, lambda: _build.launch("test", "gato_null_copy",
                                                            dev, 0, 6))
    assert [n for n, *_ in found] == ["gato.launch"]
    assert calls == [(0, 5, 7), (0, 6, 7)]
    with pytest.raises(_Entered):
        _build.launch("test", "gato_null_copy", dev, 3)
