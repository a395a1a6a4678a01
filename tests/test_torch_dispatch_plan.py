"""solve_batched's launch plans (solver.launch_plan), on the CPU: one plan
built per call signature and found by later calls, a new one for any change
of the key, nothing kept for a signature that raises, the 64-plan bound,
and a hit giving what staging and _solve_core give, bit for bit, while any
input not yet staged takes that path itself."""

import pytest
import torch

import gato_tpu_torch as gt
from gato_tpu_torch import solver
from gato_tpu_torch.formats import KKTBlocks
from gato_tpu_torch.kernels import fused_solve
from gato_tpu_torch.testing import random_batch

SPEC = gt.ProblemSpec(3, 2, 6)
B = 2


@pytest.fixture(autouse=True)
def _no_plans():
    solver._PLANS.clear()
    yield
    solver._PLANS.clear()


def _tensors(spec=SPEC, n=B, seed0=11) -> KKTBlocks:
    return KKTBlocks(*(torch.as_tensor(a) for a in random_batch(spec, n, seed0=seed0)))


def _counts() -> tuple:
    return solver.PLAN_BUILDS, solver.PLAN_HITS


def _today(spec, blocks, options, lam0=None, backend=None):
    """The path of a call without a kept plan: route, stage, _solve_core."""
    backend = solver._resolve_backend(backend, options, "cpu", solver.spec_shape(spec),
                                      batch=len(blocks.Q))
    _, b, lam0 = solver._stage(spec, blocks, options, lam0, "cpu", (len(blocks.Q),))
    return solver._solve_core(b, lam0, options, backend)


def _assert_equal(res, ref):
    for name in res._fields:
        got, want = getattr(res, name), getattr(ref, name)
        assert got.dtype == want.dtype and torch.equal(got, want), name


def test_one_build_then_hits():
    blocks, opts = _tensors(), gt.SolverOptions()
    builds, hits = _counts()
    for _ in range(4):
        gt.solve_batched(SPEC, blocks, opts, device="cpu")
    assert _counts() == (builds + 1, hits + 3)
    plan = solver.launch_plan(SPEC, opts, None, "cpu", B)
    assert plan.backend == "torch" and plan.device == torch.device("cpu")
    assert plan.shapes[0] == torch.Size((B, 6, 3, 3)) and plan.shapes[-1] == (B, 6, 3)


KEY_CHANGES = {"options": gt.SolverOptions(max_iters=99), "batch": B + 1,
               "spec": gt.ProblemSpec(3, 2, 7), "pcg_backend": "fused", "device": "cpu:0"}


@pytest.mark.parametrize("part", list(KEY_CHANGES))
def test_a_change_to_any_key_part_builds_a_new_plan(part):
    key = dict(spec=SPEC, options=gt.SolverOptions(), pcg_backend=None, device="cpu",
               batch=B)
    solver.launch_plan(**key)
    builds = solver.PLAN_BUILDS
    solver.launch_plan(**key)
    assert solver.PLAN_BUILDS == builds
    key[part] = KEY_CHANGES[part]
    solver.launch_plan(**key)
    assert solver.PLAN_BUILDS == builds + 1


def test_a_device_without_an_index_is_keyed_at_the_current_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert solver._plan_device("cuda") == torch.device("cuda", 3)
    assert solver._plan_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
    assert solver._plan_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("backend", ["torch", "pcg_kernel", "fused"])
@pytest.mark.parametrize("method", ["pcg", "direct"])
def test_a_hit_equals_staging_and_solve_core(backend, method):
    blocks = _tensors()
    opts = gt.SolverOptions(method=method, rho=1e-3)
    ref = _today(SPEC, blocks, opts, backend=backend)
    gt.solve_batched(SPEC, blocks, opts, pcg_backend=backend, device="cpu")
    hits = solver.PLAN_HITS
    res = gt.solve_batched(SPEC, blocks, opts, pcg_backend=backend, device="cpu")
    assert solver.PLAN_HITS == hits + 1
    _assert_equal(res, ref)


def test_two_hits_share_no_output():
    blocks, opts = _tensors(), gt.SolverOptions()
    first = gt.solve_batched(SPEC, blocks, opts, device="cpu")
    second = gt.solve_batched(SPEC, blocks, opts, device="cpu")
    ptrs = {t.untyped_storage().data_ptr() for t in first}
    assert not ptrs & {t.untyped_storage().data_ptr() for t in second}


def _restaged(blocks, how):
    if how == "float64":
        return KKTBlocks(*(t.double() for t in blocks))
    if how == "numpy":
        return KKTBlocks(*(t.numpy() for t in blocks))
    return KKTBlocks(*(t.transpose(0, -1).contiguous().transpose(0, -1) for t in blocks))


@pytest.mark.parametrize("how", ["float64", "numpy", "non_contiguous"])
def test_after_a_hit_unstaged_inputs_are_staged(how):
    blocks, opts = _tensors(), gt.SolverOptions(rho=1e-3)
    other = _restaged(blocks, how)
    if how == "non_contiguous":
        assert not any(t.is_contiguous() for t in other)
    ref = gt.solve_batched(SPEC, blocks, opts, device="cpu")
    builds = solver.PLAN_BUILDS
    _assert_equal(gt.solve_batched(SPEC, other, opts, device="cpu"), ref)
    _assert_equal(gt.solve_batched(SPEC, other, opts, device="cpu"), _today(SPEC, other, opts))
    assert solver.PLAN_BUILDS == builds


@pytest.mark.parametrize("field", range(7))
def test_after_a_hit_a_wrong_shape_raises_check_block_shapes(field):
    blocks, opts = _tensors(), gt.SolverOptions()
    gt.solve_batched(SPEC, blocks, opts, device="cpu")
    bad = list(blocks)
    bad[field] = bad[field][..., :-1]
    name = KKTBlocks._fields[field]
    with pytest.raises(ValueError, match=rf"blocks\.{name} shape .* does not match"):
        gt.solve_batched(SPEC, KKTBlocks(*bad), opts, device="cpu")


@pytest.mark.parametrize("lam_kind", ["tensor", "numpy", "flat"])
def test_after_a_hit_a_warm_start_lam0_is_honoured(lam_kind):
    blocks = _tensors()
    warm = gt.SolverOptions(warm_start=True, rho=1e-3)
    cold = gt.solve_batched(SPEC, blocks, warm, device="cpu")
    lam0 = cold.lam.clone()
    given = dict(tensor=lam0, numpy=lam0.numpy(), flat=lam0.reshape(B, -1))[lam_kind]
    ref = _today(SPEC, blocks, warm, lam0)
    res = gt.solve_batched(SPEC, blocks, warm, lam0=given, device="cpu")
    _assert_equal(res, ref)
    assert int(res.iters.max()) < int(cold.iters.min())
    # Without warm_start a given lam0 is ignored, as staging ignores it.
    opts = gt.SolverOptions(rho=1e-3)
    _assert_equal(gt.solve_batched(SPEC, blocks, opts, lam0=lam0, device="cpu"),
                  _today(SPEC, blocks, opts))


def _raises_every_call(spec, opts, backend, match):
    shapes = fused_solve.block_shapes((1,), *solver.spec_shape(spec))
    blocks = KKTBlocks(*(torch.zeros(s) for s in shapes.values()))
    builds, kept = solver.PLAN_BUILDS, len(solver._PLANS)
    for _ in range(3):
        with pytest.raises(ValueError, match=match):
            gt.solve_batched(spec, blocks, opts, pcg_backend=backend, device="cpu")
    assert (solver.PLAN_BUILDS, len(solver._PLANS)) == (builds, kept)


def test_a_raising_route_raises_every_call_and_keeps_nothing():
    long_k = gt.ProblemSpec(14, 7, 700)
    _raises_every_call(long_k, gt.SolverOptions(), "fused", "long-K tier")
    _raises_every_call(SPEC, gt.SolverOptions(dtype="float64"), "fused", "float32-only")
    _raises_every_call(SPEC, gt.SolverOptions(dtype="float64"), "pcg_kernel",
                       "float32-only")


def test_the_bound_evicts_the_oldest_plan():
    first = gt.SolverOptions(max_iters=1)
    for i in range(solver.PLAN_CACHE_SIZE + 1):
        solver.launch_plan(SPEC, gt.SolverOptions(max_iters=1 + i), None, "cpu", B)
    assert len(solver._PLANS) == solver.PLAN_CACHE_SIZE
    assert (SPEC, first, None, torch.device("cpu"), B) not in solver._PLANS
    builds = solver.PLAN_BUILDS
    solver.launch_plan(SPEC, gt.SolverOptions(max_iters=2), None, "cpu", B)
    assert solver.PLAN_BUILDS == builds
    solver.launch_plan(SPEC, first, None, "cpu", B)
    assert solver.PLAN_BUILDS == builds + 1


def test_float64_options_plan_float64_tensors():
    blocks = KKTBlocks(*(t.double() for t in _tensors()))
    opts = gt.SolverOptions(dtype="float64", rho=1e-3)
    gt.solve_batched(SPEC, blocks, opts, device="cpu")
    res = gt.solve_batched(SPEC, blocks, opts, device="cpu")
    assert res.lam.dtype == torch.float64
    _assert_equal(res, _today(SPEC, blocks, opts))
