"""gato_tpu_torch.timing against gato_tpu.timing (the port of
tests/test_timing.py): the perturbation and the cluster rule against the
reference on the same seeded inputs, the chain machinery on scripted
readings, and the solver-surface wrapper on the CPU (real latency numbers
need the card: chip_smoke.py phase 4g).

Tolerance: perturb in float32 agrees with gato_tpu's to 2 float32 ulps of
the result (one cos, sin and tanh each, rounded by another library).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gato_tpu import timing as jt
from gato_tpu.formats import KKTBlocks as JBlocks

import gato_tpu_torch as gt
from gato_tpu_torch import timing
from gato_tpu_torch.testing import random_blocks

torch.set_num_threads(1)

PEND = gt.ProblemSpec(2, 1, 5)


def test_measure_rtt_runs():
    assert timing.measure_rtt_ms(reps=2, device="cpu") > 0


@pytest.mark.parametrize("t", [0.0, 1.0, 7.0])
def test_perturb_matches_gato_tpu(t):
    blocks = random_blocks(gt.ProblemSpec(4, 2, 6), seed=5)
    lam = np.random.default_rng(1).normal(size=blocks.q.shape).astype(np.float32)
    b = gt.blocks_to_torch(blocks, "cpu")
    Q, q = timing.perturb(b, b.q, torch.tensor(lam), torch.tensor(t, dtype=torch.float32))
    jb = JBlocks(*(jnp.asarray(np.asarray(a)) for a in blocks))
    Qr, qr = jt.perturb(jb, jb.q, jnp.asarray(lam), jnp.float32(t))
    for ours, ref in ((Q, Qr), (q, qr)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=2 * 2.0 ** -23, atol=0)


def test_perturb_changes_q_and_Q():
    b = gt.blocks_to_torch(random_blocks(PEND, seed=0), "cpu")
    Q1, q1 = timing.perturb(b, b.q, torch.ones_like(b.q), torch.tensor(1.0))
    Q2, q2 = timing.perturb(b, b.q, torch.ones_like(b.q), torch.tensor(2.0))
    # Both the operator and the rhs must vary with t (hoisting breaker).
    assert float((Q1 - Q2).abs().max()) > 0
    assert float((q1 - q2).abs().max()) > 0


@pytest.mark.parametrize("estimates, n", [([0.39, 15.6, 0.41], 2),
                                          ([3.0, 1.0, 2.0, 2.5, 9.0], 3),
                                          ([5.0], 2), ([1.0, 1.0, 4.0, 4.0], 2)])
def test_best_cluster_matches_gato_tpu(estimates, n):
    assert timing._best_cluster(estimates, n) == jt._best_cluster(estimates, n)


def test_best_cluster_rejects_transient():
    # A one-off 40x stall must not pollute the reported value.
    ms, spread = timing._best_cluster([0.39, 15.6, 0.41], 2)
    assert abs(ms - 0.40) < 0.02 and spread < 0.03


def test_time_solve_single_and_batched():
    blocks = random_blocks(PEND, seed=1)
    ms, info = timing.time_solve(PEND, blocks, gt.SolverOptions(rho=1e-3), T=4,
                                 reps=2, n_independent=2, min_diff_ms=0.0,
                                 device="cpu")
    # CPU timings are jitter: extra re-measure rounds may fire (capped at
    # n_independent + max_extra estimates) and T may double on a negative
    # pilot difference (up to three times).
    assert ms > 0 and info["T"] in (4, 8, 16, 32)
    assert 2 <= len(info["reps_ms"]) <= 6
    assert info["first_call_ms"] > 0
    batch = type(blocks)(*(np.stack([np.asarray(a)] * 3) for a in blocks))
    ms_b, _ = timing.time_solve(PEND, batch, gt.SolverOptions(rho=1e-3), T=4,
                                reps=2, n_independent=2, min_diff_ms=0.0,
                                device="cpu")
    assert ms_b > 0


@pytest.mark.parametrize("method", ["pcg", "direct"])
def test_time_solve_step_is_the_solve(method, monkeypatch):
    """The chained step is a solve of the perturbed problem: at t = 0 with a
    zero carry the perturbation is exactly 1 + 1e-6, and the step's output is
    lam + dz_x of that solve."""
    spec = gt.ProblemSpec(3, 2, 6)
    blocks = random_blocks(spec, seed=4)
    opts = gt.SolverOptions(rho=1e-3, method=method)
    seen = {}

    def fake_chain_time(step, q0, T, **kw):
        out = step(q0, torch.zeros_like(q0), torch.tensor(0.0))
        seen["out"], seen["T"], seen["label"] = out, T, kw["label"]
        return 1.0, {}

    monkeypatch.setattr(timing, "chain_time", fake_chain_time)
    timing.time_solve(spec, blocks, opts, T=3, device="cpu")
    assert seen["T"] == 3 and seen["label"] == f"torch/{method}"
    b = gt.blocks_to_torch(blocks, "cpu")
    scale = 1.0 + 1e-6 * torch.cos(torch.tensor(0.0))
    moved = gt.KKTBlocks(b.Q * scale, *b[1:])
    ref = gt.solve(spec, moved, opts, pcg_backend="torch", device="cpu")
    expect = ref.lam + ref.dz_x + 1e-20 * ref.dz_u.sum()
    torch.testing.assert_close(seen["out"], expect, rtol=0, atol=0)


def test_time_solve_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        timing.time_solve(PEND, random_blocks(PEND, seed=1), T=2)
    with pytest.raises(RuntimeError, match="cuda"):
        timing.measure_rtt_ms(2)


def test_chain_time_doubles_on_noise():
    calls = []

    def step(q0, lam_carry, t):
        return q0 * (1.0 + 0.0 * t) + lam_carry * 0.0

    q0 = torch.ones((4, 2))
    ms, info = timing.chain_time(step, q0, T=2, reps=2, n_independent=2,
                                 min_diff_ms=1e9, log=calls.append)
    # Impossible noise floor: T doubled three times (the cap), warning
    # recorded, log called.
    assert info["T"] == 16 and "noise_warning" in info and calls


def _scripted_chain_time(monkeypatch, timed_values, **kw):
    """Run chain_time against a scripted sequence of _timed readings (pairs
    consumed as t1, t2 per estimate) with the chain build stubbed."""
    monkeypatch.setattr(timing, "_chain_fn",
                        lambda step_fn, q0, length: (lambda q: 0.0))
    vals = iter(timed_values)
    monkeypatch.setattr(timing, "_timed", lambda chain, q0, rep: next(vals))
    return timing.chain_time(lambda q0, lam, t: q0, torch.zeros(()), T=2,
                             reps=1, **kw)


def test_chain_time_drops_corrupted_differences(monkeypatch):
    """A stall can make a T-vs-2T difference non-positive; such an estimate
    must be DROPPED and re-measured — floor-clamping it would let two stalls
    form a fake zero-spread 'tightest cluster' of identical floor values."""
    # est0: 30-10 = 20 ms (good); est1: 48-50 = -2 ms (corrupted, dropped;
    # gate median([20,-2]) = 9 >= 8 still passes); extra: 31-10 = 21 (good).
    ms, info = _scripted_chain_time(
        monkeypatch, [10.0, 30.0, 50.0, 48.0, 10.0, 31.0])
    assert info["reps_ms"] == [10.0, 10.5]      # 20/T, 21/T with T=2
    assert ms == 10.25                          # cluster median, no floor
    assert "noise_warning" not in info


def test_chain_time_warns_when_estimates_stay_corrupted(monkeypatch):
    """If re-measurement cannot recover enough usable estimates, the result
    carries a noise warning instead of a silently-tiny clean-looking number."""
    # est0 good (diff 20), est1 + all 4 extras corrupted (diff -1 each).
    vals = [10.0, 30.0, 50.0, 49.0] + [10.0, 9.0] * 4
    ms, info = _scripted_chain_time(monkeypatch, vals)
    assert info["reps_ms"] == [10.0]
    assert ms == 10.0
    assert "usable estimates" in info["noise_warning"]


@pytest.mark.parametrize("vals", [[10.0, 30.0, 50.0, 48.0, 10.0, 31.0],
                                  [10.0, 30.0, 50.0, 49.0] + [10.0, 9.0] * 4,
                                  [5.0, 30.0, 5.0, 31.0]])
def test_chain_time_scripted_matches_gato_tpu(monkeypatch, vals):
    """The same scripted readings give the same result and info as
    gato_tpu.timing.chain_time."""
    ours = _scripted_chain_time(monkeypatch, list(vals))
    monkeypatch.setattr(jt, "_chain_fn",
                        lambda step_fn, q0, length: (lambda q: 0.0))
    it = iter(list(vals))
    monkeypatch.setattr(jt, "_timed", lambda chain, q0, rep: next(it))
    ref = jt.chain_time(lambda q0, lam, t: q0, jnp.zeros(()), T=2, reps=1)
    ours[1].pop("first_call_ms")
    ref[1].pop("first_call_ms")
    assert ours == ref


def test_chain_carries_the_previous_output():
    """Each step sees the previous step's output as its carry and the step
    counter as a tensor; the chain returns the sum of the last output."""
    seen = []

    def step(q, carry, t):
        seen.append((float(carry.sum()), float(t)))
        return q + carry

    chain = timing._chain_fn(step, torch.ones(3), 4)
    assert float(chain(torch.ones(3))) == 12.0
    assert seen == [(0.0, 0.0), (3.0, 1.0), (6.0, 2.0), (9.0, 3.0)]
