"""The probe kernels' plain versions (rows 16, 17 and 18,
gato_tpu_torch/kernels/probes.py) against NumPy restatements of the TPU
probes they port.

The TPU kernels sit inside functions that also time on a TPU
(``_null_kernel_time_ns``, ``probe_D``, ``bench_dispatch_floor``), so they
cannot be called alone on the CPU; these restatements follow the cited
lines op for op, on the TPU's layout (rows on sublanes, knots on lanes):

* row 16, tools/probe_iter_floor.py:60-100.  One difference, stated: the
  matvec's neighbours past either end are zeros (the port's
  block-tridiagonal matvec), where the TPU kernel rolled its lanes
  cyclically (``pltpu.roll``).  The port's freeze test reads y's first
  element, the TPU's the sum of its first row: both are true for every
  finite y, and the restatement keeps the TPU's;
* row 17, tools/probe_throughput.py:202-217;
* row 18, bench.py:893-894.

The inputs are the ones the card checks take (probes.chain_operator,
probes.fma_operator: each knot's own step orthogonal, so every knot's y
keeps its size).  Tolerances, within each (problem, knot): row 18 bit for
bit; rows 16 and 17 in float64 within 1e-12 of the knot's scale (the same
arithmetic in another order), in float32 within 1e-5 (sums of 3 s
products in another order along a chain of up to 48 steps).
"""

import numpy as np
import pytest
import torch

from gato_tpu_torch.kernels import probes

torch.set_num_threads(1)


def restate_null_chain(M, y0, n_mv, n_dot, trips):
    """tools/probe_iter_floor.py:60-100 on one problem: M (K, 3, s, s),
    y0 (K, s), as tiles (s, K) of rows by knots."""
    dt = y0.dtype
    K, _, s, _ = M.shape
    Mc = [[(M[:, slot, :, b] * dt.type(0.01)).T for b in range(s)]
          for slot in range(3)]                       # Mc[slot][b]: (s, K)
    y = y0.T.copy()

    def matvec(y):
        zero = np.zeros((s, 1), dt)
        xm = np.concatenate([zero, y[:, :-1]], axis=1)   # the TPU: roll by 1
        xp = np.concatenate([y[:, 1:], zero], axis=1)    # the TPU: roll by L-1
        acc = None
        for slot, x in ((0, xm), (1, y), (2, xp)):
            a = Mc[slot][0] * x[0:1, :]
            for b in range(1, s):
                a = a + Mc[slot][b] * x[b:b + 1, :]
            acc = a if acc is None else acc + a
        return acc

    for _ in range(trips):
        for _m in range(n_mv):
            y = matvec(y) * dt.type(0.25) + y * dt.type(0.5)
        for _d in range(n_dot):
            row = np.sum(y * y, axis=0, keepdims=True)
            sc = np.sum(row, axis=1, keepdims=True)
            a = np.where(sc != 0, dt.type(1.0) / (dt.type(1.0) + sc), dt.type(0.0))
            y = y + np.broadcast_to(a, (1, K)) * (y * dt.type(0.125))
        live = np.broadcast_to(np.sum(y[0:1, :], axis=1, keepdims=True), (1, K)) > -1e30
        y = np.where(live, y, y * dt.type(0.5))
        y = np.where(live, y, y + dt.type(1.0))
        y = np.where(live, y, y * dt.type(0.25))
    return y.T


def restate_fma_chain(M, y0, depth, trips):
    """tools/probe_throughput.py:202-217 on one problem: M (K, s, s) as the
    s column tiles Mc[b] (s, K), y0 (K, s) as a tile (s, K)."""
    dt = y0.dtype
    s = M.shape[1]
    Mc = [(M[:, :, b] * dt.type(0.01)).T for b in range(s)]
    y = y0.T.copy()
    for _ in range(trips):
        for _d in range(depth):
            acc = Mc[0] * y[0:1, :]
            for b in range(1, s):
                acc = acc + Mc[b] * y[b:b + 1, :]
            y = acc * dt.type(0.25) + y * dt.type(0.5)
    return y.T


def _chain_case(seed, B, K, s, dtype):
    M, y0 = probes.chain_operator(B, K, s, seed=seed, dtype=torch.float64)
    return M.numpy().astype(dtype), y0.numpy().astype(dtype)


def _fma_case(seed, B, K, dtype):
    M, y0 = probes.fma_operator(B, K, seed=seed, dtype=torch.float64)
    return M.numpy().astype(dtype), y0.numpy().astype(dtype)


def _knots_close(got, ref, tol):
    """|got - ref| <= tol max |ref| within every knot row of (K, s)."""
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    assert np.isfinite(got).all() and scale.min() > 1e-20
    assert (np.abs(got - ref) <= tol * scale).all(), float((np.abs(got - ref) / scale).max())


@pytest.mark.parametrize("n_mv, n_dot", [(2, 2), (1, 2), (4, 2), (2, 1), (2, 4)])
@pytest.mark.parametrize("dtype, tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_null_chain_plain_matches_the_restatement(n_mv, n_dot, dtype, tol):
    M, y0 = _chain_case(16, 2, 6, 3, dtype)
    got = probes.null_chain_cuda(torch.tensor(M), torch.tensor(y0), n_mv=n_mv,
                                 n_dot=n_dot, trips=12)
    for b in range(2):
        _knots_close(got[b].numpy(), restate_null_chain(M[b], y0[b], n_mv, n_dot, 12), tol)


@pytest.mark.parametrize("depth, trips", [(2, 8), (6, 3), (1, 1)])
@pytest.mark.parametrize("dtype, tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_fma_chain_plain_matches_the_restatement(depth, trips, dtype, tol):
    M, y0 = _fma_case(17, 3, 5, dtype)
    got = probes.fma_chain_cuda(torch.tensor(M), torch.tensor(y0), depth=depth,
                                trips=trips)
    for b in range(3):
        _knots_close(got[b].numpy(), restate_fma_chain(M[b], y0[b], depth, trips), tol)


@pytest.mark.parametrize("shape", [(1, 50, 14), (4, 5, 2), (1, 7, 3), (256, 50, 14)])
def test_null_copy_plain_is_the_restatement_bit_for_bit(shape):
    q = np.random.default_rng(18).normal(size=shape).astype(np.float32)
    got = probes.null_copy_cuda(torch.tensor(q)).numpy()
    ref = q * 1.0000001                       # bench.py:894, a float32 product
    assert ref.dtype == np.float32
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))


def test_zero_trips_return_the_input():
    M, y0 = _chain_case(3, 1, 4, 2, np.float32)
    for scope in probes.SCOPES:
        got = probes.null_chain_cuda(torch.tensor(M), torch.tensor(y0), n_mv=2,
                                     n_dot=2, trips=0, scope=scope)
        assert torch.equal(got, torch.tensor(y0))
    M, y0 = _fma_case(3, 1, 4, np.float32)
    got = probes.fma_chain_cuda(torch.tensor(M), torch.tensor(y0), depth=3, trips=0)
    assert torch.equal(got, torch.tensor(y0))


def test_wrappers_refuse_bad_arguments_and_count_no_cpu_launch():
    M, y0 = _chain_case(3, 1, 4, 2, np.float32)
    M, y0 = torch.tensor(M), torch.tensor(y0)
    before = (probes.COPY_LAUNCHES, probes.CHAIN_BLOCK_LAUNCHES,
              probes.CHAIN_GRID_LAUNCHES, probes.FMA_LAUNCHES)
    with pytest.raises(ValueError, match="scope"):
        probes.null_chain_cuda(M, y0, n_mv=1, n_dot=1, trips=1, scope="warp")
    with pytest.raises(ValueError, match="trips"):
        probes.null_chain_cuda(M, y0, n_mv=1, n_dot=1, trips=-1)
    with pytest.raises(ValueError, match="depth"):
        probes.fma_chain_cuda(M[:, :, 0], y0, depth=1.5, trips=1)
    with pytest.raises(ValueError, match="width"):
        probes.fma_chain_cuda(M[:, :, 0], y0, depth=1, trips=1)
    probes.null_copy_cuda(y0)
    probes.null_chain_cuda(M, y0, n_mv=1, n_dot=1, trips=1, scope="grid")
    assert (probes.COPY_LAUNCHES, probes.CHAIN_BLOCK_LAUNCHES,
            probes.CHAIN_GRID_LAUNCHES, probes.FMA_LAUNCHES) == before


def test_chain_operator_steps_are_scaled_orthogonal():
    """A knot's own matvec step 0.5 I + 0.0025 M[k, 1] is 0.99 times an
    orthogonal block; the neighbour blocks are the small coupling."""
    M, _ = probes.chain_operator(2, 6, 5, seed=4, dtype=torch.float64)
    step = 0.5 * torch.eye(5, dtype=torch.float64) + 0.0025 * M[:, :, 1]
    gram = step.transpose(-1, -2) @ step
    c2 = probes.CHAIN_CONTRACTION ** 2
    assert torch.allclose(gram, c2 * torch.eye(5, dtype=torch.float64), rtol=0, atol=1e-12)
    assert float(M[:, :, [0, 2]].abs().max()) < 10 * probes.CHAIN_COUPLING


def test_fma_operator_keeps_every_knot_size():
    """Row 17's inputs: every knot's |y| is y0's after 200 matvecs."""
    M, y0 = probes.fma_operator(2, 7, seed=5, dtype=torch.float64)
    y = probes.fma_chain_plain(M, y0, depth=2, trips=100)
    assert torch.allclose(y.norm(dim=-1), y0.norm(dim=-1), rtol=1e-10, atol=0)


@pytest.mark.parametrize("n_mv, n_dot", [(4, 2), (1, 2)])
def test_floor_chain_holds_y_at_a_fixed_point(n_mv, n_dot):
    """The iteration floor's data keep y finite and away from 0 over
    thousands of trips (the dot steps balance the 0.99 contraction), so
    every trip's reciprocal runs on a nonzero sum of squares."""
    from gato_tpu_torch.tools import probe_iter_floor

    M, y0 = probe_iter_floor.chain_inputs(6, "cpu")
    y = probes.null_chain_plain(M, y0, n_mv=n_mv, n_dot=n_dot, trips=3000)
    probe_iter_floor.check_live("floor", y)
    assert 1.0 < float(y.norm()) < 10.0
    with pytest.raises(RuntimeError, match="zero"):
        probe_iter_floor.check_live("floor", torch.zeros_like(y))
    with pytest.raises(RuntimeError, match="finite"):
        probe_iter_floor.check_live("floor", y / 0.0)
