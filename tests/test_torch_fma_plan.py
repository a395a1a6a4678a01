"""Row 17 (the FMA-chain probe) on the CPU: its launch plan and a NumPy
float32 model of its schedule.

kernels/probes.py mirrors the plan of csrc/probes.cu's fma_chain_kernel
(``fma_plan``: one CTA a problem; 16 lanes a knot and a row a lane up to
FMA_WARP_KNOTS knots, else two lanes a knot and seven rows a lane; threads
and shared bytes a CTA).  The model runs the kernel lane by lane: each
lane's rows of 0.01 M and its copy of the knot's y as registers, the
first matvec alone and the rest in pairs, y exchanged through the knot's
slot of 16 floats in shared memory (double-buffered) or by the pair's
shuffles.  Every slot and register that no lane writes holds NaN, so a
wrong slot, parity, lane or row shows.  fmaf is modelled as the float64
product and sum of float32 operands, rounded once to float32.

Tolerances: the model against a model of the schedule it replaced (one
thread an output row) bit for bit, since every row keeps one fmaf order;
against tests/test_torch_probes.py's restatement of the TPU probe D body
(tools/probe_throughput.py:202-217, separate products and sums) and
against fma_chain_plain (float32 einsums) within 1e-5 of each knot's
scale over up to 12 matvecs.
"""

import numpy as np
import pytest
import torch
from test_torch_probes import restate_fma_chain

from gato_tpu_torch.kernels import probes

torch.set_num_threads(1)

S = probes.FMA_WIDTH
HORIZONS = [1, 4, 5, 40, 41, 50, 73]
BATCHES = [1, 3, 132]
TOL = 1e-5
F32 = np.float32


def _fmaf(a, b, c):
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def _fmul(a, b):
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)).astype(F32)


def _owners(plan, K):
    """{(knot, row): [threads]} over the rows the lanes write out."""
    owners = {}
    for t in range(plan.threads):
        k, q = divmod(t, plan.lanes)
        for r in range(plan.rows):
            row = q * plan.rows + r
            if k < K and row < S:
                owners.setdefault((k, row), []).append(t)
    return owners


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("K", HORIZONS)
def test_plan_covers_every_row_once_a_knot_in_one_warp(K, B):
    p = probes.fma_plan(B, K)
    assert p.ctas == B
    assert p.lanes == (16 if K <= probes.FMA_WARP_KNOTS else 2)
    assert p.rows == (1 if p.lanes == 16 else 7)
    assert p.threads % 32 == 0 and p.lanes * K <= p.threads < p.lanes * K + 32
    assert p.threads <= (16 * probes.FMA_WARP_KNOTS if p.lanes == 16
                         else 2 * probes.FMA_MAX_KNOTS)
    owners = _owners(p, K)
    assert sorted(owners) == [(k, a) for k in range(K) for a in range(S)]
    assert all(len(ts) == 1 for ts in owners.values())
    # A knot's lanes share a warp: its __syncwarp and shuffles reach them all.
    assert all(len({t // 32 for t in range(k * p.lanes, (k + 1) * p.lanes)}) == 1
               for k in range(K))
    assert p.smem == (2 * K * probes.FMA_SLOT * 4 if p.lanes == 16 else 0)
    assert p.smem <= 48 * 1024       # no opt-in to more shared memory


def test_plan_refuses_what_the_kernel_does_not_take():
    assert probes.fma_plan(1, probes.FMA_MAX_KNOTS).threads == 2 * probes.FMA_MAX_KNOTS
    for K in (0, probes.FMA_MAX_KNOTS + 1):
        with pytest.raises(ValueError, match=str(probes.FMA_MAX_KNOTS)):
            probes.fma_plan(1, K)


def model_schedule(M, y0, depth, trips):
    """y after trips x depth matvecs by the kernel's schedule, on M
    (B, K, 14, 14) and y0 (B, K, 14) float32."""
    Bn, K, _ = y0.shape
    p = probes.fma_plan(Bn, K)
    L, R, T = p.lanes, p.rows, p.threads
    t = np.arange(T)
    q, k = t % L, t // L
    kk = np.minimum(k, K - 1)                     # lanes past the last knot shadow it
    rows = q[:, None] * R + np.arange(R)[None, :]            # (T, R)
    live = rows < S
    own = (k < K)[:, None] & live
    rc = np.minimum(rows, S - 1)
    m = np.where(live[None, :, :, None], M[:, kk[:, None], rc] * F32(0.01), F32(0))
    yo = np.where(live[None], y0[:, kk[:, None], rc], F32(0))             # (B, T, R)
    y = np.zeros((Bn, T, probes.FMA_SLOT), F32)
    y[..., :S] = y0[:, kk]
    slots = np.full((Bn, 2, K, probes.FMA_SLOT), np.nan, F32)
    first = t - q                   # the knot's first lane (the shuffles' base lane)

    def matvec(par):
        nonlocal y, yo
        acc = _fmul(m[..., 0], y[:, :, None, 0])
        for c in range(1, S):
            acc = _fmaf(m[..., c], y[:, :, None, c], acc)
        yo = _fmaf(F32(0.25), acc, _fmul(F32(0.5), yo))
        new = np.full_like(y, np.nan)
        if L == 16:
            ts, rs = np.nonzero(own)
            slots[:, par, k[ts], rows[ts, rs]] = yo[:, ts, rs]
            new[:] = slots[:, par, kk]                # after the __syncwarp
        else:
            for src in range(L):
                new[..., src * R:(src + 1) * R] = yo[:, first + src]
        y = new

    n = trips * depth
    if n > 0:
        matvec(1)
    i = 1
    while i + 1 < n:
        matvec(0)
        matvec(1)
        i += 2
    if i < n:
        matvec(0)
    out = np.full(y0.shape, np.nan, F32)
    ts, rs = np.nonzero(own)
    out[:, k[ts], rows[ts, rs]] = yo[:, ts, rs]
    return out


def model_row_a_thread(M, y0, depth, trips):
    """The schedule row 17 ran before: one thread an output row, the same
    fmaf order."""
    m = M * F32(0.01)
    y = y0.copy()
    for _ in range(trips * depth):
        acc = _fmul(m[..., 0], y[:, :, None, 0])
        for c in range(1, S):
            acc = _fmaf(m[..., c], y[:, :, None, c], acc)
        y = _fmaf(F32(0.25), acc, _fmul(F32(0.5), y))
    return y


def _knots_close(got, ref, tol):
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    assert np.isfinite(got).all() and scale.min() > 1e-20
    assert (np.abs(got - ref) <= tol * scale).all(), float((np.abs(got - ref) / scale).max())


@pytest.mark.parametrize("depth, trips", [(2, 6), (1, 3), (3, 0)])
@pytest.mark.parametrize("K", HORIZONS)
def test_schedule_model_matches_the_old_order_and_the_probe(K, depth, trips):
    B = 3
    M, y0 = (t.numpy() for t in probes.fma_operator(B, K, seed=170 + K))
    got = model_schedule(M, y0, depth, trips)
    assert np.isfinite(got).all()
    ref = model_row_a_thread(M, y0, depth, trips)
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))
    for b in range(B):
        _knots_close(got[b], restate_fma_chain(M[b], y0[b], depth, trips), TOL)
    plain = probes.fma_chain_plain(torch.tensor(M), torch.tensor(y0), depth=depth,
                                   trips=trips).numpy()
    _knots_close(got, plain, TOL)
