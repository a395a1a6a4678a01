"""gato_tpu_torch.direct and the block-Thomas kernels' plain versions against
gato_tpu on the same NumPy inputs, on the CPU.

* direct.py (btd_solve, btd_solve_cr, thomas_multi, btd_solve_auto,
  residual_converged) against gato_tpu.direct, at odd and even K, batched
  and not.  Tolerances as tests/test_direct.py: 1e-4 (rtol and atol, of the
  solution's scale) in float32, 1e-10 in float64.
* kernels/thomas_batch.py's plain versions (taken for CPU tensors) against
  gato_tpu.kernels.thomas_batch.solve_direct_thomas_batched, which runs its
  Pallas kernels in interpret mode off the TPU: rtol 1e-4, atol 1e-5 of
  scale (tests/test_direct_fused.py:102-104), converged equal; the factor
  stacks against gato_tpu.assemble.condense and gato_tpu.direct.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gato_tpu
from gato_tpu import assemble as jassemble
from gato_tpu import direct as jdirect
from gato_tpu.kernels import thomas_batch as jtb

import gato_tpu_torch as gt
from gato_tpu_torch import direct
from gato_tpu_torch.blocktri import btd_to_dense
from gato_tpu_torch import testing as tt
from gato_tpu_torch.kernels import thomas_batch as kt

torch.set_num_threads(1)

SHAPES = [(3, 2, 7), (4, 2, 8), (6, 3, 9)]


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(ours, ref, tol=1e-4, atol=None):
    ours, ref = _np(ours).astype(np.float64), _np(ref).astype(np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(ours, ref, rtol=tol,
                               atol=(tol if atol is None else atol) * scale)


def _spd_btd(K, s, seed, dtype=np.float32):
    """A random symmetric positive definite block tridiagonal (K, 3, s, s)
    (tests/test_direct.py's generator)."""
    rng = np.random.default_rng(seed)
    off = rng.normal(size=(K - 1, s, s)) * 0.2
    diag = np.asarray([(lambda F: F @ F.T + np.eye(s) * 2.0)(rng.normal(size=(s, s)))
                       for _ in range(K)])
    zero = np.zeros((1, s, s))
    left = np.concatenate([zero, off], axis=0)
    right = np.concatenate([off.transpose(0, 2, 1), zero], axis=0)
    return np.stack([left, diag, right], axis=1).astype(dtype)


def _system(K, s, batch, seed, dtype=np.float32):
    if batch is None:
        S = _spd_btd(K, s, seed, dtype)
        b = np.random.default_rng(seed + 1).normal(size=(K, s)).astype(dtype)
    else:
        S = np.stack([_spd_btd(K, s, seed + i, dtype) for i in range(batch)])
        b = np.random.default_rng(seed + 1).normal(size=(batch, K, s)).astype(dtype)
    return S, b


@pytest.mark.parametrize("K", [2, 7, 8, 9, 16])
@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("solver", ["btd_solve", "btd_solve_cr"])
def test_btd_solvers_match_gato_tpu(solver, K, batch):
    S, b = _system(K, 3, batch, seed=K)
    ours = getattr(direct, solver)(torch.tensor(S), torch.tensor(b))
    ref = getattr(jdirect, solver)(jnp.asarray(S), jnp.asarray(b))
    assert tuple(ours.shape) == b.shape
    _close(ours, ref)


@pytest.mark.parametrize("solver", ["btd_solve", "btd_solve_cr"])
@pytest.mark.parametrize("K", [7, 8])
def test_btd_solvers_float64_match_gato_tpu(solver, K):
    S, b = _system(K, 4, 2, seed=40 + K, dtype=np.float64)
    ours = getattr(direct, solver)(torch.tensor(S), torch.tensor(b))
    assert ours.dtype == torch.float64
    with jax.enable_x64(True):
        ref = getattr(jdirect, solver)(jnp.asarray(S), jnp.asarray(b))
        _close(ours, ref, tol=1e-10)
    dense = np.linalg.solve(btd_to_dense(S[0]), b[0].reshape(-1))
    _close(ours[0].reshape(-1), dense, tol=1e-10)


@pytest.mark.parametrize("m", [5, 6])
def test_thomas_multi_matches_gato_tpu(m):
    s, nrhs = 3, 4
    S = np.stack([_spd_btd(m, s, seed=70 + i) for i in range(2)])   # (2, m, 3, s, s)
    L, D, U = (np.moveaxis(S[:, :, j], 1, 0) for j in range(3))    # (m, 2, s, s)
    Bm = np.random.default_rng(5).normal(size=(m, 2, s, nrhs)).astype(np.float32)
    ours = direct.thomas_multi(*(torch.tensor(a) for a in (L, D, U, Bm)))
    ref = jdirect.thomas_multi(*(jnp.asarray(a) for a in (L, D, U, Bm)))
    assert tuple(ours.shape) == Bm.shape
    _close(ours, ref)


def test_btd_solve_auto_and_cr_flag():
    S, b = _system(9, 3, 2, seed=3)
    St, bt = torch.tensor(S), torch.tensor(b)
    assert torch.equal(direct.btd_solve_auto(St, bt), direct.btd_solve(St, bt))
    assert torch.equal(direct.btd_solve_auto(St, bt, use_cr=False),
                       direct.btd_solve(St, bt))
    assert torch.equal(direct.btd_solve_auto(St, bt, use_cr=True),
                       direct.btd_solve_cr(St, bt))
    x, bad = direct.btd_solve_cr(St, bt, flag=True)
    assert bad.tolist() == [False, False]
    torch.testing.assert_close(x, direct.btd_solve_cr(St, bt), rtol=0, atol=0)
    assert gt.btd_solve is direct.btd_solve
    # An exactly zero pivot (first row and column of problem 1's D_1, an
    # odd row of the first level): the flagged solve stays finite and says so.
    S0 = S.copy()
    S0[1, 1, 1, 0, :] = 0.0
    S0[1, 1, 1, :, 0] = 0.0
    x, bad = direct.btd_solve_cr(torch.tensor(S0), bt, flag=True)
    assert bad.tolist() == [False, True] and bool(torch.isfinite(x).all())


def test_residual_converged_matches_gato_tpu():
    eta = np.array([0.0, 1e-7, 3e-6, 5.0, np.nan, 1e30], np.float32)
    gsq = np.array([0.0, 0.0, 1.0, 1e7, 1.0, 1.0], np.float32)
    ours = direct.residual_converged(torch.tensor(eta), torch.tensor(gsq))
    ref = jdirect.residual_converged(jnp.asarray(eta), jnp.asarray(gsq))
    assert ours.tolist() == np.asarray(ref).tolist() == \
        [True, True, False, True, False, False]
    assert direct.DIRECT_CONV_RTOL == jdirect.DIRECT_CONV_RTOL


def _jbatch(bb):
    return [jnp.asarray(np.asarray(a)) for a in bb]


@pytest.mark.parametrize("shape", SHAPES)
def test_thomas_plain_matches_pallas_interpret(shape):
    spec = gt.ProblemSpec(*shape)
    bb = tt.random_batch(spec, 5, seed0=31)
    ours, dx, du = kt.solve_direct_thomas_cuda(*gt.blocks_to_torch(bb, "cpu"),
                                               rho=1e-2)
    ref, rx, ru = jtb.solve_direct_thomas_batched(*_jbatch(bb), rho=1e-2)
    assert ours.converged.tolist() == np.asarray(ref.converged).tolist() == [True] * 5
    assert ours.iters.tolist() == [0] * 5
    for x, y in ((ours.lam, ref.lam), (dx, rx), (du, ru)):
        _close(x, y, tol=1e-4, atol=1e-5)
    assert float(ours.eta.max()) < 1e-6 and float(np.max(ref.eta)) < 1e-6


def test_thomas_plain_singular_matches_pallas_interpret():
    """One exactly singular problem (zero row/column in Q[2], rho = 0) among
    healthy ones: its lambda, dz and eta turn non-finite and it alone
    reports False, on both sides; the others are what they are alone."""
    spec = gt.ProblemSpec(3, 2, 7)
    good = [tt.random_blocks(spec, seed=s) for s in (1, 2, 4)]
    mix = tt.stack_blocks(good[:1] + [tt.singular_blocks(spec, seed=3, knot=2)]
                          + good[1:])
    ours, dx, du = kt.solve_direct_thomas_cuda(*gt.blocks_to_torch(mix, "cpu"),
                                               rho=0.0)
    ref, rx, ru = jtb.solve_direct_thomas_batched(*_jbatch(mix), rho=0.0)
    assert ours.converged.tolist() == np.asarray(ref.converged).tolist() == \
        [True, False, True, True]
    for t in (ours.lam[1], dx[1], du[1], ours.eta[1]):
        assert not bool(torch.isfinite(t).any())
    assert not np.isfinite(np.asarray(ref.lam)[1]).any()
    keep = [0, 2, 3]
    alone, ax, au = kt.solve_direct_thomas_cuda(
        *gt.blocks_to_torch(tt.stack_blocks(good), "cpu"), rho=0.0)
    for x, y, r in ((ours.lam, alone.lam, ref.lam), (dx, ax, rx), (du, au, ru)):
        assert torch.equal(x[keep], y)
        _close(x[keep], np.asarray(r)[keep], tol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_thomas_forward_stacks_match_condense(shape):
    """theta and phi are S's diagonal and lower blocks, gamma is condense's,
    Cinv the inverses of the block-Thomas pivots, Qinv and Rinv condense's;
    and bhat solves the forward recurrence."""
    spec = gt.ProblemSpec(*shape)
    K = spec.knot_points
    bb = tt.random_batch(spec, 3, seed0=50)
    rho = 1e-2
    f = kt.thomas_fwd_cuda(*gt.blocks_to_torch(bb, "cpu"), rho=rho)
    sys_ = jax.vmap(lambda *xs: jassemble.condense(*xs, rho, None))(*_jbatch(bb))
    S = np.asarray(sys_.S)
    _close(f.theta, S[:, :, 1])
    _close(f.phi, S[:, :, 0])
    _close(f.gamma, sys_.gamma)
    _close(f.Qinv, sys_.Qinv)
    _close(f.Rinv, sys_.Rinv)
    # The pivots C_k = D_k - L_k C_{k-1}^{-1} U_{k-1} of gato_tpu.direct's
    # recurrence, and y_k = gamma_k - L_k C_{k-1}^{-1} y_{k-1}.
    S64, g64 = S.astype(np.float64), np.asarray(sys_.gamma, np.float64)
    c_inv, y = None, None
    for k in range(K):
        if k == 0:
            ck, yk = S64[:, 0, 1], g64[:, 0]
        else:
            w = S64[:, k, 0] @ c_inv
            ck = S64[:, k, 1] - w @ S64[:, k - 1, 2]
            yk = g64[:, k] - np.einsum("bij,bj->bi", w, y)
        c_inv, y = np.linalg.inv(ck), yk
        _close(f.Cinv[:, k], c_inv, tol=1e-4)
        _close(f.bhat[:, k], y, tol=1e-4)


def test_thomas_dispatch_and_wrapper_errors():
    assert kt.MIN_BATCH == jtb._MIN_BATCH == 16
    assert not kt.should_dispatch(15, 50, 14, 7)
    assert kt.should_dispatch(16, 50, 14, 7) and kt.should_dispatch(4096, 50, 14, 7)
    assert not kt.fits(16, 50, 33, 7)
    assert kt.fits(11000, 50, 14, 7) and not kt.fits(11500, 50, 14, 7)
    assert not kt.should_dispatch(11500, 50, 14, 7)
    spec = gt.ProblemSpec(2, 1, 5)
    before = (kt.FWD_LAUNCHES, kt.REV_LAUNCHES)
    b = gt.blocks_to_torch(tt.random_batch(spec, 2), "cpu")
    res, _, _ = kt.solve_direct_thomas_cuda(*b, rho=1e-3)
    assert (kt.FWD_LAUNCHES, kt.REV_LAUNCHES) == before
    assert tuple(res.eta.shape) == (2,)
    meta = gt.blocks_to_torch(tt.random_batch(spec, 1), "meta")
    with pytest.raises(ValueError, match="neither CPU nor CUDA"):
        kt.thomas_fwd_cuda(*meta)
    f = kt.thomas_fwd_plain(*b)
    with pytest.raises(ValueError, match="neither CPU nor CUDA"):
        kt.thomas_rev_cuda(kt.ThomasFactors(*(t.to("meta") for t in f)),
                           meta.q, meta.A, meta.B, meta.r)


def test_direct_float64_end_to_end():
    """The 'torch' backend in float64 against gato_tpu and the dense oracle."""
    spec = gt.ProblemSpec(4, 2, 10)
    blocks = tt.random_blocks(spec, seed=1, dtype=np.float64)
    opts = dict(rho=1e-3, method="direct", dtype="float64")
    ours = gt.solve(spec, blocks, gt.SolverOptions(**opts), device="cpu")
    assert ours.lam.dtype == torch.float64 and int(ours.iters) == 0
    lam_ref, dz_ref = tt.dense_oracle(spec, blocks, rho=1e-3)
    np.testing.assert_allclose(ours.lam_flat(), lam_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ours.dz_flat(), dz_ref, rtol=1e-10, atol=1e-12)
    with jax.enable_x64(True):
        ref = gato_tpu.solve(gato_tpu.ProblemSpec(4, 2, 10),
                             gato_tpu.KKTBlocks(*blocks),
                             gato_tpu.SolverOptions(**opts), pcg_backend="jax")
        _close(ours.lam, ref.lam, tol=1e-10)
        assert bool(ours.converged) == bool(ref.converged)
