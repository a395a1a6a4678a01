"""gato_tpu_torch's blocktri / condense / pcg / recover_dz against gato_tpu's
pure-JAX modules on the same NumPy inputs.

Tolerances: 1e-4 (rtol and atol) in float32, where the two frameworks sum in
different orders; 1e-10 in float64.  PCG iteration counts are equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gato_tpu import assemble as ja
from gato_tpu import blocktri as jb
from gato_tpu import pcg as jp
from gato_tpu import recover as jr
from gato_tpu.problem import Preconditioner as JPrec

import gato_tpu_torch as gt
from gato_tpu_torch import assemble, blocktri, pcg, recover
from gato_tpu_torch import testing as tt

torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-4)
F64 = dict(rtol=1e-10, atol=1e-10)
PRECS = ["symmetric_stair", "block_jacobi", "jacobi"]


def _close(ours, ref, tol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **tol)


def _batch(sizes, n, seed0=0, dtype=np.float32):
    spec = gt.ProblemSpec(*sizes)
    return tt.random_batch(spec, n, seed0=seed0, dtype=dtype)


def test_blocktri_primitives_match():
    rng = np.random.default_rng(0)
    S = rng.normal(size=(2, 6, 3, 4, 4)).astype(np.float32)
    S[:, 0, 0] = 0.0
    S[:, -1, 2] = 0.0
    x = rng.normal(size=(2, 6, 4)).astype(np.float32)
    tS, tx = torch.from_numpy(S), torch.from_numpy(x)
    for i in range(2):
        _close(blocktri.halo_stack(tx)[i], jb.halo_stack(jnp.asarray(x[i])), F32)
        _close(blocktri.btd_matvec(tS, tx)[i],
               jb.btd_matvec(jnp.asarray(S[i]), jnp.asarray(x[i])), F32)
        assert np.array_equal(blocktri.btd_to_dense(tS)[i], jb.btd_to_dense(S[i]))
    dense = blocktri.btd_to_dense(tS)
    np.testing.assert_allclose(
        np.einsum("bij,bj->bi", dense, x.reshape(2, -1)),
        blocktri.btd_matvec(tS, tx).reshape(2, -1).numpy(), **F32)


@pytest.mark.parametrize("n", [3, 14])
def test_block_inv_matches(n):
    rng = np.random.default_rng(n)
    F = rng.normal(size=(5, 4, n, n))
    M = F @ np.swapaxes(F, -1, -2) + n * np.eye(n)
    _close(blocktri.block_inv(torch.from_numpy(M.astype(np.float32))),
           jb.block_inv(jnp.asarray(M, jnp.float32)), F32)
    inv64 = blocktri.block_inv(torch.from_numpy(M))
    np.testing.assert_allclose(inv64.numpy(), np.linalg.inv(M), **F64)
    inv_c, bad = blocktri.block_inv_flag(torch.from_numpy(M))
    assert torch.equal(inv_c, inv64) and not bool(bad.any())


def test_block_inv_flag_on_singular_block():
    M = np.eye(3)[None].repeat(3, 0)
    M[1, 0, 0] = 0.0            # zero pivot, live diagonal -> flagged
    M[2] = 0.0                  # all-zero block is padding -> not flagged
    inv, bad = blocktri.block_inv_flag(torch.from_numpy(M))
    assert bad.tolist() == [False, True, False]
    assert bool(torch.isfinite(inv).all())
    assert not bool(torch.isfinite(blocktri.block_inv(torch.from_numpy(M))).all())


def _jax_condense(b, rho, prec):
    out = jax.vmap(lambda *xs: ja.condense(*xs, rho, JPrec(prec)))(
        *(jnp.asarray(a) for a in b))
    return out


@pytest.mark.parametrize("prec", PRECS)
def test_condense_matches_f32(prec):
    b = _batch((14, 7, 50), 2, seed0=4)
    ours = assemble.condense(*gt.blocks_to_torch(b, "cpu"), 1e-3,
                             gt.Preconditioner(prec))
    ref = _jax_condense(b, jnp.float32(1e-3), prec)
    for name in ("S", "Pinv", "gamma", "Qinv", "Rinv"):
        _close(getattr(ours, name), getattr(ref, name), F32)
    # flag mode: identical on well-posed data, nothing flagged
    flagged = assemble.condense(*gt.blocks_to_torch(b, "cpu"), 1e-3,
                                gt.Preconditioner(prec), flag=True)
    assert flagged.bad.tolist() == [False, False]
    for name in ("S", "Pinv", "gamma", "Qinv", "Rinv"):
        assert torch.equal(getattr(flagged, name), getattr(ours, name))


@pytest.mark.parametrize("prec", PRECS)
def test_condense_matches_f64(prec):
    b = _batch((4, 2, 8), 2, seed0=9, dtype=np.float64)
    ours = assemble.condense(*gt.blocks_to_torch(b, "cpu", torch.float64),
                             1e-2, gt.Preconditioner(prec))
    with jax.enable_x64(True):
        ref = _jax_condense(b, jnp.float64(1e-2), prec)
        assert ref.S.dtype == jnp.float64
        for name in ("S", "Pinv", "gamma", "Qinv", "Rinv"):
            _close(getattr(ours, name), getattr(ref, name), F64)


def _systems(sizes, n, seed0, rho=1e-3, prec="symmetric_stair",
             dtype=np.float32):
    b = _batch(sizes, n, seed0=seed0, dtype=dtype)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    sys_ = assemble.condense(*gt.blocks_to_torch(b, "cpu", tdt), rho,
                             gt.Preconditioner(prec))
    return b, sys_


def _jax_pcg(sys_, lam0=None, **kw):
    S, P, g = (jnp.asarray(t.numpy()) for t in (sys_.S, sys_.Pinv, sys_.gamma))
    if lam0 is None:
        return jax.vmap(lambda a, b, c: jp.pcg(a, b, c, **kw))(S, P, g)
    return jax.vmap(lambda a, b, c, l: jp.pcg(a, b, c, l, **kw))(
        S, P, g, jnp.asarray(lam0.numpy()))


@pytest.mark.parametrize("poly", [1, 2])
def test_pcg_matches_ragged_batch(poly):
    """A batch of IIWA problems converging at different iterations: each
    problem's iterates and exit index are the ones it gets alone."""
    _, sys_ = _systems((14, 7, 50), 6, seed0=20)
    kw = dict(exit_tol=1e-6, max_iters=100, poly_degree=poly)
    ours = pcg.pcg(sys_.S, sys_.Pinv, sys_.gamma, **kw)
    ref = _jax_pcg(sys_, **kw)
    assert len(set(ours.iters.tolist())) > 1  # ragged
    assert ours.iters.tolist() == np.asarray(ref.iters).tolist()
    assert ours.converged.tolist() == np.asarray(ref.converged).tolist()
    _close(ours.lam, ref.lam, F32)
    # alone == in the batch
    one = pcg.pcg(sys_.S[2], sys_.Pinv[2], sys_.gamma[2], **kw)
    assert int(one.iters) == int(ours.iters[2])
    _close(one.lam, ours.lam[2].numpy(), F32)


def test_pcg_warm_start_and_cap():
    _, sys_ = _systems((4, 2, 30), 3, seed0=5)
    cold = pcg.pcg(sys_.S, sys_.Pinv, sys_.gamma, exit_tol=1e-8, max_iters=300)
    warm = pcg.pcg(sys_.S, sys_.Pinv, sys_.gamma, cold.lam, exit_tol=1e-8,
                   max_iters=300)
    ref = _jax_pcg(sys_, cold.lam, exit_tol=1e-8, max_iters=300)
    assert warm.iters.tolist() == np.asarray(ref.iters).tolist()
    assert max(warm.iters.tolist()) <= 1
    _close(warm.lam, ref.lam, F32)
    capped = pcg.pcg(sys_.S, sys_.Pinv, sys_.gamma, exit_tol=1e-30, max_iters=3)
    assert capped.iters.tolist() == [3, 3, 3]
    assert not bool(capped.converged.any())


def test_pcg_zero_rhs_and_frozen():
    _, sys_ = _systems((3, 1, 6), 2, seed0=1)
    gamma = sys_.gamma.clone()
    gamma[0] = 0.0
    frozen = torch.tensor([False, True])
    res = pcg.pcg(sys_.S, sys_.Pinv, gamma, exit_tol=1e-8, max_iters=50,
                  frozen=frozen)
    assert res.iters.tolist() == [0, 50]          # alpha = 0 when nu = 0
    assert res.converged.tolist() == [True, False]
    assert float(res.eta[1]) == float(np.float32(pcg.FROZEN_ETA))
    assert torch.equal(res.lam, torch.zeros_like(res.lam))


@pytest.mark.parametrize("prec", PRECS)
def test_pcg_f64_matches(prec):
    _, sys_ = _systems((4, 2, 8), 3, seed0=11, rho=1e-2, prec=prec,
                       dtype=np.float64)
    kw = dict(exit_tol=1e-20, max_iters=200)
    ours = pcg.pcg(sys_.S, sys_.Pinv, sys_.gamma, **kw)
    with jax.enable_x64(True):
        ref = _jax_pcg(sys_, **kw)
        assert ours.iters.tolist() == np.asarray(ref.iters).tolist()
        _close(ours.lam, ref.lam, F64)


def test_recover_dz_matches():
    b, sys_ = _systems((14, 7, 50), 2, seed0=30)
    rng = np.random.default_rng(1)
    lam = rng.normal(size=(2, 50, 14)).astype(np.float32)
    tb = gt.blocks_to_torch(b, "cpu")
    dz_x, dz_u = recover.recover_dz(sys_.Qinv, sys_.Rinv, tb.A, tb.B, tb.q,
                                    tb.r, torch.from_numpy(lam))
    for i in range(2):
        rx, ru = jr.recover_dz(*(jnp.asarray(t[i].numpy()) for t in
                                 (sys_.Qinv, sys_.Rinv, tb.A, tb.B, tb.q, tb.r)),
                               jnp.asarray(lam[i]))
        _close(dz_x[i], rx, F32)
        _close(dz_u[i], ru, F32)
