"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``; each test skips where torch sees no CUDA device.  This file
imports neither jax nor gato_tpu, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures JAX).  Tolerance: rtol = atol =
1e-4 of each array's scale; iteration counts equal.
"""

import numpy as np
import pytest
import torch

import gato_tpu_torch as gt
from gato_tpu_torch import assemble
from gato_tpu_torch import testing as tt
from gato_tpu_torch.kernels import fused_solve as kb
from gato_tpu_torch.kernels import pcg_kernel as ka

pytestmark = pytest.mark.cuda

SHAPES = [(2, 1, 5), (3, 2, 10), (14, 7, 50), (20, 9, 37)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(a, b):
    a = a.double().cpu().numpy()
    b = b.double().cpu().numpy()
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("sizes", SHAPES)
@pytest.mark.parametrize("poly", [1, 2])
def test_pcg_kernel_matches_plain(dev, sizes, poly):
    spec = gt.ProblemSpec(*sizes)
    b = gt.blocks_to_torch(tt.random_batch(spec, 5, seed0=3), dev)
    sys_ = assemble.condense(*b, 1e-3)
    kw = dict(exit_tol=1e-8, max_iters=200, poly_degree=poly)
    before = ka.LAUNCHES
    got = ka.pcg_batched_cuda(sys_.S, sys_.Pinv, sys_.gamma, **kw)
    torch.cuda.synchronize()
    assert ka.LAUNCHES == before + 1
    ref = ka.pcg_batched_plain(sys_.S, sys_.Pinv, sys_.gamma, **kw)
    assert got.iters.tolist() == ref.iters.tolist()
    assert got.converged.tolist() == ref.converged.tolist()
    _close(got.lam, ref.lam)


@pytest.mark.parametrize("sizes", SHAPES)
@pytest.mark.parametrize("prec", ["symmetric_stair", "block_jacobi", "jacobi"])
def test_fused_kernel_matches_plain(dev, sizes, prec):
    spec = gt.ProblemSpec(*sizes)
    b = gt.blocks_to_torch(tt.random_batch(spec, 5, seed0=8), dev)
    # scalar Jacobi is compared over 10 iterations (see chip_smoke.py)
    kw = dict(rho=1e-3, exit_tol=1e-8,
              max_iters=10 if prec == "jacobi" else 200, preconditioner=prec)
    before = kb.LAUNCHES
    got, gx, gu = kb.fused_solve_cuda(*b, **kw)
    torch.cuda.synchronize()
    assert kb.LAUNCHES == before + 1
    ref, rx, ru = kb.fused_solve_plain(*b, torch.zeros_like(b.q), **kw)
    assert got.iters.tolist() == ref.iters.tolist()
    assert got.converged.tolist() == ref.converged.tolist()
    for x, y in ((got.lam, ref.lam), (gx, rx), (gu, ru)):
        _close(x, y)


def test_fused_kernel_singular_problem_is_frozen(dev):
    spec = gt.ProblemSpec(4, 2, 8)
    mix = tt.stack_blocks([tt.random_blocks(spec, seed=1),
                           tt.singular_blocks(spec, seed=3, knot=2)])
    got, _, _ = kb.fused_solve_cuda(*gt.blocks_to_torch(mix, dev), rho=0.0,
                                    exit_tol=1e-8, max_iters=25)
    assert got.converged.tolist() == [True, False]
    assert int(got.iters[1]) == 25
    assert float(got.eta[1]) == float(np.float32(1e30))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    spec = gt.ProblemSpec(2, 1, 5)
    b64 = gt.blocks_to_torch(tt.random_batch(spec, 1), dev, torch.float64)
    with pytest.raises(ValueError, match="float32"):
        kb.fused_solve_cuda(*b64)
    big = gt.ProblemSpec(33, 1, 3)
    b = gt.blocks_to_torch(tt.random_batch(big, 1), dev)
    with pytest.raises(ValueError, match="<= 32"):
        kb.fused_solve_cuda(*b)


def test_solve_entry_points_on_cuda(dev):
    p = tt.pendulum_problem()
    before = kb.LAUNCHES
    lam, dz = gt.linsys_solve(p.G_row, p.G_col, p.G_val, p.C_row, p.C_col,
                              p.C_val, p.g, p.c, [0.0] * 10, 2, 1e-6, 10,
                              False, 1e-3, verbose=False)
    assert kb.LAUNCHES > before and len(lam) == 10 and len(dz) == 14
    spec = tt.IIWA
    batch = tt.random_batch(spec, 16, seed0=50)
    opts = gt.SolverOptions(rho=1e-3, exit_tol=1e-8)
    got = gt.solve_batched(spec, batch, opts)
    ref = gt.solve_batched(spec, batch, opts, pcg_backend="torch")
    assert got.iters.tolist() == ref.iters.tolist()
    for name in ("lam", "dz_x", "dz_u"):
        _close(getattr(got, name), getattr(ref, name))
