"""The CUDA kernel wrappers' plain paths (taken for CPU tensors) against
gato_tpu's Pallas kernels in interpret mode and its pure-JAX path.

The interpret-mode calls are few (four) and at the pendulum shape (2, 1, 5):
they compile slowly on the CPU.  Tolerances: 1e-4 (rtol and atol) in
float32; iteration counts and converged flags equal exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gato_tpu
from gato_tpu.kernels import fused_solve as jfs
from gato_tpu.kernels import pcg_pallas as jpp

import gato_tpu_torch as gt
from gato_tpu_torch import assemble
from gato_tpu_torch import testing as tt
from gato_tpu_torch.kernels import _build
from gato_tpu_torch.kernels import fused_solve as kb
from gato_tpu_torch.kernels import pcg_kernel as ka

torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-4)
PEND = gt.ProblemSpec(2, 1, 5)


def _close(ours, ref):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **F32)


def _same_outcome(ours, ref):
    assert ours.iters.tolist() == np.asarray(ref.iters).tolist()
    assert ours.converged.tolist() == np.asarray(ref.converged).tolist()


@pytest.mark.parametrize("poly", [1, 2])
def test_pcg_kernel_plain_matches_pallas_interpret(poly):
    b = tt.random_batch(PEND, 3, seed0=7)
    sys_ = assemble.condense(*gt.blocks_to_torch(b, "cpu"), 1e-3)
    kw = dict(exit_tol=1e-10, max_iters=300, poly_degree=poly)
    first = ka.pcg_batched_cuda(sys_.S, sys_.Pinv, sys_.gamma, **kw)
    lam0 = torch.zeros_like(sys_.gamma)
    lam0[1] = first.lam[1]                     # one problem warm started
    ours = ka.pcg_batched_cuda(sys_.S, sys_.Pinv, sys_.gamma, lam0, **kw)
    ref = jpp.pcg_fused_batched(
        *(jnp.asarray(t.numpy()) for t in (sys_.S, sys_.Pinv, sys_.gamma, lam0)),
        interpret=True, **kw)
    _same_outcome(ours, ref)
    assert int(ours.iters[1]) <= 1 < int(ours.iters[0])
    _close(ours.lam, ref.lam)
    # eta at exit is round-off (~1e-12 here): both below exit_tol is all
    # that can be compared.
    assert bool((ours.eta < 1e-10).all()) and bool((np.asarray(ref.eta) < 1e-10).all())


def test_fused_plain_matches_pallas_interpret():
    b = tt.random_batch(PEND, 3, seed0=7)
    kw = dict(rho=1e-3, exit_tol=1e-10, max_iters=300)
    ours, dx, du = kb.fused_solve_cuda(*gt.blocks_to_torch(b, "cpu"), **kw)
    ref, rx, ru = jfs.solve_fused_batched(*(jnp.asarray(a) for a in b),
                                          interpret=True, **kw)
    _same_outcome(ours, ref)
    for x, y in ((ours.lam, ref.lam), (dx, rx), (du, ru)):
        _close(x, y)


def test_fused_plain_singular_matches_pallas_interpret():
    """An exactly singular problem among healthy ones: only it is frozen
    (max_iters, unconverged, eta = 1e30), on both sides."""
    mix = tt.stack_blocks([tt.random_blocks(PEND, seed=1),
                           tt.singular_blocks(PEND, seed=3, knot=2),
                           tt.random_blocks(PEND, seed=2)])
    kw = dict(rho=0.0, exit_tol=1e-8, max_iters=40)
    ours, dx, du = kb.fused_solve_cuda(*gt.blocks_to_torch(mix, "cpu"), **kw)
    ref, rx, ru = jfs.solve_fused_batched(*(jnp.asarray(a) for a in mix),
                                          interpret=True, **kw)
    _same_outcome(ours, ref)
    assert ours.converged.tolist() == [True, False, True]
    assert int(ours.iters[1]) == 40
    assert float(ours.eta[1]) == float(np.asarray(ref.eta)[1]) \
        == float(np.float32(1e30))
    for x, y in ((ours.lam, ref.lam), (dx, rx), (du, ru)):
        _close(x, y)


@pytest.mark.parametrize("prec", ["symmetric_stair", "block_jacobi", "jacobi"])
@pytest.mark.parametrize("poly", [1, 2])
def test_fused_plain_matches_jax_path(prec, poly):
    """The plain composite against gato_tpu's pure path, every
    preconditioner and poly degree.  Scalar Jacobi composed to degree 2 is
    the known exception to exact iteration parity (test_precond_poly.py's
    test_fused_scalar_jacobi_poly_degree_converges): the composed
    operator may be indefinite and its exit index depends on the order of
    sums, so there only convergence and the solution are compared, at
    tests/test_precond_poly.py's tolerance for that case (1e-3)."""
    spec = gt.ProblemSpec(4, 2, 8)
    b = tt.random_batch(spec, 4, seed0=60)
    kw = dict(rho=1e-2, exit_tol=1e-8, max_iters=200, poly_degree=poly)
    ours, dx, du = kb.fused_solve_cuda(*gt.blocks_to_torch(b, "cpu"),
                                       preconditioner=prec, **kw)
    opts = gato_tpu.SolverOptions(rho=1e-2, exit_tol=1e-8, max_iters=200,
                                  precond_poly_degree=poly,
                                  preconditioner=prec)
    ref = gato_tpu.solve_batched(gato_tpu.ProblemSpec(4, 2, 8),
                                 gato_tpu.KKTBlocks(*b), opts,
                                 pcg_backend="jax")
    exception = (prec, poly) == ("jacobi", 2)
    if not exception:
        _same_outcome(ours, ref)
    assert bool(ours.converged.all()) and bool(np.asarray(ref.converged).all())
    tol = dict(rtol=1e-3, atol=1e-3) if exception else F32
    for x, y in ((ours.lam, ref.lam), (dx, ref.dz_x), (du, ref.dz_u)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **tol)


def test_cpu_tensors_take_the_plain_path_without_launching():
    before = (ka.LAUNCHES, kb.LAUNCHES)
    b = gt.blocks_to_torch(tt.random_batch(PEND, 2), "cpu")
    res, _, _ = kb.fused_solve_cuda(*b, rho=1e-3)
    sys_ = assemble.condense(*b, 1e-3)
    res_a = ka.pcg_batched_cuda(sys_.S, sys_.Pinv, sys_.gamma)
    assert torch.equal(res_a.iters, res.iters)
    assert (ka.LAUNCHES, kb.LAUNCHES) == before
    assert _build.library.cache_info().currsize == 0  # nothing built


def test_wrapper_argument_errors():
    b = gt.blocks_to_torch(tt.random_batch(PEND, 1), "cpu")
    with pytest.raises(ValueError, match="unknown preconditioner"):
        kb.fused_solve_cuda(*b, preconditioner="ilu")
    meta = gt.blocks_to_torch(tt.random_batch(PEND, 1), "meta")
    with pytest.raises(ValueError, match="neither CPU nor CUDA"):
        kb.fused_solve_cuda(*meta)
    with pytest.raises(ValueError, match="neither CPU nor CUDA"):
        ka.pcg_batched_cuda(torch.empty(1, 5, 3, 2, 2, device="meta"),
                            torch.empty(1, 5, 3, 2, 2, device="meta"),
                            torch.empty(1, 5, 2, device="meta"))


def test_build_is_keyed_by_source_hash():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert _build.source_hash() in path.name
    for name in _build.SOURCES + _build.HEADERS:
        assert (_build.CSRC / name).is_file()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
