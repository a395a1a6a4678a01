"""The cross-backend property sweep of tests/test_property_sweep.py on the
port: the port's three backends ('torch', 'pcg_kernel' and 'fused', their
plain versions here, device="cpu") against gato_tpu's 'jax' backend and
the dense float64 oracle, over the same nine shapes, regularizers,
tolerances and poly degrees, from the same seeds.

Tolerances (tests/test_property_sweep.py's): against gato_tpu, iteration
counts equal, lambda within rtol = atol = 1e-4 of its scale, dz_u within
rtol = atol = 1e-3; the packed surface bit for bit with 'fused'; against
the dense oracle, 2e-3 (PCG at exit_tol 1e-12, and dz of the exact
solves) and 2e-4 (lambda of the exact solves); the exact solve in float64
within 1e-10 of scale.

All nine cases run here: gato_tpu marks five of them slow for its Pallas
interpret mode, and this file runs gato_tpu's 'jax' backend alone.
"""

import dataclasses

import numpy as np
import pytest
import torch

import gato_tpu
from gato_tpu import solver as jsolver

import gato_tpu_torch as gt
from gato_tpu_torch import testing as tt

torch.set_num_threads(1)

BACKENDS = ("torch", "pcg_kernel", "fused")

CASES = [
    # (state, control, K, rho, exit_tol, degree), tests/test_property_sweep.py's
    ((2, 1, 5), 1e-3, 1e-8, 1),        # pendulum shape
    ((2, 1, 5), 1e-3, 1e-8, 2),
    ((5, 4, 7), 1e-2, 1e-10, 1),       # control > state
    ((3, 2, 64), 1e-4, 1e-8, 1),       # longer horizon, tiny rho
    ((3, 2, 64), 1e-4, 1e-8, 3),
    ((9, 5, 21), 1e-1, 1e-6, 2),       # heavy regularization
    ((1, 1, 4), 1e-3, 1e-10, 1),       # minimal sizes
    ((17, 3, 6), 1e-2, 1e-8, 1),       # s past a 16-row tile
    ((2, 1, 2), 1e-3, 1e-8, 1),        # minimal horizon: every knot a boundary
]


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _scaled(got, ref, tol, scale, what):
    np.testing.assert_allclose(_np(got) / scale, _np(ref) / scale, rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("sizes,rho,tol,degree", CASES)
def test_backend_agreement(sizes, rho, tol, degree):
    spec = gt.ProblemSpec(*sizes)
    blocks = tt.random_blocks(spec, seed=hash((spec.nx, spec.nk)) % 1000)
    opts = gt.SolverOptions(rho=rho, exit_tol=tol, max_iters=400,
                            precond_poly_degree=degree)
    ref = jsolver.solve(gato_tpu.ProblemSpec(*sizes), gato_tpu.KKTBlocks(*blocks),
                        gato_tpu.SolverOptions(rho=rho, exit_tol=tol, max_iters=400,
                                               precond_poly_degree=degree),
                        pcg_backend="jax")
    assert bool(ref.converged)
    scale = max(float(np.max(np.abs(np.asarray(ref.lam)))), 1.0)
    for be in BACKENDS:
        got = gt.solve(spec, blocks, opts, pcg_backend=be, device="cpu")
        assert bool(got.converged), (be, sizes)
        assert int(got.iters) == int(ref.iters), (be, sizes)
        _scaled(got.lam, ref.lam, 1e-4, scale, str((be, sizes)))
        np.testing.assert_allclose(_np(got.dz_u), np.asarray(ref.dz_u), rtol=1e-3,
                                   atol=1e-3, err_msg=str((be, sizes)))
        if be == "fused":
            # The packed surface is the same kernel on the same tensors.
            pr = gt.solve_packed(gt.pack(spec, blocks, device="cpu"), opts).unpack()
            for name in ("lam", "dz_x", "dz_u", "iters", "converged", "eta"):
                assert torch.equal(getattr(pr, name), getattr(got, name)), \
                    (name, sizes)


@pytest.mark.parametrize("sizes,rho", [
    ((2, 1, 5), 1e-3),
    ((5, 4, 7), 1e-2),
    ((3, 2, 64), 1e-4),
])
def test_solutions_match_dense_oracle(sizes, rho):
    """All three backends against the float64 dense saddle-point oracle."""
    spec = gt.ProblemSpec(*sizes)
    blocks = tt.random_blocks(spec, seed=3)
    opts = gt.SolverOptions(rho=rho, exit_tol=1e-12, max_iters=500)
    lam_ref, dz_ref = tt.dense_oracle(spec, blocks, rho=rho)
    scale = max(float(np.max(np.abs(lam_ref))), 1.0)
    for be in BACKENDS:
        res = gt.solve(spec, blocks, opts, pcg_backend=be, device="cpu")
        _scaled(res.lam_flat(), lam_ref, 2e-3, scale, be)
        np.testing.assert_allclose(res.dz_flat(), dz_ref, rtol=2e-3, atol=2e-3,
                                   err_msg=be)


@pytest.mark.parametrize("sizes,rho", [
    ((2, 1, 5), 1e-3),
    ((5, 4, 7), 1e-2),
    ((3, 2, 64), 1e-4),
    ((1, 1, 4), 1e-3),
    ((17, 3, 6), 1e-2),
    ((2, 1, 2), 1e-3),                 # minimal horizon
])
def test_direct_backends_match_dense_oracle(sizes, rho):
    """method='direct' on every backend ('fused': row 4's plain version;
    'pcg_kernel': the long-K exact tier's) against the float64 dense
    oracle."""
    spec = gt.ProblemSpec(*sizes)
    blocks = tt.random_blocks(spec, seed=17)
    opts = gt.SolverOptions(rho=rho, method="direct")
    lam_ref, dz_ref = tt.dense_oracle(spec, blocks, rho=rho)
    scale = max(float(np.max(np.abs(lam_ref))), 1.0)
    for be in BACKENDS:
        res = gt.solve(spec, blocks, opts, pcg_backend=be, device="cpu")
        assert int(res.iters) == 0 and bool(res.converged), be
        _scaled(res.lam_flat(), lam_ref, 2e-4, scale, be)
        np.testing.assert_allclose(res.dz_flat(), dz_ref, rtol=2e-3, atol=2e-3,
                                   err_msg=be)


@pytest.mark.parametrize("sizes,rho", [((3, 2, 64), 1e-4), ((17, 3, 6), 1e-2)])
def test_float64_exact_solve_matches_dense_oracle(sizes, rho):
    """In float64 the exact solve ('torch' backend) meets the float64 dense
    oracle within 1e-10 of scale."""
    spec = gt.ProblemSpec(*sizes)
    blocks = tt.random_blocks(spec, seed=17, dtype=np.float64)
    opts = dataclasses.replace(gt.SolverOptions(rho=rho, method="direct"),
                               dtype="float64")
    lam_ref, dz_ref = tt.dense_oracle(spec, blocks, rho=rho)
    res = gt.solve(spec, blocks, opts, device="cpu")
    assert res.lam.dtype == torch.float64
    scale = max(float(np.max(np.abs(lam_ref))), 1.0)
    _scaled(res.lam_flat(), lam_ref, 1e-10, scale, "lam")
    dz_scale = max(float(np.max(np.abs(dz_ref))), 1.0)
    _scaled(res.dz_flat(), dz_ref, 1e-10, dz_scale, "dz")
