"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``; each test skips where torch sees no CUDA device.  This file
imports neither jax nor gato_tpu, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures JAX).  Tolerance: rtol = atol =
1e-4 of each array's scale; iteration counts equal.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gato_tpu_torch as gt
from gato_tpu_torch import assemble, debug, timing
from gato_tpu_torch import testing as tt
from gato_tpu_torch.kernels import direct_fused as kd
from gato_tpu_torch.kernels import fused_sequence as ks
from gato_tpu_torch.kernels import fused_solve as kb
from gato_tpu_torch.kernels import halo_matvec as hm
from gato_tpu_torch.kernels import longk as kl
from gato_tpu_torch.kernels import pcg_kernel as ka
from gato_tpu_torch.kernels import thomas_batch as kt
from gato_tpu_torch.kernels import probes

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


def _limits(dev):
    props = torch.cuda.get_device_properties(dev)
    return props.multi_processor_count, props.shared_memory_per_block_optin


# Kernel A at every cluster size and at its plan's edges: K = 2, 50 and 688
# (the last horizon before the long-K tier), s = 2, 14, 20 and 32.
PCG_EDGES = [(14, 7, 50), (14, 7, 2), (14, 7, 688), (2, 1, 50), (20, 9, 37), (32, 32, 6)]


@pytest.mark.parametrize("sizes", PCG_EDGES)
@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8, 16])
@pytest.mark.parametrize("poly", [1, 2])
def test_pcg_kernel_matches_plain_at_every_cluster_size(dev, sizes, cluster, poly):
    s, _, K = sizes
    b = gt.blocks_to_torch(tt.random_batch(gt.ProblemSpec(*sizes), 3, seed0=11), dev)
    sys_ = assemble.condense(*b, 1e-3)
    n_sms, limit = _limits(dev)
    kw = dict(exit_tol=1e-6, max_iters=100, poly_degree=poly)
    if cluster is not None and not ka.cluster_fits(K, s, cluster, limit):
        with pytest.raises(ValueError, match="cluster="):
            ka.pcg_batched_cuda(sys_.S, sys_.Pinv, sys_.gamma, cluster=cluster, **kw)
        return
    before = ka.LAUNCHES
    got = ka.pcg_batched_cuda(sys_.S, sys_.Pinv, sys_.gamma, cluster=cluster, **kw)
    torch.cuda.synchronize()
    assert ka.LAUNCHES == before + 1
    assert ka.LAST_CLUSTER == (cluster or ka.cluster_size(3, K, s, n_sms, limit))
    ref = ka.pcg_batched_plain(sys_.S, sys_.Pinv, sys_.gamma, **kw)
    _iters_agree(got, ref, 1e-6)
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


# Kernel B and the farm kernel at every cluster size: IIWA and pendulum
# widths, an odd width, and K at the edge of fused_solve.fits (IIWA 688).
CLUSTER_SHAPES = [(14, 7, 50), (2, 1, 5), (5, 3, 20), (14, 7, 688)]


def _iters_agree(got, ref, exit_tol):
    """Equal exit indices, or one apart where the earlier exit's eta lies
    within 1e-3 of exit_tol (a float32 round-off tie, the documented
    exception to equal iteration counts)."""
    for gi, ri, ge, re_ in zip(got.iters.tolist(), ref.iters.tolist(),
                               got.eta.tolist(), ref.eta.tolist()):
        if gi != ri:
            early = ge if gi < ri else re_
            assert abs(gi - ri) == 1 and abs(early - exit_tol) <= 1e-3 * exit_tol, \
                (gi, ri, ge, re_)
    assert got.converged.tolist() == ref.converged.tolist()


@pytest.mark.parametrize("sizes", CLUSTER_SHAPES)
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("prec", ["symmetric_stair", "block_jacobi", "jacobi"])
@pytest.mark.parametrize("poly", [1, 2])
def test_fused_kernel_matches_plain_at_every_cluster_size(dev, sizes, cluster, prec, poly):
    spec = gt.ProblemSpec(*sizes)
    K = spec.knot_points
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if cluster > K or not kb.cluster_fits(K, *sizes[:2], cluster, limit):
        with pytest.raises(ValueError, match="cluster="):
            kb.fused_solve_cuda(*gt.blocks_to_torch(tt.random_batch(spec, 1), dev),
                                cluster=cluster)
        return
    # the data of test_fused_kernel_matches_plain
    b = gt.blocks_to_torch(tt.random_batch(spec, 1 if K > 100 else 5, seed0=8), dev)
    # scalar Jacobi over a capped run, as in chip_smoke.py.  Composed to
    # degree 2 it may be indefinite (the exception gato_tpu's
    # tests/test_precond_poly.py documents), and
    # float32 round-off parts the plain version's own lambda from its
    # float64 run by 1.1e-4 of scale after 3 iterations at (5, 3, 20)
    # (2.6e-6 at most after 2, at every shape here; measured on the CPU).
    cap = {("jacobi", 1): 10, ("jacobi", 2): 2}.get((prec, poly), 300)
    kw = dict(rho=1e-3, exit_tol=1e-8, max_iters=cap, preconditioner=prec,
              poly_degree=poly)
    before = kb.LAUNCHES
    got, gx, gu = kb.fused_solve_cuda(*b, cluster=cluster, **kw)
    torch.cuda.synchronize()
    assert kb.LAUNCHES == before + 1 and kb.LAST_CLUSTER == cluster
    ref, rx, ru = kb.fused_solve_plain(*b, torch.zeros_like(b.q), **kw)
    _iters_agree(got, ref, 1e-8)
    for x, y in ((got.lam, ref.lam), (gx, rx), (gu, ru)):
        _close(x, y)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_singular_problem_is_frozen_at_every_cluster_size(dev, cluster):
    spec = gt.ProblemSpec(4, 2, 8)
    mix = tt.stack_blocks([tt.random_blocks(spec, seed=1),
                           tt.singular_blocks(spec, seed=3, knot=2),
                           tt.random_blocks(spec, seed=2)])
    b = gt.blocks_to_torch(mix, dev)
    got, gx, gu = kb.fused_solve_cuda(*b, rho=0.0, exit_tol=1e-8, max_iters=25,
                                      cluster=cluster)
    assert got.converged.tolist() == [True, False, True]
    assert int(got.iters[1]) == 25
    assert float(got.eta[1]) == float(np.float32(1e30))
    assert torch.equal(got.lam[1], torch.zeros_like(got.lam[1]))
    ref, rx, ru = kb.fused_solve_plain(*b, torch.zeros_like(b.q), rho=0.0,
                                       exit_tol=1e-8, max_iters=25)
    for x, y in ((got.lam, ref.lam), (gx, rx), (gu, ru)):
        _close(x, y)


@pytest.mark.parametrize("sizes", CLUSTER_SHAPES)
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_farm_equals_chained_kernel_b_at_every_cluster_size(dev, sizes, cluster):
    """The farm kernel at a forced C equals T chained kernel-B launches at
    the same C bit for bit, and its plain version within 1e-4 of scale;
    one step with a singular Q is frozen alone and hands lambda_0 on."""
    spec = gt.ProblemSpec(*sizes)
    K = spec.knot_points
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if cluster > K or not kb.cluster_fits(K, *sizes[:2], cluster, limit):
        with pytest.raises(ValueError, match="cluster="):
            farm = gt.blocks_to_torch(tt.random_farm(spec, 1, 1), dev)
            ks.fused_sequence_cuda(*farm, torch.zeros_like(farm.q[0]),
                                   torch.zeros(1, device=dev), cluster=cluster)
        return
    T, B = 4, 1 if K > 100 else 3
    farm = tt.random_farm(spec, T, B, seed0=17)
    if sizes == (14, 7, 50):
        Q = farm.Q.copy()
        Q[2, 0] = tt.singular_blocks(spec, seed=3, knot=1).Q
        farm = farm._replace(Q=Q)
    b = gt.blocks_to_torch(farm, dev)
    lam = torch.randn(B, K, spec.state_size, device=dev) * 0.1
    rhos = torch.tensor([1e-3, 1e-2, 1e-3, 3e-3], device=dev)
    if sizes == (14, 7, 50):
        rhos[2] = 0.0
    kw = dict(exit_tol=1e-8, max_iters=300, poly_degree=2)
    before = ks.LAUNCHES
    got, gx, gu = ks.fused_sequence_cuda(*b, lam, rhos, cluster=cluster, **kw)
    assert ks.LAUNCHES == before + 1 and ks.LAST_CLUSTER == cluster
    ref, rx, ru = ks.fused_sequence_plain(*b, lam, rhos, **kw)
    lam0 = lam
    for t in range(T):
        res, dx, du = kb.fused_solve_cuda(*(a[t] for a in b), lam0,
                                          rho=float(rhos[t]), cluster=cluster, **kw)
        for x, y in ((got.lam[t], res.lam), (gx[t], dx), (gu[t], du),
                     (got.iters[t], res.iters), (got.eta[t], res.eta),
                     (got.converged[t], res.converged)):
            assert torch.equal(x, y), t
        lam0 = res.lam
    if sizes == (14, 7, 50):
        assert not bool(got.converged[2, 0]) and int(got.iters[2, 0]) == 300
        assert torch.equal(got.lam[2, 0], got.lam[1, 0])
    assert got.converged.tolist() == ref.converged.tolist()
    for t in range(T):
        _iters_agree(gt.SolveResult(*(x[t] for x in (got.lam, gx, gu, got.iters,
                                                     got.converged, got.eta))),
                     gt.SolveResult(*(x[t] for x in (ref.lam, rx, ru, ref.iters,
                                                     ref.converged, ref.eta))), 1e-8)
    for x, y in ((got.lam, ref.lam), (gx, rx), (gu, ru)):
        _close(x, y)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    spec = gt.ProblemSpec(2, 1, 5)
    b64 = gt.blocks_to_torch(tt.random_batch(spec, 1), dev, torch.float64)
    with pytest.raises(ValueError, match="float32"):
        kb.fused_solve_cuda(*b64)
    big = gt.ProblemSpec(33, 1, 3)
    b = gt.blocks_to_torch(tt.random_batch(big, 1), dev)
    with pytest.raises(ValueError, match="<= 32"):
        kb.fused_solve_cuda(*b)
    b = gt.blocks_to_torch(tt.random_batch(spec, 1), dev)
    for cluster in (3, 8, 32, 0):   # not a cluster size, or more CTAs than knots
        with pytest.raises(ValueError, match="cluster="):
            kb.fused_solve_cuda(*b, cluster=cluster)


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


@pytest.mark.parametrize("sizes", SHAPES)
@pytest.mark.parametrize("prec", ["symmetric_stair", "block_jacobi", "jacobi"])
def test_sequence_kernel_matches_plain(dev, sizes, prec):
    spec = gt.ProblemSpec(*sizes)
    T, B = 4, 5
    b = gt.blocks_to_torch(tt.random_farm(spec, T, B, seed0=12), dev)
    lam0 = torch.zeros_like(b.q[0])
    rhos = torch.tensor([1e-3, 1e-2, 1e-3, 3e-3], device=dev)
    # scalar Jacobi is compared over 10 iterations (see chip_smoke.py)
    kw = dict(exit_tol=1e-8, max_iters=10 if prec == "jacobi" else 200,
              preconditioner=prec)
    before = ks.LAUNCHES
    got, gx, gu = ks.fused_sequence_cuda(*b, lam0, rhos, **kw)
    torch.cuda.synchronize()
    assert ks.LAUNCHES == before + 1
    ref, rx, ru = ks.fused_sequence_plain(*b, lam0, rhos, **kw)
    assert got.iters.tolist() == ref.iters.tolist()
    assert got.converged.tolist() == ref.converged.tolist()
    for x, y in ((got.lam, ref.lam), (gx, rx), (gu, ru)):
        _close(x, y)


@pytest.mark.parametrize("sizes", SHAPES)
@pytest.mark.parametrize("wide", [False, True])
def test_sequence_kernel_equals_chained_kernel_b(dev, sizes, wide):
    """Step t of one sequence launch equals kernel B launched with step
    t-1's lambda and rhos[t], bit for bit; with more streams than SMs the
    rule takes its floor (the smallest cluster size whose records fit
    shared memory), for the farm and for kernel B alike."""
    spec = gt.ProblemSpec(*sizes)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    T, B = 4, sms + 8 if wide else 3
    b = gt.blocks_to_torch(tt.random_farm(spec, T, B, seed0=13), dev)
    lam = torch.randn(B, spec.knot_points, spec.state_size, device=dev) * 0.1
    rhos = torch.tensor([1e-3, 1e-2, 1e-3, 3e-3], device=dev)
    kw = dict(exit_tol=1e-8, max_iters=200, poly_degree=2)
    got, gx, gu = ks.fused_sequence_cuda(*b, lam, rhos, **kw)
    for t in range(T):
        res, dx, du = kb.fused_solve_cuda(*(a[t] for a in b), lam,
                                          rho=float(rhos[t]), **kw)
        for x, y in ((got.lam[t], res.lam), (gx[t], dx), (gu[t], du),
                     (got.iters[t], res.iters), (got.eta[t], res.eta)):
            assert torch.equal(x, y), t
        lam = res.lam


def test_sequence_kernel_singular_step_is_frozen_alone(dev):
    spec = gt.ProblemSpec(4, 2, 8)
    T, B = 4, 2
    farm = tt.random_farm(spec, T, B, seed0=30)
    Q = farm.Q.copy()
    Q[2, 1] = tt.singular_blocks(spec, seed=3, knot=2).Q
    b = gt.blocks_to_torch(farm._replace(Q=Q), dev)
    got, _, _ = ks.fused_sequence_cuda(*b, torch.zeros_like(b.q[0]),
                                       torch.zeros(T, device=dev),
                                       exit_tol=1e-8, max_iters=25)
    conv = got.converged.cpu().numpy()
    assert not conv[2, 1] and conv.sum() == T * B - 1
    assert int(got.iters[2, 1]) == 25
    assert float(got.eta[2, 1]) == float(np.float32(1e30))
    assert torch.equal(got.lam[2, 1], got.lam[1, 1])


def test_mpc_and_packed_entry_points_launch_the_kernels(dev):
    spec = gt.ProblemSpec(4, 2, 12)
    farm = tt.random_farm(spec, 3, 4, seed0=40)
    opts = gt.SolverOptions(rho=1e-3, exit_tol=1e-8)
    before = ks.LAUNCHES
    got = gt.solve_sequence_batched(spec, farm, opts)
    torch.cuda.synchronize()
    assert ks.LAUNCHES == before + 1
    ref = gt.solve_sequence_batched(spec, farm, opts, pcg_backend="torch")
    assert got.iters.tolist() == ref.iters.tolist()
    for name in ("lam", "dz_x", "dz_u"):
        _close(getattr(got, name), getattr(ref, name))
    before = ks.LAUNCHES
    seq = gt.pack_sequence(spec, farm)
    out = gt.solve_packed_sequence(seq, opts)
    assert ks.LAUNCHES == before + 1
    assert torch.equal(out.lam_p, got.lam)
    before = kb.LAUNCHES
    packed = gt.pack(spec, gt.KKTBlocks(*(a[0] for a in farm)))
    res = gt.solve_packed(packed, opts)
    assert kb.LAUNCHES == before + 1
    assert torch.equal(res.lam_p, got.lam[0])


def test_fused_routes_refuse_a_horizon_past_shared_memory(dev):
    """Kernel B and the farm kernel past their shared memory: an explicit
    'fused' raises naming the routes that serve the horizon (auto and
    'pcg_kernel' take the long-K tier there)."""
    spec = gt.ProblemSpec(14, 7, 1000)
    farm = tt.random_farm(spec, 1, 1, seed0=0)
    with pytest.raises(ValueError, match=r"None \(auto\) or 'pcg_kernel'"):
        gt.solve_sequence_batched(spec, farm, pcg_backend="fused")
    one = gt.blocks_to_torch(tt.random_batch(spec, 1), dev)
    with pytest.raises(ValueError, match=r"None \(auto\) or 'pcg_kernel'"):
        kb.fused_solve_cuda(*one)
    with pytest.raises(ValueError, match=r"None \(auto\) or 'pcg_kernel'"):
        ks.fused_sequence_cuda(*(a.unsqueeze(0) for a in one), torch.zeros_like(one.q),
                               torch.zeros(1, device=dev))


# K = 2 is the shortest horizon (one cyclic-reduction level); s = 20 takes
# the forward walk's block-wide Gauss-Jordan, s <= 16 its warp one.
DIRECT_SHAPES = [(3, 2, 2), (2, 1, 5), (3, 2, 7), (4, 2, 8), (6, 3, 9),
                 (14, 7, 50), (20, 9, 37)]


def _direct_outcome(got, ref, gamma):
    """Exact solves: converged equal, iters 0, and eta (a squared residual
    at round-off level) equal within 1e-10 (1 + ||gamma||^2): a relative
    residual of 1e-5, float32 round-off for these systems."""
    assert got.converged.tolist() == ref.converged.tolist()
    assert got.iters.tolist() == [0] * len(got.iters)
    e, r = got.eta.double().cpu().numpy(), ref.eta.double().cpu().numpy()
    g2 = (gamma.double() ** 2).sum(dim=(-2, -1)).cpu().numpy()
    assert np.all(np.abs(e - r) <= 1e-10 * (1 + g2)), (e, r, g2)


@pytest.mark.parametrize("sizes", DIRECT_SHAPES)
@pytest.mark.parametrize("B", [1, 15])
def test_direct_fused_kernel_matches_plain(dev, sizes, B):
    spec = gt.ProblemSpec(*sizes)
    b = gt.blocks_to_torch(tt.random_batch(spec, B, seed0=21), dev)
    before = kd.LAUNCHES
    got, gx, gu = kd.direct_fused_cuda(*b, rho=1e-3)
    torch.cuda.synchronize()
    assert kd.LAUNCHES == before + 1
    ref, rx, ru = kd.direct_fused_plain(*b, rho=1e-3)
    _direct_outcome(got, ref, assemble.condense(*b, 1e-3, None).gamma)
    assert bool(got.converged.all())
    for x, y in ((got.lam, ref.lam), (gx, rx), (gu, ru)):
        _close(x, y)


# Row 4 at every cluster size and at its plan's edges: K = 2, 3, 50, an odd
# K and 740 (the last horizon it serves, records in the global slice), the
# pendulum's and wide widths.
ROW4_EDGES = [(14, 7, 50), (14, 7, 2), (14, 7, 3), (14, 7, 51), (14, 7, 740),
              (2, 1, 5), (20, 9, 37), (32, 32, 6)]


@pytest.mark.parametrize("sizes", ROW4_EDGES)
@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8, 16])
@pytest.mark.parametrize("B", [1, 15])
def test_direct_fused_kernel_matches_plain_at_every_cluster_size(dev, sizes, cluster, B):
    s, c, K = sizes
    b = gt.blocks_to_torch(tt.random_batch(gt.ProblemSpec(*sizes), B, seed0=23), dev)
    n_sms, limit = _limits(dev)
    if cluster is not None and not kd.cluster_fits(K, s, c, cluster, limit):
        with pytest.raises(ValueError, match="cluster="):
            kd.direct_fused_cuda(*b, rho=1e-3, cluster=cluster)
        return
    before = kd.LAUNCHES
    got, gx, gu = kd.direct_fused_cuda(*b, rho=1e-3, cluster=cluster)
    torch.cuda.synchronize()
    assert kd.LAUNCHES == before + 1
    assert kd.LAST_CLUSTER == (cluster or kd.cluster_size(B, K, s, c, n_sms, limit))
    ref, rx, ru = kd.direct_fused_plain(*b, rho=1e-3)
    _direct_outcome(got, ref, assemble.condense(*b, 1e-3, None).gamma)
    assert bool(got.converged.all())
    for x, y in ((got.lam, ref.lam), (gx, rx), (gu, ru)):
        _close(x, y)


def test_direct_fused_kernel_matches_plain_at_a_wide_batch(dev):
    """IIWA K = 50, B = 256: the rule's floor (C = 2, records in shared
    memory), B C CTAs in waves."""
    b = gt.blocks_to_torch(tt.random_batch(tt.IIWA, 256, seed0=24), dev)
    got, gx, gu = kd.direct_fused_cuda(*b, rho=1e-3)
    torch.cuda.synchronize()
    assert kd.LAST_CLUSTER == 2
    ref, rx, ru = kd.direct_fused_plain(*b, rho=1e-3)
    _direct_outcome(got, ref, assemble.condense(*b, 1e-3, None).gamma)
    for x, y in ((got.lam, ref.lam), (gx, rx), (gu, ru)):
        _close(x, y)


@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8, 16])
def test_direct_fused_singular_contract_at_every_cluster_size(dev, cluster):
    """One exactly singular IIWA problem between two healthy ones: finite
    outputs, eta >= 1e30 and converged False for it alone, the others as
    their plain versions."""
    mix = tt.stack_blocks([tt.random_blocks(tt.IIWA, seed=40),
                           tt.singular_blocks(tt.IIWA, seed=3, knot=2),
                           tt.random_blocks(tt.IIWA, seed=41)])
    b = gt.blocks_to_torch(mix, dev)
    got, gx, gu = kd.direct_fused_cuda(*b, rho=0.0, cluster=cluster)
    torch.cuda.synchronize()
    assert got.converged.tolist() == [True, False, True]
    assert float(got.eta[1]) >= 1e30
    for x in (got.lam, gx, gu):
        assert bool(torch.isfinite(x).all())
    ref, rx, ru = kd.direct_fused_plain(*b, rho=0.0)
    for x, y in ((got.lam, ref.lam), (gx, rx), (gu, ru)):
        _close(x[[0, 2]], y[[0, 2]])


@pytest.mark.parametrize("sizes", DIRECT_SHAPES)
@pytest.mark.parametrize("B", [16, 40])
def test_thomas_kernels_match_plain(dev, sizes, B):
    spec = gt.ProblemSpec(*sizes)
    b = gt.blocks_to_torch(tt.random_batch(spec, B, seed0=22), dev)
    before = (kt.FWD_LAUNCHES, kt.REV_LAUNCHES)
    fk = kt.thomas_fwd_cuda(*b, rho=1e-3)
    got, gx, gu = kt.thomas_rev_cuda(fk, b.q, b.A, b.B, b.r)
    torch.cuda.synchronize()
    assert (kt.FWD_LAUNCHES, kt.REV_LAUNCHES) == (before[0] + 1, before[1] + 1)
    fp = kt.thomas_fwd_plain(*b, rho=1e-3)
    for name, x, y in zip(kt.ThomasFactors._fields, fk, fp):
        _close(x, y)
    ref, rx, ru = kt.thomas_rev_plain(fp, b.q, b.A, b.B, b.r)
    _direct_outcome(got, ref, fp.gamma)
    assert bool(got.converged.all())
    for x, y in ((got.lam, ref.lam), (gx, rx), (gu, ru)):
        _close(x, y)
    # the reverse kernel on the plain stacks: the same back-substitution
    again, _, _ = kt.thomas_rev_cuda(fp, b.q, b.A, b.B, b.r)
    _close(again.lam, ref.lam)


# Row 5's plan at its edges: K = 2, odd K, the horizons the exact routes
# take it to (741, 1024, 8192), B around the walks' CTA count, and the
# wide walk (s = 20, 32).
THOMAS_EDGES = [((14, 7, 2), 1), ((14, 7, 3), 15), ((14, 7, 51), 16), ((14, 7, 50), 256),
                ((14, 7, 741), 16), ((14, 7, 1024), 16), ((14, 7, 1024), 256),
                ((14, 7, 8192), 1), ((20, 9, 37), 16), ((20, 9, 2), 15),
                ((32, 32, 6), 16), ((32, 32, 3), 256), ((16, 5, 9), 133), ((5, 7, 5), 16)]


@pytest.mark.parametrize("sizes,B", THOMAS_EDGES)
def test_thomas_forward_matches_plain_at_the_plan_edges(dev, sizes, B):
    """Row 5's two launches (condensation tiles, one warp a walk) against
    thomas_fwd_plain: every factor stack, and the pair's outcome."""
    spec = gt.ProblemSpec(*sizes)
    b = gt.blocks_to_torch(tt.random_batch(spec, B, seed0=23), dev)
    before = kt.FWD_LAUNCHES
    fk = kt.thomas_fwd_cuda(*b, rho=1e-3)
    torch.cuda.synchronize()
    assert kt.FWD_LAUNCHES == before + 1
    fp = kt.thomas_fwd_plain(*b, rho=1e-3)
    for name, x, y in zip(kt.ThomasFactors._fields, fk, fp):
        _close(x, y)
    got, gx, gu = kt.thomas_rev_cuda(fk, b.q, b.A, b.B, b.r)
    ref, rx, ru = kt.thomas_rev_plain(fp, b.q, b.A, b.B, b.r)
    _direct_outcome(got, ref, fp.gamma)
    assert bool(got.converged.all())
    for x, y in ((got.lam, ref.lam), (gx, rx), (gu, ru)):
        _close(x, y)


def test_thomas_forward_poisons_each_knot_as_plain(dev):
    """A zero row and column in Q[2] at rho = 0, and a zero R[4]: bhat is
    non-finite from the first clamped knot on, exactly where the plain
    version's is, in that problem alone."""
    spec = gt.ProblemSpec(4, 2, 8)
    good = [tt.random_blocks(spec, seed=s) for s in (1, 2)]
    bad = tt.singular_blocks(spec, seed=3, knot=2)
    bad_r = tt.random_blocks(spec, seed=4)
    bad_r.R[4] = 0.0
    bad_r.R[4][1, 1] = 1.0
    b = gt.blocks_to_torch(tt.stack_blocks([good[0], bad, good[1], bad_r]), dev)
    fk = kt.thomas_fwd_cuda(*b, rho=0.0)
    fp = kt.thomas_fwd_plain(*b, rho=0.0)
    torch.cuda.synchronize()
    assert torch.equal(torch.isfinite(fk.bhat).cpu(), torch.isfinite(fp.bhat).cpu())
    assert not bool(torch.isfinite(fk.bhat[1, 2:]).any())
    assert bool(torch.isfinite(fk.bhat[1, :2]).all())
    assert not bool(torch.isfinite(fk.bhat[3, 5:]).all())
    for i in (0, 2):
        for x, y in zip(fk, fp):
            _close(x[i], y[i])


# Row 6's walk and epilogue at their plan's edges: IIWA K = 2, 3, 50 and
# 1024 at B = 1, 16 and 256 (one or two walks a CTA; epilogue tiles of one
# knot, a partial tile, many tiles), and the padded widths s = 5, 16, 20.
REV_EDGES = ([((14, 7, K), B) for K in (2, 3, 50, 1024) for B in (1, 16, 256)]
             + [((5, 3, 9), 1), ((5, 3, 9), 16), ((16, 5, 9), 16), ((20, 9, 37), 16)])


@pytest.mark.parametrize("sizes,B", REV_EDGES)
def test_thomas_reverse_matches_plain_at_the_plan_edges(dev, sizes, B):
    """Row 6 on the plain forward's stacks: its walk's lambda against
    thomas_rev_plain, its epilogue's dz, eta and converged against both
    thomas_rev_plain and the knot-parallel thomas_epilogue_plain on the
    kernel's own lambda; one count a call for each launch."""
    b = gt.blocks_to_torch(tt.random_batch(gt.ProblemSpec(*sizes), B, seed0=26), dev)
    f = kt.thomas_fwd_plain(*b, rho=1e-3)
    before = (kt.REV_LAUNCHES, kt.EPILOGUE_LAUNCHES)
    got, gx, gu = kt.thomas_rev_cuda(f, b.q, b.A, b.B, b.r)
    torch.cuda.synchronize()
    assert (kt.REV_LAUNCHES, kt.EPILOGUE_LAUNCHES) == (before[0] + 1, before[1] + 1)
    ref, rx, ru = kt.thomas_rev_plain(f, b.q, b.A, b.B, b.r)
    _direct_outcome(got, ref, f.gamma)
    assert bool(got.converged.all())
    for x, y in ((got.lam, ref.lam), (gx, rx), (gu, ru)):
        _close(x, y)
    epi, ex, eu = kt.thomas_epilogue_plain(f, b.q, b.A, b.B, b.r, got.lam)
    _direct_outcome(got, epi, f.gamma)
    _close(gx, ex)
    _close(gu, eu)


@pytest.mark.parametrize("sizes", [(14, 7, 50), (5, 3, 9)])
def test_thomas_reverse_singular_mix(dev, sizes):
    """An exactly singular problem among 16 healthy ones through rows 5
    and 6: its lambda, dz and eta non-finite and converged False; the
    others bit for bit as a run without it, and as the plain pair."""
    spec = gt.ProblemSpec(*sizes)
    good = [tt.random_blocks(spec, seed=s) for s in range(60, 76)]
    b = gt.blocks_to_torch(tt.stack_blocks(
        good[:1] + [tt.singular_blocks(spec, seed=3, knot=2)] + good[1:]), dev)
    got, gx, gu = kt.solve_direct_thomas_cuda(*b, rho=0.0)
    keep = [0] + list(range(2, 17))
    alone, ax, au = kt.solve_direct_thomas_cuda(*(a[keep] for a in b), rho=0.0)
    torch.cuda.synchronize()
    assert got.converged.tolist() == [True, False] + [True] * 15
    for x in (got.lam, gx, gu, got.eta):
        assert not bool(torch.isfinite(x[1]).any())
    for x, y in ((got.lam, alone.lam), (gx, ax), (gu, au), (got.eta, alone.eta)):
        assert torch.equal(x[keep], y)
    ref, rx, ru = kt.solve_direct_thomas_plain(*b, rho=0.0)
    for x, y in ((got.lam, ref.lam), (gx, rx), (gu, ru)):
        _close(x[keep], y[keep])


def test_direct_kernels_singular_contracts(dev):
    """One exactly singular problem among healthy ones: row 4 reports it
    finite with eta = 1e30, rows 5-6 non-finite; the others are untouched
    and converge in both."""
    spec = gt.ProblemSpec(4, 2, 8)
    good = [tt.random_blocks(spec, seed=s) for s in range(1, 17)]
    mix = tt.stack_blocks(good[:1] + [tt.singular_blocks(spec, seed=3, knot=2)]
                          + good[1:])
    b = gt.blocks_to_torch(mix, dev)
    row4, dx4, du4 = kd.direct_fused_cuda(*b, rho=0.0)
    assert row4.converged.tolist() == [True, False] + [True] * 15
    assert float(row4.eta[1]) >= 1e30
    for t in (row4.lam, dx4, du4):
        assert bool(torch.isfinite(t).all())
    thom, dxt, dut = kt.solve_direct_thomas_cuda(*b, rho=0.0)
    assert thom.converged.tolist() == [True, False] + [True] * 15
    assert not bool(torch.isfinite(thom.eta[1]))
    for t in (thom.lam, dxt, dut):
        assert not bool(torch.isfinite(t[1]).all())
    keep = [0] + list(range(2, 17))
    alone, ax, au = kt.solve_direct_thomas_cuda(*(a[keep] for a in b), rho=0.0)
    for x, y in ((thom.lam[keep], alone.lam), (dxt[keep], ax), (dut[keep], au)):
        assert torch.equal(x, y)


def test_direct_entry_points_launch_the_kernels(dev):
    spec = gt.ProblemSpec(6, 3, 12)
    opts = gt.SolverOptions(rho=1e-3, method="direct")
    one = tt.random_blocks(spec, seed=5)
    before = kd.LAUNCHES
    got = gt.solve(spec, one, opts)
    assert kd.LAUNCHES == before + 1
    ref = gt.solve(spec, one, opts, pcg_backend="torch")
    for name in ("lam", "dz_x", "dz_u"):
        _close(getattr(got, name), getattr(ref, name))
    assert bool(got.converged) and int(got.iters) == 0
    batch = tt.random_batch(spec, 20, seed0=60)
    before = (kd.LAUNCHES, kt.FWD_LAUNCHES, kt.REV_LAUNCHES)
    small = gt.solve_batched(spec, tt.stack_blocks([one] * 8), opts)
    wide = gt.solve_batched(spec, batch, opts)
    assert (kd.LAUNCHES, kt.FWD_LAUNCHES, kt.REV_LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    assert bool(small.converged.all()) and bool(wide.converged.all())
    ref = gt.solve_batched(spec, batch, opts, pcg_backend="torch")
    for name in ("lam", "dz_x", "dz_u"):
        _close(getattr(wide, name), getattr(ref, name))
    farm = tt.random_farm(spec, 4, 5, seed0=70)
    rhos = [1e-3, 2e-3, 1e-3, 2e-3]
    before = kt.FWD_LAUNCHES
    seq = gt.solve_sequence_batched(spec, farm, opts, rhos=rhos)
    assert kt.FWD_LAUNCHES == before + 1
    for t in range(4):
        step = gt.solve_batched(spec, gt.KKTBlocks(*(a[t] for a in farm)),
                                gt.SolverOptions(rho=rhos[t], method="direct"),
                                pcg_backend="torch")
        _close(seq.lam[t], step.lam)
    before = (kd.LAUNCHES, kt.FWD_LAUNCHES)
    for tier in ("cr", "thomas"):
        packed = gt.pack(spec, batch, method="direct", tier=tier)
        res = gt.solve_packed(packed, opts).unpack()
        _close(res.lam, ref.lam)
    assert (kd.LAUNCHES, kt.FWD_LAUNCHES) == (before[0] + 1, before[1] + 1)


def test_direct_refuses_a_horizon_past_shared_memory(dev):
    """Row 4 past its shared memory: an explicit 'fused' and the wrapper
    raise naming the route that serves the horizon (auto and 'pcg_kernel'
    take the long-K exact tier there)."""
    spec = gt.ProblemSpec(14, 7, 1000)
    one = tt.random_blocks(spec, seed=0)
    with pytest.raises(ValueError, match=r"None \(auto\) or 'pcg_kernel'"):
        gt.solve(spec, one, gt.SolverOptions(method="direct"), pcg_backend="fused")
    with pytest.raises(ValueError, match=r"None \(auto\) or 'pcg_kernel'"):
        kd.direct_fused_cuda(*gt.blocks_to_torch(tt.stack_blocks([one]), dev))


# The long-K tier (rows 7, 8/10, 9 and 13): (K, B, preconditioner, poly,
# max_iters) at IIWA widths; row 8's shape (K=2048) and row 10's (K=8192);
# the edges of the PCG kernel's split: K = 689 (just past kernel B) and
# 1025 (not a multiple of the CTAs a problem, a short last CTA), three
# Horner terms, and a batch whose operators stream.
LONGK_CASES = [(1024, 1, "symmetric_stair", 1, 100), (1024, 4, "block_jacobi", 2, 100),
               (1024, 4, "jacobi", 1, 10), (2048, 1, "symmetric_stair", 1, 100),
               (8192, 1, "symmetric_stair", 1, 100), (689, 1, "symmetric_stair", 1, 100),
               (1025, 1, "symmetric_stair", 1, 100), (1025, 3, "block_jacobi", 1, 100),
               (700, 2, "symmetric_stair", 3, 100), (2048, 16, "symmetric_stair", 1, 100)]


@pytest.mark.parametrize("K,B,prec,poly,cap", LONGK_CASES)
def test_longk_kernels_match_plain(dev, K, B, prec, poly, cap):
    spec = gt.ProblemSpec(14, 7, K)
    b = gt.blocks_to_torch(tt.random_batch(spec, B, seed0=80), dev)
    lam0 = torch.zeros_like(b.q)
    kw = dict(exit_tol=1e-6, max_iters=cap, poly_degree=poly)
    before = (kl.CONDENSE_LAUNCHES, kl.PCG_LAUNCHES, kl.FUSED_LAUNCHES,
              kl.RECOVER_LAUNCHES)
    kops = kl.condense_longk_cuda(*b, rho=1e-3, preconditioner=prec)
    pops = kl.condense_longk_plain(*b, rho=1e-3, preconditioner=prec)
    for x, y in zip(kops[:5], pops[:5]):
        _close(x, y)
    assert kops.bad.tolist() == pops.bad.tolist() == [False] * B
    got = kl.pcg_longk_cuda(pops.S, pops.Pinv, pops.gamma, lam0, pops.bad, **kw)
    ref = kl.pcg_longk_plain(pops.S, pops.Pinv, pops.gamma, lam0, pops.bad, **kw)
    assert got.iters.tolist() == ref.iters.tolist()
    _close(got.lam, ref.lam)
    fused, fqi, fri = kl.fused_longk_cuda(*b, lam0, rho=1e-3, preconditioner=prec, **kw)
    # Row 9 is rows 7 + 8/10 on its own plan (one CTA an SM).
    one_an_sm = kl.pcg_rounds(B, K, 14, *kl._limits(dev), per_sm=1)
    split = kl.pcg_longk_cuda(kops.S, kops.Pinv, kops.gamma, lam0, kops.bad,
                              _rounds=one_an_sm, **kw)
    assert torch.equal(fused.lam, split.lam) and torch.equal(fqi, kops.Qinv)
    dx, du = kl.recover_longk_cuda(pops.Qinv, pops.Rinv, b.A, b.B, b.q, b.r, ref.lam)
    rx, ru = kl.recover_longk_plain(pops.Qinv, pops.Rinv, b.A, b.B, b.q, b.r, ref.lam)
    torch.cuda.synchronize()
    _close(dx, rx)
    _close(du, ru)
    assert (kl.CONDENSE_LAUNCHES, kl.PCG_LAUNCHES, kl.FUSED_LAUNCHES,
            kl.RECOVER_LAUNCHES) == (before[0] + 1, before[1] + 2, before[2] + 1,
                                     before[3] + 1)


@pytest.mark.parametrize("sizes", [(3, 2, 2), (2, 1, 5), (3, 2, 10), (20, 9, 37),
                                   (32, 32, 6)])
def test_longk_tiers_match_plain_at_other_widths(dev, sizes):
    """Both routes at the widths the other kernels are tested at, K = 2
    (one tile) and s = c = 32 (one-knot tiles)."""
    spec = gt.ProblemSpec(*sizes)
    b = gt.blocks_to_torch(tt.random_batch(spec, 3, seed0=110), dev)
    kw = dict(rho=1e-3, exit_tol=1e-8, max_iters=300)
    ref, rx, ru = kl.solve_longk_batched(*(a.cpu() for a in b), **kw)
    for tier in ("fused_xl", "xl"):
        got, gx, gu = kl.solve_longk_batched(*b, force_tier=tier, **kw)
        torch.cuda.synchronize()
        assert got.iters.tolist() == ref.iters.tolist()
        for x, y in ((got.lam, ref.lam), (gx, rx), (gu, ru)):
            _close(x, y)


def test_longk_batch_past_the_resident_ctas_runs_in_rounds(dev):
    """More problems than SMs: the cooperative kernels take them in rounds
    (kl.pcg_rounds), one launch each, with the plain versions' outcome."""
    from gato_tpu_torch.kernels import _build
    spec = gt.ProblemSpec(4, 2, 30)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    B = 2 * n_sms + 5
    limit = _build.max_shared_bytes(dev.index) - _build.RESERVED_SHARED_BYTES
    assert len(kl.pcg_rounds(B, 30, 4, n_sms, limit)) == 3
    assert len(kl.pcg_rounds(B, 30, 4, n_sms, limit, per_sm=1)) == 3
    b = gt.blocks_to_torch(tt.random_batch(spec, B, seed0=100), dev)
    kw = dict(rho=1e-3, exit_tol=1e-8, max_iters=200)
    ref, rx, ru = kl.solve_longk_batched(*(a.cpu() for a in b), **kw)
    for tier in ("fused_xl", "xl"):
        # Each round's launch is counted.
        before = kl.FUSED_LAUNCHES if tier == "fused_xl" else kl.PCG_LAUNCHES
        got, gx, gu = kl.solve_longk_batched(*b, force_tier=tier, **kw)
        after = kl.FUSED_LAUNCHES if tier == "fused_xl" else kl.PCG_LAUNCHES
        assert after == before + 3
        torch.cuda.synchronize()
        assert got.iters.tolist() == ref.iters.tolist()
        assert bool(got.converged.all())
        for x, y in ((got.lam, ref.lam), (gx, rx), (gu, ru)):
            _close(x, y)


# (K, B, poly, ctas): the plan's split, one knot a CTA, a forced split of
# two CTAs an SM (the operators partly streamed), several problems a round.
LONGK_SPLITS = [(1024, 1, 1, None), (132, 1, 1, 132), (1024, 1, 2, 264), (8192, 1, 1, 264),
                (1025, 3, 3, None), (2048, 16, 1, None), (64, 4, 1, 64)]


@pytest.mark.parametrize("K,B,poly,ctas", LONGK_SPLITS)
def test_longk_pcg_meetings_and_splits_agree(dev, K, B, poly, ctas):
    """Rows 8/10 at the plan's split and at forced ones, with the plain
    version's iterations and lambda; a round of one problem gives the same
    bits on flagged partials as on the plan's grid barriers (the same sums
    in the same order), and grid barriers are refused for several
    problems.  One problem of the batch is frozen."""
    spec = gt.ProblemSpec(14, 7, K)
    b = gt.blocks_to_torch(tt.random_batch(spec, B, seed0=160), dev)
    ops = kl.condense_longk_plain(*b, rho=1e-3)
    frozen = torch.zeros(B, dtype=torch.bool, device=dev)
    frozen[-1] = B > 1
    kw = dict(exit_tol=1e-6, max_iters=100, poly_degree=poly)
    ref = kl.pcg_longk_plain(ops.S, ops.Pinv, ops.gamma, None, frozen, **kw)
    rounds = kl.pcg_rounds(B, K, 14, *kl._limits(dev), ctas)
    plans = [None if ctas is None else rounds]
    if all(rd.nprob == 1 for rd in rounds):
        plans.append(tuple(rd._replace(meet="flags") for rd in rounds))
    else:
        with pytest.raises(ValueError, match="grid barriers only"):
            kl.pcg_longk_cuda(ops.S, ops.Pinv, ops.gamma, None, frozen, _rounds=tuple(
                rd._replace(meet="grid") for rd in rounds), **kw)
    runs = [kl.pcg_longk_cuda(ops.S, ops.Pinv, ops.gamma, None, frozen, _rounds=plan, **kw)
            for plan in plans]
    torch.cuda.synchronize()
    for other in runs[1:]:
        for x, y in zip(runs[0], other):
            assert torch.equal(x, y)
    got = runs[0]
    assert got.iters.tolist() == ref.iters.tolist()
    assert got.converged.tolist() == ref.converged.tolist()
    _close(got.lam, ref.lam)
    if B > 1:
        assert float(got.eta[-1]) >= 1e30 and torch.equal(got.lam[-1], torch.zeros_like(
            got.lam[-1]))


def test_longk_singular_problem_is_frozen(dev):
    spec = gt.ProblemSpec(14, 7, 1024)
    mix = tt.stack_blocks([tt.random_blocks(spec, seed=1),
                           tt.singular_blocks(spec, seed=3, knot=2),
                           tt.random_blocks(spec, seed=2)])
    b = gt.blocks_to_torch(mix, dev)
    for tier in kl.TIERS:
        res, dx, du = kl.solve_longk_batched(*b, rho=0.0, exit_tol=1e-6,
                                             max_iters=50, force_tier=tier)
        assert res.converged.tolist() == [True, False, True]
        assert int(res.iters[1]) == 50 and 1e30 <= float(res.eta[1]) < float("inf")
        for t in (res.lam, dx, du):
            assert bool(torch.isfinite(t).all())


def test_longk_entry_points_launch_the_kernels(dev):
    spec = gt.ProblemSpec(14, 7, 700)
    opts = gt.SolverOptions(rho=1e-3, exit_tol=1e-8)
    batch = tt.random_batch(spec, 3, seed0=90)
    tier = kl.AUTO_TIER
    count = kl.FUSED_LAUNCHES if tier == "fused_xl" else kl.PCG_LAUNCHES
    got = gt.solve_batched(spec, batch, opts)
    after = kl.FUSED_LAUNCHES if tier == "fused_xl" else kl.PCG_LAUNCHES
    assert after == count + 1
    ref = gt.solve_batched(spec, batch, opts, pcg_backend="torch")
    assert got.iters.tolist() == ref.iters.tolist()
    for name in ("lam", "dz_x", "dz_u"):
        _close(getattr(got, name), getattr(ref, name))
    packed = gt.pack(spec, batch)
    assert packed.plan.tier == "longk"
    before = kl.RECOVER_LAUNCHES
    res = gt.solve_packed(packed, opts)
    assert kl.RECOVER_LAUNCHES == before + 1
    assert torch.equal(res.lam_p, got.lam)
    farm = tt.random_farm(spec, 3, 2, seed0=91)
    before = kl.RECOVER_LAUNCHES
    seq = gt.solve_sequence_batched(spec, farm, opts)
    assert kl.RECOVER_LAUNCHES == before + 3 and bool(seq.converged.all())
    ref = gt.solve_sequence_batched(spec, farm, opts, pcg_backend="torch")
    for name in ("lam", "dz_x", "dz_u"):
        _close(getattr(seq, name), getattr(ref, name))


def test_shared_memory_mirrors_match_the_library(dev):
    """The routing's and the launch plan's pure functions (fused_solve's
    cta_smem_bytes, cta_threads and cluster_size, pcg_kernel.smem_bytes,
    direct_fused.smem_bytes, longk's tile and PCG layouts) agree with what
    the kernels' launchers compute."""
    from gato_tpu_torch.kernels import _build
    lib = _build.library()
    props = torch.cuda.get_device_properties(dev)
    limit = props.shared_memory_per_block_optin
    for K, s, c in ((5, 2, 1), (50, 14, 7), (700, 14, 7), (37, 20, 9), (3, 32, 32),
                    (740, 14, 7), (741, 14, 7)):
        for C in kb.CLUSTER_SIZES:
            for ops in (0, 1):
                assert kb.cta_smem_bytes(K, s, c, C, ops) == lib.gato_cluster_smem_bytes(
                    K, s, c, C, ops)
            assert kb.cta_threads(K, s, c, C) == lib.gato_cluster_threads(K, s, c, C)
        if kb.fits(K, s, c, limit):
            for B in (1, 4, 16, 64, 256, 4096):
                assert kb.cluster_size(B, K, s, c, props.multi_processor_count, limit) == \
                    lib.gato_cluster_size(B, K, s, c, props.multi_processor_count,
                                          limit - 1024)
        assert ka.smem_bytes(K, s) == lib.gato_pcg_smem_bytes(K, s)
        assert kd.smem_bytes(K, s, c) == lib.gato_direct_smem_bytes(K, s, c)
        # Kernel A's and row 4's cluster plans.
        for C in kb.CLUSTER_SIZES:
            assert ka.cta_threads(K, s, C) == lib.gato_pcg_cluster_threads(K, s, C)
            for ops in (0, 1):
                assert ka.cta_smem_bytes(K, s, C, ops) == lib.gato_pcg_cluster_smem_bytes(
                    K, s, C, ops)
                assert kd.cta_smem_bytes(K, s, c, C, ops) == \
                    lib.gato_direct_cluster_smem_bytes(K, s, c, C, ops)
    # The long-K plans' layouts (rows 7, 8/10 and 9; which plan to take is
    # kernels/longk.py's alone).
    lim = limit - 1024
    for K, s, c in ((2, 3, 2), (50, 14, 7), (689, 14, 7), (1025, 14, 7), (8192, 14, 7),
                    (16384, 14, 7), (37, 20, 9), (6, 32, 32)):
        for nk in range(1, kl.MAX_TILE_KNOTS + 1):
            assert kl.tile_plan(nk, s, c).total * 4 == lib.gato_longk_tile_smem_bytes(nk, s, c)
            assert kl.tile_threads(nk, s, c) == lib.gato_longk_tile_threads(nk, s, c)
        for per in (1, 7, 56, 132, 264):
            for flags in (0, 1, 3, 7):
                ring = kl.pcg_ring(K, s, per, flags, lim)
                assert kl.pcg_plan(K, s, per, flags, ring).total * 4 == \
                    lib.gato_longk_pcg_smem_bytes(K, s, per, flags, ring)
            assert kl.pcg_plan(K, s, per, 0, 0).vec_floats == lib.gato_longk_pcg_vec_floats(
                K, s, per)
        assert kl.recover_smem_bytes(s, c) == lib.gato_longk_recover_smem_bytes(s, c)


def _noncontiguous(t: torch.Tensor) -> torch.Tensor:
    """t's values in a view that is not contiguous (every other element of
    a doubled last axis)."""
    wide = torch.empty(*t.shape[:-1], 2 * t.shape[-1], dtype=t.dtype, device=t.device)
    wide[..., ::2] = t
    return wide[..., ::2]


@pytest.mark.parametrize("s,c", [(14, 7), (16, 8), (30, 10)])
@pytest.mark.parametrize("B", [0, 1, 3, 16])
@pytest.mark.parametrize("K", [2, 33, 1024, 8192])
def test_recover_longk_matches_plain(dev, K, B, s, c):
    """Row 13 (a warp a knot) against its plain version at IIWA's width
    (compiled in), a padded width of 16 and one of 32, on random inputs,
    Qinv, A and lambda handed over as non-contiguous views; one launch a
    call (none for B = 0)."""
    gen = torch.Generator().manual_seed(K + B + s)
    f = lambda *shape: torch.randn(*shape, generator=gen).to(dev)  # noqa: E731
    Qinv, Rinv, A, Bm = f(B, K, s, s), f(B, K - 1, c, c), f(B, K - 1, s, s), f(B, K - 1, s, c)
    q, r, lam = f(B, K, s), f(B, K - 1, c), f(B, K, s)
    before = kl.RECOVER_LAUNCHES
    dx, du = kl.recover_longk_cuda(_noncontiguous(Qinv), Rinv, _noncontiguous(A), Bm, q,
                                   r, _noncontiguous(lam))
    torch.cuda.synchronize()
    assert kl.RECOVER_LAUNCHES == before + (B > 0)
    assert dx.shape == (B, K, s) and du.shape == (B, K - 1, c)
    if B > 0:
        rx, ru = kl.recover_longk_plain(Qinv, Rinv, A, Bm, q, r, lam)
        _close(dx, rx)
        _close(du, ru)


# The long-K exact tier (rows 11 and 12, the unpeel kernel; rows 7 and 13).
DIRECT_LONGK_K = [50, 741, 1025, 1536, 8192]


@pytest.mark.parametrize("K", DIRECT_LONGK_K)
@pytest.mark.parametrize("B", [1, 15])
def test_longk_direct_kernels_match_plain(dev, K, B):
    """Rows 11 and 12 and the unpeel kernel at IIWA widths: each against its
    plain version on the same condensed system."""
    spec = gt.ProblemSpec(14, 7, K)
    b = gt.blocks_to_torch(tt.random_batch(spec, B, seed0=120), dev)
    ops = kl.condense_longk_cuda(*b, rho=1e-3, preconditioner="jacobi")
    before = (kl.CR_LAUNCHES, kl.PEEL_LAUNCHES, kl.UNPEEL_LAUNCHES)
    x, bad = kl.cr_longk_cuda(ops.S, ops.gamma)
    Sh, bh, level = kl.peel_longk_cuda(ops.S, ops.gamma)
    torch.cuda.synchronize()
    xp, badp = kl.cr_longk_plain(ops.S, ops.gamma)
    Shp, bhp, levelp = kl.peel_longk_plain(ops.S, ops.gamma)
    xh = kl.cr_longk_plain(Shp, bhp)[0]
    xu = kl.unpeel_longk_cuda(xh, levelp)
    torch.cuda.synchronize()
    assert (kl.CR_LAUNCHES, kl.PEEL_LAUNCHES, kl.UNPEEL_LAUNCHES) == tuple(
        n + 1 for n in before)
    assert bad.tolist() == badp.tolist() == [False] * B
    assert torch.equal(level.bad.cpu(), levelp.bad.cpu()) and not bool(level.bad.any())
    for k, p in ((x, xp), (Sh, Shp), (bh, bhp), (level.Doinv, levelp.Doinv),
                 (xu, kl.unpeel_longk_plain(xh, levelp)), (xu, xp)):
        _close(k, p)


# Row 12 and the unpeel at a level of W = 2, 3, 1025 and 8192 rows (an odd
# W leaves the last even row without a right neighbour), B = 1 and 15.
@pytest.mark.parametrize("W", [2, 3, 1025, 8192])
@pytest.mark.parametrize("B", [1, 15])
def test_peel_and_unpeel_match_plain(dev, W, B):
    """Row 12 against peel_longk_plain (S', b', D_o^{-1} of every odd row,
    the flags per odd row: at B = 15 problem 7's odd row 1 has a zero pivot
    on a live block) and the unpeel against unpeel_longk_plain on the plain
    level; values compared for the healthy problems."""
    b = gt.blocks_to_torch(tt.random_batch(gt.ProblemSpec(14, 7, W), B, seed0=140), dev)
    ops = kl.condense_longk_cuda(*b, rho=1e-3, preconditioner="jacobi")
    S, g = ops.S.clone(), ops.gamma
    healthy = list(range(B))
    if B > 1:
        S[7, 1, 1, 0, :] = 0.0
        S[7, 1, 1, :, 0] = 0.0
        healthy.remove(7)
    before = (kl.PEEL_LAUNCHES, kl.UNPEEL_LAUNCHES)
    Sh, bh, level = kl.peel_longk_cuda(S, g)
    torch.cuda.synchronize()
    Shp, bhp, levelp = kl.peel_longk_plain(S, g)
    xh = kl.cr_longk_plain(Shp, bhp)[0]
    xu = kl.unpeel_longk_cuda(xh, levelp)
    torch.cuda.synchronize()
    assert (kl.PEEL_LAUNCHES, kl.UNPEEL_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert Sh.shape == Shp.shape and level.Doinv.shape == levelp.Doinv.shape
    assert torch.equal(level.bad.cpu(), levelp.bad.cpu())
    assert level.bad.nonzero().tolist() == ([[7, 0]] if B > 1 else [])
    for k, p in ((Sh, Shp), (bh, bhp), (level.Doinv, levelp.Doinv),
                 (xu, kl.unpeel_longk_plain(xh, levelp))):
        _close(k[healthy], p[healthy])
    _close(xu[healthy], kl.cr_longk_plain(S, g)[0][healthy])


def test_rows_6_and_12_refuse_what_they_do_not_take(dev):
    """The short call path's checks (_build.checked) of rows 6 and 12 and
    the unpeel: shape, type, device, and a level of one row."""
    S = torch.randn(2, 4, 3, 5, 5, device=dev)
    g = torch.randn(2, 4, 5, device=dev)
    with pytest.raises(ValueError, match=r"peel_longk_cuda: S shape"):
        kl.peel_longk_cuda(S, g[:, :3])
    with pytest.raises(ValueError, match=r"peel_longk_cuda: S must be"):
        kl.peel_longk_cuda(S[0], g)
    with pytest.raises(ValueError, match="float32"):
        kl.peel_longk_cuda(S.double(), g)
    with pytest.raises(ValueError, match="is on cpu"):
        kl.peel_longk_cuda(S.cpu(), g)
    with pytest.raises(ValueError, match="at least 2 rows"):
        kl.peel_longk_cuda(S[:, :1], g[:, :1])
    _, _, level = kl.peel_longk_cuda(S, g)
    with pytest.raises(ValueError, match=r"unpeel_longk_cuda: x_half shape"):
        kl.unpeel_longk_cuda(torch.zeros(2, 3, 5, device=dev), level)
    with pytest.raises(ValueError, match=r"unpeel_longk_cuda: Doinv"):
        kl.unpeel_longk_cuda(torch.zeros(2, 2, 5, device=dev),
                             level._replace(Doinv=level.Doinv.double()))
    b = gt.blocks_to_torch(tt.random_batch(gt.ProblemSpec(5, 3, 9), 2, seed0=1), dev)
    f = kt.thomas_fwd_cuda(*b, rho=1e-3)
    with pytest.raises(ValueError, match=r"thomas_rev_cuda: Cinv shape"):
        kt.thomas_rev_cuda(f._replace(Cinv=f.Cinv[:, 1:]), b.q, b.A, b.B, b.r)
    with pytest.raises(ValueError, match="float32"):
        kt.thomas_rev_cuda(f._replace(theta=f.theta.double()), b.q, b.A, b.B, b.r)


@pytest.mark.parametrize("sizes", [(3, 2, 2), (2, 1, 5), (3, 2, 10), (14, 7, 741),
                                   (20, 9, 37), (32, 32, 6)])
def test_longk_direct_tiers_match_plain(dev, sizes, monkeypatch):
    """Both exact tiers at the widths the other kernels are tested at (s = 20
    and 32 take the kernels' wide Gauss-Jordan) against the whole tier's
    plain versions on the CPU, and 'hybrid' peeled down to one row."""
    spec = gt.ProblemSpec(*sizes)
    b = gt.blocks_to_torch(tt.random_batch(spec, 3, seed0=130), dev)
    ref, rx, ru = kl.solve_direct_longk_batched(*(a.cpu() for a in b), rho=1e-3)
    gamma = assemble.condense(*b, 1e-3, None).gamma
    for tier, rows in (("xl", 1024), ("hybrid", 1024), ("hybrid", 1)):
        monkeypatch.setattr(kl, "HYBRID_CR_ROWS", rows)
        got, gx, gu = kl.solve_direct_longk_batched(*b, rho=1e-3, force_tier=tier)
        torch.cuda.synchronize()
        _direct_outcome(got, ref, gamma)
        assert bool(got.converged.all())
        for x, y in ((got.lam, ref.lam), (gx, rx), (gu, ru)):
            _close(x, y)


# Row 11's plan at its edges (IIWA: the tail takes K <= 71 alone, ht = 2
# from K = 72, 16 at 741-1024, 128 at 8192), the wide widths, and batches.
CR_EDGES = [((14, 7, 2), 1), ((14, 7, 3), 15), ((14, 7, 71), 1), ((14, 7, 72), 15),
            ((14, 7, 73), 16), ((14, 7, 741), 16), ((14, 7, 1024), 1), ((14, 7, 1024), 15),
            ((14, 7, 1025), 256), ((14, 7, 8192), 1), ((14, 7, 8192), 15),
            ((20, 9, 37), 15), ((20, 9, 300), 16), ((32, 32, 13), 1), ((32, 32, 14), 15),
            ((32, 32, 200), 16), ((3, 2, 1), 4)]


@pytest.mark.parametrize("sizes,B", CR_EDGES)
def test_cr_longk_matches_plain_at_the_plan_edges(dev, sizes, B):
    """Row 11 (grid levels, tail, grid back-substitution) against
    cr_longk_plain on row 7's condensation, one count a call."""
    K = sizes[2]
    if K >= 2:
        b = gt.blocks_to_torch(tt.random_batch(gt.ProblemSpec(*sizes), B, seed0=150), dev)
        ops = kl.condense_longk_cuda(*b, rho=1e-3, preconditioner="jacobi")
        S, gamma = ops.S, ops.gamma
    else:
        g = torch.Generator().manual_seed(0)
        D = torch.randn(B, 1, sizes[0], sizes[0], generator=g)
        S = torch.zeros(B, 1, 3, sizes[0], sizes[0])
        S[:, :, 1] = D @ D.transpose(-1, -2) + sizes[0] * torch.eye(sizes[0])
        S, gamma = S.to(dev), torch.randn(B, 1, sizes[0], generator=g).to(dev)
    before = kl.CR_LAUNCHES
    x, bad = kl.cr_longk_cuda(S, gamma)
    torch.cuda.synchronize()
    assert kl.CR_LAUNCHES == before + 1
    xp, badp = kl.cr_longk_plain(S, gamma)
    assert bad.tolist() == badp.tolist() == [False] * B
    _close(x, xp)


def test_direct_stamps_tool_stamps_kernel_a_and_row_4(dev):
    """tools/direct_stamps.py's stamps child (a build with
    -DGATO_STAGE_STAMPS) splits kernel A into its copy, set-up, loop and
    store, and row 4 into its condensation, levels, root, back-substitution
    levels, residual and recovery."""
    tool = Path(__file__).resolve().parents[1] / "gato_tpu_torch" / "tools" / "direct_stamps.py"
    out = subprocess.run([sys.executable, str(tool), "--runs", "1", "--stamps-child",
                          "--only", "rowA,row4"], capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line["rowA"]) == {"K=50 B=1", "K=50 B=256", "K=688 B=1"}
    assert set(line["row4"]) == {"K=50 B=1", "K=50 B=15", "K=50 B=256", "K=740 B=1"}
    for r in line["rowA"].values():
        assert r["labels"] == ["copy", "set-up", "loop", "store"]
        assert all(p >= 0 for p in r["phases"]) and r["phases"][2] > 0
    for key, r in line["row4"].items():
        levels = (int(key.split()[0][2:]) - 1).bit_length()
        assert len(r["phases"]) == len(r["labels"]) == 2 * levels + 4
        assert r["labels"][0] == "condensation" and r["labels"][-1] == "recovery"
        assert all(p >= 0 for p in r["phases"])


def test_direct_stamps_tool_stamps_rows_6_and_12(dev):
    """tools/direct_stamps.py's stamps child splits row 6 into its walk (by
    knot) and its epilogue, and row 12 into its launches and the unpeel."""
    tool = Path(__file__).resolve().parents[1] / "gato_tpu_torch" / "tools" / "direct_stamps.py"
    out = subprocess.run([sys.executable, str(tool), "--runs", "1", "--stamps-child",
                          "--only", "row6,row12"], capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line["row6"]) == {"K=50 B=1", "K=50 B=16", "K=50 B=256", "K=1024 B=16"}
    for key, r in line["row6"].items():
        assert r["knots_stamped"] == min(int(key.split()[0][2:]), 64)
        assert r["walk"] > 0 and r["epilogue"] > 0 and r["knot"] > 0
    assert set(line["row12"]) == {"K=1024 B=1", "K=1024 B=15", "K=8192 B=1", "K=8192 B=15"}
    for r in line["row12"].values():
        assert r["first"] > 0 and r["second"] > 0 and r["unpeel"] > 0 and r["gap"] >= 0


def test_direct_plan_mirrors_match_the_library(dev):
    """Rows 5, 6, 11 and 12's and the unpeel's plan functions agree with
    their launchers'."""
    from gato_tpu_torch.kernels import _build
    lib = _build.library()
    for s in (2, 5, 14, 16, 20, 32):
        for walks in range(1, kt.MAX_WALKS + 1):
            assert kt.walk_smem_bytes(s, walks) == lib.gato_thomas_walk_smem_bytes(s, walks)
            assert kt.rev_smem_bytes(s, walks) == lib.gato_thomas_rev_smem_bytes(s, walks)
        for c in (1, 3, 7, 9, 32):
            assert kt.epi_smem_bytes(s, c) == lib.gato_thomas_epi_smem_bytes(s, c)
        assert kl.peel_smem_bytes(s) == lib.gato_longk_peel_smem_bytes(s)
        assert kl.unpeel_smem_bytes(s) == lib.gato_longk_unpeel_smem_bytes(s)
        assert kl.cr_grid_floats(s) * 4 == lib.gato_longk_cr_grid_smem_bytes(s)
        for rows in (1, 2, 13, 64, 71):
            assert kl.cr_tail_floats(rows, s) * 4 == lib.gato_longk_cr_tail_smem_bytes(rows, s)


def test_longk_direct_singular_contract(dev):
    """A zero row and column in Q[2] at rho = 0 among healthy problems: both
    tiers report it converged False with eta >= 1e30 and finite outputs,
    the others as if it were absent; a zero pivot in an odd row of the
    condensed system flags that problem alone in rows 11 and 12."""
    spec = gt.ProblemSpec(14, 7, 1024)
    good = [tt.random_blocks(spec, seed=s) for s in (1, 2)]
    mix = gt.blocks_to_torch(tt.stack_blocks([good[0], tt.singular_blocks(spec, seed=3, knot=2),
                                              good[1]]), dev)
    alone = gt.blocks_to_torch(tt.stack_blocks(good), dev)
    for tier in ("xl", "hybrid"):
        res, dx, du = kl.solve_direct_longk_batched(*mix, rho=0.0, force_tier=tier)
        ref, rx, ru = kl.solve_direct_longk_batched(*alone, rho=0.0, force_tier=tier)
        torch.cuda.synchronize()
        assert res.converged.tolist() == [True, False, True]
        assert float(res.eta[1]) >= 1e30
        for t in (res.lam, dx, du):
            assert bool(torch.isfinite(t).all())
        for x, y in ((res.lam[[0, 2]], ref.lam), (dx[[0, 2]], rx), (du[[0, 2]], ru)):
            _close(x, y)
    ops = kl.condense_longk_cuda(*alone, rho=1e-3, preconditioner="jacobi")
    S = ops.S.clone()
    S[1, 5, 1, 0, :] = 0.0
    S[1, 5, 1, :, 0] = 0.0
    _, bad = kl.cr_longk_cuda(S, ops.gamma)
    _, _, level = kl.peel_longk_cuda(S, ops.gamma)
    assert bad.tolist() == kl.cr_longk_plain(S, ops.gamma)[1].tolist() == [False, True]
    assert level.bad.nonzero().tolist() == [[1, 2]]


@pytest.mark.parametrize("B", [1, 15])
@pytest.mark.parametrize("prec", ["jacobi", "symmetric_stair"])
def test_longk_condense_and_recover_at_short_k(dev, B, prec):
    """Rows 7 and 13 at K = 50, where 'pcg_kernel' + direct now runs them."""
    spec = gt.ProblemSpec(14, 7, 50)
    b = gt.blocks_to_torch(tt.random_batch(spec, B, seed0=140), dev)
    kops = kl.condense_longk_cuda(*b, rho=1e-3, preconditioner=prec)
    pops = kl.condense_longk_plain(*b, rho=1e-3, preconditioner=prec)
    for x, y in zip(kops[:5], pops[:5]):
        _close(x, y)
    lam = torch.randn(b.q.shape, generator=torch.Generator().manual_seed(1)).to(dev)
    dx, du = kl.recover_longk_cuda(pops.Qinv, pops.Rinv, b.A, b.B, b.q, b.r, lam)
    rx, ru = kl.recover_longk_plain(pops.Qinv, pops.Rinv, b.A, b.B, b.q, b.r, lam)
    torch.cuda.synchronize()
    _close(dx, rx)
    _close(du, ru)


def test_row_14_shape_runs_the_long_k_pcg_kernel(dev):
    """IIWA K = 16384 (gato_tpu's pcg_streamed, row 14): the long-K PCG
    kernel against its plain version, and solve through auto on it."""
    spec = gt.ProblemSpec(14, 7, 16384)
    one = tt.random_blocks(spec, seed=150)
    b = gt.blocks_to_torch(tt.stack_blocks([one]), dev)
    ops = kl.condense_longk_cuda(*b, rho=1e-3)
    kw = dict(exit_tol=1e-6, max_iters=100)
    got = kl.pcg_longk_cuda(ops.S, ops.Pinv, ops.gamma, None, ops.bad, **kw)
    ref = kl.pcg_longk_plain(ops.S, ops.Pinv, ops.gamma, torch.zeros_like(ops.gamma),
                             ops.bad, **kw)
    torch.cuda.synchronize()
    assert got.iters.tolist() == ref.iters.tolist() and bool(got.converged.all())
    _close(got.lam, ref.lam)
    count = kl.PCG_LAUNCHES if kl.AUTO_TIER != "fused_xl" else kl.FUSED_LAUNCHES
    res = gt.solve(spec, one, gt.SolverOptions(rho=1e-3, **kw))
    after = kl.PCG_LAUNCHES if kl.AUTO_TIER != "fused_xl" else kl.FUSED_LAUNCHES
    assert after == count + 1 and int(res.iters) == int(got.iters[0])
    _close(res.lam, got.lam[0])


def test_longk_direct_entry_points_launch_the_kernels(dev):
    """method='direct' past row 4 below B = 16 on every surface: solve,
    solve_batched, 'pcg_kernel' at K = 50, pack / solve_packed, a 'longk'
    PCG pack and the exact farm; each launches rows 7, 11 and 13 once."""
    spec = gt.ProblemSpec(14, 7, 800)
    opts = gt.SolverOptions(rho=1e-3, method="direct")
    batch = tt.random_batch(spec, 3, seed0=160)

    def counts():
        return (kl.CONDENSE_LAUNCHES, kl.CR_LAUNCHES, kl.RECOVER_LAUNCHES)

    def once(fn):
        before = counts()
        out = fn()
        torch.cuda.synchronize()
        assert counts() == tuple(n + 1 for n in before)
        return out

    ref = gt.solve_batched(spec, batch, opts, pcg_backend="torch")
    got = once(lambda: gt.solve_batched(spec, batch, opts))
    assert got.iters.tolist() == [0, 0, 0] and bool(got.converged.all())
    for name in ("lam", "dz_x", "dz_u"):
        _close(getattr(got, name), getattr(ref, name))
    one = once(lambda: gt.solve(spec, gt.KKTBlocks(*(a[0] for a in batch)), opts))
    _close(one.lam, ref.lam[0])
    short = gt.ProblemSpec(14, 7, 50)
    sb = gt.blocks_to_torch(tt.random_batch(short, 2, seed0=161), dev)
    res = once(lambda: gt.solve_batched(short, sb, opts, pcg_backend="pcg_kernel"))
    row4, _, _ = kd.direct_fused_cuda(*sb, rho=1e-3)
    _close(res.lam, row4.lam)
    packed = gt.pack(spec, batch, method="direct")
    assert packed.plan.tier == "longk"
    res = once(lambda: gt.solve_packed(packed, opts))
    assert torch.equal(res.lam_p, got.lam)
    res = once(lambda: gt.solve_packed(gt.pack(spec, batch), opts))
    assert torch.equal(res.lam_p, got.lam)
    farm = tt.random_farm(spec, 2, 3, seed0=162)
    seq = once(lambda: gt.solve_sequence_batched(spec, farm, opts))
    assert tuple(seq.lam.shape) == (2, 3, 800, 14) and bool(seq.converged.all())
    step = gt.solve_batched(spec, gt.KKTBlocks(*(a[1] for a in farm)), opts,
                            pcg_backend="torch")
    _close(seq.lam[1], step.lam)
    before = (kl.PEEL_LAUNCHES, kl.UNPEEL_LAUNCHES)
    hy, _, _ = kl.solve_direct_longk_batched(*gt.blocks_to_torch(batch, dev), rho=1e-3,
                                             force_tier="hybrid")
    assert (kl.PEEL_LAUNCHES, kl.UNPEEL_LAUNCHES) == (before[0] + 1, before[1] + 1)
    _close(hy.lam, ref.lam)


# --------------------------------------------------------------------------
# Row 15 (kernels/halo_matvec.py) and the sharded paths on one card.

# (s, Kl): IIWA at two shard sizes, narrow and widest blocks, a one-row
# shard; IIWA at the edges of the kernel's tiling (two block rows a CTA:
# one CTA half used, 32 CTAs, 33 half used, 129) and the widest blocks at
# the largest shard.
HALO_CASES = [(14, 256), (14, 2048), (4, 64), (3, 37), (32, 19), (7, 1),
              (14, 1), (14, 2), (14, 63), (14, 64), (14, 65), (14, 257),
              (32, 2048)]


@pytest.mark.parametrize("s,Kl", HALO_CASES)
@pytest.mark.parametrize("shard", ["first", "interior", "last", "alone"])
def test_halo_matvec_matches_plain(dev, s, Kl, shard):
    """Row 15 against its plain version; an edge shard's missing halo is
    zeros.  Tolerance 1e-5 of scale: one matvec, float32 sum order."""
    rng = np.random.default_rng(1000 * s + Kl)

    def rand(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=dev)

    # S as a view one block row into a larger tensor: at s = 3 its first
    # float is not 16-byte aligned, the kernel's scalar head.
    S = rand(Kl + 1, 3, s, s)[1:]
    x = rand(Kl, s)
    left = rand(s) if shard in ("interior", "last") else None
    right = rand(s) if shard in ("first", "interior") else None
    before = hm.LAUNCHES
    got = hm.halo_matvec_cuda(S, x, left, right)
    torch.cuda.synchronize()
    assert hm.LAUNCHES == before + 1
    ref = hm.halo_matvec_plain(S, x, left, right)
    a, b = got.double().cpu().numpy(), ref.double().cpu().numpy()
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * float(np.abs(b).max()))


def _halo_inputs(dev, s, Kl, seed):
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=dev)
    return rand(Kl, 3, s, s), rand(Kl, s), rand(s), rand(s)


@pytest.mark.parametrize("layout", ["offset", "strided"])
def test_halo_matvec_takes_misaligned_and_strided_x(dev, layout):
    """x as a view one float into its storage (not 16-byte aligned), and x
    as a non-contiguous view (the wrapper's copy), against the plain
    version within 1e-5 of scale, as above."""
    s, Kl = 14, 65
    S, x, left, right = _halo_inputs(dev, s, Kl, seed=3)
    if layout == "offset":
        x = torch.cat([torch.zeros(1, device=dev), x.flatten()])[1:].view(Kl, s)
        assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    else:
        x = torch.stack([x, x], -1)[..., 0]
        assert not x.is_contiguous()
    got = hm.halo_matvec_cuda(S, x, left, right)
    ref = hm.halo_matvec_plain(S, x, left, right)
    a, b = got.double().cpu().numpy(), ref.double().cpu().numpy()
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * float(np.abs(b).max()))


def test_halo_matvec_without_halos_launches_one_kernel_and_allocates_y(dev):
    """Both halos absent: one call records exactly one CUDA activity in a
    torch.profiler trace (the kernel: no fill of a zero halo, no copy),
    and the caching allocator's count grows by y's block alone."""
    from torch.profiler import ProfilerActivity, profile

    S, x, _, _ = _halo_inputs(dev, 14, 256, seed=4)
    hm.halo_matvec_cuda(S, x)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    y = hm.halo_matvec_cuda(S, x)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    assert grown <= -(-y.numel() * 4 // 512) * 512, grown
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        hm.halo_matvec_cuda(S, x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "halo_matvec" in names[0], names


def test_halo_matvec_refuses_what_it_does_not_take(dev):
    S = torch.zeros(8, 3, 4, 4, device=dev)
    x = torch.zeros(8, 4, device=dev)
    with pytest.raises(ValueError, match="float32"):
        hm.halo_matvec_cuda(S.double(), x.double())
    with pytest.raises(ValueError, match="shape"):
        hm.halo_matvec_cuda(S[:7], x)
    with pytest.raises(ValueError, match="shape"):
        hm.halo_matvec_cuda(S, x, torch.zeros(5, device=dev))


def _sharded_counts():
    return hm.LAUNCHES, kl.CONDENSE_LAUNCHES, kl.RECOVER_LAUNCHES


@pytest.mark.parametrize("prec", ["symmetric_stair", "block_jacobi"])
def test_solve_sharded_kernel_tier_on_one_card(dev, prec):
    """solve_sharded on four shards of one card: the kernel tier (rows 7,
    15 and 13) against the torch tier, equal iterations (IIWA K = 256 at
    seed 41 meets no round-off tie) and lambda, dz within 1e-4 of scale;
    row 15 launched 2 (iters + 2) times a shard at poly degree 1 (two
    matvecs to set up, two a loop body, iters + 1 bodies), rows 7 and 13
    once a shard."""
    spec = gt.ProblemSpec(14, 7, 256)
    blocks = tt.random_blocks(spec, seed=41)
    mesh = gt.Mesh(["cuda:0"] * 4)
    kw = dict(rho=1e-3, exit_tol=1e-6, max_iters=100, preconditioner=prec)
    before = _sharded_counts()
    got = gt.solve_sharded(mesh, *blocks, **kw)
    torch.cuda.synchronize()
    after = _sharded_counts()
    ref = gt.solve_sharded(mesh, *blocks, use_kernel=False, **kw)
    assert bool(got[0].converged) and int(got[0].iters) == int(ref[0].iters)
    iters = int(got[0].iters)
    assert tuple(a - b for a, b in zip(after, before)) == (4 * 2 * (iters + 2), 4, 4)
    _close(got[0].lam, ref[0].lam)
    _close(got[1], ref[1])
    _close(got[2], ref[2])
    assert got[0].lam.device == torch.device("cuda", 0)


def test_sharded_paths_on_one_card(dev):
    """pcg_sharded (both tiers), the exact path and the degenerate
    placement on Mesh(["cuda:0"] * n); float64 takes the torch tier and an
    explicit use_kernel=True in float64 raises."""
    spec = gt.ProblemSpec(14, 7, 128)
    blocks = tt.random_blocks(spec, seed=42)
    sys_ = assemble.condense(*gt.blocks_to_torch(blocks, dev), 1e-3)
    kw = dict(exit_tol=1e-6, max_iters=100)
    for n in (1, 2, 4):
        mesh = gt.Mesh(["cuda:0"] * n)
        a = gt.pcg_sharded(mesh, sys_.S, sys_.Pinv, sys_.gamma, **kw)
        b = gt.pcg_sharded(mesh, sys_.S, sys_.Pinv, sys_.gamma, use_kernel=False, **kw)
        assert int(a.iters) == int(b.iters) and bool(a.converged)
        _close(a.lam, b.lam)
        exact = gt.solve_sharded(mesh, *blocks, rho=1e-3, method="direct")
        single = gt.solve(spec, blocks, gt.SolverOptions(rho=1e-3, method="direct"))
        assert bool(exact[0].converged)
        _close(exact[0].lam, single.lam)
    thin = gt.ProblemSpec(14, 7, 4)
    tb = tt.random_blocks(thin, seed=43)
    mesh = gt.Mesh(["cuda:0"] * 4)
    before = hm.LAUNCHES
    res = gt.solve_sharded(mesh, *tb, rho=1e-3, **kw)
    assert hm.LAUNCHES == before          # one-knot shards: the torch tier
    single = gt.solve(thin, tb, gt.SolverOptions(rho=1e-3, **kw), pcg_backend="torch")
    assert int(res[0].iters) == int(single.iters)
    b64 = [np.asarray(x, np.float64) for x in blocks]
    res64 = gt.solve_sharded(mesh, *b64, rho=1e-3, **kw)
    assert res64[0].lam.dtype == torch.float64
    with pytest.raises(ValueError, match="float32-only"):
        gt.solve_sharded(mesh, *b64, rho=1e-3, use_kernel=True, **kw)


def test_dp_entry_points_on_one_card(dev):
    """solve_batched_dp and solve_sequence_batched_dp on four groups of one
    card: each group runs solve_batched / solve_sequence_batched on its
    problems, so the results equal those calls on each group bit for bit."""
    spec = tt.IIWA
    batch = tt.random_batch(spec, 16, seed0=70)
    mesh = gt.Mesh(["cuda:0"] * 4, "dp")
    for method in ("pcg", "direct"):
        opts = gt.SolverOptions(rho=1e-3, exit_tol=1e-8, method=method)
        got = gt.solve_batched_dp(mesh, *batch, rho=1e-3, exit_tol=1e-8,
                                  method=method)
        parts = [gt.solve_batched(spec, gt.KKTBlocks(*(a[i:i + 4] for a in batch)), opts)
                 for i in range(0, 16, 4)]
        for name, g in zip(("lam", "iters", "converged", "eta"), got[0]):
            assert torch.equal(g, torch.cat([getattr(p, name) for p in parts])), name
        assert torch.equal(got[1], torch.cat([p.dz_x for p in parts]))
        assert torch.equal(got[2], torch.cat([p.dz_u for p in parts]))
    farm = tt.random_farm(spec, 4, 8, seed0=71)
    opts = gt.SolverOptions(rho=1e-3, exit_tol=1e-8)
    got = gt.solve_sequence_batched_dp(mesh, *farm, rho=1e-3, exit_tol=1e-8)
    parts = [gt.solve_sequence_batched(spec, gt.KKTBlocks(*(a[:, i:i + 2] for a in farm)),
                                       opts) for i in range(0, 8, 2)]
    for g, field in zip(got, zip(*parts)):
        assert torch.equal(g, torch.cat(field, dim=1))


# ---------------------------------------------------------------------------
# Rows 16, 17 and 18 (kernels/probes.py) and the measurement surface
# (timing, debug) on the card.


@pytest.mark.parametrize("B,K,s,offset", [(1, 50, 14, 0), (256, 50, 14, 0),
                                          (3, 7, 3, 0), (1, 50, 14, 1), (3, 7, 3, 1)])
def test_null_copy_matches_plain_bit_for_bit(dev, B, K, s, offset):
    """Row 18 bit for bit against q * 1.0000001: IIWA at B = 1 and 256, K s
    not a multiple of 4 (the scalar tail), and q a view ``offset`` floats
    into its storage (not 16-byte aligned: the scalar path)."""
    rng = np.random.default_rng(B + K + s + offset)
    flat = torch.tensor(rng.normal(size=offset + B * K * s), dtype=torch.float32,
                        device=dev)
    q = flat[offset:].view(B, K, s)
    assert (q.data_ptr() % 16 == 0) == (offset == 0)
    before = probes.COPY_LAUNCHES
    got = probes.null_copy_cuda(q)
    torch.cuda.synchronize()
    assert probes.COPY_LAUNCHES == before + 1
    assert torch.equal(got, probes.null_copy_plain(q))


def _knots_close(got, ref, tol):
    """|got - ref| <= tol max |ref| within every (problem, knot) row."""
    a, b = got.double().cpu().numpy(), ref.double().cpu().numpy()
    assert np.isfinite(a).all()
    scale = np.abs(b).max(axis=-1, keepdims=True)
    assert scale.min() > 1e-30
    assert (np.abs(a - b) <= tol * scale).all(), float((np.abs(a - b) / scale).max())


@pytest.mark.parametrize("scope", ["block", "grid"])
@pytest.mark.parametrize("n_mv,n_dot", [(2, 2), (1, 2), (4, 2), (2, 1), (2, 4)])
@pytest.mark.parametrize("B,K", [(1, 50), (3, 37), (1, 1024)])
def test_null_chain_matches_plain(dev, scope, n_mv, n_dot, B, K):
    """Row 16 against its plain version over 100 trips, knot by knot.
    Tolerance 1e-4 of each (problem, knot)'s scale: chain_operator keeps
    every knot's y within a few times every other's, and float32 round-off
    along up to 600 dependent steps in another order is the rest (float32
    against float64 drifts up to 2.6e-5 of a knot's scale here)."""
    M, y0 = probes.chain_operator(B, K, 14, seed=K + n_mv + 10 * n_dot, device=dev)
    counter = "CHAIN_BLOCK_LAUNCHES" if scope == "block" else "CHAIN_GRID_LAUNCHES"
    before = getattr(probes, counter)
    got = probes.null_chain_cuda(M, y0, n_mv=n_mv, n_dot=n_dot, trips=100, scope=scope)
    torch.cuda.synchronize()
    assert getattr(probes, counter) == before + 1
    ref = probes.null_chain_plain(M, y0, n_mv=n_mv, n_dot=n_dot, trips=100)
    _knots_close(got, ref, 1e-4)


@pytest.mark.parametrize("n_mv,n_dot", [(2, 2), (4, 2), (0, 2), (3, 0)])
@pytest.mark.parametrize("scope,kw", [("block", dict(cluster=1)), ("block", dict(cluster=2)),
                                      ("block", dict(cluster=16)),
                                      ("block", dict(cluster=16, _halo=1)),
                                      ("grid", dict(_halo=1)), ("grid", dict(_halo=4))])
def test_null_chain_schedules_match_plain(dev, scope, kw, n_mv, n_dot):
    """Row 16 at the cluster sizes kernel B takes (1, 2 and 16) and at
    halo depths the plans do not pick (one knot at both scopes, four at the
    grid scope), IIWA K = 50, B = 1, 100 trips, against its plain version
    within 1e-4 of each knot's scale."""
    M, y0 = probes.chain_operator(1, 50, 14, seed=50 + n_mv + 10 * n_dot, device=dev)
    got = probes.null_chain_cuda(M, y0, n_mv=n_mv, n_dot=n_dot, trips=100, scope=scope,
                                 **kw)
    torch.cuda.synchronize()
    ref = probes.null_chain_plain(M, y0, n_mv=n_mv, n_dot=n_dot, trips=100)
    _knots_close(got, ref, 1e-4)


def test_null_chain_layout_mirrors_the_library(dev):
    """kernels/probes.py's chain_smem_bytes and chain_threads against
    csrc/probes.cu's."""
    from gato_tpu_torch.kernels import _build
    lib = _build.library()
    for kn, s, H in ((1, 14, 1), (4, 14, 1), (4, 14, 3), (64, 14, 1), (8, 14, 2),
                     (5, 2, 4), (3, 20, 2), (50, 14, 1)):
        assert probes.chain_threads(kn, s, H) == lib.gato_null_chain_threads(kn, s, H)
        for cluster in (0, 1):
            for resident in (0, 1):
                assert probes.chain_smem_bytes(kn, s, H, bool(cluster), bool(resident)) == \
                    lib.gato_null_chain_smem_bytes(kn, s, H, cluster, resident)


@pytest.mark.parametrize("K,B,depth,trips", [
    (50, 1, 2, 100), (50, 132, 2, 100), (5, 3, 2, 100), (73, 2, 2, 100),
    # each layout's edges (one knot and 40 for 16 lanes a knot; 41 and 128
    # for two), a last warp holding one knot in each (17, 49), and odd
    # counts of matvecs
    (1, 1, 2, 100), (40, 2, 2, 100), (41, 3, 2, 100), (128, 2, 2, 100),
    (17, 1, 2, 100), (49, 1, 2, 100), (4, 1, 3, 33), (50, 3, 1, 7)])
def test_fma_chain_matches_plain(dev, K, B, depth, trips):
    """Row 17 against its plain version over trips of depth matvecs (200
    for most), knot by knot, within 1e-4 of each knot's scale, as row 16."""
    M, y0 = probes.fma_operator(B, K, seed=K + B, device=dev)
    before = probes.FMA_LAUNCHES
    got = probes.fma_chain_cuda(M, y0, depth=depth, trips=trips)
    torch.cuda.synchronize()
    assert probes.FMA_LAUNCHES == before + 1
    _knots_close(got, probes.fma_chain_plain(M, y0, depth=depth, trips=trips), 1e-4)


def test_fma_chain_plan_mirrors_the_library(dev):
    """kernels/probes.py's fma_plan against csrc/probes.cu's fma_lanes,
    fma_threads and fma_smem_bytes at every K the kernel takes."""
    from gato_tpu_torch.kernels import _build
    lib = _build.library()
    for K in range(1, probes.FMA_MAX_KNOTS + 1):
        p = probes.fma_plan(1, K)
        assert (p.lanes, p.threads, p.smem) == (lib.gato_fma_chain_lanes(K),
                                                lib.gato_fma_chain_threads(K),
                                                lib.gato_fma_chain_smem_bytes(K)), K


def test_probes_refuse_what_they_do_not_take(dev):
    M, y0 = probes.chain_operator(1, 8, 4, seed=1, device=dev)
    with pytest.raises(ValueError, match="float32"):
        probes.null_copy_cuda(y0.double())
    with pytest.raises(ValueError, match="shape"):
        probes.null_chain_cuda(M[:, :7], y0, n_mv=1, n_dot=1, trips=1)
    with pytest.raises(ValueError, match="width"):
        probes.fma_chain_cuda(torch.zeros(1, 8, 5, 5, device=dev),
                              torch.zeros(1, 8, 5, device=dev), depth=1, trips=1)
    with pytest.raises(ValueError, match="128"):
        probes.fma_chain_cuda(torch.zeros(1, 129, 14, 14, device=dev),
                              torch.zeros(1, 129, 14, device=dev), depth=1, trips=1)
    with pytest.raises(ValueError, match="cluster"):
        probes.null_chain_cuda(M, y0, n_mv=1, n_dot=1, trips=1, cluster=3)
    with pytest.raises(ValueError, match="halo"):
        probes.null_chain_cuda(M, y0, n_mv=1, n_dot=1, trips=1, scope="grid", _halo=9)
    with pytest.raises(ValueError, match="shared memory"):
        probes.null_chain_cuda(*probes.chain_operator(1, 400, 14, seed=2, device=dev),
                               n_mv=1, n_dot=1, trips=1, cluster=1)


def test_trace_records_the_cuda_kernels(dev, tmp_path):
    """debug.trace around one linsys_solve names kernel B's CUDA symbol and
    writes a Chrome trace."""
    p = tt.pendulum_problem()
    args = (p.G_row, p.G_col, p.G_val, p.C_row, p.C_col, p.C_val, p.g, p.c,
            [0.0] * 10, 1, 1e-6, 10, False, 1e-3)
    gt.linsys_solve(*args, verbose=False)
    with debug.trace(str(tmp_path)) as prof:
        gt.linsys_solve(*args, verbose=False)
    assert any("fused_solve_kernel" in e.key for e in prof.key_averages())
    assert len(list(tmp_path.iterdir())) == 1


_FIRST_SESSION = """
import json, sys, tempfile
import torch
from torch.profiler import ProfilerActivity, profile
import gato_tpu_torch as gt
from gato_tpu_torch import debug, testing as tt
from gato_tpu_torch.kernels import longk as kl
dev = torch.device("cuda", 0)
b = gt.blocks_to_torch(tt.random_batch(gt.ProblemSpec(14, 7, 1024), 2, seed0=1), dev)
kl.solve_longk_batched(*b, rho=1e-3)
kl.solve_direct_longk_batched(*b, rho=1e-3)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    kl.solve_direct_longk_batched(*b, rho=1e-3)
    torch.cuda.synchronize()
raw = any(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())
traced = []
for _ in range(3):
    with tempfile.TemporaryDirectory() as tmp:
        with debug.trace(tmp) as prof:
            kl.solve_direct_longk_batched(*b, rho=1e-3)
        traced.append(any("cr_tail_kernel" in e.key for e in prof.key_averages()))
print(json.dumps({"raw_first_session_records_cuda": raw, "traced": traced}))
"""


def test_trace_sessions_of_a_fresh_process_after_the_long_k_kernels(dev):
    """The profiler sessions that recorded no device activity on the card
    were a process's first (after the long-K phases, and in a fresh child):
    in fresh processes that run the long-K tiers, a plain first
    torch.profiler session, then three debug.trace sessions, each of which
    must name row 11's kernel.  How often the plain first session recorded
    nothing is reported as a warning."""
    import json
    import subprocess
    import sys
    import warnings
    raw = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", _FIRST_SESSION], capture_output=True,
                             text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["traced"] == [True] * 3, (line, out.stderr[-2000:])
        raw.append(line["raw_first_session_records_cuda"])
    warnings.warn(f"a fresh process's first plain profiler session recorded CUDA "
                  f"activity: {raw}")


@pytest.mark.parametrize("backend,method,B", [("fused", "pcg", 1), ("pcg_kernel", "pcg", 1),
                                              ("torch", "pcg", 1), (None, "direct", 1),
                                              ("fused", "pcg", 16), (None, "direct", 16)])
def test_time_solve_runs_each_backend(dev, backend, method, B):
    spec = tt.IIWA
    blocks = (tt.random_blocks(spec, seed=3) if B == 1
              else tt.random_batch(spec, B, seed0=3))
    ms, info = timing.time_solve(spec, blocks, gt.SolverOptions(rho=1e-3, method=method),
                                 backend, T=4, reps=2, min_diff_ms=0.0)
    assert ms > 0 and info["T"] >= 4 and info["reps_ms"]


def test_solve_debug_on_the_card_matches_solve(dev):
    spec = tt.IIWA
    blocks = tt.random_blocks(spec, seed=9)
    opts = gt.SolverOptions(rho=1e-3, exit_tol=1e-6, max_iters=100)
    dbg = debug.solve_debug(spec, blocks, opts)
    ref = gt.solve(spec, blocks, opts, pcg_backend="torch")
    assert dbg.eta_history.device.type == "cuda"
    assert int(dbg.result.iters) == int(ref.iters)
    _close(dbg.result.lam, ref.lam)
    assert timing.measure_rtt_ms(3) > 0


# ---- The gradient layer (diff.py) and the native packer on the card ----

def _diff_counts() -> tuple:
    return (kd.LAUNCHES, kt.FWD_LAUNCHES, kt.REV_LAUNCHES, kt.EPILOGUE_LAUNCHES,
            kl.CONDENSE_LAUNCHES, kl.CR_LAUNCHES, kl.PEEL_LAUNCHES,
            kl.UNPEEL_LAUNCHES, kl.RECOVER_LAUNCHES)


def _diff_loss(lam, dz_x, dz_u):
    return ((lam * torch.cos(lam)).sum() + (dz_x ** 2).sum()
            + torch.sin(dz_u).sum())


def _diff_grads(dev, spec, B, dtype):
    """The loss's gradients through kkt_solve (B = 0: one problem) or
    kkt_solve_batched, with every input and rho requiring grad."""
    blocks = tt.random_blocks(spec, seed=21) if B == 0 else tt.random_batch(
        spec, B, seed0=21)
    args = [torch.tensor(np.asarray(a), dtype=dtype, device=dev, requires_grad=True)
            for a in blocks]
    args.append(torch.tensor(1e-3, dtype=dtype, device=dev, requires_grad=True))
    solve = gt.kkt_solve if B == 0 else gt.kkt_solve_batched
    out = solve(*args)
    return out, torch.autograd.grad(_diff_loss(*out), args)


# (spec, B (0: kkt_solve), launches of forward + adjoint in _diff_counts' order)
DIFF_ROUTES = {
    "row4": (tt.IIWA, 0, (2, 0, 0, 0, 0, 0, 0, 0, 0)),
    "row4_b8": (tt.IIWA, 8, (2, 0, 0, 0, 0, 0, 0, 0, 0)),
    "pair_b16": (tt.IIWA, 16, (0, 2, 2, 2, 0, 0, 0, 0, 0)),
    "pair_b256": (tt.IIWA, 256, (0, 2, 2, 2, 0, 0, 0, 0, 0)),
    "longk_k1024": (gt.ProblemSpec(14, 7, 1024), 0, (0, 0, 0, 0, 2, 2, 0, 0, 2)),
}


@pytest.mark.parametrize("route", DIFF_ROUTES)
def test_kkt_solve_gradients_on_the_kernels(dev, route):
    """Forward and adjoint solves through the exact dispatch's kernels, by
    their launch counts; the primal and every gradient within 2e-3 of scale
    of the same call in float64 on the card (the 'torch' route)."""
    spec, B, want = DIFF_ROUTES[route]
    before = _diff_counts()
    out, grads = _diff_grads(dev, spec, B, torch.float32)
    torch.cuda.synchronize()
    got = tuple(a - b for a, b in zip(_diff_counts(), before))
    assert got == want, (route, got)
    ref_out, ref_grads = _diff_grads(dev, spec, B, torch.float64)
    assert _diff_counts() == tuple(a + b for a, b in zip(before, want))
    for x, y in zip((*out, *grads), (*ref_out, *ref_grads)):
        assert x.dtype == torch.float32 and x.device == dev
        x, y = x.detach().double().cpu().numpy(), y.detach().cpu().numpy()
        assert np.isfinite(x).all()
        scale = max(1.0, float(np.abs(y).max()))
        np.testing.assert_allclose(x, y, rtol=2e-3, atol=2e-3 * scale)


def test_native_packer_serves_linsys_solve_on_the_card(dev):
    from gato_tpu_torch import formats, native

    assert native.available()
    spec = tt.IIWA
    p = tt.blocks_to_csr(spec, tt.random_blocks(spec, seed=4))
    before = native.CALLS
    lam, dz = gt.linsys_solve(p.G_row, p.G_col, p.G_val, p.C_row, p.C_col, p.C_val,
                              p.g, p.c, [0.0] * spec.nl, 1, 1e-6, 100, False, 1e-3,
                              verbose=False)
    assert native.CALLS == before + 2 and len(lam) == spec.nl
    got = formats.pack_kkt(spec, p.G_row, p.G_col, p.G_val, p.C_row, p.C_col,
                           p.C_val, p.g, p.c)
    formats.USE_NATIVE = False
    try:
        ref = formats.pack_kkt(spec, p.G_row, p.G_col, p.G_val, p.C_row, p.C_col,
                               p.C_val, p.g, p.c)
    finally:
        formats.USE_NATIVE = True
    for x, y in zip(got, ref):
        assert np.array_equal(x, y)


def test_shared_memory_limit_holds_across_host_threads(dev):
    """A kernel's dynamic shared-memory limit belongs to the function, not
    to a host thread: a launch from a fresh thread (as the autograd engine
    makes a backward's) at a smaller size must not lower the limit that
    this thread's larger launches of the same kernel need.  Row 4 at B =
    256 and B = 1 (cluster_body.cuh's launch configuration), the Thomas pair
    at B = 256 and 16 and row 11's tail at K = 71 and 30 (grid_common.cuh's
    opt_in_smem; both past 48 KB)."""
    import threading

    spec = tt.IIWA
    wide = gt.blocks_to_torch(tt.random_batch(spec, 256, seed0=40), dev)

    def narrow(n):
        return gt.KKTBlocks(*(a[:n] for a in wide))

    long_spec = gt.ProblemSpec(14, 7, 71)
    long_b = gt.blocks_to_torch(tt.random_batch(long_spec, 2, seed0=41), dev)
    short = gt.blocks_to_torch(tt.random_batch(gt.ProblemSpec(14, 7, 30), 2, seed0=42), dev)
    cases = [
        (lambda: kd.direct_fused_cuda(*wide, rho=1e-3)[0].lam,
         lambda: kd.direct_fused_cuda(*narrow(1), rho=1e-3)),
        (lambda: kt.solve_direct_thomas_cuda(*wide, rho=1e-3)[0].lam,
         lambda: kt.solve_direct_thomas_cuda(*narrow(16), rho=1e-3)),
        (lambda: kl.solve_direct_longk_batched(*long_b, rho=1e-3, force_tier="xl")[0].lam,
         lambda: kl.solve_direct_longk_batched(*short, rho=1e-3, force_tier="xl")),
    ]
    for big, small in cases:
        first = big()
        errors = []

        def other():
            try:
                small()
                torch.cuda.synchronize()
            except Exception as err:  # reported below, in this thread
                errors.append(err)

        thread = threading.Thread(target=other)
        thread.start()
        thread.join()
        assert not errors, errors
        again = big()
        torch.cuda.synchronize()
        assert torch.equal(first, again)



_SPAN_SESSION = """
import json, os, sys, tempfile
import torch
from torch.profiler import ProfilerActivity, profile
import gato_tpu_torch as gt
from gato_tpu_torch import testing as tt
dev = torch.device("cuda", 0)
b = gt.blocks_to_torch(tt.random_batch(tt.IIWA, 1, seed0=11), dev)
opts = gt.SolverOptions(method=sys.argv[1])
gt.solve_batched(tt.IIWA, b, opts, pcg_backend="fused", device=dev)
torch.cuda.synchronize()
for _ in range(3):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gt.solve_batched(tt.IIWA, b, opts, pcg_backend="fused", device=dev)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    if any(e.get("cat") == "kernel" for e in events):
        break
print(json.dumps([[e["name"], e.get("cat"), float(e["ts"]), float(e.get("dur", 0))]
                  for e in events
                  if e.get("cat") == "kernel" or e["name"].startswith("gato.")]))
"""


@pytest.mark.parametrize("method, kernel", [("pcg", "fused_solve_kernel"),
                                            ("direct", "direct_cluster_kernel")])
def test_launch_span_precedes_its_kernel(dev, method, kernel):
    """A 'fused' solve of each method under torch.profiler records one
    gato.launch inside gato.solve_core inside gato.solve_batched, and the
    kernel starts on the device after that span starts, on the trace's
    one clock.  The session runs in a fresh process, taken again (three in
    all) where it recorded no kernel: in a process that had profiled and
    launched from other threads before, sessions recorded none."""
    out = subprocess.run([sys.executable, "-c", _SPAN_SESSION, method],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    events = json.loads(out.stdout.strip().splitlines()[-1])
    kernels = [a for name, cat, a, _ in events if cat == "kernel" and kernel in name]
    assert len(kernels) == 1, f"{len(kernels)} {kernel} events in the last of 3 sessions"
    spans = {}
    for name, _, a, dur in events:
        if name.startswith("gato."):
            spans.setdefault(name, []).append((a, a + dur))
    assert sorted(spans) == ["gato.launch", "gato.route", "gato.solve_batched",
                             "gato.solve_core", "gato.stage"]
    assert all(len(v) == 1 for v in spans.values()), spans
    (ea, eb), = spans["gato.solve_batched"]
    (ca, cb), = spans["gato.solve_core"]
    (la, lb), = spans["gato.launch"]
    assert ea <= ca <= la <= lb <= cb <= eb
    assert kernels[0] >= la


# ---- solve_batched's kept launch plans (solver.launch_plan) ----

PLAN_CASES = [(50, 1), (512, 1), (50, 16), (50, 256)]
PLAN_OPTS = dict(rho=1e-3, exit_tol=1e-6, max_iters=100)


def _plan_inputs(dev, K, B):
    spec = gt.ProblemSpec(14, 7, K)
    return spec, gt.blocks_to_torch(tt.random_batch(spec, B, seed0=K + B), dev)


def _wrapper(b, opts):
    """The route's wrapper called directly, as _solve_core calls it."""
    if opts.method == "pcg":
        res, dz_x, dz_u = kb.fused_solve_cuda(
            *b, torch.zeros_like(b.q), rho=opts.rho, exit_tol=opts.exit_tol,
            max_iters=opts.max_iters, poly_degree=opts.precond_poly_degree,
            preconditioner=opts.preconditioner.value)
    elif kt.should_dispatch(*b.Q.shape[:3], b.R.shape[-1]):
        res, dz_x, dz_u = kt.solve_direct_thomas_cuda(*b, rho=opts.rho)
    else:
        res, dz_x, dz_u = kd.direct_fused_cuda(*b, rho=opts.rho)
    return gt.SolveResult(res.lam, dz_x, dz_u, res.iters, res.converged, res.eta)


@pytest.mark.parametrize("K, B", PLAN_CASES)
@pytest.mark.parametrize("method", ["pcg", "direct"])
def test_a_plan_hit_equals_the_wrapper(dev, K, B, method):
    """A repeat call (a kept plan, its tensors staged already) gives the
    bits of the route's wrapper called directly; an index-less "cuda"
    finds the plan of the current device."""
    from gato_tpu_torch import solver

    spec, b = _plan_inputs(dev, K, B)
    opts = gt.SolverOptions(method=method, **PLAN_OPTS)
    gt.solve_batched(spec, b, opts, device=dev)
    builds, hits = solver.PLAN_BUILDS, solver.PLAN_HITS
    with torch.cuda.device(dev):
        got = gt.solve_batched(spec, b, opts, device="cuda")
    assert (solver.PLAN_BUILDS, solver.PLAN_HITS) == (builds, hits + 1)
    ref = _wrapper(b, opts)
    torch.cuda.synchronize()
    for name in gt.SolveResult._fields:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


@pytest.mark.parametrize("method, kernel", [("pcg", kb), ("direct", kd)])
def test_plan_hits_launch_once_into_fresh_outputs(dev, method, kernel):
    """Kernel B's and row 4's hits: one launch a call, outputs that share no
    storage with another call's, and kernel B's zero lam0 still zero after
    100 calls."""
    from gato_tpu_torch import solver

    spec, b = _plan_inputs(dev, 50, 1)
    opts = gt.SolverOptions(method=method, **PLAN_OPTS)
    first = gt.solve_batched(spec, b, opts, device=dev)
    plan = solver.launch_plan(spec, opts, None, dev, 1)
    assert plan.launch is not None and plan.launch[0] is kernel
    assert (plan.lam0 is not None) == (method == "pcg")
    before = kernel.LAUNCHES
    for i in range(100):
        res = gt.solve_batched(spec, b, opts, device=dev)
        assert kernel.LAUNCHES == before + i + 1
    torch.cuda.synchronize()
    ptrs = {t.untyped_storage().data_ptr() for t in first}
    assert not ptrs & {t.untyped_storage().data_ptr() for t in res}
    for name in gt.SolveResult._fields:
        assert torch.equal(getattr(res, name), getattr(first, name)), name
    if plan.lam0 is not None:
        assert int(torch.count_nonzero(plan.lam0)) == 0


# ---- Kernel B's compiled <36, 12>: a quadruped's whole body (ANYmal, 57
# knots; benchmark/configs/anymal36_k57.json) ----

ANYMAL = (36, 12, 57)


def _anymal(dev, B, seed=2**31 + 11):
    """B generator-recipe problems at (36, 12, 57), as the benchmark makes
    them (benchmark/generator.py)."""
    from benchmark import generator
    return generator.make_problems(B, ANYMAL[2], ANYMAL[0], ANYMAL[1], seed, dev)


def _rel_err(got, ref):
    got, ref = got.double().flatten(1), ref.double().flatten(1)
    return float(((got - ref).abs().amax(1) / ref.abs().amax(1)).max())


@pytest.mark.parametrize("B", [1, 4])
def test_kernel_b_36x12_against_the_float64_reference(dev, B):
    """The auto route of solve_batched at (36, 12, 57) launches kernel B's
    <36, 12> body once, with the records in shared memory at C = 16; the
    answer lies within 1.5e-3 of scale of the float64 exact solve (the exit
    test |r . M r| < 1e-6 leaves ~6e-4, tests/test_torch_wide_blocks.py), and
    its iterations are the plain path's, give or take one where eta meets
    exit_tol within float32 round-off."""
    from benchmark.reference import kkt
    f = _anymal(dev, B)
    spec = gt.ProblemSpec(*ANYMAL)
    opts = gt.SolverOptions(rho=1e-3, exit_tol=1e-6, max_iters=100)
    launches, scratch = kb.LAUNCHES, kb.SCRATCH_FLOATS
    got = gt.solve_batched(spec, gt.KKTBlocks(*f), opts)
    torch.cuda.synchronize()
    assert kb.LAUNCHES == launches + 1 and kb.LAST_CLUSTER == 16
    assert kb.SCRATCH_FLOATS == scratch
    launch = kb.plan(B, 57, 36, 12, torch.device(dev), rho=1e-3, exit_tol=1e-6,
                     max_iters=100, poly_degree=1, preconditioner="symmetric_stair")
    assert launch.instance == "36x12" and launch.cluster == 16 and launch.in_smem
    assert bool(got.converged.all())
    ref = kkt.solve(f, 1e-3)
    assert _rel_err(got.lam, ref.lam) <= 1.5e-3
    assert _rel_err(torch.cat([got.dz_x.flatten(1), got.dz_u.flatten(1)], 1),
                    torch.cat([ref.dz_x.flatten(1), ref.dz_u.flatten(1)], 1)) <= 1.5e-3
    plain = gt.solve_batched(spec, gt.KKTBlocks(*f), opts, pcg_backend="torch")
    _iters_agree(got, plain, 1e-6)


@pytest.mark.parametrize("cluster", [16, 8, 4])
@pytest.mark.parametrize("prec", ["symmetric_stair", "block_jacobi", "jacobi"])
def test_kernel_b_36x12_at_cluster_sizes(dev, cluster, prec):
    """Kernel B's <36, 12> at C = 16 (records in shared memory) and 8, 4
    (records in the global scratch slice, counted in SCRATCH_FLOATS)
    against its plain version, each preconditioner (scalar Jacobi over 10
    iterations, as above); a second launch gives the same bits."""
    f = _anymal(dev, 2, seed=71)
    kw = dict(rho=1e-3, exit_tol=1e-8, max_iters=10 if prec == "jacobi" else 300,
              preconditioner=prec)
    launches, scratch = kb.LAUNCHES, kb.SCRATCH_FLOATS
    got, gx, gu = kb.fused_solve_cuda(*f, cluster=cluster, **kw)
    torch.cuda.synchronize()
    in_smem = cluster == 16
    assert kb.LAUNCHES == launches + 1 and kb.LAST_CLUSTER == cluster
    assert kb.SCRATCH_FLOATS == scratch + (0 if in_smem else 2 * 57 * 9648)
    ref, rx, ru = kb.fused_solve_plain(*f, torch.zeros_like(f[4]), **kw)
    _iters_agree(got, ref, 1e-8)
    for x, y in ((got.lam, ref.lam), (gx, rx), (gu, ru)):
        _close(x, y)
    again, ax, au = kb.fused_solve_cuda(*f, cluster=cluster, **kw)
    for x, y in ((got.lam, again.lam), (gx, ax), (gu, au), (got.iters, again.iters),
                 (got.eta, again.eta)):
        assert torch.equal(x, y)


def test_kernel_b_36x12_entry_points(dev):
    """solve, the packed surface and the farm at (36, 12, 57): kernel B where
    it takes them, the plain path for the farm (no farm kernel at these
    widths) and for method='direct'; an explicit kernel backend that has no
    kernel for the widths raises."""
    f = [t.cpu().numpy() for t in _anymal(dev, 1, seed=5)]
    spec = gt.ProblemSpec(*ANYMAL)
    one = gt.KKTBlocks(*(a[0] for a in f))
    opts = gt.SolverOptions(rho=1e-3, exit_tol=1e-8, max_iters=300)
    launches = kb.LAUNCHES
    res = gt.solve(spec, one, opts)
    packed = gt.solve_packed(gt.pack(spec, gt.KKTBlocks(*f)), opts)
    torch.cuda.synchronize()
    assert kb.LAUNCHES == launches + 2
    assert torch.equal(packed.lam_p[0], res.lam)
    ref = gt.solve(spec, one, opts, pcg_backend="torch")
    for name in ("lam", "dz_x", "dz_u"):
        _close(getattr(res, name), getattr(ref, name))
    farm = gt.KKTBlocks(*(np.stack([a, a]) for a in f))
    seq_launches = ks.LAUNCHES
    seq = gt.solve_sequence_batched(spec, farm, opts)
    assert ks.LAUNCHES == seq_launches and bool(seq.converged.all())
    direct = gt.SolverOptions(rho=1e-3, method="direct")
    exact = gt.solve(spec, one, direct)
    assert bool(exact.converged)
    plain = gt.solve(spec, one, direct, pcg_backend="torch")
    for name in gt.SolveResult._fields:
        assert torch.equal(getattr(exact, name), getattr(plain, name)), name
    for method in ("pcg", "direct"):
        with pytest.raises(ValueError, match="<= 32"):
            gt.solve(spec, one, gt.SolverOptions(method=method), pcg_backend="pcg_kernel")
    with pytest.raises(ValueError, match="<= 32"):
        gt.solve_sequence_batched(spec, farm, opts, pcg_backend="fused")


@pytest.mark.parametrize("cluster", [16, 4])
def test_kernel_b_36x12_zero_pivot_freezes_its_problem_alone(dev, cluster):
    """The <36, 12> body's Gauss-Jordan (one warp a matrix) keeps the
    zero-pivot rule: Q_13 + rho with an exactly zero first pivot (knot 13:
    a CTA's last knot and its neighbour's halo at C = 16 and at C = 4)
    freezes its problem (max_iters, not converged, eta = 1e30, lambda_0
    kept), and the other problem of the batch equals its solve alone, bit
    for bit."""
    rho = 1e-3
    Q, *rest = _anymal(dev, 2, seed=73)
    Q = Q.clone()
    Q[0, 13, 0, 0] = -rho
    f = (Q, *rest)
    lam0 = torch.randn(f[4].shape, generator=torch.Generator().manual_seed(74)).to(dev)
    kw = dict(rho=rho, exit_tol=1e-8, max_iters=60, cluster=cluster)
    got, gx, gu = kb.fused_solve_cuda(*f, lam0, **kw)
    torch.cuda.synchronize()
    assert kb.LAST_CLUSTER == cluster
    assert int(got.iters[0]) == 60 and not bool(got.converged[0])
    assert float(got.eta[0]) == float(np.float32(1e30))
    assert torch.equal(got.lam[0], lam0[0])
    alone, ax, au = kb.fused_solve_cuda(*(t[1:] for t in f), lam0[1:], **kw)
    for x, y in ((got.lam[1:], alone.lam), (gx[1:], ax), (gu[1:], au),
                 (got.iters[1:], alone.iters), (got.converged[1:], alone.converged),
                 (got.eta[1:], alone.eta)):
        assert torch.equal(x, y)


def test_wide_widths_route_to_the_plain_path_on_the_card(dev):
    """(50, 40, 20): no kernel takes the widths; the auto route solves on the
    plain path for either method, and kernel B's wrapper refuses them."""
    spec = gt.ProblemSpec(40, 20, 50)
    batch = tt.random_batch(spec, 2, seed0=9)
    for method in ("pcg", "direct"):
        opts = gt.SolverOptions(rho=1e-3, exit_tol=1e-6, method=method)
        got = gt.solve_batched(spec, batch, opts)
        assert bool(got.converged.all())
        ref = gt.solve_batched(spec, batch, opts, pcg_backend="torch")
        for name in gt.SolveResult._fields:
            assert torch.equal(getattr(got, name), getattr(ref, name)), name
    with pytest.raises(ValueError, match="<= 32"):
        kb.fused_solve_cuda(*gt.blocks_to_torch(batch, dev))


def test_kernel_a_takes_a_control_size_above_32_on_the_card(dev):
    """(50, 14, 40): kernel B has no body for c = 40; the auto route
    condenses in PyTorch ops and launches kernel A at s = 14, and solves
    as the plain path does."""
    spec = gt.ProblemSpec(14, 40, 50)
    batch = tt.random_batch(spec, 2, seed0=9)
    opts = gt.SolverOptions(rho=1e-3, exit_tol=1e-6)
    launches = ka.LAUNCHES
    got = gt.solve_batched(spec, batch, opts)
    torch.cuda.synchronize()
    assert ka.LAUNCHES == launches + 1 and bool(got.converged.all())
    ref = gt.solve_batched(spec, batch, opts, pcg_backend="torch")
    _iters_agree(got, ref, 1e-6)
    for name in ("lam", "dz_x", "dz_u"):
        _close(getattr(got, name), getattr(ref, name))


def test_compiled_widths_mirror_the_library(dev):
    from gato_tpu_torch.kernels import _build
    lib = _build.library()
    for s, c in ((14, 7), (2, 1), (36, 12), (12, 36), (36, 13), (7, 14), (3, 2)):
        assert bool(lib.gato_fused_compiled(s, c)) == ((s, c) in kb.COMPILED_WIDTHS)
    K, s, c = 57, 36, 12
    props = torch.cuda.get_device_properties(dev)
    limit = props.shared_memory_per_block_optin
    for C in kb.CLUSTER_SIZES:
        for ops in (0, 1):
            assert kb.cta_smem_bytes(K, s, c, C, ops) == lib.gato_cluster_smem_bytes(
                K, s, c, C, ops)
        assert kb.cta_threads(K, s, c, C) == lib.gato_cluster_threads(K, s, c, C)
    for B in (1, 4, 175):
        assert kb.cluster_size(B, K, s, c, props.multi_processor_count, limit) == \
            lib.gato_cluster_size(B, K, s, c, props.multi_processor_count, limit - 1024)
    assert lib.gato_fused_scratch_floats(K, s, c) == K * 9648


# sha256 of kernel B's outputs (lam, dz_x, dz_u, iters, converged, eta) on
# seeded batches with DIGEST_TOOLCHAIN (nvcc's release line; the card): the
# narrow bodies' as the build before the <36, 12> body gave them, the
# <36, 12> body's as the build before its one-warp Gauss-Jordan gave them.
# Each body keeps its bits.  Another nvcc or card may round otherwise, so
# there the test skips; gato_tpu_torch/tools/bitcheck.py compares two
# builds on one toolchain.
DIGEST_TOOLCHAIN = "Cuda compilation tools, release 12.9, V12.9.86; NVIDIA H100 80GB HBM3"
BODY_DIGESTS = {
    ((14, 7, 50), None): "6ff0f016bb98c1aa8d750616021f0e2cfd33b316e5faf090ae362dc221648496",
    ((14, 7, 50), 2): "8fbd9a181d6fa6287e71d5efc73451f74ac4e27bc0828edc25eca865a34cb3b1",
    ((2, 1, 5), None): "e1a43ec7df1c8f22fc3f7c5b34114d26acce41af7e883d6916c8fd2029026f43",
    ((36, 12, 57), 16): "39d54b390cfbfce69dc703dacb37871bc2004551cb7dfd6b8ebd7f04ee0d4bae",
    ((36, 12, 57), 4): "5be59eb6264d3fee66e30b48ba21b8be9d8e093d0375dcbe3fa39a7aa5a0b93e",
}


def _toolchain(dev) -> str:
    from gato_tpu_torch.kernels import _build
    out = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    release = next(line for line in out.splitlines() if "release" in line)
    return f"{release.strip()}; {torch.cuda.get_device_name(dev)}"


def _kernel_b_digest(dev, sizes, cluster):
    import hashlib
    spec = gt.ProblemSpec(*sizes)
    b = gt.blocks_to_torch(tt.random_batch(spec, 4, seed0=61), dev)
    res, dx, du = kb.fused_solve_cuda(*b, rho=1e-3, exit_tol=1e-8, max_iters=200,
                                      cluster=cluster)
    h = hashlib.sha256()
    for t in (res.lam, dx, du, res.iters, res.converged, res.eta):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("sizes, cluster", [((14, 7, 50), None), ((14, 7, 50), 2),
                                            ((2, 1, 5), None), ((36, 12, 57), 16),
                                            ((36, 12, 57), 4)])
def test_kernel_b_bodies_keep_their_bits(dev, sizes, cluster):
    if _toolchain(dev) != DIGEST_TOOLCHAIN:
        pytest.skip(f"digests recorded with {DIGEST_TOOLCHAIN!r}, this build uses "
                    f"{_toolchain(dev)!r}")
    assert _kernel_b_digest(dev, sizes, cluster) == BODY_DIGESTS[(sizes, cluster)]
