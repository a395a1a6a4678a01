"""gato_tpu_torch.kernels.longk (the long-horizon PCG tier: rows 7, 8/10, 9
and 13) against gato_tpu.kernels.longk on the same NumPy inputs, with
device="cpu", where each kernel wrapper runs its plain version.

gato_tpu's long-K kernels run in Pallas interpret mode at SPEC = (3, 2,
200) with chunk_lanes=128, as tests/test_longk.py runs them (several lane
chunks, so every cross-chunk carry of the TPU kernels is exercised).
Tolerances: lambda and dz within 5e-4 of scale with iteration counts and
converged equal (tests/test_longk.py's); condensed operators blockwise to
rtol = atol = 1e-5 (S, gamma, Qinv, Rinv) and 1e-4 (Pinv); recovery to
1e-5.  The slice end to end runs at IIWA width just past kernel B's shared
memory (K = 700) against gato_tpu's 'jax' path, where a float32 exit one
iteration apart at eta within 1e-3 of exit_tol is a round-off tie
(CLAUDE.md's second exception).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gato_tpu
from gato_tpu import mpc as jmpc
from gato_tpu.kernels import longk as jlk
from gato_tpu.kernels.fused_solve import _pack_mat, _pack_vec, _unpack_vec

import gato_tpu_torch as gt
from gato_tpu_torch import solver
from gato_tpu_torch import testing as tt
from gato_tpu_torch.kernels import longk as kl

torch.set_num_threads(1)

SPEC = gt.ProblemSpec(3, 2, 200)
RHO = 1e-3
H100 = 232448
IIWA_700 = gt.ProblemSpec(14, 7, 700)
ETA_TIE = 1e-3


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel(ours, ref) -> float:
    ours, ref = _np(ours).astype(np.float64), _np(ref).astype(np.float64)
    return float(np.abs(ours - ref).max()) / (float(np.abs(ref).max()) or 1.0)


def _batch(spec, seeds):
    return tt.stack_blocks([tt.random_blocks(spec, seed=s) for s in seeds])


def _jax(blocks):
    return [jnp.asarray(np.asarray(a), jnp.float32) for a in blocks]


def _torch(blocks):
    return gt.blocks_to_torch(blocks, "cpu")


def _same_solve(ours, ref, tol=5e-4):
    """(PCGResult, dz_x, dz_u) triples: equal iteration counts and converged
    flags, lambda and dz within tol of scale."""
    (res, dx, du), (jres, jdx, jdu) = ours, ref
    assert res.iters.tolist() == np.asarray(jres.iters).tolist()
    assert res.converged.tolist() == np.asarray(jres.converged).tolist()
    for a, b in ((res.lam, jres.lam), (dx, jdx), (du, jdu)):
        assert _rel(a, b) < tol


@pytest.mark.parametrize("tier", kl.TIERS)
def test_each_tier_matches_gato_tpu(tier):
    """force_tier on both sides: gato_tpu's three lane-packed tiers, the
    port's two routes ('xl' and 'stream' are one route on the card)."""
    b = _batch(SPEC, [7])
    kw = dict(rho=RHO, exit_tol=1e-8, max_iters=300, force_tier=tier)
    ours = kl.solve_longk_batched(*_torch(b), **kw)
    ref = jlk.solve_longk_batched(*_jax(b), chunk_lanes=128, **kw)
    _same_solve(ours, ref)
    assert bool(ours[0].converged.all())


@pytest.mark.parametrize("prec,poly,warm", [
    ("block_jacobi", 1, False),
    ("jacobi", 1, False),
    ("symmetric_stair", 2, True),
])
def test_options_match_gato_tpu(prec, poly, warm):
    """Every preconditioner, and poly degree 2 with a warm start on a
    ragged batch (its problems exit at different iterations)."""
    b = _batch(SPEC, [30, 31])
    lam0 = (np.random.default_rng(0).normal(size=(2, 200, 3)).astype(np.float32)
            * 0.1 if warm else np.zeros((2, 200, 3), np.float32))
    kw = dict(rho=RHO, exit_tol=1e-8, max_iters=500, poly_degree=poly,
              preconditioner=prec)
    ours = kl.solve_longk_batched(*_torch(b), torch.from_numpy(lam0), **kw)
    ref = jlk.solve_longk_batched(*_jax(b), jnp.asarray(lam0), chunk_lanes=128,
                                  **kw)
    _same_solve(ours, ref)
    assert bool(ours[0].converged.all())
    if warm:   # the ragged case: the two problems exit apart
        assert len(set(ours[0].iters.tolist())) == 2


def _unpack_blocks(Mb, n_rows, n_cols, n):
    """gato_tpu's lane layout (1, [slot,] cols, sp, Kp) -> (n, [slot,] rows,
    cols): column b, row a, knot lane k."""
    M = np.asarray(Mb)[0][..., :n_rows, :n]
    return np.moveaxis(M, -1, 0).swapaxes(-1, -2)


@pytest.mark.parametrize("prec", ["symmetric_stair", "block_jacobi", "jacobi"])
def test_condensation_matches_condense_call(prec):
    """Row 7's plain version against gato_tpu's chunked condensation kernel
    (its carry, and the stair's slot 2 shifted one lane left as
    solve_longk_batched does), blockwise."""
    spec = gt.ProblemSpec(2, 2, 160)
    Q, R, A, B, q, r, c = tt.random_blocks(spec, seed=3)
    s, cdim, K = 2, 2, 160
    sp, Kp, Lc, n_chunks = 8, 256, 128, 2
    pm = functools.partial(_pack_mat, K_sub=Kp, g=1, L=Kp, n_groups=1, sp=sp)
    pv = functools.partial(_pack_vec, K_sub=Kp, g=1, L=Kp, n_groups=1, sp=sp)
    Sb, Pb, gamb, Qib, Rib = jlk._condense_call(
        RHO, *(pm(jnp.asarray(x)[None]) for x in (Q, R, A, B)),
        *(pv(jnp.asarray(x)[None]) for x in (q, r, c)),
        s=s, c=cdim, sp=sp, Kp=Kp, Lc=Lc, n_chunks=n_chunks, precond=prec,
        interpret=True)
    Pb = Pb.at[:, 2].set(jlk._shift_left_lane(Pb[:, 2]))
    ops = kl.condense_longk_cuda(*_torch(tt.stack_blocks([(Q, R, A, B, q, r, c)])),
                                 rho=RHO, preconditioner=prec)
    np.testing.assert_allclose(_np(ops.S[0]), _unpack_blocks(Sb, s, s, K),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ops.Pinv[0]), _unpack_blocks(Pb, s, s, K),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(ops.gamma[0]), np.asarray(gamb)[0][:s, :K].T,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ops.Qinv[0]), _unpack_blocks(Qib, s, s, K),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ops.Rinv[0]),
                               _unpack_blocks(Rib, cdim, cdim, K - 1),
                               rtol=1e-5, atol=1e-5)
    assert ops.bad.tolist() == [False]


def test_recovery_matches_recover_call():
    """Row 13's plain version against gato_tpu's recovery kernel, which
    reads lambda_{k+1} from a copy shifted one lane left."""
    K, s, cdim = SPEC.knot_points, SPEC.state_size, SPEC.control_size
    b = _batch(SPEC, [11])
    ops = kl.condense_longk_cuda(*_torch(b), rho=RHO)
    lam = np.random.default_rng(1).normal(size=(1, K, s)).astype(np.float32)
    dz_x, dz_u = kl.recover_longk_cuda(ops.Qinv, ops.Rinv, *_torch(b)[2:4],
                                       torch.from_numpy(b.q), torch.from_numpy(b.r),
                                       torch.from_numpy(lam))
    sp, Kp = 8, 256
    pm = functools.partial(_pack_mat, K_sub=Kp, g=1, L=Kp, n_groups=1, sp=sp)
    pv = functools.partial(_pack_vec, K_sub=Kp, g=1, L=Kp, n_groups=1, sp=sp)
    lamb = pv(jnp.asarray(lam))
    dzxb, dzub = jlk._recover_call(
        pm(jnp.asarray(_np(ops.Qinv))), pm(jnp.asarray(_np(ops.Rinv))),
        pm(jnp.asarray(b.A)), pm(jnp.asarray(b.B)), pv(jnp.asarray(b.q)),
        pv(jnp.asarray(b.r)), lamb, jlk._shift_left_lane(lamb),
        s=s, c=cdim, sp=sp, Kp=Kp, Lc=128, n_chunks=2, interpret=True)
    ref_x = np.asarray(_unpack_vec(dzxb, 1, K, s, Kp, 1))
    ref_u = np.asarray(_unpack_vec(dzub, 1, K, cdim, Kp, 1))[:, :K - 1]
    np.testing.assert_allclose(_np(dz_x), ref_x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(dz_u), ref_u, rtol=1e-5, atol=1e-5)


def test_singular_problem_meets_gato_tpus_contract():
    """One exactly singular problem (a zero row and column in Q[2], rho =
    0) among healthy ones: it alone reports max_iters, not converged and
    eta >= 1e30, as gato_tpu's long-K tier does; the healthy problems are
    solved as if it were absent."""
    good = [tt.random_blocks(SPEC, seed=s) for s in (1, 2)]
    mix = tt.stack_blocks([good[0], tt.singular_blocks(SPEC, seed=3, knot=2),
                           good[1]])
    kw = dict(rho=0.0, exit_tol=1e-8, max_iters=300)
    res, dx, du = kl.solve_longk_batched(*_torch(mix), **kw)
    jres, jdx, jdu = jlk.solve_longk_batched(*_jax(mix), chunk_lanes=128, **kw)
    assert res.iters.tolist() == np.asarray(jres.iters).tolist()
    assert res.converged.tolist() == np.asarray(jres.converged).tolist() \
        == [True, False, True]
    assert res.iters.tolist()[1] == 300
    assert 1e30 <= float(res.eta[1]) < float("inf")
    assert float(np.asarray(jres.eta)[1]) >= 1e30
    for t in (res.lam, dx, du):
        assert bool(torch.isfinite(t).all())
    alone, ax, au = kl.solve_longk_batched(*_torch(tt.stack_blocks(good)), **kw)
    for x, y, jy in ((res.lam, alone.lam, jres.lam), (dx, ax, jdx), (du, au, jdu)):
        np.testing.assert_allclose(_np(x[[0, 2]]), _np(y), rtol=1e-6, atol=1e-7)
        assert _rel(x[[0, 2]], np.asarray(jy)[[0, 2]]) < 5e-4


def test_routing_at_the_h100_limit(monkeypatch):
    """Kernel A's and kernel B's vectors stop fitting an H100 block at IIWA
    K = 689: auto takes 'pcg_kernel' there and 'pcg_kernel' the long-K
    tier; an explicit 'fused' raises naming the routes that serve it."""
    assert kl.H100_SHARED_BYTES == H100
    assert not kl.should_dispatch(600, 14, 7, H100)
    assert kl.should_dispatch(700, 14, 7, H100)
    assert kl.should_dispatch(8192, 14, 7, H100)
    shape = (700, 14, 7)
    pcg = gt.SolverOptions()
    assert solver._resolve_backend(None, pcg, "cuda", (600, 14, 7), H100) == "fused"
    assert solver._resolve_backend(None, pcg, "cuda", shape, H100) == "pcg_kernel"
    assert solver._resolve_backend(None, pcg, "cpu", shape, H100) == "torch"
    assert solver._resolve_backend("pcg_kernel", pcg, "cuda", shape, H100) \
        == "pcg_kernel"
    direct = gt.SolverOptions(method="direct")
    assert solver._resolve_backend(None, direct, "cuda", shape, H100) == "fused"
    with pytest.raises(ValueError, match=r"pcg_backend None \(auto\) or 'pcg_kernel'"):
        solver._resolve_backend("fused", pcg, "cuda", shape, H100)
    one = tt.random_blocks(IIWA_700, seed=0)
    assert gt.pack(IIWA_700, one, device="cpu").plan.tier == "longk"
    assert gt.pack(gt.ProblemSpec(14, 7, 600), tt.random_blocks(
        gt.ProblemSpec(14, 7, 600), seed=0), device="cpu").plan.tier is None
    farm = tt.random_farm(gt.ProblemSpec(14, 7, 700), 2, 1, seed0=0)
    assert gt.pack_sequence(IIWA_700, farm, device="cpu").plan.tier == "longk"
    with pytest.raises(ValueError, match="'pcg_kernel'"):
        gt.solve(IIWA_700, one, pcg_backend="fused", device="cpu")
    with pytest.raises(ValueError, match="unknown force_tier"):
        kl.solve_longk_batched(*_torch(_batch(SPEC, [1])), force_tier="vmem")
    # 'pcg_kernel' on the CPU takes the long-K route where the card would.
    calls = []
    real = kl.solve_longk_batched
    monkeypatch.setattr(kl, "solve_longk_batched",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    gt.solve(gt.ProblemSpec(14, 7, 600), tt.random_blocks(
        gt.ProblemSpec(14, 7, 600), seed=0), pcg_backend="pcg_kernel", device="cpu")
    assert calls == []
    gt.solve(IIWA_700, one, pcg_backend="pcg_kernel", device="cpu")
    assert calls == [(1, 700, 14, 14)]


def _jopts(**kw):
    return gato_tpu.SolverOptions(**kw)


def _same_iters(ours, ref, exit_tol):
    oi, ri = _np(ours.iters).reshape(-1), np.asarray(ref.iters).reshape(-1)
    oe, re_ = _np(ours.eta).reshape(-1), np.asarray(ref.eta).reshape(-1)
    np.testing.assert_array_equal(_np(ours.converged).reshape(-1),
                                  np.asarray(ref.converged).reshape(-1))
    for i in np.nonzero(oi != ri)[0]:
        early = oe[i] if oi[i] < ri[i] else re_[i]
        assert abs(int(oi[i]) - int(ri[i])) == 1 and \
            abs(early - exit_tol) <= ETA_TIE * exit_tol, (i, oi[i], ri[i])


def _matches(ours, ref, exit_tol, tol=5e-4):
    _same_iters(ours, ref, exit_tol)
    for name in ("lam", "dz_x", "dz_u"):
        assert _rel(getattr(ours, name), np.asarray(getattr(ref, name))) < tol, name


def test_slice_end_to_end_past_kernel_b(monkeypatch):
    """The slice at IIWA width just past kernel B's shared memory (K =
    700), on the CPU through the long-K tier's plain versions: solve,
    solve_batched (B = 2), solve_sequence_batched (B = 2, T = 3) and
    pack / solve_packed, against gato_tpu's 'jax' path."""
    calls = []
    real = kl.solve_longk_batched
    monkeypatch.setattr(kl, "solve_longk_batched",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    exit_tol = 1e-6
    opts = gt.SolverOptions(rho=RHO, exit_tol=exit_tol, max_iters=200)
    jopts = _jopts(rho=RHO, exit_tol=exit_tol, max_iters=200)
    jspec = gato_tpu.ProblemSpec(14, 7, 700)
    batch = _batch(IIWA_700, [20, 21])
    one = gt.KKTBlocks(*(a[0] for a in batch))

    ours = gt.solve(IIWA_700, one, opts, pcg_backend="pcg_kernel", device="cpu")
    ref = gato_tpu.solve(jspec, gato_tpu.KKTBlocks(*one), jopts, pcg_backend="jax")
    _matches(ours, ref, exit_tol)
    ours = gt.solve_batched(IIWA_700, batch, opts, pcg_backend="pcg_kernel",
                            device="cpu")
    ref = gato_tpu.solve_batched(jspec, gato_tpu.KKTBlocks(*batch), jopts,
                                 pcg_backend="jax")
    _matches(ours, ref, exit_tol)
    packed = gt.pack(IIWA_700, batch, device="cpu")
    assert packed.plan.tier == "longk"
    _matches(gt.solve_packed(packed, opts).unpack(), ref, exit_tol)
    assert len(calls) == 3

    farm = tt.random_farm(IIWA_700, 3, 2, seed0=22)
    ours = gt.solve_sequence_batched(IIWA_700, farm, opts, pcg_backend="pcg_kernel",
                                     device="cpu")
    ref = jmpc.solve_sequence_batched(jspec, gato_tpu.KKTBlocks(*farm), jopts,
                                      pcg_backend="jax")
    _matches(ours, ref, exit_tol)
    assert len(calls) == 3 + 3
    window = gt.solve_packed_sequence(gt.pack_sequence(IIWA_700, farm, device="cpu"),
                                      opts)
    for name in ("lam_p", "iters"):
        assert torch.equal(getattr(window, name),
                           getattr(ours, {"lam_p": "lam"}.get(name, name)))
    assert bool(ours.converged.all())
