"""gato_tpu_torch.mpc (solve_sequence, solve_sequence_batched) against
gato_tpu.mpc on the same NumPy inputs, with device="cpu".

On the CPU the 'fused' backend runs the sequence kernel's plain version
(kernels/fused_sequence.py), 'pcg_kernel' the PCG kernel's.  Tolerances:
rtol = atol = 1e-4 of each array's scale in float32, 1e-10 in float64;
iteration counts equal, except an exit one iteration apart where the
earlier exit's eta lies within 1e-3 (relative) of exit_tol, a float32
round-off tie (CLAUDE.md's second exception).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gato_tpu
from gato_tpu import mpc as jmpc

import gato_tpu_torch as gt
from gato_tpu_torch import mpc
from gato_tpu_torch import testing as tt
from gato_tpu_torch.kernels import fused_sequence as ks

torch.set_num_threads(1)

BACKENDS = ["torch", "pcg_kernel", "fused"]
ETA_TIE = 1e-3


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(ours, ref, tol=1e-4):
    ours, ref = _np(ours).astype(np.float64), _np(ref).astype(np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol * scale)


def _same_iters(ours, ref, exit_tol):
    """Equal iteration counts and converged flags, but for round-off ties."""
    oi, ri = _np(ours.iters).reshape(-1), _np(ref.iters).reshape(-1)
    oe, re_ = _np(ours.eta).reshape(-1), _np(ref.eta).reshape(-1)
    np.testing.assert_array_equal(_np(ours.converged), _np(ref.converged))
    for i in np.nonzero(oi != ri)[0]:
        early = oe[i] if oi[i] < ri[i] else re_[i]
        assert abs(int(oi[i]) - int(ri[i])) == 1 and \
            abs(early - exit_tol) <= ETA_TIE * exit_tol, (i, oi[i], ri[i])


def _same_result(ours, ref, exit_tol, tol=1e-4):
    _same_iters(ours, ref, exit_tol)
    for name in ("lam", "dz_x", "dz_u"):
        _close(getattr(ours, name), getattr(ref, name), tol)


def _same_direct(ours, ref, tol=1e-4):
    """Exact solves: iters 0, converged equal, lambda and dz within tol."""
    assert not _np(ours.iters).any() and not np.asarray(ref.iters).any()
    np.testing.assert_array_equal(_np(ours.converged), _np(ref.converged))
    for name in ("lam", "dz_x", "dz_u"):
        _close(getattr(ours, name), getattr(ref, name), tol)


def _stack_steps(steps, axis=0):
    return gt.KKTBlocks(*(np.stack([np.asarray(s[f]) for s in steps], axis=axis)
                          for f in range(7)))


def _tile(blocks, T):
    return gt.KKTBlocks(*(np.broadcast_to(np.asarray(a), (T,) + np.asarray(a).shape).copy()
                          for a in blocks))


def _jspec(spec):
    return gato_tpu.ProblemSpec(spec.state_size, spec.control_size,
                                spec.knot_points)


def _jblocks(blocks):
    return gato_tpu.KKTBlocks(*(jnp.asarray(a) for a in blocks))


@pytest.mark.parametrize("backend", BACKENDS)
def test_sequence_matches_gato_tpu(backend):
    spec = gt.ProblemSpec(4, 2, 16)
    T = 5
    seq = _stack_steps([tt.random_blocks(spec, seed=300 + t) for t in range(T)])
    kw = dict(exit_tol=1e-10, max_iters=400, rho=0.01)
    ours = gt.solve_sequence(spec, seq, gt.SolverOptions(**kw),
                             pcg_backend=backend, device="cpu")
    ref = jmpc.solve_sequence(_jspec(spec), _jblocks(seq),
                              gato_tpu.SolverOptions(**kw), pcg_backend="jax")
    assert tuple(ours.lam.shape) == (T, 16, 4)
    assert tuple(ours.dz_u.shape) == (T, 15, 2)
    _same_result(ours, ref, 1e-10)


def test_sequence_lam0_and_per_step_rho_match_gato_tpu():
    spec = gt.ProblemSpec(4, 2, 16)
    T = 5
    seq = _stack_steps([tt.random_blocks(spec, seed=310 + t) for t in range(T)])
    lam0 = np.random.default_rng(3).normal(size=(16, 4)).astype(np.float32)
    rhos = np.array([1e-3, 1e-2, 1e-1, 3e-2, 1e-3], dtype=np.float32)
    kw = dict(exit_tol=1e-10, max_iters=400, rho=0.5)   # rho is overridden
    ours = gt.solve_sequence(spec, seq, gt.SolverOptions(**kw), lam0=lam0,
                             rhos=rhos, device="cpu")
    ref = jmpc.solve_sequence(_jspec(spec), _jblocks(seq),
                              gato_tpu.SolverOptions(**kw), lam0=lam0,
                              rhos=jnp.asarray(rhos), pcg_backend="jax")
    _same_result(ours, ref, 1e-10)
    for t in range(T):
        one = gt.KKTBlocks(*(a[t] for a in seq))
        lam_ref, _ = tt.dense_oracle(spec, one, rho=float(rhos[t]))
        np.testing.assert_allclose(ours.lam[t].numpy().reshape(-1), lam_ref,
                                   rtol=2e-3, atol=2e-3, err_msg=f"step {t}")


def test_sequence_warm_start_reduces_iters():
    """Identical problems repeated: step 0 pays the full count, later steps
    converge at once from the carried multipliers, as in gato_tpu."""
    spec = gt.ProblemSpec(4, 2, 20)
    blocks = tt.random_blocks(spec, seed=44)
    seq = _tile(blocks, 4)
    kw = dict(exit_tol=1e-8, max_iters=300, rho=0.01)
    ours = gt.solve_sequence(spec, seq, gt.SolverOptions(**kw), device="cpu")
    ref = jmpc.solve_sequence(_jspec(spec), _jblocks(seq),
                              gato_tpu.SolverOptions(**kw), pcg_backend="jax")
    _same_result(ours, ref, 1e-8)
    iters = ours.iters.tolist()
    assert iters[0] > 5 and all(i <= 1 for i in iters[1:])
    lam_ref, _ = tt.dense_oracle(spec, blocks, rho=0.01)
    np.testing.assert_allclose(ours.lam[-1].numpy().reshape(-1), lam_ref,
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sequence_batched_matches_gato_tpu_and_independent_sequences(backend):
    spec = gt.ProblemSpec(4, 2, 12)
    T, B = 4, 3
    streams = [_stack_steps([tt.random_blocks(spec, seed=700 + 10 * b + t)
                             for t in range(T)]) for b in range(B)]
    farm = gt.KKTBlocks(*(np.stack([s[f] for s in streams], axis=1)
                          for f in range(7)))
    kw = dict(exit_tol=1e-10, max_iters=400, rho=0.01)
    opts = gt.SolverOptions(**kw)
    ours = gt.solve_sequence_batched(spec, farm, opts, pcg_backend=backend,
                                     device="cpu")
    assert tuple(ours.lam.shape) == (T, B, 12, 4)
    ref = jmpc.solve_sequence_batched(_jspec(spec), _jblocks(farm),
                                      gato_tpu.SolverOptions(**kw),
                                      pcg_backend="jax")
    _same_result(ours, ref, 1e-10)
    for b in range(B):
        alone = gt.solve_sequence(spec, streams[b], opts, pcg_backend=backend,
                                  device="cpu")
        _same_result(gt.SolveResult(*(t[:, b] for t in ours)), alone, 1e-10)


def test_fused_sequence_matches_pallas_interpret():
    """The 'fused' route's plain version against gato_tpu's sequence kernel
    in interpret mode: a slowly varying farm, a lam0, per-step rhos."""
    spec = gt.ProblemSpec(3, 2, 10)
    T, B = 3, 2
    farm = tt.random_farm(spec, T, B, seed0=20)
    lam0 = np.random.default_rng(5).normal(size=(B, 10, 3)).astype(np.float32)
    rhos = np.array([1e-3, 1e-2, 1e-3], dtype=np.float32)
    kw = dict(exit_tol=1e-10, max_iters=300)
    ours = gt.solve_sequence_batched(spec, farm, gt.SolverOptions(**kw),
                                     lam0=lam0, rhos=rhos, pcg_backend="fused",
                                     device="cpu")
    ref = jmpc.solve_sequence_batched(_jspec(spec), _jblocks(farm),
                                      gato_tpu.SolverOptions(**kw), lam0=lam0,
                                      rhos=jnp.asarray(rhos),
                                      pcg_backend="fused")
    _same_result(ours, ref, 1e-10)


def test_sequence_float64_matches_gato_tpu():
    spec = gt.ProblemSpec(4, 2, 10)
    T = 3
    seq = _stack_steps([tt.random_blocks(spec, seed=50 + t, dtype=np.float64)
                        for t in range(T)])
    rhos = np.array([1e-3, 1e-2, 1e-1])
    kw = dict(exit_tol=1e-22, max_iters=400, dtype="float64")
    ours = gt.solve_sequence(spec, seq, gt.SolverOptions(**kw), rhos=rhos,
                             device="cpu")
    assert ours.lam.dtype == torch.float64
    with jax.enable_x64(True):
        ref = jmpc.solve_sequence(_jspec(spec), _jblocks(seq),
                                  gato_tpu.SolverOptions(**kw),
                                  rhos=jnp.asarray(rhos), pcg_backend="jax")
        np.testing.assert_array_equal(ours.iters.numpy(), np.asarray(ref.iters))
        for name in ("lam", "dz_x", "dz_u"):
            _close(getattr(ours, name), getattr(ref, name), 1e-10)


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_sequence_batched_direct_matches_per_step_batches(backend):
    """The exact farm (method='direct', tests/test_mpc.py:106-143): a (T, B)
    sequence equals the T per-step solve_batched(method='direct') calls,
    per-step rhos included (folded into the Q and R diagonals before one
    batched call), and gato_tpu's farm.  On the CPU 'fused' runs the
    kernels' plain versions: T*B = 12 problems take row 4's."""
    spec = gt.ProblemSpec(4, 2, 12)
    T, Bn = 3, 4
    steps = [[tt.random_blocks(spec, seed=900 + 10 * t + b) for b in range(Bn)]
             for t in range(T)]
    seq = gt.KKTBlocks(*(np.stack([np.stack([np.asarray(steps[t][b][f])
                                             for b in range(Bn)])
                                   for t in range(T)]) for f in range(7)))
    rhos = np.array([1e-2, 5e-2, 1e-3], dtype=np.float32)
    res = gt.solve_sequence_batched(spec, seq, gt.SolverOptions(method="direct"),
                                    rhos=rhos, pcg_backend=backend, device="cpu")
    assert tuple(res.lam.shape) == (T, Bn, 12, 4)
    assert bool(res.converged.all()) and not res.iters.any()
    for t in range(T):
        ref = gt.solve_batched(spec, gt.KKTBlocks(*(a[t] for a in seq)),
                               gt.SolverOptions(method="direct", rho=float(rhos[t])),
                               pcg_backend="torch", device="cpu")
        for name in ("lam", "dz_u"):
            np.testing.assert_allclose(getattr(res, name)[t].numpy(),
                                       getattr(ref, name).numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=f"t={t}")
    jref = jmpc.solve_sequence_batched(_jspec(spec), _jblocks(seq),
                                       gato_tpu.SolverOptions(method="direct"),
                                       rhos=jnp.asarray(rhos))
    _same_direct(res, jref)


def test_sequence_direct_single_stream_matches_per_step():
    """solve_sequence(method='direct') (tests/test_mpc.py:146-160): T
    independent exact solves run as one batch over the T axis, equal to
    per-step solve(method='direct') and to gato_tpu; lam0 is ignored."""
    spec = gt.ProblemSpec(3, 2, 8)
    T = 4
    steps = [tt.random_blocks(spec, seed=700 + t) for t in range(T)]
    seq = _stack_steps(steps)
    opts = gt.SolverOptions(method="direct", rho=1e-2)
    lam0 = np.ones((8, 3), np.float32)
    res = gt.solve_sequence(spec, seq, opts, lam0=lam0, device="cpu")
    assert tuple(res.lam.shape) == (T, 8, 3)
    for t in range(T):
        ref = gt.solve(spec, steps[t], opts, device="cpu")
        np.testing.assert_allclose(res.lam[t].numpy(), ref.lam.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=f"t={t}")
    jref = jmpc.solve_sequence(_jspec(spec), _jblocks(seq),
                               gato_tpu.SolverOptions(method="direct", rho=1e-2))
    _same_direct(res, jref)


def test_direct_farm_float64_and_thomas_width_match_gato_tpu():
    """A farm of T*B = 16 problems takes the block-Thomas pair's plain
    versions on the 'fused' route; float64 runs the 'torch' backend.  Both
    against gato_tpu's exact farm."""
    spec = gt.ProblemSpec(3, 2, 7)
    farm = tt.random_farm(spec, 4, 4, seed0=80)
    rhos = np.array([1e-3, 2e-3, 1e-3, 2e-3], np.float32)
    res = gt.solve_sequence_batched(spec, farm, gt.SolverOptions(method="direct"),
                                    rhos=rhos, pcg_backend="fused", device="cpu")
    jref = jmpc.solve_sequence_batched(_jspec(spec), _jblocks(farm),
                                       gato_tpu.SolverOptions(method="direct"),
                                       rhos=jnp.asarray(rhos))
    _same_direct(res, jref)
    f64 = gt.KKTBlocks(*(np.asarray(a, np.float64) for a in farm))
    kw = dict(method="direct", dtype="float64")
    ours = gt.solve_sequence_batched(spec, f64, gt.SolverOptions(**kw),
                                     rhos=rhos.astype(np.float64), device="cpu")
    assert ours.lam.dtype == torch.float64
    with jax.enable_x64(True):
        ref = jmpc.solve_sequence_batched(_jspec(spec), _jblocks(f64),
                                          gato_tpu.SolverOptions(**kw),
                                          rhos=jnp.asarray(rhos, jnp.float64))
        _same_direct(ours, ref, tol=1e-10)


def test_singular_step_is_frozen_alone():
    """An exactly singular step (rho = 0) in the middle of one stream: only
    that (t, b) is frozen, it hands its lambda_0 on unchanged, and the
    stream's later steps converge."""
    spec = gt.ProblemSpec(4, 2, 8)
    T, B = 4, 2
    farm = tt.random_farm(spec, T, B, seed0=30)
    bad = tt.singular_blocks(spec, seed=3, knot=2)
    Q = farm.Q.copy()
    Q[2, 1] = bad.Q
    farm = farm._replace(Q=Q)
    opts = gt.SolverOptions(exit_tol=1e-8, max_iters=40, rho=0.0)
    res = gt.solve_sequence_batched(spec, farm, opts, pcg_backend="fused",
                                    device="cpu")
    conv = res.converged.numpy()
    assert not conv[2, 1] and conv.sum() == T * B - 1
    assert int(res.iters[2, 1]) == 40
    assert float(res.eta[2, 1]) == float(np.float32(1e30))
    assert torch.equal(res.lam[2, 1], res.lam[1, 1])
    lam_ref, _ = tt.dense_oracle(spec, gt.KKTBlocks(*(a[3, 1] for a in farm)))
    np.testing.assert_allclose(res.lam[3, 1].numpy().reshape(-1), lam_ref,
                               rtol=2e-3, atol=2e-3)


def test_sequence_wrapper_on_cpu_launches_nothing():
    spec = gt.ProblemSpec(2, 1, 5)
    farm = gt.blocks_to_torch(tt.random_farm(spec, 2, 2, seed0=1), "cpu")
    before = ks.LAUNCHES
    res, dz_x, dz_u = ks.fused_sequence_cuda(
        *farm, torch.zeros(2, 5, 2), torch.tensor([1e-3, 1e-2]))
    assert ks.LAUNCHES == before
    assert tuple(res.iters.shape) == (2, 2) and tuple(dz_u.shape) == (2, 2, 4, 1)
    with pytest.raises(ValueError, match="neither CPU nor CUDA"):
        ks.fused_sequence_cuda(*gt.blocks_to_torch(tt.random_farm(spec, 2, 2, seed0=1), "meta"),
                               torch.zeros(2, 5, 2, device="meta"),
                               torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="unknown preconditioner"):
        ks.fused_sequence_cuda(*farm, torch.zeros(2, 5, 2), torch.zeros(2),
                               preconditioner="ilu")
    with pytest.raises(ValueError, match="T >= 1"):
        ks.fused_sequence_cuda(*(a[0] for a in farm), torch.zeros(2, 5, 2),
                               torch.zeros(2))


def test_sequence_errors():
    spec = gt.ProblemSpec(2, 1, 5)
    farm = tt.random_farm(spec, 2, 3, seed0=2)
    single = gt.KKTBlocks(*(a[:, 0] for a in farm))
    # method='direct' is the exact farm, as in gato_tpu (no longer an error).
    direct = gt.SolverOptions(method="direct", rho=1e-3)
    jdirect = gato_tpu.SolverOptions(method="direct", rho=1e-3)
    _same_direct(gt.solve_sequence_batched(spec, farm, direct, device="cpu"),
                 jmpc.solve_sequence_batched(_jspec(spec), _jblocks(farm), jdirect))
    _same_direct(gt.solve_sequence(spec, single, direct, device="cpu"),
                 jmpc.solve_sequence(_jspec(spec), _jblocks(single), jdirect))
    # 'pcg_kernel' is the long-K exact tier (gato_tpu's 'pallas'), here in
    # its plain versions.
    _same_direct(gt.solve_sequence(spec, single, direct, pcg_backend="pcg_kernel",
                                   device="cpu"),
                 jmpc.solve_sequence(_jspec(spec), _jblocks(single), jdirect))
    with pytest.raises(ValueError, match="unknown pcg_backend"):
        gt.solve_sequence_batched(spec, farm, pcg_backend="nope", device="cpu")
    f64 = gt.SolverOptions(dtype="float64")
    for backend in ("fused", "pcg_kernel"):
        with pytest.raises(ValueError, match="float32-only"):
            gt.solve_sequence(spec, single, f64, pcg_backend=backend,
                              device="cpu")
    with pytest.raises(ValueError, match=r"leading \(T, B\) axes"):
        gt.solve_sequence_batched(spec, single, device="cpu")
    with pytest.raises(ValueError, match="leading T axis"):
        gt.solve_sequence(spec, farm, device="cpu")
    with pytest.raises(ValueError, match="one value per step"):
        gt.solve_sequence(spec, single, rhos=[1e-3] * 3, device="cpu")
    assert mpc.solve_sequence is gt.solve_sequence


def test_sequence_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    spec = gt.ProblemSpec(2, 1, 5)
    farm = tt.random_farm(spec, 2, 2, seed0=3)
    with pytest.raises(RuntimeError, match="is_available"):
        gt.solve_sequence_batched(spec, farm)
    with pytest.raises(RuntimeError, match="is_available"):
        gt.solve_sequence(spec, gt.KKTBlocks(*(a[:, 0] for a in farm)),
                          device="cuda:0")
