"""gato_tpu_torch.packed (the packed serving surface) against
gato_tpu.packed on the same NumPy inputs, with device="cpu", at
tests/test_packed.py's shape (3, 2, 10).

gato_tpu's packed surface runs its Pallas kernels in interpret mode here;
ours runs the kernels' plain versions.  Against gato_tpu: rtol = atol =
1e-4 of each array's scale, iteration counts and converged flags equal.
Inside the port, the packed surface runs the same code on the same arrays
as solve_batched and solve_sequence_batched, so there it is bit-identical.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gato_tpu
from gato_tpu import packed as jpk

import gato_tpu_torch as gt
from gato_tpu_torch import packed as pk
from gato_tpu_torch import testing as tt
from gato_tpu_torch.kernels import thomas_batch as kt
from gato_tpu_torch.problem import Preconditioner

torch.set_num_threads(1)

SPEC = gt.ProblemSpec(3, 2, 10)
JSPEC = gato_tpu.ProblemSpec(3, 2, 10)
OPTS = gt.SolverOptions(rho=1e-3, exit_tol=1e-10, max_iters=300)
JOPTS = gato_tpu.SolverOptions(rho=1e-3, exit_tol=1e-10, max_iters=300)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(ours, ref):
    ours, ref = _np(ours).astype(np.float64), _np(ref).astype(np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4 * scale)


def _matches_gato_tpu(ours, ref):
    np.testing.assert_array_equal(_np(ours.iters), _np(ref.iters))
    np.testing.assert_array_equal(_np(ours.converged), _np(ref.converged))
    for name in ("lam", "dz_x", "dz_u"):
        _close(getattr(ours, name), getattr(ref, name))


def _same(res, ref):
    for name in ("lam", "dz_x", "dz_u", "iters", "converged", "eta"):
        assert torch.equal(getattr(res, name), getattr(ref, name)), name


def _jblocks(blocks):
    return gato_tpu.KKTBlocks(*(jnp.asarray(a) for a in blocks))


def _seq_stack(T, B, seed0):
    """tests/test_packed.py's farm: frozen matrices, q moved by 0.01 a step."""
    rng = np.random.default_rng(seed0)
    base = tt.random_batch(SPEC, B, seed0=seed0)
    qs = (base.q[None] + 0.01 * rng.normal(size=(T,) + base.q.shape)).astype(np.float32)
    return gt.KKTBlocks(*(np.broadcast_to(a, (T,) + a.shape).copy()
                          for a in base))._replace(q=qs)


def test_packed_matches_gato_tpu_and_solve_batched():
    bb = tt.random_batch(SPEC, 5, seed0=11)
    res = pk.solve_packed(pk.pack(SPEC, bb, device="cpu"), OPTS).unpack()
    ref = jpk.solve_packed(jpk.pack(JSPEC, _jblocks(bb)), JOPTS).unpack()
    _matches_gato_tpu(res, ref)
    _same(res, gt.solve_batched(SPEC, bb, OPTS, pcg_backend="fused",
                                device="cpu"))


def test_packed_single_problem():
    one = tt.random_blocks(SPEC, seed=40)
    packed = pk.pack(SPEC, one, device="cpu")
    assert not packed.plan.batched and packed.plan.batch == 1
    res = pk.solve_packed(packed, OPTS).unpack()
    assert tuple(res.lam.shape) == (SPEC.knot_points, SPEC.state_size)
    assert res.iters.ndim == 0
    _same(res, gt.solve(SPEC, one, OPTS, pcg_backend="fused", device="cpu"))
    ref = gato_tpu.solve(JSPEC, _jblocks(one), JOPTS, pcg_backend="jax")
    _matches_gato_tpu(res, ref)


@pytest.mark.parametrize("precond", ["jacobi", "block_jacobi"])
def test_packed_preconditioner_variants(precond):
    bb = tt.random_batch(SPEC, 3, seed0=55)
    opts = dataclasses.replace(OPTS, preconditioner=Preconditioner(precond))
    res = pk.solve_packed(pk.pack(SPEC, bb, device="cpu"), opts).unpack()
    _same(res, gt.solve_batched(SPEC, bb, opts, pcg_backend="fused",
                                device="cpu"))
    ref = gato_tpu.solve_batched(
        JSPEC, _jblocks(bb), dataclasses.replace(JOPTS, preconditioner=precond),
        pcg_backend="jax")
    _matches_gato_tpu(res, ref)


def test_update_vectors_matches_full_repack():
    bb = tt.random_batch(SPEC, 3, seed0=70)
    bb2 = tt.random_batch(SPEC, 3, seed0=170)
    mixed = bb._replace(q=bb2.q, r=bb2.r, c=bb2.c)
    packed = pk.pack(SPEC, bb, device="cpu")
    refreshed = pk.update_vectors(packed, bb2.q, bb2.r, bb2.c)
    full = pk.pack(SPEC, mixed, device="cpu")
    for f in ("Qb", "Rb", "Ab", "Bb", "qb", "rb", "cb"):
        assert torch.equal(getattr(full, f), getattr(refreshed, f)), f
    assert refreshed.Qb is packed.Qb           # the matrices are not restaged
    res = pk.solve_packed(refreshed, OPTS).unpack()
    _same(res, pk.solve_packed(full, OPTS).unpack())
    jpacked = jpk.update_vectors(jpk.pack(JSPEC, _jblocks(bb)),
                                 jnp.asarray(bb2.q), jnp.asarray(bb2.r),
                                 jnp.asarray(bb2.c))
    _matches_gato_tpu(res, jpk.solve_packed(jpacked, JOPTS).unpack())


def test_packed_warm_start_carry():
    bb = tt.random_batch(SPEC, 2, seed0=100)
    packed = pk.pack(SPEC, bb, device="cpu")
    first = pk.solve_packed(packed, OPTS)
    again = pk.solve_packed(packed, OPTS, lam0=first.lam_packed)
    assert int(again.iters.max()) <= 1
    public = pk.solve_packed(packed, OPTS, lam0=first.unpack().lam.numpy())
    _same(again.unpack(), public.unpack())
    jp = jpk.pack(JSPEC, _jblocks(bb))
    jfirst = jpk.solve_packed(jp, JOPTS)
    _matches_gato_tpu(first.unpack(), jfirst.unpack())
    jagain = jpk.solve_packed(jp, JOPTS, lam0=jfirst.lam_packed)
    _matches_gato_tpu(again.unpack(), jagain.unpack())


@pytest.mark.parametrize("tier", [None, "cr", "thomas"])
def test_packed_direct_tiers_match_gato_tpu(tier):
    """pack(method='direct', tier=...) -> solve_packed -> update_vectors ->
    solve_packed against gato_tpu's packed exact solve and against
    solve_batched; the tier decides the kernel (its plain version here):
    auto picks 'cr' below B = 16 and 'thomas' from it."""
    jopts = dataclasses.replace(JOPTS, method="direct")
    opts = dataclasses.replace(OPTS, method="direct")
    for n in (3, 16):
        bb = tt.random_batch(SPEC, n, seed0=400)
        bb2 = tt.random_batch(SPEC, n, seed0=500)
        packed = pk.pack(SPEC, bb, method="direct", tier=tier, device="cpu")
        want = tier or ("thomas" if n >= 16 else "cr")
        assert packed.plan.tier == want and packed.plan.method == "direct"
        res = pk.solve_packed(packed, opts).unpack()
        jp = jpk.pack(JSPEC, _jblocks(bb), method="direct", tier=tier)
        _matches_gato_tpu(res, jpk.solve_packed(jp, jopts).unpack())
        assert bool(res.converged.all()) and not res.iters.any()
        if want == ("thomas" if n >= 16 else "cr"):
            _same(res, gt.solve_batched(SPEC, bb, opts, pcg_backend="fused",
                                        device="cpu"))
        refreshed = pk.update_vectors(packed, bb2.q, bb2.r, bb2.c)
        res2 = pk.solve_packed(refreshed, opts).unpack()
        jr = jpk.update_vectors(jp, jnp.asarray(bb2.q), jnp.asarray(bb2.r),
                                jnp.asarray(bb2.c))
        _matches_gato_tpu(res2, jpk.solve_packed(jr, jopts).unpack())


def test_packed_direct_single_problem_and_budget(monkeypatch):
    one = tt.random_blocks(SPEC, seed=41)
    opts = dataclasses.replace(OPTS, method="direct")
    packed = pk.pack(SPEC, one, method="direct", device="cpu")
    assert packed.plan.tier == "cr" and not packed.plan.batched
    res = pk.solve_packed(packed, opts).unpack()
    assert res.iters.ndim == 0 and int(res.iters) == 0
    _same(res, gt.solve(SPEC, one, opts, pcg_backend="fused", device="cpu"))
    ref = gato_tpu.solve(JSPEC, _jblocks(one),
                         dataclasses.replace(JOPTS, method="direct"),
                         pcg_backend="jax")
    _matches_gato_tpu(res, ref)
    # A pack made for 'direct' serves 'pcg' too (kernel B on the same tensors).
    _same(pk.solve_packed(packed, OPTS).unpack(),
          gt.solve(SPEC, one, OPTS, pcg_backend="fused", device="cpu"))
    # A forced 'thomas' past the factor-stack budget raises; auto falls to 'cr'.
    bb = tt.random_batch(SPEC, 16, seed0=600)
    monkeypatch.setattr(kt, "FACTOR_BUDGET_BYTES", kt.factor_bytes(15, 10, 3, 2))
    with pytest.raises(ValueError, match="tier='thomas' was requested"):
        pk.pack(SPEC, bb, method="direct", tier="thomas", device="cpu")
    assert pk.pack(SPEC, bb, method="direct", device="cpu").plan.tier == "cr"


def test_packed_sequence_matches_gato_tpu_and_mpc():
    seq = _seq_stack(T=4, B=3, seed0=20)
    res = pk.solve_packed_sequence(pk.pack_sequence(SPEC, seq, device="cpu"),
                                   OPTS).unpack()
    assert tuple(res.lam.shape) == (4, 3, 10, 3)
    _same(res, gt.solve_sequence_batched(SPEC, seq, OPTS, pcg_backend="fused",
                                         device="cpu"))
    ref = jpk.solve_packed_sequence(jpk.pack_sequence(JSPEC, _jblocks(seq)),
                                    JOPTS).unpack()
    _matches_gato_tpu(res, ref)


def test_packed_sequence_window_carry():
    """Two windows carried by lam_tail_packed reproduce one window bit for
    bit, and the windows match gato_tpu's."""
    seq = _seq_stack(T=6, B=3, seed0=21)
    full = pk.solve_packed_sequence(pk.pack_sequence(SPEC, seq, device="cpu"),
                                    OPTS)
    first = gt.KKTBlocks(*(a[:3] for a in seq))
    second = gt.KKTBlocks(*(a[3:] for a in seq))
    r1 = pk.solve_packed_sequence(pk.pack_sequence(SPEC, first, device="cpu"),
                                  OPTS)
    r2 = pk.solve_packed_sequence(pk.pack_sequence(SPEC, second, device="cpu"),
                                  OPTS, lam0=r1.lam_tail_packed)
    _same(gt.SolveResult(*(torch.cat([a, b]) for a, b in
                           zip(r1.unpack(), r2.unpack()))), full.unpack())
    j1 = jpk.solve_packed_sequence(jpk.pack_sequence(JSPEC, _jblocks(first)),
                                   JOPTS)
    j2 = jpk.solve_packed_sequence(jpk.pack_sequence(JSPEC, _jblocks(second)),
                                   JOPTS, lam0=j1.lam_tail_packed)
    _matches_gato_tpu(r2.unpack(), j2.unpack())


def test_packed_validation():
    bb = tt.random_batch(SPEC, 2, seed0=160)
    packed = pk.pack(SPEC, bb, device="cpu")
    with pytest.raises(ValueError, match="float32-only"):
        pk.solve_packed(packed, dataclasses.replace(OPTS, dtype="float64"))
    with pytest.raises(ValueError, match="unknown method"):
        pk.pack(SPEC, bb, method="thomas", device="cpu")
    # method='direct' packs and solves (gato_tpu's exact packed solve), from a
    # 'direct' pack and from a 'pcg' one (the layout is the same).
    direct = dataclasses.replace(OPTS, method="direct")
    jref = jpk.solve_packed(jpk.pack(JSPEC, _jblocks(bb), method="direct"),
                            dataclasses.replace(JOPTS, method="direct")).unpack()
    _matches_gato_tpu(pk.solve_packed(pk.pack(SPEC, bb, method="direct",
                                              device="cpu"), direct).unpack(), jref)
    _matches_gato_tpu(pk.solve_packed(packed, direct).unpack(), jref)
    with pytest.raises(ValueError, match="explicit tiers exist for method='direct'"):
        pk.pack(SPEC, bb, tier="cr", device="cpu")
    with pytest.raises(ValueError, match="explicit tiers exist"):
        pk.pack(SPEC, bb, method="direct", tier="longk", device="cpu")
    with pytest.raises(ValueError, match="float32-only"):
        pk.pack(SPEC, bb._replace(Q=bb.Q.astype(np.float64)), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        pk.pack(gt.ProblemSpec(4, 2, 10), bb, device="cpu")
    with pytest.raises(ValueError, match="blocks.c shape"):
        pk.pack(SPEC, bb._replace(c=bb.c[:, :-1, :]), device="cpu")
    with pytest.raises(ValueError, match="q shape"):
        pk.update_vectors(packed, np.zeros((2, 4, 3), np.float32), bb.r, bb.c)
    with pytest.raises(ValueError, match="float32-only"):
        pk.update_vectors(packed, bb.q.astype(np.float64), bb.r, bb.c)
    with pytest.raises(ValueError, match="lam0 shape"):
        pk.solve_packed(packed, OPTS, lam0=np.zeros((7, 7), np.float32))
    single = pk.pack(SPEC, tt.random_blocks(SPEC, seed=1), device="cpu")
    with pytest.raises(ValueError, match="lam0 shape"):
        pk.solve_packed(single, OPTS, lam0=np.zeros((10, 4), np.float32))
    with pytest.raises(ValueError, match="unbatched pack"):
        pk.update_vectors(single, bb.q, bb.r, bb.c)


def test_pack_sequence_validation():
    seq = _seq_stack(T=2, B=2, seed0=22)
    with pytest.raises(ValueError, match="warm-started PCG farm"):
        pk.pack_sequence(SPEC, seq, method="direct", device="cpu")
    with pytest.raises(ValueError, match=r"leading \(T, B\) axes"):
        pk.pack_sequence(SPEC, gt.KKTBlocks(*(a[0] for a in seq)),
                         device="cpu")
    ps = pk.pack_sequence(SPEC, seq, device="cpu")
    assert ps.T == 2 and ps.plan.batch == 2
    with pytest.raises(ValueError, match="method='direct'"):
        pk.solve_packed_sequence(ps, gt.SolverOptions(rho=1e-3, method="direct"))
    with pytest.raises(ValueError, match="float32-only"):
        pk.solve_packed_sequence(ps, dataclasses.replace(OPTS, dtype="float64"))
    with pytest.raises(ValueError, match="lam0 shape"):
        pk.solve_packed_sequence(ps, OPTS, lam0=np.zeros((7, 7), np.float32))


def test_packed_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    bb = tt.random_batch(SPEC, 2)
    with pytest.raises(RuntimeError, match="is_available"):
        pk.pack(SPEC, bb)
    with pytest.raises(RuntimeError, match="is_available"):
        pk.pack_sequence(SPEC, _seq_stack(T=2, B=2, seed0=0))
    assert gt.pack is pk.pack and gt.solve_packed_sequence is pk.solve_packed_sequence
