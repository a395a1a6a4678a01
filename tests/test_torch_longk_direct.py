"""gato_tpu_torch's long-horizon exact tier (rows 7, 11, 12 and 13:
kernels/longk.py's solve_direct_longk_batched) against gato_tpu on the same
NumPy inputs, with device="cpu", where each kernel wrapper runs its plain
version; and row 14's coverage by the long-K PCG kernel.

gato_tpu's long-K kernels run in Pallas interpret mode with
chunk_lanes=128, as tests/test_longk.py runs them.  Tolerances are
tests/test_longk.py's: lambda and dz within 5e-4 of scale, iters 0 and
converged equal; a peel's outputs blockwise within 1e-5 of scale.  The
routing and the slice run at IIWA width past row 4's shared memory on an
H100 (K = 741 and beyond) against gato_tpu's 'jax' path; K = 1536 is where
gato_tpu's own peel kernel leaves tail lanes unwritten (ROADMAP queue 3),
so the port is held there against 'jax', not against that peel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gato_tpu
from gato_tpu import mpc as jmpc
from gato_tpu.kernels import longk as jlk
from gato_tpu.kernels import pcg_streamed as jps

import gato_tpu_torch as gt
from gato_tpu_torch import assemble, solver
from gato_tpu_torch import testing as tt
from gato_tpu_torch.kernels import longk as kl

torch.set_num_threads(1)

RHO = 1e-3
H100 = 232448
TOL = 5e-4


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


def _result(out):
    """A SolveResult (of either package) as it is; a (PCGResult, dz_x,
    dz_u) triple as a SolveResult."""
    if hasattr(out, "dz_x"):
        return out
    res, dz_x, dz_u = out
    return gt.SolveResult(res.lam, dz_x, dz_u, res.iters, res.converged, res.eta)


def _same_exact(ours, ref, tol=TOL):
    """Exact solves: iters 0, converged equal, lambda and dz within tol of
    scale."""
    ours, ref = _result(ours), _result(ref)
    assert not _np(ours.iters).any() and not np.asarray(ref.iters).any()
    np.testing.assert_array_equal(_np(ours.converged), np.asarray(ref.converged))
    for name in ("lam", "dz_x", "dz_u"):
        assert _rel(getattr(ours, name), getattr(ref, name)) < tol, name


def test_xl_tier_matches_gato_tpu():
    """'xl' (rows 7, 11, 13) against gato_tpu's one-kernel CR tier."""
    b = _batch(gt.ProblemSpec(3, 2, 200), [7, 8])
    ours = kl.solve_direct_longk_batched(*_torch(b), rho=RHO, force_tier="xl")
    ref = jlk.solve_direct_longk_batched(*_jax(b), rho=RHO, chunk_lanes=128,
                                         force_tier="xl")
    _same_exact(ours, ref)
    assert bool(ours[0].converged.all()) and float(ours[0].eta.max()) < 1e-6


def _shrink_xl_budget(monkeypatch):
    """gato_tpu's 'hybrid' peels 512 -> 256 -> 128 lanes at (3, 2, 400)
    (tests/test_longk.py's budget), outside its peel's tail fault."""
    monkeypatch.setattr(jlk, "_DIRECT_XL_BUDGET_BYTES", 128 * 4 * 8 * (10 * 3 + 6))
    assert jlk._hybrid_widths(512, 3, 8) == [512, 256, 128]


def test_hybrid_tier_matches_gato_tpu(monkeypatch):
    """'hybrid' with two peels (400 -> 200 -> 100 rows, then row 11) against
    gato_tpu's two peels and kernel CR."""
    _shrink_xl_budget(monkeypatch)
    monkeypatch.setattr(kl, "HYBRID_CR_ROWS", 100)
    b = _batch(gt.ProblemSpec(3, 2, 400), [5, 6])
    calls = []
    real = kl.peel_longk_cuda
    monkeypatch.setattr(kl, "peel_longk_cuda",
                        lambda S, g: calls.append(S.shape[1]) or real(S, g))
    ours = kl.solve_direct_longk_batched(*_torch(b), rho=RHO, force_tier="hybrid")
    assert calls == [400, 200]
    ref = jlk.solve_direct_longk_batched(*_jax(b), rho=RHO, chunk_lanes=128,
                                         force_tier="hybrid")
    _same_exact(ours, ref)
    assert bool(ours[0].converged.all())


def test_singular_problem_in_a_peeled_level(monkeypatch):
    """A singular Q block (zero row and column, rho = 0) at knot 7, which the
    first peel eliminates: converged False on both sides, eta >= 1e30 and
    finite outputs in the port, and the healthy problem of the batch as if
    it were alone."""
    _shrink_xl_budget(monkeypatch)
    monkeypatch.setattr(kl, "HYBRID_CR_ROWS", 100)
    spec = gt.ProblemSpec(3, 2, 400)
    good = tt.random_blocks(spec, seed=5)
    mix = tt.stack_blocks([good, tt.singular_blocks(spec, seed=3, knot=7)])
    kw = dict(rho=0.0, force_tier="hybrid")
    res, dx, du = kl.solve_direct_longk_batched(*_torch(mix), **kw)
    jres, jdx, jdu = jlk.solve_direct_longk_batched(*_jax(mix), chunk_lanes=128, **kw)
    assert res.converged.tolist() == np.asarray(jres.converged).tolist() == [True, False]
    assert float(res.eta[1]) >= 1e30
    for t in (res.lam, dx, du):
        assert bool(torch.isfinite(t).all())
    alone, ax, au = kl.solve_direct_longk_batched(*_torch(tt.stack_blocks([good])), **kw)
    for x, y, jy in ((res.lam, alone.lam, jres.lam), (dx, ax, jdx), (du, au, jdu)):
        np.testing.assert_allclose(_np(x[:1]), _np(y), rtol=1e-6, atol=1e-7)
        assert _rel(x[:1], np.asarray(jy)[:1]) < TOL


def _pack_system(S, b, sp, Kp):
    """(B, K, 3, s, s), (B, K, s) -> gato_tpu's lane layout (B, 3, s, sp, Kp),
    (B, sp, Kp): block column, block row, knot lane; zero padding."""
    Bn, K, _, s, _ = S.shape
    Sp = np.zeros((Bn, 3, s, sp, Kp), np.float32)
    Sp[:, :, :, :s, :K] = np.transpose(S, (0, 2, 4, 3, 1))
    bp = np.zeros((Bn, sp, Kp), np.float32)
    bp[:, :s, :K] = np.transpose(b, (0, 2, 1))
    return jnp.asarray(Sp), jnp.asarray(bp)


def _unpack_stack(M, s, n):
    """(B, s, sp, W) one-slot stack -> (B, n, s, s) blocks."""
    return np.transpose(np.asarray(M)[:, :, :s, :n], (0, 3, 2, 1))


def _unpack_vec(v, s, n):
    return np.transpose(np.asarray(v)[:, :s, :n], (0, 2, 1))


def _block_close(ours, ref):
    ours, ref = _np(ours), np.asarray(ref)
    scale = float(np.abs(ref).max()) or 1.0
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5 * scale)


def test_peel_matches_gato_tpus_peel_level_by_level():
    """Row 12's plain version against gato_tpu's peel kernel (_peel_call,
    interpret) and its XLA reference (_cr_peel), two levels on the port's
    condensed operators of (3, 2, 400) with a singular odd-row block in
    problem 1: reduced system, D_o^{-1}, the saves and the flags."""
    spec = gt.ProblemSpec(3, 2, 400)
    ops = kl.condense_longk_plain(*_torch(_batch(spec, [5, 9])), rho=RHO,
                                  preconditioner="jacobi")
    S, g = ops.S.clone(), ops.gamma
    S[1, 5, 1, 0, :] = 0.0       # odd row 5: a zero pivot on a live block
    S[1, 5, 1, :, 0] = 0.0
    s, sp = 3, 8
    rng = np.random.default_rng(2)
    Sb, gb = _pack_system(_np(S), _np(g), sp, 512)
    for W_out in (256, 128):
        W, W_in = S.shape[1], Sb.shape[-1]
        Sh, bh, level = kl.peel_longk_plain(S, g)
        we, wo = (W + 1) // 2, W // 2
        assert Sh.shape == (2, we, 3, s, s) and level.Doinv.shape == (2, wo, s, s)
        Ln, Dn, Un, bn, OInv, bad_rows = jlk._peel_call(
            Sb[..., 0::2], Sb[..., 1::2], gb[..., 0::2], gb[..., 1::2],
            s=s, sp=sp, interpret=True)
        for slot, M in enumerate((Ln, Dn, Un)):
            _block_close(Sh[:, :, slot], _unpack_stack(M, s, we))
        _block_close(bh, _unpack_vec(bn, s, we))
        _block_close(level.Doinv, _unpack_stack(OInv, s, wo))
        np.testing.assert_array_equal(_np(level.bad), np.asarray(bad_rows)[:, 0, :wo] > 0)
        if W == 400:
            assert level.bad.any(-1).tolist() == [False, True]
        # The back-substitution of the level from a reduced solution xh.
        xh = rng.normal(size=(2, we, s)).astype(np.float32)
        x = kl.unpeel_longk_plain(torch.from_numpy(xh), level)
        # The XLA reference peel one problem at a time, its saves, and its
        # back-substitution (_cr_unpeel).
        for p in range(2):
            Sx, bx, saved, flag = jlk._cr_peel(Sb[p], gb[p], W_out, s=s, sp=sp)
            for slot in range(3):
                _block_close(Sh[p:p + 1, :, slot], _unpack_stack(Sx[slot][None], s, we))
            _block_close(bh[p:p + 1], _unpack_vec(bx[None], s, we))
            _block_close(level.Doinv[p:p + 1], _unpack_stack(saved[0][None], s, wo))
            for got, want in ((level.S[p:p + 1, 1::2, 0], saved[1]),
                              (level.S[p:p + 1, 1::2, 2], saved[2])):
                _block_close(got, _unpack_stack(want[None], s, wo))
            _block_close(level.b[p:p + 1, 1::2], _unpack_vec(saved[3][None], s, wo))
            assert bool(float(flag) > 0) == bool(level.bad[p].any())
            xhp = np.zeros((sp, W_out), np.float32)
            xhp[:s, :we] = xh[p].T
            ref = jlk._cr_unpeel(jnp.asarray(xhp), saved, W_in, s=s, sp=sp)
            _block_close(x[p], np.asarray(ref)[:s, :W].T)
        S, g = Sh, bh
        Sb, gb = _pack_system(_np(S), _np(g), sp, W_out)


def test_iiwa_past_gato_tpus_peel_fault():
    """IIWA K = 1536, where gato_tpu's peel kernel leaves tail lanes
    unwritten: the port's 'xl' and 'hybrid' (one peel) against gato_tpu's
    'jax' exact path (condense, block Thomas)."""
    spec = gt.ProblemSpec(14, 7, 1536)
    one = tt.random_blocks(spec, seed=11)
    ref = gato_tpu.solve(gato_tpu.ProblemSpec(14, 7, 1536), gato_tpu.KKTBlocks(*one),
                         gato_tpu.SolverOptions(method="direct", rho=RHO),
                         pcg_backend="jax")
    b = _torch(tt.stack_blocks([one]))
    assert kl.hybrid_peels(1536) == 1
    for tier in ("xl", "hybrid"):
        res, dx, du = kl.solve_direct_longk_batched(*b, rho=RHO, force_tier=tier)
        _same_exact(gt.SolveResult(res.lam[0], dx[0], du[0], res.iters[0],
                                   res.converged[0], res.eta[0]), ref)
        assert bool(res.converged[0])


def test_routing_past_row_4(monkeypatch):
    """IIWA K = 800 on an H100: method='direct' below B = 16 resolves to
    'pcg_kernel' (the long-K exact tier), from B = 16 to 'fused' (the
    Thomas pair); an explicit 'fused' below B = 16 raises.  'pcg_kernel' +
    direct runs the tier at any K (50 and 800), solve_packed on a 'direct'
    pack and on a 'longk' PCG pack, and the exact farm, each against
    gato_tpu's 'jax' direct path."""
    spec = gt.ProblemSpec(14, 7, 800)
    shape = (800, 14, 7)
    direct = gt.SolverOptions(method="direct", rho=RHO)
    assert not kl.should_dispatch_direct(740, 14, 7, H100)
    assert kl.should_dispatch_direct(741, 14, 7, H100)
    for B, want in ((1, "pcg_kernel"), (15, "pcg_kernel"), (16, "fused")):
        assert solver._resolve_backend(None, direct, "cuda", shape, H100, B) == want
    assert solver._resolve_backend(None, direct, "cuda", (740, 14, 7), H100, 1) == "fused"
    assert solver._resolve_backend(None, direct, "cpu", shape, H100, 1) == "torch"
    assert solver._resolve_backend("pcg_kernel", direct, "cuda", shape, H100) == "pcg_kernel"
    with pytest.raises(ValueError, match=r"None \(auto\) or 'pcg_kernel'"):
        solver._resolve_backend("fused", direct, "cuda", shape, H100, 15)

    calls = []
    real = kl.solve_direct_longk_batched
    monkeypatch.setattr(kl, "solve_direct_longk_batched",
                        lambda *a, **k: calls.append(a[0].shape[:2]) or real(*a, **k))
    jopts = gato_tpu.SolverOptions(method="direct", rho=RHO)
    for K in (50, 800):
        kspec = gt.ProblemSpec(14, 7, K)
        one = tt.random_blocks(kspec, seed=20 + K)
        ours = gt.solve(kspec, one, direct, pcg_backend="pcg_kernel", device="cpu")
        ref = gato_tpu.solve(gato_tpu.ProblemSpec(14, 7, K), gato_tpu.KKTBlocks(*one),
                             jopts, pcg_backend="jax")
        _same_exact(ours, ref)
    assert calls == [(1, 50), (1, 800)]

    batch = _batch(spec, [30, 31])
    jbatch = gato_tpu.KKTBlocks(*batch)
    jspec = gato_tpu.ProblemSpec(14, 7, 800)
    ref = gato_tpu.solve_batched(jspec, jbatch, jopts, pcg_backend="jax")
    whole = gt.solve_batched(spec, batch, direct, pcg_backend="pcg_kernel", device="cpu")
    _same_exact(whole, ref)
    packed = gt.pack(spec, batch, method="direct", device="cpu")
    assert packed.plan.tier == "longk"
    assert gt.pack(spec, batch, method="direct", tier="cr", device="cpu").plan.tier == "longk"
    got = gt.solve_packed(packed, direct).unpack()
    for name in ("lam", "dz_x", "dz_u", "iters", "converged", "eta"):
        assert torch.equal(getattr(got, name), getattr(whole, name)), name
    pcg_pack = gt.pack(spec, batch, device="cpu")
    assert pcg_pack.plan.tier == "longk" and pcg_pack.plan.method == "pcg"
    _same_exact(gt.solve_packed(pcg_pack, direct).unpack(), ref)
    assert len(calls) == 2 + 3

    farm = tt.random_farm(spec, 2, 3, seed0=40)
    rhos = np.array([RHO, 2 * RHO], np.float32)
    ours = gt.solve_sequence_batched(spec, farm, direct, rhos=rhos,
                                     pcg_backend="pcg_kernel", device="cpu")
    ref = jmpc.solve_sequence_batched(jspec, gato_tpu.KKTBlocks(*farm), jopts,
                                      rhos=jnp.asarray(rhos), pcg_backend="jax")
    assert calls[-1] == (6, 800)
    assert tuple(ours.lam.shape) == (2, 3, 800, 14)
    _same_exact(ours, ref)


def test_row_14_is_covered_by_the_long_k_pcg_kernel(monkeypatch):
    """gato_tpu takes pcg_streamed (row 14's matvec kernel in an XLA PCG
    loop) past longk.fits_vmem, IIWA K = 16384, where the port's long-K PCG
    kernel (rows 8/10) runs: its plain version against pcg_streamed
    (interpret, three lane chunks so the chunk halos are exercised) on the
    same condensed operators, with equal iteration counts."""
    assert not jlk.fits_vmem(16384, 14, 7) and jlk.fits_vmem(8192, 14, 7)
    assert kl.should_dispatch(16384, 14, 7, H100)
    monkeypatch.setattr(jps, "_CHUNK_BYTES", 3 * 3 * 8 * 4 * 128)
    assert jps.plan_chunks(300, 3)[2] == 3
    spec = gt.ProblemSpec(3, 2, 300)
    ops = kl.condense_longk_plain(*_torch(_batch(spec, [12])), rho=RHO)
    kw = dict(exit_tol=1e-8, max_iters=200)
    ours = kl.pcg_longk_plain(ops.S, ops.Pinv, ops.gamma, torch.zeros_like(ops.gamma),
                              **kw)
    ref = jps.pcg_streamed(*(jnp.asarray(_np(x[0])) for x in (ops.S, ops.Pinv,
                                                               ops.gamma)),
                           interpret=True, **kw)
    assert int(ours.iters[0]) == int(ref.iters) and bool(ours.converged[0])
    assert bool(ours.converged[0]) == bool(ref.converged)
    assert _rel(ours.lam[0], ref.lam) < TOL


def test_tier_knobs(monkeypatch):
    spec = gt.ProblemSpec(3, 2, 9)
    b = _torch(_batch(spec, [1]))
    with pytest.raises(ValueError, match="force_tier"):
        kl.solve_direct_longk_batched(*b, force_tier="vmem")
    assert [kl.direct_tier(B, K) for B, K in ((1, 8192), (15, 741), (15, 1024), (8, 2048))] \
        == ["xl", "xl", "hybrid", "hybrid"]
    assert [kl.hybrid_peels(K) for K in (741, 2048, 2049, 4096, 8192)] == [1, 1, 2, 2, 3]
    # every forced tier, and 'hybrid' peeled down to one row (9 -> 5 -> 3 ->
    # 2 -> 1)
    sys_ = assemble.condense(*b, RHO, None)
    ref = kl.cr_longk_plain(sys_.S, sys_.gamma)[0]
    for tier, rows in (("xl", 1024), ("hybrid", 1024), ("hybrid", 1), ("xla", 1024)):
        monkeypatch.setattr(kl, "HYBRID_CR_ROWS", rows)
        res, _, _ = kl.solve_direct_longk_batched(*b, rho=RHO, force_tier=tier)
        assert _rel(res.lam, ref) < 1e-5 and bool(res.converged.all())
        assert rows > 1 or kl.hybrid_peels(9) == 4
    # the auto tier past the rule's threshold: one peel, then row 11
    monkeypatch.setattr(kl, "HYBRID_MIN_ROWS", 9)
    calls = []
    real = kl.peel_longk_cuda
    monkeypatch.setattr(kl, "peel_longk_cuda",
                        lambda S, g: calls.append(S.shape[1]) or real(S, g))
    res, _, _ = kl.solve_direct_longk_batched(*b, rho=RHO)
    assert calls == [9] and _rel(res.lam, ref) < 1e-5
