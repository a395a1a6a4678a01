"""gato_tpu_torch.parallel (knot-sharded solves and data-parallel batches and
farms) against gato_tpu.parallel.sharded on the same NumPy inputs.

gato_tpu runs on the 8-device CPU mesh of tests/conftest.py; the port on
``Mesh(["cpu"] * n)``, where every kernel wrapper runs its plain version
(``use_kernel=True`` there runs rows 7, 13 and 15's plain versions, the
kernel tier's code path).  gato_tpu's kernel tier runs its Pallas kernels
in interpret mode, as tests/test_sharded.py runs them.

Tolerances, each stated at its assert: float32 results within 1e-4 of
scale (the frameworks, and the two placements, add in different orders);
per-shard condensed operators within rtol 2e-4, atol 2e-5 of scale
(tests/test_sharded.py's); float64 within 1e-10.  Iteration counts equal:
the shapes and seeds are tests/test_sharded.py's, chosen there so that no
exit lies within float32 round-off of exit_tol (its K = 64, seed 23 for the
whole solve; K = 32, seed 8 and 21 for PCG alone), and the checks below
print eta's margin when they fail.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import gato_tpu
from gato_tpu import assemble as ja
from gato_tpu import direct as jd
from gato_tpu.parallel import sharded as jsh
from gato_tpu.problem import Preconditioner as JPrec

import gato_tpu_torch as gt
from gato_tpu_torch import assemble, pcg
from gato_tpu_torch import testing as tt
from gato_tpu_torch.kernels import halo_matvec as hm
from gato_tpu_torch.parallel import mesh as pm
from gato_tpu_torch.parallel import sharded as sh

torch.set_num_threads(1)

PRECS = ["symmetric_stair", "block_jacobi", "jacobi"]
RHO = 0.01
KW = dict(exit_tol=1e-10, max_iters=300)
SPEC = gt.ProblemSpec(4, 2, 64)     # tests/test_sharded.py:405-408, seed 23
SEED = 23


def _jmesh(n, name="knot"):
    return JMesh(np.array(jax.devices()[:n]), (name,))


def _mesh(n, name="knot"):
    return gt.Mesh(["cpu"] * n, name)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _scaled(ours, ref, rtol=1e-4, atol=1e-4):
    """|ours - ref| <= rtol |ref| + atol max|ref|."""
    ours, ref = _np(ours).astype(np.float64), _np(ref).astype(np.float64)
    scale = float(np.abs(ref).max()) or 1.0
    np.testing.assert_allclose(ours / scale, ref / scale, rtol=rtol, atol=atol)


def _same_iters(ours, ref, exit_tol=KW["exit_tol"]):
    assert bool(ours.converged) == bool(ref.converged)
    assert int(ours.iters) == int(ref.iters), (
        f"iterations {int(ours.iters)} vs {int(ref.iters)}; eta "
        f"{float(ours.eta):.6e} / {float(ref.eta):.6e}, exit_tol {exit_tol:g}")


def _jsys(blocks, prec="symmetric_stair"):
    return ja.condense(*(jnp.asarray(a) for a in blocks), rho=jnp.float32(RHO),
                       preconditioner=JPrec(prec))


# --------------------------------------------------------------------------
# Row 15 and its plain version.


def _tpu_halo_matvec(S, x, left, right):
    """gato_tpu's _mv_halo_kernel in interpret mode on one packed shard."""
    from jax.experimental import pallas as pl
    from gato_tpu.kernels.pcg_pallas import _LANE, _SUBLANE, _round_up
    from gato_tpu.kernels.pcg_streamed import _pack_operator, _pack_vec

    Kl, s = x.shape
    sp, Lp = _round_up(s, _SUBLANE), _round_up(Kl, _LANE)
    col = lambda v: jnp.pad(jnp.asarray(v)[:, None], ((0, sp - s), (0, 0)))
    y = pl.pallas_call(
        functools.partial(jsh._mv_halo_kernel, s=s, Kl=Kl),
        out_shape=jax.ShapeDtypeStruct((sp, Lp), jnp.float32), interpret=True,
    )(_pack_operator(jnp.asarray(S), Lp, sp), _pack_vec(jnp.asarray(x), Lp, sp),
      col(left), col(right))
    return np.asarray(y)[:s, :Kl].T


# (K, Kl, s): three shards of K; IIWA's s = 14, odd s = 3 and the widest
# s = 32 with Kl not a multiple of 4.
HALO_SHAPES = [(48, 16, 4), (21, 7, 14), (33, 11, 3), (15, 5, 32)]


@pytest.mark.parametrize("K,Kl,s", HALO_SHAPES)
@pytest.mark.parametrize("shard", ["first", "interior", "last"])
def test_halo_matvec_matches_tpu_kernel(shard, K, Kl, s):
    """Row 15's wrapper on CPU tensors (its plain version) against
    gato_tpu's kernel in interpret mode, and against the whole vector's
    btd_matvec on the shard's rows: an edge shard takes zero halos.
    Tolerance 1e-6 of scale: one matvec, float32 sum-order round-off."""
    rng = np.random.default_rng(7)
    S = rng.normal(size=(K, 3, s, s)).astype(np.float32)
    S[0, 0] = S[-1, 2] = 0.0
    x = rng.normal(size=(K, s)).astype(np.float32)
    a = {"first": 0, "interior": Kl, "last": K - Kl}[shard]
    zero = np.zeros(s, np.float32)
    left = x[a - 1] if a > 0 else zero
    right = x[a + Kl] if a + Kl < K else zero
    ours = hm.halo_matvec_cuda(*(torch.from_numpy(v) for v in
                                 (S[a:a + Kl], x[a:a + Kl], left, right)))
    _scaled(ours, _tpu_halo_matvec(S[a:a + Kl], x[a:a + Kl], left, right),
            rtol=1e-6, atol=1e-6)
    whole = gato_tpu.blocktri.btd_matvec(jnp.asarray(S), jnp.asarray(x))
    _scaled(ours, np.asarray(whole)[a:a + Kl], rtol=1e-6, atol=1e-6)
    if shard != "interior":
        # A halo left out is zeros: the trajectory's end.
        halos = {"left": torch.from_numpy(left), "right": torch.from_numpy(right)}
        del halos["left" if shard == "first" else "right"]
        edge = hm.halo_matvec_cuda(torch.from_numpy(S[a:a + Kl]),
                                   torch.from_numpy(x[a:a + Kl]), **halos)
        assert torch.equal(edge, ours)


# --------------------------------------------------------------------------
# pcg_sharded.


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_pcg_sharded_matches_gato_tpu(n, use_kernel):
    """Both tiers against gato_tpu's einsum tier at the same n
    (tests/test_sharded.py:28-44's shape and seed): equal iterations,
    lambda within 1e-4 of scale."""
    blocks = tt.random_blocks(gt.ProblemSpec(4, 2, 32), seed=8)
    js = _jsys(blocks)
    ref = jsh.pcg_sharded(_jmesh(n), js.S, js.Pinv, js.gamma, use_kernel=False,
                          **KW)
    ours = gt.pcg_sharded(_mesh(n), _np(js.S), _np(js.Pinv), _np(js.gamma),
                          use_kernel=use_kernel, **KW)
    assert bool(ours.converged)
    _same_iters(ours, ref)
    _scaled(ours.lam, ref.lam)


def test_pcg_sharded_matches_tpu_kernel_tier():
    """Row 15's path against gato_tpu's kernel tier (its _mv_halo_kernel in
    interpret mode) at n = 2, tests/test_sharded.py:301-317's case."""
    blocks = tt.random_blocks(gt.ProblemSpec(4, 2, 32), seed=21)
    js = _jsys(blocks)
    ref = jsh.pcg_sharded(_jmesh(2), js.S, js.Pinv, js.gamma, use_kernel=True,
                          **KW)
    before = hm.LAUNCHES
    ours = gt.pcg_sharded(_mesh(2), _np(js.S), _np(js.Pinv), _np(js.gamma),
                          use_kernel=True, **KW)
    assert hm.LAUNCHES == before   # CPU tensors: the plain version, no launch
    _same_iters(ours, ref)
    _scaled(ours.lam, ref.lam)


@pytest.mark.parametrize("poly", [1, 2])
def test_pcg_sharded_one_shard_is_pcg(poly):
    """On one shard the loop is pcg.pcg's recurrence with the same
    operations in the same order: bit for bit, iterations equal."""
    tb = gt.blocks_to_torch(tt.random_blocks(SPEC, seed=SEED), "cpu")
    sys_ = assemble.condense(*tb, RHO)
    lam0 = torch.zeros_like(sys_.gamma)
    ref = pcg.pcg(sys_.S, sys_.Pinv, sys_.gamma, lam0, poly_degree=poly, **KW)
    ours = gt.pcg_sharded(_mesh(1), sys_.S, sys_.Pinv, sys_.gamma,
                          poly_degree=poly, **KW)
    assert int(ours.iters) == int(ref.iters) and bool(ours.converged)
    assert torch.equal(ours.lam, ref.lam) and torch.equal(ours.eta, ref.eta)


# --------------------------------------------------------------------------
# The per-shard condensation: every row, the seam rows in particular.


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("sizes,n", [((4, 2, 32), 2), ((4, 2, 32), 4),
                                     ((3, 2, 16), 8)])
def test_shard_operators_match_condense(prec, sizes, n):
    """Each shard's S, Pinv and gamma (ghost knots dropped) against
    gato_tpu.assemble.condense of the whole problem at every row, rtol
    2e-4 and atol 2e-5 of scale (tests/test_sharded.py:383-391), and the
    seam rows (a shard's first two and last) on their own.  n = 8 at
    K = 16 leaves 2 knots a shard, so a shard's left ghosts are its whole
    left neighbour."""
    spec = gt.ProblemSpec(*sizes)
    blocks = tt.random_blocks(spec, seed=31)
    js = _jsys(blocks, prec)
    K, Kl = spec.knot_points, spec.knot_points // n
    tb = gt.blocks_to_torch(blocks, "cpu")
    pad = lambda x: torch.cat([x, torch.zeros_like(x[:1])])
    padded = tb._replace(R=pad(tb.R), A=pad(tb.A), B=pad(tb.B), r=pad(tb.r))
    for use_kernel in (False, True):
        shards = sh._condense_shards(_mesh(n).devices, padded, Kl, RHO,
                                     gt.Preconditioner(prec), use_kernel)
        for name, ref in (("S", js.S), ("Pinv", js.Pinv), ("gamma", js.gamma)):
            got = torch.cat([getattr(x, name) for x in shards])
            _scaled(got, ref, rtol=2e-4, atol=2e-5)
            seams = [k for a in range(Kl, K, Kl) for k in (a - 1, a, a + 1)]
            _scaled(got[seams], np.asarray(ref)[seams], rtol=2e-4, atol=2e-5)


# --------------------------------------------------------------------------
# solve_sharded, method='pcg'.


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_solve_sharded_matches_gato_tpu(prec, use_kernel):
    """Both tiers at (4, 2, 64) on n = 4, every preconditioner, against
    gato_tpu's einsum tier: equal iterations (the JAX test's shape and
    seed avoid a round-off tie), lambda within 1e-4 and dz within 1e-3 of
    scale (tests/test_sharded.py:440-446's)."""
    blocks = tt.random_blocks(SPEC, seed=SEED)
    kw = dict(rho=RHO, **KW)
    ref = jsh.solve_sharded(_jmesh(4), *(jnp.asarray(a) for a in blocks),
                            use_kernel=False, preconditioner=JPrec(prec), **kw)
    ours = gt.solve_sharded(_mesh(4), *blocks, use_kernel=use_kernel,
                            preconditioner=prec, **kw)
    _same_iters(ours[0], ref[0])
    assert bool(ours[0].converged)
    _scaled(ours[0].lam, ref[0].lam)
    for got, want in zip(ours[1:], ref[1:]):
        _scaled(got, want, rtol=1e-3, atol=1e-3)


def test_solve_sharded_matches_tpu_kernel_tier():
    """The port's kernel-tier path against gato_tpu's kernel tier (Pallas
    condense, halo matvec and recovery in interpret mode) at (4, 2, 64) on
    n = 4, symmetric stair: equal iterations, tolerances as above."""
    blocks = tt.random_blocks(SPEC, seed=SEED)
    kw = dict(rho=RHO, **KW)
    ref = jsh.solve_sharded(_jmesh(4), *(jnp.asarray(a) for a in blocks),
                            use_kernel=True, **kw)
    ours = gt.solve_sharded(_mesh(4), *blocks, use_kernel=True, **kw)
    _same_iters(ours[0], ref[0])
    _scaled(ours[0].lam, ref[0].lam)
    for got, want in zip(ours[1:], ref[1:]):
        _scaled(got, want, rtol=1e-3, atol=1e-3)


def test_solve_sharded_iiwa_width():
    """IIWA widths (14, 7), K = 64 on n = 4, both tiers against gato_tpu's
    einsum tier and the dense float64 oracle (lambda within 2e-3, the
    oracle test's tolerance in tests/test_sharded.py:57-59)."""
    spec = gt.ProblemSpec(14, 7, 64)
    blocks = tt.random_blocks(spec, seed=5)
    kw = dict(rho=1e-3, exit_tol=1e-8, max_iters=200)
    ref = jsh.solve_sharded(_jmesh(4), *(jnp.asarray(a) for a in blocks),
                            use_kernel=False, **kw)
    lam_ref, _ = tt.dense_oracle(spec, blocks, rho=1e-3)
    for use_kernel in (False, True):
        ours = gt.solve_sharded(_mesh(4), *blocks, use_kernel=use_kernel, **kw)
        _same_iters(ours[0], ref[0], exit_tol=1e-8)
        _scaled(ours[0].lam, ref[0].lam)
        for got, want in zip(ours[1:], ref[1:]):
            _scaled(got, want, rtol=1e-3, atol=1e-3)
        _scaled(ours[0].lam.reshape(-1), lam_ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("method", ["pcg", "direct"])
def test_solve_sharded_one_shard_is_solve(method):
    """On one shard the sharded solve is the port's single-device 'torch'
    solve: the same operations, bit for bit (ghost knots and the pad never
    enter a kept row)."""
    blocks = tt.random_blocks(SPEC, seed=SEED)
    opts = gt.SolverOptions(rho=RHO, method=method, **KW)
    ref = gt.solve(SPEC, blocks, opts, pcg_backend="torch", device="cpu")
    res, dz_x, dz_u = gt.solve_sharded(_mesh(1), *blocks, rho=RHO,
                                       method=method, **KW)
    assert int(res.iters) == int(ref.iters)
    assert bool(res.converged) and bool(ref.converged)
    if method == "pcg":
        for got, want in ((res.lam, ref.lam), (dz_x, ref.dz_x), (dz_u, ref.dz_u)):
            assert torch.equal(got, want)
    else:
        # The one-shard SPIKE is cyclic reduction on a 1-row interface, not
        # Thomas: float32 round-off, 2e-4 / 2e-5 (tests/test_sharded.py's).
        for got, want in ((res.lam, ref.lam), (dz_x, ref.dz_x), (dz_u, ref.dz_u)):
            _scaled(got, want, rtol=2e-4, atol=2e-5)


def test_solve_sharded_float64():
    """float64 on n = 4, both methods, against gato_tpu's einsum tier
    under x64 and the port's single-device float64 solve: within 1e-10."""
    blocks = tt.random_blocks(SPEC, seed=SEED, dtype=np.float64)
    for method in ("pcg", "direct"):
        kw = dict(rho=RHO, method=method, **KW)
        ours = gt.solve_sharded(_mesh(4), *blocks, **kw)
        assert ours[0].lam.dtype == torch.float64
        single = gt.solve(SPEC, blocks, gt.SolverOptions(dtype="float64", **kw),
                          device="cpu")
        with jax.enable_x64(True):
            ref = jsh.solve_sharded(_jmesh(4), *(jnp.asarray(a) for a in blocks),
                                    **kw)
            assert int(ours[0].iters) == int(ref[0].iters) == int(single.iters)
            for got, want, one in zip((ours[0].lam, *ours[1:]),
                                      (ref[0].lam, *ref[1:]),
                                      (single.lam, single.dz_x, single.dz_u)):
                _scaled(got, want, rtol=1e-10, atol=1e-10)
                _scaled(got, one, rtol=1e-10, atol=1e-10)


# --------------------------------------------------------------------------
# The exact path.


@pytest.mark.parametrize("n", [2, 4, 8])
def test_btd_solve_sharded_matches_thomas(n):
    """SPIKE is exact: against gato_tpu's single-device block Thomas, rtol
    2e-4 and atol 2e-5, as tests/test_sharded.py:603-621 holds gato_tpu's
    (whose own SPIKE is held below through solve_sharded(method='direct'),
    a jitted call; btd_solve_sharded alone dispatches op by op, ~20 s)."""
    blocks = tt.random_blocks(gt.ProblemSpec(4, 2, 32), seed=91)
    js = _jsys(blocks)
    ours = gt.btd_solve_sharded(_mesh(n), _np(js.S), _np(js.gamma))
    np.testing.assert_allclose(_np(ours), np.asarray(jd.btd_solve(js.S, js.gamma)),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("n", [2, 8])
def test_solve_sharded_direct_matches_gato_tpu(n):
    """method='direct' against gato_tpu's: iters 0, converged from the true
    residual, lambda and dz within rtol 2e-4 and atol 2e-5
    (tests/test_sharded.py:641-653)."""
    blocks = tt.random_blocks(gt.ProblemSpec(4, 2, 32), seed=23)
    ref = jsh.solve_sharded(_jmesh(n), *(jnp.asarray(a) for a in blocks),
                            rho=RHO, method="direct")
    ours = gt.solve_sharded(_mesh(n), *blocks, rho=RHO, method="direct")
    assert int(ours[0].iters) == 0 and bool(ours[0].converged)
    assert bool(ref[0].converged)
    for got, want in zip((ours[0].lam, *ours[1:]), (ref[0].lam, *ref[1:])):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-4, atol=2e-5)


# --------------------------------------------------------------------------
# Degenerate placements and errors.


@pytest.mark.parametrize("method", ["pcg", "direct"])
def test_one_knot_shards(method):
    """K = n = 8: 'pcg' takes the torch tier (also with use_kernel=True),
    'direct' block Thomas on the whole system, as gato_tpu does
    (tests/test_sharded.py:656-670); against gato_tpu's at the same
    placement.  Tolerances as for the whole solve."""
    spec = gt.ProblemSpec(3, 2, 8)
    blocks = tt.random_blocks(spec, seed=31)
    kw = dict(rho=RHO, method=method) | (KW if method == "pcg" else {})
    ref = jsh.solve_sharded(_jmesh(8), *(jnp.asarray(a) for a in blocks), **kw)
    uk = [None, False] + ([True] if method == "pcg" else [])
    for use_kernel in uk:
        ours = gt.solve_sharded(_mesh(8), *blocks, use_kernel=use_kernel, **kw)
        assert int(ours[0].iters) == int(ref[0].iters)
        assert bool(ours[0].converged)
        _scaled(ours[0].lam, ref[0].lam, rtol=2e-4, atol=2e-5)
        for got, want in zip(ours[1:], ref[1:]):
            _scaled(got, want, rtol=1e-3, atol=1e-3)


def test_errors():
    blocks = tt.random_blocks(gt.ProblemSpec(3, 1, 30), seed=2)
    sys_ = assemble.condense(*gt.blocks_to_torch(blocks, "cpu"), RHO)
    with pytest.raises(ValueError, match="not divisible"):
        gt.pcg_sharded(_mesh(8), sys_.S, sys_.Pinv, sys_.gamma)
    with pytest.raises(ValueError, match="not divisible"):
        gt.solve_sharded(_mesh(8), *blocks, rho=RHO)
    with pytest.raises(ValueError, match="not divisible"):
        gt.btd_solve_sharded(_mesh(4), sys_.S, sys_.gamma)
    with pytest.raises(ValueError, match="2 rows per shard"):
        gt.btd_solve_sharded(_mesh(30), sys_.S, sys_.gamma)
    with pytest.raises(ValueError, match="direct"):
        gt.solve_sharded(_mesh(2), *blocks, rho=RHO, method="direct",
                         use_kernel=True)
    with pytest.raises(ValueError, match="method"):
        gt.solve_sharded(_mesh(2), *blocks, rho=RHO, method="thomas")
    with pytest.raises(ValueError, match="poly_degree"):
        gt.solve_sharded(_mesh(2), *blocks, rho=RHO, poly_degree=0)
    with pytest.raises(ValueError, match="axis"):
        gt.solve_sharded(_mesh(2, "dp"), *blocks, rho=RHO)
    with pytest.raises(ValueError, match="at least one device"):
        gt.Mesh([])


def test_use_kernel_rule():
    """The tier rule without a card: None takes the kernels only on an
    all-CUDA mesh in float32; an explicit True in float64 raises on a CUDA
    mesh and runs the plain versions on a CPU mesh.  A CUDA mesh raises
    where CUDA is absent (solver.resolve_device)."""
    cuda = object.__new__(gt.Mesh)
    cuda.devices, cuda.axis_name = (torch.device("cuda", 0),) * 2, "knot"
    assert sh._resolve_use_kernel(cuda, torch.float32, None) is True
    assert sh._resolve_use_kernel(cuda, torch.float64, None) is False
    with pytest.raises(ValueError, match="float32-only"):
        sh._resolve_use_kernel(cuda, torch.float64, True)
    cpu = _mesh(2)
    assert sh._resolve_use_kernel(cpu, torch.float32, None) is False
    assert sh._resolve_use_kernel(cpu, torch.float64, True) is True
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            gt.Mesh(["cuda:0"] * 2)


def test_collectives():
    """ppermute's edges get zeros, and a shifted row is a copy; psum adds in
    shard order."""
    devs = _mesh(3).devices
    vals = [torch.full((2,), float(i + 1)) for i in range(3)]
    right = pm.shift_right(vals, devs)
    left = pm.shift_left(vals, devs)
    assert [v.tolist() for v in right] == [[0, 0], [1, 1], [2, 2]]
    assert [v.tolist() for v in left] == [[2, 2], [3, 3], [0, 0]]
    assert right[1].data_ptr() != vals[0].data_ptr()
    assert pm.psum(vals, devs).tolist() == [6, 6]
    assert pm.all_gather(vals, devs[0]).shape == (3, 2)
    assert pm.gather(vals, devs[0]).shape == (6,)


# --------------------------------------------------------------------------
# Data parallelism.


def _batch(spec, n, seed0):
    return tt.random_batch(spec, n, seed0=seed0)


@pytest.mark.parametrize("method", ["pcg", "direct"])
def test_solve_batched_dp_matches_solve_batched(method):
    """n = 4 groups of 2 against the port's solve_batched on the whole
    batch: per problem the same 'torch' operations, so equal iterations
    and results within 1e-6 of scale (batched einsums of another width may
    block their sums differently); against gato_tpu's solve_batched_dp
    (its kernels in interpret mode, tests/test_sharded.py:111-134's case),
    equal iterations and 1e-4 of scale."""
    spec = gt.ProblemSpec(4, 2, 10)
    b = _batch(spec, 8, 200)
    kw = dict(rho=RHO, **KW)
    res, dz_x, dz_u = gt.solve_batched_dp(_mesh(4, "dp"), *b, method=method, **kw)
    single = gt.solve_batched(spec, b, gt.SolverOptions(method=method, **kw),
                              device="cpu")
    assert res.iters.tolist() == single.iters.tolist()
    assert res.converged.tolist() == single.converged.tolist()
    for got, want in ((res.lam, single.lam), (dz_x, single.dz_x), (dz_u, single.dz_u)):
        _scaled(got, want, rtol=1e-6, atol=1e-6)
    ref = jsh.solve_batched_dp(_jmesh(4, "dp"), *(jnp.asarray(a) for a in b),
                               method=method, **kw)
    assert res.iters.tolist() == np.asarray(ref[0].iters).tolist()
    for got, want in ((res.lam, ref[0].lam), (dz_x, ref[1]), (dz_u, ref[2])):
        _scaled(got, want)
    # A warm start from the answer converges at once.
    if method == "pcg":
        again = gt.solve_batched_dp(_mesh(4, "dp"), *b, lam0=res.lam, **kw)
        assert int(again[0].iters.max()) <= 1


@pytest.mark.parametrize("method", ["pcg", "direct"])
def test_solve_sequence_batched_dp_matches_farm(method):
    """A farm of B = 8 streams x T = 3 steps on n = 4 groups against the
    port's solve_sequence_batched on all streams, per-step rhos and a warm
    start: equal iterations, results within 1e-6 of scale."""
    spec = gt.ProblemSpec(4, 2, 10)
    farm = tt.random_farm(spec, 3, 8, seed0=800)
    rhos = np.array([1e-2, 5e-2, 1e-3], dtype=np.float32)
    lam0 = tt.random_batch(spec, 8, seed0=900).q * 0.1
    kw = dict(exit_tol=1e-8, max_iters=300)
    out = gt.solve_sequence_batched_dp(_mesh(4, "dp"), *farm, lam0=lam0,
                                       rhos=rhos, method=method, **kw)
    ref = gt.solve_sequence_batched(spec, farm, gt.SolverOptions(method=method, **kw),
                                    lam0=lam0, rhos=rhos, device="cpu")
    assert out[0].shape == ref.lam.shape == (3, 8, 10, 4)
    assert out[3].tolist() == ref.iters.tolist()
    assert out[4].tolist() == ref.converged.tolist() and bool(out[4].all())
    for got, want in zip(out[:3], ref[:3]):
        _scaled(got, want, rtol=1e-6, atol=1e-6)


def test_dp_errors():
    spec = gt.ProblemSpec(3, 2, 8)
    b = _batch(spec, 3, 0)
    with pytest.raises(ValueError, match="divisible"):
        gt.solve_batched_dp(_mesh(2, "dp"), *b, rho=RHO)
    with pytest.raises(ValueError, match="method"):
        gt.solve_batched_dp(_mesh(3, "dp"), *b, rho=RHO, method="thomas")
    farm = tt.random_farm(spec, 2, 3, seed0=1)
    with pytest.raises(ValueError, match="divisible"):
        gt.solve_sequence_batched_dp(_mesh(2, "dp"), *farm, rho=RHO)
    with pytest.raises(ValueError, match="supports method"):
        gt.solve_sequence_batched_dp(_mesh(3, "dp"), *farm, method="nope")
