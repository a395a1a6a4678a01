"""gato_tpu_torch.diff against gato_tpu.diff on the same NumPy inputs, on
the CPU.

* The primal of kkt_solve against gato_tpu.kkt_solve: within 1e-5 of scale
  (rtol and atol) in float32.
* Gradients of tests/test_diff.py's loss through the port's kkt_solve
  against jax.grad through gato_tpu.kkt_solve, for all eight arguments:
  rtol = atol = 2e-3 of scale (tests/test_diff.py), Q and R symmetrised on
  both sides.
* Central finite differences of the port's own forward (q, c, rho and the
  symmetric Q pair): rtol 3e-2 in float32 (tests/test_diff.py), 1e-6 in
  float64; torch.autograd.gradcheck in float64 on Q = sym(X), R = sym(Y).
* kkt_solve_batched against a loop of kkt_solve (1e-5 primal, 2e-3
  gradients, rho's gradient summed over the batch); the kernel routes
  forced on CPU tensors (the plain versions of row 4, the block-Thomas pair
  and the long-K exact tier) against the 'torch' route, 2e-3 of scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gato_tpu import diff as jdiff

import gato_tpu_torch as gt
from gato_tpu_torch import diff
from gato_tpu_torch import testing as tt
from gato_tpu_torch.kernels import direct_fused as kd
from gato_tpu_torch.kernels import longk as kl
from gato_tpu_torch.kernels import thomas_batch as kt

torch.set_num_threads(1)

SPECS = {"small": gt.ProblemSpec(3, 2, 6), "iiwa": gt.ProblemSpec(14, 7, 5)}
RHO = 0.05
NAMES = ("Q", "R", "A", "B", "q", "r", "c", "rho")
GRAD_TOL = 2e-3


def _jloss(lam, dz_x, dz_u):
    return (jnp.sum(lam * jnp.cos(lam)) + jnp.sum(dz_x ** 2)
            + jnp.sum(jnp.sin(dz_u)))


def _loss(lam, dz_x, dz_u):
    return ((lam * torch.cos(lam)).sum() + (dz_x ** 2).sum()
            + torch.sin(dz_u).sum())


def _args(spec, seed=11, dtype=torch.float32, rho=RHO):
    """The seven blocks and a 0-d rho, leaves that require grad."""
    b = tt.random_blocks(spec, seed=seed)
    return [torch.tensor(np.asarray(a), dtype=dtype, requires_grad=True)
            for a in b] + [torch.tensor(rho, dtype=dtype, requires_grad=True)]


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _sym(M):
    M = np.asarray(M, dtype=np.float64)
    return 0.5 * (M + np.swapaxes(M, -1, -2))


def _close(ours, ref, tol):
    ours, ref = _np(ours).astype(np.float64), _np(ref).astype(np.float64)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol * scale)


@pytest.fixture(scope="module")
def jax_ref():
    """gato_tpu.kkt_solve's primal and jax.grad of the loss, per spec."""
    out = {}
    for key, spec in SPECS.items():
        b = tt.random_blocks(spec, seed=11)
        args = tuple(jnp.asarray(a) for a in b) + (jnp.float32(RHO),)
        primal = jdiff.kkt_solve(*args)
        grads = jax.grad(lambda *a: _jloss(*jdiff.kkt_solve(*a)),
                         argnums=tuple(range(8)))(*args)
        out[key] = (primal, grads)
    return out


@pytest.fixture(scope="module")
def port_grads():
    out = {}
    for key, spec in SPECS.items():
        args = _args(spec)
        primal = gt.kkt_solve(*args)
        out[key] = (primal, torch.autograd.grad(_loss(*primal), args))
    return out


@pytest.mark.parametrize("key", SPECS)
def test_primal_matches_gato_tpu(jax_ref, port_grads, key):
    for name, ours, ref in zip(("lam", "dz_x", "dz_u"), port_grads[key][0],
                               jax_ref[key][0]):
        assert ours.dtype == torch.float32
        assert tuple(ours.shape) == tuple(np.shape(ref)), name
        _close(ours, ref, 1e-5)


@pytest.mark.parametrize("key", SPECS)
@pytest.mark.parametrize("index", range(8), ids=NAMES)
def test_grads_match_jax_grad(jax_ref, port_grads, key, index):
    ours, ref = port_grads[key][1][index], jax_ref[key][1][index]
    assert tuple(ours.shape) == tuple(np.shape(ref))
    if NAMES[index] in ("Q", "R"):
        ours, ref = _sym(_np(ours)), _sym(ref)
        # The port's cotangent is the symmetric one already.
        g = _np(port_grads[key][1][index])
        assert np.array_equal(g, np.swapaxes(g, -1, -2))
    if NAMES[index] == "rho":
        assert port_grads[key][1][index].dtype == torch.float32
        assert port_grads[key][1][index].shape == ()
    _close(ours, ref, GRAD_TOL)


def test_solve_and_grad_example_matches_gato_tpu(jax_ref):
    spec = SPECS["small"]
    loss, grads = diff.solve_and_grad_example(
        spec, tt.random_blocks(spec, seed=11), RHO, _loss, device="cpu")
    assert len(grads) == 7 and all(g.device.type == "cpu" for g in grads)
    for name, g, ref in zip(NAMES, grads, jax_ref["small"][1]):
        if name in ("Q", "R"):
            g, ref = _sym(_np(g)), _sym(ref)
        _close(g, ref, GRAD_TOL)
    _close(loss, _jloss(*jax_ref["small"][0]), 1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            diff.solve_and_grad_example(spec, tt.random_blocks(spec), RHO, _loss)


FD = {torch.float32: (1e-3, 3e-2), torch.float64: (1e-6, 1e-6)}


@pytest.mark.parametrize("dtype", list(FD), ids=["float32", "float64"])
@pytest.mark.parametrize("index", [4, 6, 7], ids=["q", "c", "rho"])
def test_grads_match_finite_differences(dtype, index):
    eps, rtol = FD[dtype]
    args = _args(SPECS["small"], dtype=dtype)
    g = torch.autograd.grad(_loss(*gt.kkt_solve(*args)), args[index])[0]
    x0 = args[index].detach().double()
    idx = np.unravel_index(x0.numel() // 2, tuple(x0.shape)) if x0.ndim else ()

    def f(delta):
        a = [t.detach() for t in args]
        x = x0.clone()
        x[idx] += delta
        a[index] = x.to(dtype)
        with torch.no_grad():
            return float(_loss(*gt.kkt_solve(*a)))

    fd = (f(eps) - f(-eps)) / (2 * eps)
    np.testing.assert_allclose(float(g[idx]), fd, rtol=rtol)


@pytest.mark.parametrize("dtype", list(FD), ids=["float32", "float64"])
def test_grad_Q_symmetric_finite_difference(dtype):
    """Perturb Q[k, i, j] and Q[k, j, i] together against g[i, j] + g[j, i]."""
    eps, rtol = FD[dtype]
    args = _args(SPECS["small"], dtype=dtype)
    g = torch.autograd.grad(_loss(*gt.kkt_solve(*args)), args[0])[0]
    k, i, j = 2, 1, 0

    def f(delta):
        a = [t.detach() for t in args]
        Q = a[0].double().clone()
        Q[k, i, j] += delta
        Q[k, j, i] += delta
        a[0] = Q.to(dtype)
        with torch.no_grad():
            return float(_loss(*gt.kkt_solve(*a)))

    fd = (f(eps) - f(-eps)) / (2 * eps)
    np.testing.assert_allclose(float(g[k, i, j] + g[k, j, i]), fd, rtol=rtol)


@pytest.mark.parametrize("batched", [False, True], ids=["kkt_solve", "batched"])
def test_gradcheck_float64_symmetric(batched):
    """gradcheck through Q = sym(X), R = sym(Y): the VJP gives the symmetric
    gradient, so only a symmetric parametrisation has the Jacobian it
    checks."""
    if batched:
        b = tt.random_batch(gt.ProblemSpec(2, 1, 4), 2, seed0=3)
    else:
        b = tt.random_blocks(SPECS["small"], seed=3)
    args = [torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=True)
            for a in b] + [torch.tensor(0.1, dtype=torch.float64, requires_grad=True)]
    solve = gt.kkt_solve_batched if batched else gt.kkt_solve

    def f(X, Y, *rest):
        return solve(0.5 * (X + X.transpose(-1, -2)),
                     0.5 * (Y + Y.transpose(-1, -2)), *rest)

    assert torch.autograd.gradcheck(f, tuple(args), eps=1e-6, atol=1e-6, rtol=1e-5)


def test_batched_matches_loop_of_single():
    spec = SPECS["small"]
    n = 3
    blocks = tt.random_batch(spec, n, seed0=50)
    Bargs = [torch.tensor(a, requires_grad=True) for a in blocks] + [
        torch.tensor(RHO, requires_grad=True)]
    out_b = gt.kkt_solve_batched(*Bargs)
    g_b = torch.autograd.grad(_loss(*out_b), Bargs)
    rho_sum = 0.0
    for i in range(n):
        args = [torch.tensor(a[i], requires_grad=True) for a in blocks] + [
            torch.tensor(RHO, requires_grad=True)]
        out = gt.kkt_solve(*args)
        for x, y in zip(out, out_b):
            _close(y[i], x, 1e-5)
        g = torch.autograd.grad(_loss(*out), args)
        for name, x, y in zip(NAMES[:7], g, g_b):
            _close(y[i], x, GRAD_TOL)
        rho_sum += float(g[7])
    assert g_b[7].shape == ()
    np.testing.assert_allclose(float(g_b[7]), rho_sum, rtol=GRAD_TOL,
                               atol=GRAD_TOL * max(1.0, abs(rho_sum)))


def test_python_float_rho_and_partial_grads():
    """rho as a Python float takes no gradient; inputs that need none get
    None; a cotangent with stride 0 (from sum) is taken as it is."""
    spec = SPECS["small"]
    b = tt.random_blocks(spec, seed=11)
    q = torch.tensor(b.q, requires_grad=True)
    rest = [torch.tensor(a) for a in b]
    lam, dz_x, dz_u = gt.kkt_solve(*rest[:4], q, *rest[5:], RHO)
    (gq,) = torch.autograd.grad(lam.sum() + dz_u.sum(), q)
    args = _args(spec)
    ref = torch.autograd.grad(sum(x.sum() for x in gt.kkt_solve(*args)[::2]),
                              args[4])[0]
    _close(gq, ref, 1e-6)
    assert not gt.kkt_solve(*rest, RHO)[0].requires_grad


def test_routing_helper_is_the_solvers():
    """On the CPU both dtypes take the 'torch' route, as solve_batched's
    auto dispatch does."""
    spec = SPECS["small"]
    for dtype in (torch.float32, torch.float64):
        b = gt.blocks_to_torch(tt.random_batch(spec, 2), "cpu", dtype)
        assert diff._backend(b.Q, b.R) == "torch"


ROUTES = {
    # name: (the helper's backend, thomas MIN_BATCH, longk exact tier)
    "row4": ("fused", 10 ** 9, None),
    "pair": ("fused", 1, None),
    "longk_xl": ("pcg_kernel", 10 ** 9, "xl"),
    "longk_hybrid": ("pcg_kernel", 10 ** 9, "hybrid"),
}
# The plain version each route's wrappers reach on CPU tensors, and how
# often one solve reaches it (K = 6: 'hybrid' peels one level).
SPIES = {"row4": (kd, "direct_fused_plain"), "pair": (kt, "thomas_fwd_plain"),
         "cr": (kl, "cr_longk_plain"), "peel": (kl, "peel_longk_plain")}
EXPECT = {"row4": {"row4": 1}, "pair": {"pair": 1}, "longk_xl": {"cr": 1},
          "longk_hybrid": {"cr": 1, "peel": 1}}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("loss", ["sin", "sum"])
def test_forced_kernel_routes_match_torch_route(monkeypatch, route, loss):
    """Forward and adjoint solves through each exact kernel route's plain
    versions agree with the 'torch' route: primal within 1e-4, every
    gradient within 2e-3 of scale.  'sum' feeds stride-0 cotangents."""
    spec = SPECS["small"]
    blocks = tt.random_batch(spec, 3, seed0=90)
    f = _loss if loss == "sin" else (lambda *o: sum(x.sum() for x in o))

    def run():
        args = [torch.tensor(a, requires_grad=True) for a in blocks] + [
            torch.tensor(RHO, requires_grad=True)]
        out = gt.kkt_solve_batched(*args)
        return out, torch.autograd.grad(f(*out), args)

    ref_out, ref_g = run()
    backend, min_batch, tier = ROUTES[route]
    calls = []

    def forced(Q, R):
        calls.append(Q.shape[0])
        return backend

    monkeypatch.setattr(diff, "_backend", forced)
    monkeypatch.setattr(kt, "MIN_BATCH", min_batch)
    if tier is not None:
        monkeypatch.setattr(kl, "direct_tier", lambda Bn, K: tier)
    counts = dict.fromkeys(SPIES, 0)
    for key, (mod, name) in SPIES.items():
        def spy(*a, _orig=getattr(mod, name), _key=key, **k):
            counts[_key] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    out, g = run()
    assert calls == [3, 3], "the forward and the adjoint solve both route"
    want = dict.fromkeys(SPIES, 0)
    want.update({key: 2 * n for key, n in EXPECT[route].items()})
    assert counts == want
    for x, y in zip(out, ref_out):
        _close(x, y, 1e-4)
    for name, x, y in zip(NAMES, g, ref_g):
        _close(x, y, GRAD_TOL)
