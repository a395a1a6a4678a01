"""gato_tpu_torch.parallel.solve_packed_dp (one PackedKKT served over a
Mesh) against gato_tpu.parallel.sharded.solve_packed_dp, and against the
port's own solve_packed, on the same NumPy inputs.

The port runs on ``Mesh(["cpu"] * n, "dp")``, where every kernel wrapper
runs its plain version; gato_tpu on the 8-device CPU mesh of
tests/conftest.py, its Pallas kernels in interpret mode, with its VMEM
budgets patched (monkeypatch) as tests/test_sharded.py:455-601 and
tests/test_thomas_batch.py:193-215 patch them so that each pack spans two
lane groups.  The port's long-K route is forced the same way, by patching
the shared memory the CPU routing assumes (longk.H100_SHARED_BYTES).

Tolerances: against gato_tpu, iteration counts and converged flags equal,
lambda, dz_x and dz_u within 1e-4 of each array's scale (rtol = atol =
1e-4); against solve_packed on each group alone, bit for bit (the same
code on the same problems at the same batch width); against the
whole-batch solve_packed, equal iterations and 1e-4 of scale (on the card
kernel B's and row 4's cluster size follow the batch width, so a
problem's bits may differ there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import gato_tpu
from gato_tpu import packed as jpk
from gato_tpu.kernels import direct_fused as jdf
from gato_tpu.kernels import fused_solve as jfs
from gato_tpu.kernels import pcg_pallas as jpp
from gato_tpu.kernels import thomas_batch as jtb
from gato_tpu.parallel import sharded as jsh

import gato_tpu_torch as gt
from gato_tpu_torch import parallel
from gato_tpu_torch import testing as tt
from gato_tpu_torch.kernels import longk as kl
from gato_tpu_torch.parallel import sharded as sh

torch.set_num_threads(1)

OPTS = dict(rho=1e-2, exit_tol=1e-10, max_iters=300)
FIELDS = ("lam", "dz_x", "dz_u")


# Each tier's case: (spec, B, seed0, method, tier asked of pack, rho), the
# shapes and seeds of gato_tpu's tests.
CASES = {
    "pcg": ((3, 2, 12), 16, 60, "pcg", None, 1e-2),
    "cr": ((3, 2, 12), 16, 60, "direct", "cr", 1e-2),
    "thomas": ((3, 2, 4), 256, 55, "direct", "thomas", 1e-2),
    "longk_pcg": ((3, 2, 48), 4, 80, "pcg", None, 1e-3),
    "longk_direct": ((3, 2, 48), 4, 80, "direct", None, 1e-3),
}


def _budgets(monkeypatch, case):
    """gato_tpu's VMEM budgets as its own tests set them for the case, and
    the port's shared-memory assumption for the long-K cases."""
    if case.startswith("longk"):
        for mod in (jfs, jpp, jdf):
            monkeypatch.setattr(mod, "_VMEM_BUDGET_BYTES", 10_000)
        monkeypatch.setattr(kl, "H100_SHARED_BYTES", 4096)
    elif case == "thomas":
        monkeypatch.setattr(jtb, "_VMEM_BUDGET_BYTES", 1 << 19)
    else:
        monkeypatch.setattr(jfs, "_VMEM_BUDGET_BYTES", 270_000)
        monkeypatch.setattr(jdf, "_VMEM_BUDGET_BYTES", 270_000)


def _setup(case):
    sizes, B, seed0, method, tier, rho = CASES[case]
    spec = gt.ProblemSpec(*sizes)
    bb = tt.random_batch(spec, B, seed0=seed0)
    opts = gt.SolverOptions(**{**OPTS, "rho": rho}, method=method)
    return spec, bb, opts, method, tier


def _mesh(n):
    return gt.Mesh(["cpu"] * n, "dp")


def _jmesh(n):
    return JMesh(np.array(jax.devices()[:n]), ("dp",))


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(ours, ref):
    ours, ref = _np(ours).astype(np.float64), _np(ref).astype(np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4 * scale)


def _agrees(ours, ref):
    """Equal iterations and flags, values within 1e-4 of scale."""
    np.testing.assert_array_equal(_np(ours.iters), _np(ref.iters))
    np.testing.assert_array_equal(_np(ours.converged), _np(ref.converged))
    for name in FIELDS:
        _close(getattr(ours, name), getattr(ref, name))


def _same(res, ref):
    for name in FIELDS + ("iters", "converged", "eta"):
        assert torch.equal(getattr(res, name), getattr(ref, name)), name


@pytest.mark.parametrize("case", list(CASES))
def test_matches_gato_tpu(monkeypatch, case):
    """Every tier on two devices against gato_tpu's solve_packed_dp on a
    2-device mesh: the pack's tier is the one gato_tpu's pack records."""
    _budgets(monkeypatch, case)
    spec, bb, opts, method, tier = _setup(case)
    packed = gt.pack(spec, bb, method=method, tier=tier, device="cpu")
    jp = jpk.pack(gato_tpu.ProblemSpec(*CASES[case][0]),
                  gato_tpu.KKTBlocks(*(jnp.asarray(a) for a in bb)),
                  method=method, tier=tier)
    # gato_tpu names its kernel-B and row-4 lane plans 'fused'.
    assert packed.plan.tier == {"fused": tier}.get(jp.plan.tier, jp.plan.tier)
    if jp.plan.tier != "longk":
        assert jp.plan.n_groups == 2
    jopts = gato_tpu.SolverOptions(**{**OPTS, "rho": opts.rho}, method=method)
    res = gt.solve_packed_dp(_mesh(2), packed, opts)
    ref = jsh.solve_packed_dp(_jmesh(2), jp, jopts)
    assert res.plan == packed.plan
    _agrees(res.unpack(), ref.unpack())
    if method == "direct":
        assert bool(res.converged.all()) and not res.iters.any()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("n", [2, 4])
def test_groups_alone_and_whole_batch(monkeypatch, case, n):
    """Bit for bit with solve_packed on each group alone (a pack of the
    group's problems with the same tier), within 1e-4 of scale and equal
    iterations against solve_packed on the whole batch."""
    _budgets(monkeypatch, case)
    spec, bb, opts, method, tier = _setup(case)
    packed = gt.pack(spec, bb, method=method, tier=tier, device="cpu")
    res = gt.solve_packed_dp(_mesh(n), packed, opts).unpack()
    g = packed.plan.batch // n
    alone_tier = packed.plan.tier if method == "direct" and \
        packed.plan.tier != "longk" else None
    parts = []
    for i in range(n):
        group = gt.KKTBlocks(*(a[i * g:(i + 1) * g] for a in bb))
        gp = gt.pack(spec, group, method=method, tier=alone_tier, device="cpu")
        assert gp.plan.tier == packed.plan.tier
        parts.append(gt.solve_packed(gp, opts).unpack())
    _same(res, gt.SolveResult(*(torch.cat(f) for f in zip(*parts))))
    _agrees(res, gt.solve_packed(packed, opts).unpack())


def test_thomas_pack_at_a_narrow_group(monkeypatch):
    """A 'thomas' pack of B = 16 on two devices runs the Thomas pair at
    g = 8 (below its auto threshold): its stacks fit there, and the result
    is the forced-'thomas' pack of each half."""
    from gato_tpu_torch.kernels import thomas_batch as kt

    spec = gt.ProblemSpec(3, 2, 10)
    bb = tt.random_batch(spec, 16, seed0=400)
    opts = gt.SolverOptions(rho=1e-3, method="direct")
    packed = gt.pack(spec, bb, method="direct", device="cpu")
    assert packed.plan.tier == "thomas"
    assert kt.fits(8, 10, 3, 2) and not kt.should_dispatch(8, 10, 3, 2)
    calls = []
    real = kt.solve_direct_thomas_cuda
    monkeypatch.setattr(kt, "solve_direct_thomas_cuda",
                        lambda *a, **k: calls.append(a[0].shape[0]) or real(*a, **k))
    res = gt.solve_packed_dp(_mesh(2), packed, opts).unpack()
    assert calls == [8, 8]
    _agrees(res, gt.solve_packed(packed, opts).unpack())


def test_warm_carry_chains(monkeypatch):
    """Solving the same data again from dp.lam_packed takes at most one
    iteration; update_vectors then the carry chains as solve_packed does,
    and as gato_tpu's solve_packed_dp does (equal iterations)."""
    _budgets(monkeypatch, "pcg")
    spec, bb, opts, _, _ = _setup("pcg")
    packed = gt.pack(spec, bb, device="cpu")
    mesh = _mesh(2)
    first = gt.solve_packed_dp(mesh, packed, opts)
    again = gt.solve_packed_dp(mesh, packed, opts, lam0=first.lam_packed)
    assert int(again.iters.max()) <= 1
    public = gt.solve_packed_dp(mesh, packed, opts, lam0=first.unpack().lam.numpy())
    _same(again.unpack(), public.unpack())

    q2 = bb.q * 1.01
    refreshed = gt.update_vectors(packed, q2, bb.r, bb.c)
    warm = gt.solve_packed_dp(mesh, refreshed, opts, lam0=first.lam_packed)
    _same(warm.unpack(), gt.solve_packed(refreshed, opts,
                                         lam0=first.lam_packed).unpack())
    assert int(warm.iters.sum()) < int(first.iters.sum())

    jspec = gato_tpu.ProblemSpec(3, 2, 12)
    jopts = gato_tpu.SolverOptions(**OPTS)
    jp = jpk.pack(jspec, gato_tpu.KKTBlocks(*(jnp.asarray(a) for a in bb)))
    jfirst = jsh.solve_packed_dp(_jmesh(2), jp, jopts)
    jr = jpk.update_vectors(jp, jnp.asarray(q2), jnp.asarray(bb.r), jnp.asarray(bb.c))
    jwarm = jsh.solve_packed_dp(_jmesh(2), jr, jopts, lam0=jfirst.lam_packed)
    _agrees(warm.unpack(), jwarm.unpack())


@pytest.mark.parametrize("n", [1, 2, 4])
def test_a_repeated_device_copies_nothing(monkeypatch, n):
    """On Mesh(["cpu"] * n) every group's tensors share the pack's storage,
    and the carry's rows are views too: the gather of the results is the
    only new allocation."""
    spec = gt.ProblemSpec(3, 2, 12)
    bb = tt.random_batch(spec, 8, seed0=120)
    packed = gt.pack(spec, bb, device="cpu")
    g = 8 // n
    for i, local in enumerate(sh._local_packs(_mesh(n), packed, g)):
        assert local.plan == packed.plan._replace(batch=g)
        for f in ("Qb", "Rb", "Ab", "Bb", "qb", "rb", "cb"):
            mine, whole = getattr(local, f), getattr(packed, f)
            assert mine.untyped_storage().data_ptr() == \
                whole.untyped_storage().data_ptr(), f
            assert mine.data_ptr() == whole[i * g].data_ptr(), f
            assert mine.is_contiguous()
    opts = gt.SolverOptions(rho=1e-2, exit_tol=1e-10, max_iters=300)
    first = gt.solve_packed_dp(_mesh(n), packed, opts)
    seen = []
    real = sh.solve_packed
    monkeypatch.setattr(sh, "solve_packed",
                        lambda p, o, lam0=None: seen.append(lam0) or real(p, o, lam0=lam0))
    gt.solve_packed_dp(_mesh(n), packed, opts, lam0=first.lam_packed)
    assert [lam.data_ptr() for lam in seen] == \
        [first.lam_packed[i * g].data_ptr() for i in range(n)]


def test_unbatched_pack():
    """A pack of one problem is served by a mesh of one device, with the
    pack's public shapes; a wider mesh raises."""
    spec = gt.ProblemSpec(3, 2, 12)
    one = tt.random_blocks(spec, seed=41)
    packed = gt.pack(spec, one, device="cpu")
    opts = gt.SolverOptions(rho=1e-2, exit_tol=1e-10, max_iters=300)
    res = gt.solve_packed_dp(_mesh(1), packed, opts)
    _same(res.unpack(), gt.solve_packed(packed, opts).unpack())
    assert tuple(res.unpack().lam.shape) == (12, 3) and res.unpack().iters.ndim == 0
    warm = gt.solve_packed_dp(_mesh(1), packed, opts, lam0=res.unpack().lam)
    assert int(warm.unpack().iters) <= 1
    with pytest.raises(ValueError, match="not divisible by mesh axis"):
        gt.solve_packed_dp(_mesh(2), packed, opts)


def test_refusals():
    """Each refusal of gato_tpu's solve_packed_dp, with its key phrase."""
    spec = gt.ProblemSpec(3, 2, 12)
    bb = tt.random_batch(spec, 6, seed0=100)
    packed = gt.pack(spec, bb, device="cpu")
    opts = gt.SolverOptions(rho=1e-2, exit_tol=1e-10, max_iters=300)
    with pytest.raises(ValueError, match="does not relabel"):
        gt.solve_packed_dp(_mesh(2), packed, dataclasses.replace(opts, method="direct"))
    direct = gt.pack(spec, bb, method="direct", device="cpu")
    with pytest.raises(ValueError, match="does not relabel"):
        gt.solve_packed_dp(_mesh(2), direct, opts)
    with pytest.raises(ValueError, match="float32-only"):
        gt.solve_packed_dp(_mesh(2), packed, dataclasses.replace(opts, dtype="float64"))
    with pytest.raises(ValueError, match="not divisible by mesh axis dp=4"):
        gt.solve_packed_dp(_mesh(4), packed, opts)
    with pytest.raises(ValueError, match="this mesh's axis is 'dp'"):
        gt.solve_packed_dp(_mesh(2), packed, opts, axis_name="batch")
    with pytest.raises(ValueError, match="this mesh's axis is 'knot'"):
        gt.solve_packed_dp(gt.Mesh(["cpu"] * 2), packed, opts)
    with pytest.raises(ValueError, match="lam0 shape"):
        gt.solve_packed_dp(_mesh(2), packed, opts, lam0=np.zeros((6, 12, 4), np.float32))
    # A relabel the port's solve_packed would serve is still refused here.
    gt.solve_packed(packed, dataclasses.replace(opts, method="direct"))


def test_exports_and_no_cuda():
    assert gt.solve_packed_dp is parallel.solve_packed_dp is sh.solve_packed_dp
    assert "solve_packed_dp" in gt.__all__ and "solve_packed_dp" in parallel.__all__
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="is_available"):
        gt.Mesh(["cuda:0"] * 2, "dp")
