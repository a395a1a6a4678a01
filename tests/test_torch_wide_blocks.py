"""Block widths above 32: a quadruped's whole-body KKT system (36 states,
12 controls; ANYmal at 57 knots, benchmark/configs/anymal36_k57.json), on
the CPU.

* The routing over a table of widths, at an H100's shared memory: every
  entry auto-selects a route that solves (kernel B at its compiled (36, 12),
  kernel A at a control size above 32 where it holds the horizon, else the
  plain path) and an explicit kernel backend raises where it has no kernel
  for the shape.
* The packed surface's tiers at such widths, and their answers against the
  plain path's.
* The plain path against the benchmark's float64 reference
  (benchmark/reference/kkt.py) and against gato_tpu's 'jax' path.
* Kernel B's plan at (57, 36, 12) against its formulas: threads, shared
  memory, where the records sit, the cluster size.

The kernel itself runs on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import gato_tpu
import gato_tpu_torch as gt
from benchmark import generator
from benchmark.reference import kkt
from gato_tpu_torch import solver
from gato_tpu_torch import testing as tt
from gato_tpu_torch.kernels import _build
from gato_tpu_torch.kernels import fused_sequence as ks
from gato_tpu_torch.kernels import fused_solve as kb

torch.set_num_threads(1)

H100_SHARED = 232448
H100_SMS = 132
RHO, EXIT_TOL = 1e-3, 1e-6
WIDTHS = [(14, 7), (2, 1), (36, 12), (36, 13), (33, 7), (40, 20), (14, 40)]
HORIZONS = [57, 1024]

# The auto route of (s, c, K): (solve / solve_batched with method='pcg',
# the farm entry with method='pcg', method='direct' at B = 1).
AUTO = {
    (14, 7, 57): ("fused", "fused", "fused"),
    (14, 7, 1024): ("pcg_kernel", "pcg_kernel", "pcg_kernel"),
    (2, 1, 57): ("fused", "fused", "fused"),
    (2, 1, 1024): ("fused", "fused", "fused"),
    (36, 12, 57): ("fused", "torch", "torch"),
    # Kernel A behind a PyTorch condensation: its state size is 14; past
    # its shared memory the long-K tier does not take c = 40.
    (14, 40, 57): ("pcg_kernel", "pcg_kernel", "torch"),
}
# The wide shapes that an explicit 'pcg_kernel' with method='pcg' takes.
PCG_KERNEL_WIDE = {(14, 40, 57)}


def _route(backend, method, shape, farm=False):
    return solver._resolve_backend(backend, gt.SolverOptions(method=method), "cuda",
                                   shape, smem_limit=H100_SHARED, farm=farm)


@pytest.mark.parametrize("K", HORIZONS)
@pytest.mark.parametrize("s,c", WIDTHS)
def test_auto_route_takes_a_path_that_solves(s, c, K):
    shape = (K, s, c)
    want = AUTO.get((s, c, K), ("torch", "torch", "torch"))
    got = (_route(None, "pcg", shape), _route(None, "pcg", shape, farm=True),
           _route(None, "direct", shape))
    assert got == want
    for method, farm, route in (("pcg", False, got[0]), ("pcg", True, got[1]),
                                ("direct", False, got[2])):
        past = solver._past_fused(gt.SolverOptions(method=method), shape, H100_SHARED, 1,
                                  farm)
        assert past == (route != "fused")
        assert _route("torch", method, shape, farm) == "torch"
    # Off the card, or in float64, the plain path whatever the widths.
    assert solver._resolve_backend(None, gt.SolverOptions(), "cpu", shape) == "torch"
    assert solver._resolve_backend(None, gt.SolverOptions(dtype="float64"), "cuda", shape,
                                   smem_limit=H100_SHARED) == "torch"


@pytest.mark.parametrize("K", HORIZONS)
@pytest.mark.parametrize("s,c", [w for w in WIDTHS if max(w) > 32])
def test_explicit_kernel_backends_refuse_widths_they_have_no_kernel_for(s, c, K):
    shape = (K, s, c)
    for method in ("pcg", "direct"):
        if method == "pcg" and (s, c, K) in PCG_KERNEL_WIDE:
            assert _route("pcg_kernel", method, shape) == "pcg_kernel"
        else:
            with pytest.raises(ValueError, match="pcg_backend='pcg_kernel'.*<= 32"):
                _route("pcg_kernel", method, shape)
        if method == "direct" or (s, c, K) != (36, 12, 57):
            with pytest.raises(ValueError, match="pcg_backend='fused'.*'torch'"):
                _route("fused", method, shape)
    with pytest.raises(ValueError, match="pcg_backend='fused'.*<= 32"):
        _route("fused", "pcg", shape, farm=True)
    if (s, c, K) == (36, 12, 57):
        assert _route("fused", "pcg", shape) == "fused"
    if (s, c) == (36, 12):
        with pytest.raises(ValueError, match=r"\(36, 12\) only within its shared memory"):
            _route("fused", "pcg", (1024, s, c))


def test_width_rules_of_the_kernels():
    assert kb.COMPILED_WIDTHS == ((14, 7), (2, 1), (36, 12))
    assert [kb.instance(s, c) for s, c in WIDTHS] == [
        "14x7", "2x1", "36x12", "generic", "generic", "generic", "generic"]
    assert [kb.takes_widths(s, c) for s, c in WIDTHS] == [
        True, True, True, False, False, False, False]
    # Every other kernel passes no wide pairs.
    assert [kb.takes_widths(s, c, ()) for s, c in WIDTHS] == [
        True, True, False, False, False, False, False]
    assert kb.takes_widths(32, 32) and not kb.takes_widths(12, 36)
    # Kernel B serves (36, 12) up to K = 267 on an H100; the farm kernel none of it.
    assert kb.fits(267, 36, 12, H100_SHARED) and not kb.fits(268, 36, 12, H100_SHARED)
    assert not any(ks.fits(K, 36, 12, H100_SHARED) for K in (2, 57, 267))
    assert ks.fits(50, 14, 7, H100_SHARED) == kb.fits(50, 14, 7, H100_SHARED)
    assert _build.MAX_BLOCK == 32


def _spec_batch(K, n=2, seed0=31):
    spec = gt.ProblemSpec(36, 12, K)
    return spec, tt.random_batch(spec, n, seed0=seed0)


def _same(a, b):
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("s,c", [(36, 12), (40, 20)])
def test_packed_tiers_at_wide_widths_solve_as_the_plain_path(s, c):
    spec = gt.ProblemSpec(s, c, 6)
    batch = tt.random_batch(spec, 2, seed0=41)
    for method in ("pcg", "direct"):
        opts = gt.SolverOptions(rho=RHO, exit_tol=EXIT_TOL, method=method)
        packed = gt.pack(spec, batch, method=method, device="cpu")
        kernel_b = (s, c) == (36, 12) and method == "pcg"
        assert packed.plan.tier == (None if kernel_b else "torch")
        got = gt.solve_packed(packed, opts).unpack()
        # On CPU tensors kernel B's route runs its plain version.
        _same(got, gt.solve_batched(spec, batch, opts, device="cpu",
                                    pcg_backend="fused" if kernel_b else "torch"))
        with pytest.raises(ValueError, match="tier='cr'.*<= 32"):
            gt.pack(spec, batch, method="direct", tier="cr", device="cpu")
    farm = tt.random_farm(spec, 3, 2, seed0=43)
    seq = gt.pack_sequence(spec, farm, device="cpu")
    assert seq.plan.tier == "torch"
    opts = gt.SolverOptions(rho=RHO, exit_tol=EXIT_TOL)
    got = gt.solve_packed_sequence(seq, opts).unpack()
    _same(got, gt.solve_sequence_batched(spec, farm, opts, pcg_backend="torch",
                                         device="cpu"))


def test_kernel_a_route_takes_a_control_size_above_32():
    """(6, 14, 40), method='pcg': 'pcg_kernel' condenses in PyTorch ops, so
    kernel A (its plain version on CPU tensors) runs at s = 14 whatever c
    is, and solves as the plain path does (float32 round-off apart)."""
    spec = gt.ProblemSpec(14, 40, 6)
    batch = tt.random_batch(spec, 2, seed0=45)
    opts = gt.SolverOptions(rho=RHO, exit_tol=EXIT_TOL)
    got = gt.solve_batched(spec, batch, opts, pcg_backend="pcg_kernel", device="cpu")
    ref = gt.solve_batched(spec, batch, opts, pcg_backend="torch", device="cpu")
    assert bool(got.converged.all())
    assert got.iters.tolist() == ref.iters.tolist()
    for name in ("lam", "dz_x", "dz_u"):
        want = getattr(ref, name)
        torch.testing.assert_close(getattr(got, name), want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


def _rel_err(got, ref):
    """The worst problem's largest gap over its largest reference entry (the
    benchmark's measure)."""
    got, ref = got.double().flatten(1), ref.double().flatten(1)
    return float(((got - ref).abs().amax(1) / ref.abs().amax(1)).max())


@pytest.mark.parametrize("K", [6, 57])
@pytest.mark.parametrize("seed", [123, 2**31 + 5])
def test_plain_path_against_the_float64_reference(K, seed):
    """Generator-recipe problems (benchmark/generator.py) at the
    configuration's options.  PCG stops at |r . M r| < 1e-6, which leaves
    the multipliers 2.7e-4-6.1e-4 of scale from the exact answer on these
    and neighbouring seeds, on a CPU: 1.5e-3 holds that with room, under
    the TF32 control's ~8e-3 (PERF.md section 4).  Its iterations are the
    float64 reference PCG's, give or take one where eta meets exit_tol
    within float32 round-off.  The exact method is float32 block Thomas:
    within 7.9e-6 measured, 1e-4 of scale."""
    fields = generator.make_problems(4, K, 36, 12, seed, "cpu")
    spec, blocks = gt.ProblemSpec(36, 12, K), gt.KKTBlocks(*fields)
    ref = kkt.solve(fields, RHO)
    ref_dz = torch.cat([ref.dz_x.flatten(1), ref.dz_u.flatten(1)], 1)
    for method, tol in (("pcg", 1.5e-3), ("direct", 1e-4)):
        opts = gt.SolverOptions(rho=RHO, exit_tol=EXIT_TOL, max_iters=100, method=method)
        got = gt.solve_batched(spec, blocks, opts, device="cpu")
        assert bool(got.converged.all())
        assert _rel_err(got.lam, ref.lam) <= tol
        assert _rel_err(torch.cat([got.dz_x.flatten(1), got.dz_u.flatten(1)], 1),
                        ref_dz) <= tol
    plain = kkt.pcg(fields, RHO, EXIT_TOL, 100)
    got = gt.solve_batched(spec, blocks, gt.SolverOptions(rho=RHO, exit_tol=EXIT_TOL),
                           device="cpu")
    assert bool(plain.converged.all())
    assert (got.iters.long() - plain.iters).abs().max() <= 1


@pytest.mark.parametrize("K", [6, 57])
@pytest.mark.parametrize("method", ["pcg", "direct"])
def test_plain_path_matches_gato_tpu(K, method):
    """The same inputs through gato_tpu's 'jax' path: float32 round-off
    apart (1e-4 of scale; measured 2.4e-6-7.1e-6), the same iterations
    (the two documented exceptions to equal counts, scalar Jacobi at
    degree 2 and exits within round-off of exit_tol, do not arise here: the
    CPU runs are deterministic)."""
    spec, batch = _spec_batch(K, n=3, seed0=240)
    opts = dict(rho=RHO, exit_tol=EXIT_TOL, max_iters=100, method=method)
    ours = gt.solve_batched(spec, batch, gt.SolverOptions(**opts), device="cpu")
    ref = gato_tpu.solve_batched(gato_tpu.ProblemSpec(36, 12, K), gato_tpu.KKTBlocks(*batch),
                                 gato_tpu.SolverOptions(**opts), pcg_backend="jax")
    assert ours.iters.tolist() == np.asarray(ref.iters).tolist()
    assert ours.converged.tolist() == np.asarray(ref.converged).tolist()
    for name in ("lam", "dz_x", "dz_u"):
        want = np.asarray(getattr(ref, name))
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(getattr(ours, name).numpy(), want, rtol=1e-4,
                                   atol=1e-4 * scale)


def _gj(count, n, nt):
    chunk = min(nt // n, count)
    return 2 * chunk * n * n + 2 * chunk * n + chunk


@pytest.mark.parametrize("C", [1, 2, 4, 8, 16])
def test_plan_at_the_quadruped_against_its_formulas(C):
    K, s, c = 57, 36, 12
    record = 7 * s * s + c * c + s * c
    assert kb.record_floats(s, c) == record == 9648
    kn = -(-K // C)
    threads = min(max(-(-(kn + (C > 1)) * s // 32) * 32, 64), 384)
    assert kb.cta_threads(K, s, c, C) == threads
    union = max(_gj(kn + 1, s, threads), _gj(kn, c, threads), 7 * kn * s + kn * c)
    base = 96 + kn * s + 2 * 8 * s + 3 * s * s + union
    assert kb.cta_smem_bytes(K, s, c, C, False) == 4 * base
    assert kb.cta_smem_bytes(K, s, c, C, True) == 4 * (base + kn * record)
    assert kb.cluster_fits(K, s, c, C, H100_SHARED)
    # Only at C = 16 (four knots a CTA) do the records sit beside the plan.
    assert kb.ops_in_smem(K, s, c, C, H100_SHARED) == (C == 16)


def test_quadruped_plan_at_c16():
    K, s, c = 57, 36, 12
    assert kb.cta_threads(K, s, c, 16) == 192
    assert kb.cta_smem_bytes(K, s, c, 16, True) == 226484
    assert 226484 <= H100_SHARED - _build.RESERVED_SHARED_BYTES
    # C = 16 is the floor (the smallest C whose records fit), so every batch
    # width takes it.
    for B in (1, 4, 8, 9, 64, 175, 4096):
        assert kb.cluster_size(B, K, s, c, H100_SMS, H100_SHARED) == 16
