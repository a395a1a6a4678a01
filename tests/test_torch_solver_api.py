"""The slice as a whole: gato_tpu_torch's solve / solve_batched /
linsys_solve against gato_tpu's on the same inputs, with device="cpu".

Tolerances: 1e-4 (rtol and atol) in float32, 1e-10 in float64; iteration
counts equal exactly.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import sparse

import gato_tpu
from gato_tpu import testing as jt

import gato_tpu_torch as gt
from gato_tpu_torch import solver
from gato_tpu_torch import testing as tt

torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-4)
IIWA = tt.IIWA
JIIWA = gato_tpu.ProblemSpec(14, 7, 50)
REPO = Path(__file__).resolve().parent.parent


def _close(ours, ref, tol=F32):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(ref), **tol)


@pytest.mark.parametrize("backend", ["torch", "pcg_kernel", "fused"])
def test_solve_iiwa_matches_gato_tpu(backend):
    blocks = tt.random_blocks(IIWA, seed=4)
    opts = dict(rho=1e-3, exit_tol=1e-6, max_iters=100)
    ours = gt.solve(IIWA, blocks, gt.SolverOptions(**opts),
                    pcg_backend=backend, device="cpu")
    ref = gato_tpu.solve(JIIWA, gato_tpu.KKTBlocks(*blocks),
                         gato_tpu.SolverOptions(**opts), pcg_backend="jax")
    assert int(ours.iters) == int(ref.iters)
    assert bool(ours.converged) == bool(ref.converged)
    for name in ("lam", "dz_x", "dz_u"):
        _close(getattr(ours, name), getattr(ref, name))
    np.testing.assert_allclose(ours.dz_flat(), ref.dz_flat(), **F32)


def test_solve_batched_iiwa_matches_gato_tpu():
    batch = tt.random_batch(IIWA, 8, seed0=100)
    lam0 = np.random.default_rng(0).normal(size=(8, 50, 14)).astype(np.float32)
    opts = dict(rho=1e-3, exit_tol=1e-6, max_iters=100, warm_start=True)
    ours = gt.solve_batched(IIWA, batch, gt.SolverOptions(**opts), lam0=lam0,
                            device="cpu")
    ref = gato_tpu.solve_batched(JIIWA, gato_tpu.KKTBlocks(*batch),
                                 gato_tpu.SolverOptions(**opts), lam0=lam0,
                                 pcg_backend="jax")
    assert ours.iters.tolist() == np.asarray(ref.iters).tolist()
    assert ours.converged.tolist() == np.asarray(ref.converged).tolist()
    for name in ("lam", "dz_x", "dz_u"):
        _close(getattr(ours, name), getattr(ref, name))


def test_float64_end_to_end():
    import jax

    spec = gt.ProblemSpec(4, 2, 10)
    blocks = tt.random_blocks(spec, seed=1)
    opts = dict(rho=1e-3, exit_tol=1e-22, max_iters=400, dtype="float64")
    ours = gt.solve(spec, blocks, gt.SolverOptions(**opts), device="cpu")
    assert ours.lam.dtype == torch.float64
    lam_ref, dz_ref = tt.dense_oracle(spec, blocks, rho=1e-3)
    np.testing.assert_allclose(ours.lam_flat(), lam_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ours.dz_flat(), dz_ref, rtol=1e-10, atol=1e-12)
    with jax.enable_x64(True):
        ref = gato_tpu.solve(gato_tpu.ProblemSpec(4, 2, 10),
                             gato_tpu.KKTBlocks(*blocks),
                             gato_tpu.SolverOptions(**opts), pcg_backend="jax")
        assert int(ours.iters) == int(ref.iters)
        _close(ours.lam, ref.lam, dict(rtol=1e-10, atol=1e-10))


def test_pendulum_linsys_solve_gate(capsys):
    """The original's end-to-end test on the port: same CSR data, same
    arguments, same dense oracle and tolerances (rtol=1, atol=0.01), and the
    same printed lines; the iteration count equals gato_tpu's."""
    p = tt.pendulum_problem()
    l, dz = gt.linsys_solve(p.G_row, p.G_col, p.G_val, p.C_row, p.C_col,
                            p.C_val, p.g, p.c, [0.0] * 10, 10, 1e-6, 10,
                            False, 0.001, device="cpu")
    G = sparse.csr_matrix((p.G_val, p.G_col, p.G_row)).todense()
    C = sparse.csr_matrix((p.C_val, p.C_col, p.C_row)).todense()
    A = np.block([[G, C.T], [C, np.zeros((C.shape[0], C.shape[0]))]])
    gamma = np.block([[np.array([p.g]).T], [np.array([p.c]).T]])
    x = np.linalg.inv(A).dot(gamma)
    x_ours = np.block([[np.array([dz]).T], [np.array([l]).T]])
    assert np.allclose(x_ours, x, rtol=1, atol=0.01)

    out = capsys.readouterr().out
    assert "first run PCG terminated in" in out
    assert "avg time:" in out
    lr, dzr = gato_tpu.linsys_solve(p.G_row, p.G_col, p.G_val, p.C_row,
                                    p.C_col, p.C_val, p.g, p.c, [0.0] * 10,
                                    1, 1e-6, 10, False, 0.001,
                                    pcg_backend="jax")
    ref_out = capsys.readouterr().out
    count = int(out.split("terminated in ")[1].split()[0])
    assert count == int(ref_out.split("terminated in ")[1].split()[0])
    np.testing.assert_allclose(l, lr, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(dz, dzr, rtol=1e-4, atol=1e-3)


def test_linsys_solve_iiwa_warm_start_matches_gato_tpu(capsys):
    blocks = tt.random_blocks(IIWA, seed=11)
    p = tt.blocks_to_csr(IIWA, blocks)
    lam_in = list(np.random.default_rng(2).normal(size=IIWA.nl) * 0.1)
    args = (p.G_row, p.G_col, p.G_val, p.C_row, p.C_col, p.C_val, p.g, p.c,
            lam_in, 2, 1e-8, 100, True, 1e-3)
    l, dz = gt.linsys_solve(*args, device="cpu", verbose=False)
    lr, dzr = gato_tpu.linsys_solve(*args, pcg_backend="jax", verbose=False)
    assert capsys.readouterr().out == ""
    _close(np.array(l), np.array(lr))
    _close(np.array(dz), np.array(dzr))
    lam_ref, dz_ref = tt.dense_oracle(IIWA, blocks, rho=1e-3)
    np.testing.assert_allclose(l, lam_ref, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(dz, dz_ref, rtol=1e-3, atol=1e-3)


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    p = tt.pendulum_problem()
    blocks = tt.random_blocks(PEND := gt.ProblemSpec(2, 1, 5), seed=0)
    with pytest.raises(RuntimeError, match="is_available"):
        gt.linsys_solve(p.G_row, p.G_col, p.G_val, p.C_row, p.C_col, p.C_val,
                        p.g, p.c, [0.0] * 10, 1, 1e-6, 10, False, 0.001)
    with pytest.raises(RuntimeError, match="is_available"):
        gt.solve(PEND, blocks)
    with pytest.raises(RuntimeError, match="is_available"):
        gt.solve_batched(PEND, tt.stack_blocks([blocks]), device="cuda:0")


def test_backend_resolution():
    opts = gt.SolverOptions()
    f64 = gt.SolverOptions(dtype="float64")
    assert solver.default_pcg_backend("cuda") == "fused"
    assert solver.default_pcg_backend("cpu") == "torch"
    assert solver.default_pcg_backend("cuda", "float64") == "torch"
    assert solver._resolve_backend(None, opts, "cpu") == "torch"
    assert solver._resolve_backend(None, f64, "cuda") == "torch"
    assert solver._resolve_backend("pcg_kernel", opts, "cpu") == "pcg_kernel"
    for backend in ("fused", "pcg_kernel"):
        with pytest.raises(ValueError, match="float32-only"):
            solver._resolve_backend(backend, f64, "cpu")
    with pytest.raises(ValueError, match="unknown pcg_backend"):
        solver._resolve_backend("pallas", opts, "cpu")
    spec = gt.ProblemSpec(2, 1, 5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gt.solve(spec, tt.random_blocks(spec), gt.SolverOptions(method="direct"),
                 device="cpu")
    with pytest.raises(ValueError, match="leading batch axis"):
        gt.solve_batched(spec, tt.random_blocks(spec), device="cpu")


def test_import_pulls_in_no_jax():
    """The port never imports jax or gato_tpu, not even from a submodule."""
    code = (
        "import sys, gato_tpu_torch, gato_tpu_torch.api, gato_tpu_torch.solver,"
        " gato_tpu_torch.testing, gato_tpu_torch.kernels._build,"
        " gato_tpu_torch.kernels.pcg_kernel, gato_tpu_torch.kernels.fused_solve;"
        " bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('gato_tpu') and not m.startswith('gato_tpu_torch')];"
        " assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    forbidden = re.compile(r"^\s*(import|from)\s+(jax|gato_tpu)(\s|\.|,|$)",
                           re.MULTILINE)
    for path in (REPO / "gato_tpu_torch").rglob("*.py"):
        assert not forbidden.search(path.read_text()), path
