"""The plain reference against a dense float64 KKT solve, its control, and
its independence from the program."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import generator, harness
from benchmark.reference import kkt

BENCH = Path(harness.BENCH)
FORBIDDEN_TOP = {"jax", "jaxlib", "flax", "gato_tpu"}


def dense_kkt(blocks, rho):
    """[[H, C^T], [C, 0]] and [g; c] of one problem, in float64, built
    entry by entry from the definition in reference/kkt.py's docstring."""
    Q, R, A, B, q, r, c = (np.asarray(t, dtype=np.float64) for t in blocks)
    K, s = q.shape
    cd = r.shape[1]
    sc = s + cd
    nz, nl = K * sc - cd, K * s
    M = np.zeros((nz + nl, nz + nl))
    rhs = np.zeros(nz + nl)
    for k in range(K):
        o = k * sc
        M[o:o + s, o:o + s] = Q[k] + rho * np.eye(s)
        rhs[o:o + s] = q[k]
        if k < K - 1:
            M[o + s:o + sc, o + s:o + sc] = R[k] + rho * np.eye(cd)
            rhs[o + s:o + sc] = r[k]
    C = np.zeros((nl, nz))
    C[:s, :s] = np.eye(s)
    for k in range(1, K):
        o = (k - 1) * sc
        C[k * s:(k + 1) * s, o:o + s] = A[k - 1]
        C[k * s:(k + 1) * s, o + s:o + sc] = B[k - 1]
        C[k * s:(k + 1) * s, o + sc:o + sc + s] = np.eye(s)
    M[:nz, nz:] = C.T
    M[nz:, :nz] = C
    rhs[nz:] = c.reshape(-1)
    x = np.linalg.solve(M, rhs)
    dz, lam = x[:nz], x[nz:].reshape(K, s)
    dz_x = np.stack([dz[k * sc:k * sc + s] for k in range(K)])
    dz_u = np.stack([dz[k * sc + s:(k + 1) * sc] for k in range(K - 1)])
    return lam, dz_x, dz_u


@pytest.mark.parametrize("shape", [(5, 3, 2), (6, 14, 7)])
def test_reference_agrees_with_the_dense_kkt_solve(shape):
    K, s, c = shape
    blocks = generator.make_problems(3, K, s, c, 11, "cpu")
    sol = kkt.solve(blocks, 1e-3)
    assert sol.lam.dtype == torch.float64
    for i in range(3):
        lam, dz_x, dz_u = dense_kkt([t[i] for t in blocks], 1e-3)
        np.testing.assert_allclose(sol.lam[i].numpy(), lam, rtol=0, atol=1e-10 * abs(lam).max())
        np.testing.assert_allclose(sol.dz_x[i].numpy(), dz_x, rtol=0, atol=1e-10 * abs(dz_x).max())
        np.testing.assert_allclose(sol.dz_u[i].numpy(), dz_u, rtol=0, atol=1e-10 * abs(dz_u).max())


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11), 3.0])
    y = kkt.tf32_round(x)
    assert y.tolist() == [1.0, 1 + 2 ** -10, 1 + 2 ** -10, 1.0, -(1 + 2 ** -10), 3.0]
    big = torch.randn(1000)
    assert ((kkt.tf32_round(big) - big).abs() <= big.abs() * 2 ** -11).all()


def test_the_control_is_off_by_tf32_rounding_and_no_more():
    blocks = generator.make_problems(4, 50, 14, 7, 3, "cpu")
    ref = kkt.solve(blocks, 1e-3)
    ctl = kkt.solve(blocks, 1e-3, tf32=True)
    f32 = kkt.solve(blocks, 1e-3, dtype=torch.float32)
    err = lambda a: ((a.lam.double() - ref.lam).abs().amax() / ref.lam.abs().amax()).item()
    assert ctl.lam.dtype == torch.float32
    assert 3e-4 < err(ctl) < 0.1
    assert err(f32) < 2e-5


def test_reference_pcg_converges_where_the_exact_solve_exists():
    blocks = generator.make_problems(4, 50, 14, 7, 4, "cpu")
    tight = kkt.pcg(blocks, 1e-3, 1e-6, 100)
    loose = kkt.pcg(blocks, 1e-3, 1e-2, 100)
    assert tight.converged.all() and loose.converged.all()
    assert (tight.iters > loose.iters).all() and (tight.iters < 60).all()
    capped = kkt.pcg(blocks, 1e-3, 1e-6, 5)
    assert not capped.converged.any() and (capped.iters == 5).all()


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").glob("*.py"))
    assert files
    for path in files:
        for name in imports(path):
            assert name.split(".")[0] not in FORBIDDEN_TOP | {"gato_tpu_torch", "benchmark"}, (path, name)


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in sorted(BENCH.rglob("*.py")):
        for name in imports(path):
            assert name.split(".")[0] not in FORBIDDEN_TOP, (path, name)
