"""The port's examples (examples/torch/*.py): an inventory against
examples/, a static check that none imports jax or gato_tpu, each script
run with ``--device cpu`` in a subprocess (a hang or crash cannot take the
suite down), its refusal of ``--device cuda`` where CUDA is absent, and two
parity checks in process against gato_tpu on the same inputs.

Each script takes 4-7 s here, so all run in the fast tier.  Tolerances:
pendulum's lambda within 1e-5 and dz within 1e-4 of the scale (max |value|)
of gato_tpu.linsys_solve's: the two float32 PCG runs of four iterations
differ by 7.2e-6 of lambda's scale and 2.6e-5 of dz's, which the recovery
amplifies; the serving example's cold iteration list equal to
gato_tpu.solve_packed's.
"""

import ast
import contextlib
import io
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gato_tpu
from gato_tpu import packed as jpk
from gato_tpu.testing import pendulum_problem

from gato_tpu_torch import testing as tt

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = sorted((ROOT / "examples" / "torch").glob("*.py"))
TIMEOUT = 300

# The closing line each script prints when every section ran.
CLOSING = {
    "pendulum": r"^Test passed$",
    "iiwa_batch": r"^MPC sequence: first solve \d+ iters, warm-started rest mean",
    "serving": r"^window 1: per-step mean iters \[",
    "advanced": r"^dp-split batch \(16 problems / 4 groups on .*\): all converged=True$",
}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def _run(path, device):
    return subprocess.run([sys.executable, str(path), "--device", device], cwd=ROOT,
                          env=_env(), capture_output=True, text=True, timeout=TIMEOUT)


def _in_process(name):
    """Run examples/torch/<name>.py with --device cpu in this process;
    returns (its globals, its standard output)."""
    out = io.StringIO()
    argv = sys.argv
    sys.argv = [name, "--device", "cpu"]
    try:
        with contextlib.redirect_stdout(out):
            env = runpy.run_path(str(ROOT / "examples" / "torch" / f"{name}.py"),
                                 run_name="__main__")
    finally:
        sys.argv = argv
    return env, out.getvalue()


def test_inventory():
    """examples/torch/ has a script for each of examples/, and no other."""
    assert {p.stem for p in EXAMPLES} == {p.stem for p in (ROOT / "examples").glob("*.py")}
    assert set(CLOSING) == {p.stem for p in EXAMPLES}


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_imports_no_jax(path):
    """No import statement of the script names jax or gato_tpu (the port's
    package, gato_tpu_torch, is what it imports)."""
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "gato_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "gato_tpu"}, roots


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_runs_on_cpu(path):
    out = _run(path, "cpu")
    assert out.returncode == 0, (
        f"{path.name} exited {out.returncode}\n--- stdout:\n{out.stdout[-2000:]}\n"
        f"--- stderr:\n{out.stderr[-2000:]}")
    last = out.stdout.strip().splitlines()[-1]
    assert re.search(CLOSING[path.stem], last), last


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_refuses_cuda_without_cuda(path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    out = _run(path, "cuda")
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr, out.stderr[-2000:]
    assert out.stdout == ""


def test_pendulum_matches_gato_tpu():
    env, text = _in_process("pendulum")
    assert text.strip().splitlines()[-1] == "Test passed"
    p = pendulum_problem()
    l_ref, dz_ref = gato_tpu.linsys_solve(
        p.G_row, p.G_col, p.G_val, p.C_row, p.C_col, p.C_val,
        p.g, p.c, [0.0] * 10,
        testiters=10, exit_tol=1e-6, max_iters=10, warm_start=False, rho=0.001)
    for ours, ref, tol in ((env["l"], l_ref, 1e-5), (env["dz"], dz_ref, 1e-4)):
        scale = float(np.max(np.abs(ref)))
        np.testing.assert_allclose(ours, ref, rtol=0, atol=tol * scale)


def test_serving_cold_iterations_match_gato_tpu():
    env, text = _in_process("serving")
    cold = re.search(r"^cold solve: iters (\[.*\])$", text, re.M)
    assert cold, text
    spec = gato_tpu.ProblemSpec(4, 2, 12)
    blocks = tt.random_batch(env["spec"], 8, seed0=0)
    assert all(np.array_equal(a, b) for a, b in zip(blocks, env["blocks"]))
    ref = jpk.solve_packed(
        jpk.pack(spec, gato_tpu.KKTBlocks(*(jnp.asarray(a) for a in blocks))),
        gato_tpu.SolverOptions(rho=1e-3, exit_tol=1e-8, max_iters=200))
    assert ast.literal_eval(cold.group(1)) == np.asarray(ref.iters).tolist()
    assert "solve_packed_dp refuses the relabel" in text
